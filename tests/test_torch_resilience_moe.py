"""The port's ``substrate.dispatch`` draws against the reference's, on
the MoE engine's token-by-token path.

The MoE family prefills token by token through the decode step, so its
first trace is the first prompt token's: six attention sites, the router,
the three expert banks and the unembed.  Both packages serve the same
requests (reduced qwen3-moe-30b-a3b, fp32, ``xla``, the reference's
converted weights) with ``gemm_fault_at = n`` for every n from 0 to one
past those draws, and with a crash mid-stream; their streams, outcomes,
counters, draw counters and chaos logs must be equal (the book is
``tests/test_torch_resilience_draws.py``'s).  A fault in the first trace
makes the reference trace at every later call, so the requests are
short.
"""
import pytest
import torch

from test_torch_resilience_parity import assert_parity, models


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MOE_DRAWS = 6 + 4 + 1             # one decode trace: attention, MoE, unembed
MOE_PROMPTS = [[5, 6, 7], [21]]


@pytest.fixture(scope="module")
def moe():
    return models("qwen3-moe-30b-a3b", backend="xla")


def test_moe_reference_draw_count(moe):
    got = assert_parity(*moe, prompts=MOE_PROMPTS, max_new=3,
                        chaos=dict(seed=1), prefill_mode="token")
    assert got["chaos_draws"]["substrate.dispatch"] == MOE_DRAWS


@pytest.mark.parametrize("n", range(MOE_DRAWS + 1))
def test_moe_token_prefill_gemm_fault_at_matches_reference(moe, n):
    got = assert_parity(*moe, prompts=MOE_PROMPTS, max_new=3,
                        chaos=dict(gemm_fault_at=n), prefill_mode="token")
    assert got["stats"]["kernel_fault_retries"] == (n < MOE_DRAWS)
    assert got["outcomes"] == ["ok"] * 2


@pytest.mark.parametrize("crash_at,fault_at", [(0, 2), (2, MOE_DRAWS + 2)])
def test_moe_token_prefill_crash_matches_reference(moe, crash_at, fault_at):
    """A crash mid-stream of the MoE engine (at the first tick: before
    any trace; at the third: the restored engine draws on from the
    snapshot's counters), then a GEMM fault in the restored engine's
    first trace: streams, draws and logs as the reference's."""
    got = assert_parity(*moe, prompts=MOE_PROMPTS, max_new=3,
                        chaos=dict(crash_at=crash_at, gemm_fault_at=fault_at),
                        prefill_mode="token", snapshot_every_ticks=1)
    assert got["restarts"] == 1 and got["outcomes"] == ["ok"] * 2
    assert got["chaos_log"][-1] == ("substrate.dispatch", fault_at,
                                    "attn.wv")
