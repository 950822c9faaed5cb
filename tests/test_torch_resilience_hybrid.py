"""The port's ``substrate.dispatch`` draws against the reference's on the
hybrid interleave (reduced jamba-1.5-large-398b, fp32, ``xla``, the
reference's converted weights, token-by-token prefill).

The reference traces its decode step's scan body once: a super-block of
the whole period, eight sub-layers, so a trace draws at every dispatch
of all eight (seven mamba mixers, one attention layer, four dense MLPs,
four MoE layers) and the unembed: 59 draws, where a model of period 1
draws one layer's.  The port keys its draws by site label and sub-layer
position (``substrate.chaos_sublayer``).  Both packages serve the same
requests with ``gemm_fault_at`` at a later sub-layer's mamba.out, at the
attention layer's attn.qk and at the unembed; their streams, outcomes,
counters, draw counters and chaos logs must be equal
(``tests/test_torch_resilience_parity.py``'s ``assert_parity``).
"""
import pytest

from test_torch_resilience_parity import assert_parity, models

HYBRID_DRAWS = 7 * 4 + 6 + 4 * 2 + 4 * 4 + 1
PROMPTS = [[5, 6, 7], [21]]


@pytest.fixture(scope="module")
def jamba():
    return models("jamba-1.5-large-398b", backend="xla")


def test_hybrid_reference_draw_count(jamba):
    got = assert_parity(*jamba, prompts=PROMPTS, max_new=3,
                        chaos=dict(seed=1), prefill_mode="token")
    assert got["chaos_draws"]["substrate.dispatch"] == HYBRID_DRAWS == 59


@pytest.mark.parametrize("n,site", [(9, "mamba.out"), (31, "attn.qk"),
                                    (58, "unembed")])
def test_hybrid_gemm_fault_at_matches_reference(jamba, n, site):
    got = assert_parity(*jamba, prompts=PROMPTS, max_new=3,
                        chaos=dict(gemm_fault_at=n), prefill_mode="token")
    assert got["chaos_log"][0] == ("substrate.dispatch", n, site)
    assert got["stats"]["kernel_fault_retries"] == 1
    assert got["outcomes"] == ["ok"] * 2
