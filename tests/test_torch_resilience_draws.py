"""The port's ``substrate.dispatch`` draws against the reference's.

The reference draws the chaos point while ``jax.jit`` traces a step: once
per site of its one traced layer (the ``lax.scan`` body) plus the unembed,
and never again once the trace is cached — but a jit whose first trace
raised is traced anew at every later call (jax 0.9), so such a step draws
at every dispatch.  The port runs eagerly and keeps the same book per step
(``serving/engine.py``).  Here both packages serve the same requests with
``gemm_fault_at = n`` for every n from 0 to one past the reference's draws
in its first prefill and first decode traces together (2 x 9 for
reduced qwen2-0.5b: eight sites of one layer and the unembed, a trace),
dense here and paged in ``tests/test_torch_resilience_draws_paged.py``
(``tests/test_torch_resilience_moe.py`` does the same for the MoE
engine); their streams, outcomes, counters, draw counters and
chaos logs must be equal.  The ``xla`` backend keeps the
reference's run short; the draws do not depend on the backend.
"""
import jax
import jax.numpy as jnp
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


QWEN_DRAWS = 2 * (8 + 1)          # first prefill + first decode trace


@pytest.fixture(scope="module")
def qwen():
    return models(backend="xla")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_reference_draw_counts(qwen, paged):
    """A chaos-free run draws exactly the first traces' sites, in both."""
    kw = dict(kv_pages=40, page_size=8) if paged else {}
    got = assert_parity(*qwen, chaos=dict(seed=1), **kw)
    assert got["chaos_draws"]["substrate.dispatch"] == QWEN_DRAWS


def test_reference_jit_retraces_after_a_failed_first_trace():
    """The jax fact the port's book reproduces: a jit whose first trace
    raised traces again at every call; one whose first trace succeeded
    never does."""
    traces, fail = [0], [True]

    def f(x):
        traces[0] += 1
        if fail[0]:
            fail[0] = False
            raise RuntimeError("first trace fails")
        return x * 2

    for first_fails in (True, False):
        traces[0], fail[0] = 0, first_fails
        jf = jax.jit(lambda x: f(x))
        x = jnp.ones(3)
        if first_fails:
            with pytest.raises(RuntimeError):
                jf(x)
        for _ in range(4):
            jf(x)
        assert traces[0] == (5 if first_fails else 1)


def check_gemm_fault_at(qwen, n, **kw):
    got = assert_parity(*qwen, chaos=dict(gemm_fault_at=n), **kw)
    assert got["stats"]["kernel_fault_retries"] == (n < QWEN_DRAWS)
    assert got["outcomes"] == ["ok"] * 3


@pytest.mark.parametrize("n", range(QWEN_DRAWS + 1))
def test_gemm_fault_at_matches_reference(qwen, n):
    check_gemm_fault_at(qwen, n)
