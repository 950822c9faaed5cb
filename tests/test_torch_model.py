"""The port's dense LM vs the reference ``repro.models.lm``.

The reference parameter tree (``lm.init_params(cfg, PRNGKey(0))``) is
converted leaf by leaf (``repro_torch.models.convert``), both packages run
the same tokens, and the logits are compared.  Tolerances, absolute on
logits of magnitude < 1 (random init):

* fp32: 1e-4 — both sides compute in fp32 and differ only in summation
  order and in the last bits of exp/rsqrt/sin/cos, through 2 layers.
* bf16: 2^-5 relative to max |logit| — hidden states round to bf16 after
  every GEMM (8 significant bits), and a one-step rounding flip in one
  package propagates through both layers; a few bf16 steps of the logit
  scale.

The reference's Pallas kernels run in interpret mode on the CPU; the
port's wrappers run their plain versions on CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.models import lm as ref_lm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import substrate
from repro_torch.models import convert, lm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FP32_ATOL = 1e-4
BF16_RTOL = 2.0 ** -5
BACKENDS = ["xla", "ref", "arrayflex"]


def _cfgs(backend, dtype="float32"):
    rc = dataclasses.replace(ref_reduced(ARCHS["qwen2-0.5b"]),
                             gemm_backend=backend, compute_dtype=dtype)
    tc = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                             gemm_backend=backend, compute_dtype=dtype)
    return rc, tc


@pytest.fixture(scope="module")
def ref_params():
    rc, _ = _cfgs("xla")
    return ref_lm.init_params(rc, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_params(ref_params):
    _, tc = _cfgs("xla")
    np_tree = jax.tree_util.tree_map(np.asarray, ref_params)
    return convert.params_from_reference(tc, np_tree, device="cpu")


def _assert_logits(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    atol = (FP32_ATOL if dtype == "float32"
            else BF16_RTOL * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _decode_both(backend, dtype, ref_params, port_params, steps=3):
    rc, tc = _cfgs(backend, dtype)
    B, S = 2, 16
    r_cache = ref_lm.init_cache(rc, B, S)
    t_cache = lm.init_cache(tc, B, S, device="cpu")
    toks = [3, 5]
    for step in range(steps):
        pos = [step, step + 2]           # ragged per-row positions
        rl, r_cache = ref_lm.decode_step(rc, ref_params, r_cache,
                                         jnp.asarray(toks, jnp.int32),
                                         jnp.asarray(pos, jnp.int32))
        tl, t_cache = lm.decode_step(tc, port_params, t_cache,
                                     torch.tensor(toks), torch.tensor(pos))
        yield rl, tl, r_cache, t_cache
        toks = [int(t) for t in np.argmax(np.asarray(rl), -1)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_logits_match_reference_fp32(backend, ref_params,
                                            port_params):
    for rl, tl, rcache, tcache in _decode_both(backend, "float32",
                                               ref_params, port_params):
        _assert_logits(tl, rl, "float32")
    np.testing.assert_array_equal(
        np.asarray(rcache[0]["k"].astype(jnp.float32)),
        tcache[0]["k"].float().numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_logits_match_reference_bf16(backend, ref_params,
                                            port_params):
    for rl, tl, _, _ in _decode_both(backend, "bfloat16", ref_params,
                                     port_params):
        _assert_logits(tl, rl, "bfloat16")


def _prefill_both(backend, dtype, ref_params, port_params):
    rc, tc = _cfgs(backend, dtype)
    B, S = 3, 16
    toks = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 0, 0], [9, 0, 0, 0, 0]])
    lens = np.array([5, 3, 0])            # row 2 inactive this chunk
    pos = np.array([0, 2, 0])
    rl, rcache = ref_lm.prefill_step(rc, ref_params, ref_lm.init_cache(
        rc, B, S), jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(lens))
    tl, tcache = lm.prefill_step(tc, port_params, lm.init_cache(
        tc, B, S, device="cpu"), torch.tensor(toks), torch.tensor(pos),
        torch.tensor(lens))
    return rl[:2], tl[:2], rcache, tcache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_logits_match_reference(backend, dtype, ref_params,
                                        port_params):
    rl, tl, rcache, tcache = _prefill_both(backend, dtype, ref_params,
                                           port_params)
    _assert_logits(tl, rl, dtype)
    for name in ("k", "v"):
        want = np.asarray(rcache[0][name].astype(jnp.float32))
        got = tcache[0][name].float().numpy()
        atol = 0.0 if dtype == "float32" else BF16_RTOL * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_equals_decode_row_for_row(backend, port_params):
    """The contract of tests/test_serving_prefill.py inside the port: a
    chunked prefill of tokens[:-1] followed by one decode step gives the
    logits of decoding the whole prompt token by token."""
    _, tc = _cfgs(backend)
    prompt = [11, 12, 13, 14, 15, 16]
    c1 = lm.init_cache(tc, 1, 16, device="cpu")
    for i, t in enumerate(prompt):
        step, c1 = lm.decode_step(tc, port_params, c1, torch.tensor([t]),
                                  torch.tensor([i]))
    c2 = lm.init_cache(tc, 1, 16, device="cpu")
    n = len(prompt) - 1
    _, c2 = lm.prefill_step(tc, port_params, c2, torch.tensor([prompt[:-1]]),
                            torch.tensor([0]), torch.tensor([n]))
    chunked, c2 = lm.decode_step(tc, port_params, c2,
                                 torch.tensor([prompt[-1]]),
                                 torch.tensor([n]))
    torch.testing.assert_close(chunked, step, rtol=0, atol=1e-5)
    torch.testing.assert_close(c1[0]["k"], c2[0]["k"], rtol=0, atol=1e-2)


def test_site_plans_and_dispatches_match_reference(ref_params, port_params):
    """One decode step plans the same k at every site in both packages;
    the reference traces each scanned site once, the port dispatches it
    once per layer."""
    import repro.kernels.substrate as ref_sub
    rc, tc = _cfgs("arrayflex")
    ref_sub.clear_plan_cache()
    substrate.clear_plan_cache()
    ref_lm.decode_step(rc, ref_params, ref_lm.init_cache(rc, 2, 16),
                       jnp.asarray([1, 2], jnp.int32),
                       jnp.asarray([0, 0], jnp.int32))
    lm.decode_step(tc, port_params, lm.init_cache(tc, 2, 16, device="cpu"),
                   torch.tensor([1, 2]), torch.tensor([0, 0]))
    assert set(substrate.SITE_PLANS) == set(ref_sub.SITE_PLANS)
    for site, plan in substrate.SITE_PLANS.items():
        want = ref_sub.SITE_PLANS[site]
        assert (plan.M, plan.N, plan.T, plan.k) == \
            (want.M, want.N, want.T, want.k), site
    assert set(substrate.DISPATCH_COUNTS) == set(ref_sub.DISPATCH_COUNTS)
    for site, n in substrate.DISPATCH_COUNTS.items():
        per_trace = ref_sub.DISPATCH_COUNTS[site]
        assert n == per_trace * (1 if site == "unembed" else tc.n_layers)
    ref_sub.clear_plan_cache()
    substrate.clear_plan_cache()


def test_init_params_mirror_reference_tree(ref_params):
    _, tc = _cfgs("xla")
    ours = lm.init_params(tc, seed=0, device="cpu")
    ref_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref_params)

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(shapes(v) for v in node)
        return tuple(node.shape)

    assert shapes(ours) == ref_shapes
    again = lm.init_params(tc, seed=0, device="cpu")
    torch.testing.assert_close(ours["embed"]["table"],
                               again["embed"]["table"], rtol=0, atol=0)
    other = lm.init_params(tc, seed=1, device="cpu")
    assert not torch.equal(ours["embed"]["table"], other["embed"]["table"])


def test_init_cache_matches_reference():
    rc, tc = _cfgs("xla")
    want = ref_lm.init_cache(rc, 3, 20)
    got = lm.init_cache(tc, 3, 20, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: tuple(v.shape) for k, v in g.items()} == \
            {k: tuple(v.shape) for k, v in w.items()}
        assert all(v.dtype == torch.bfloat16 for v in g.values())


def test_prepare_params_casts_once(port_params):
    _, tc = _cfgs("arrayflex", "bfloat16")
    served = lm.prepare_params(tc, port_params)
    blk = served["blocks"][0]
    assert blk["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert blk["attn"]["wq"]["b"].dtype == torch.float32
    assert blk["ln1"]["scale"].dtype == torch.float32
    table = port_params["embed"]["table"].to(torch.bfloat16)
    assert torch.equal(served["embed"]["table_t"], table.t())
    assert served["embed"]["table_t"].is_contiguous()
    # same numbers from the served tree and the raw tree
    cache = lm.init_cache(tc, 1, 8, device="cpu")
    a, _ = lm.decode_step(tc, served, cache, torch.tensor([4]),
                          torch.tensor([0]))
    cache = lm.init_cache(tc, 1, 8, device="cpu")
    b, _ = lm.decode_step(tc, port_params, cache, torch.tensor([4]),
                          torch.tensor([0]))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("change", [dict(family="audio"),
                                    dict(sliding_window=8)])
def test_unported_families_raise(change):
    """Formerly refused, now run: the audio family's cache gains the cross
    ``xk`` / ``xv`` leaves and a sliding window clamps the K/V ring, with
    the reference's leaf shapes."""
    rc, tc = _cfgs("xla")
    rc, tc = (dataclasses.replace(rc, **change),
              dataclasses.replace(tc, **change))
    for S in (4, 16):
        got = lm.init_cache(tc, 1, S, device="cpu")
        want = ref_lm.init_cache(rc, 1, S)
        assert [{k: tuple(t.shape) for k, t in c.items()} for c in got] == \
            [{k: tuple(t.shape) for k, t in c.items()} for c in want]
    assert ("xk" in got[0]) == (change.get("family") == "audio")
    assert got[0]["k"].shape[2] == (8 if "sliding_window" in change else 16)


def test_entry_points_default_to_the_card():
    _, tc = _cfgs("xla")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(tc, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(tc, seed=0)
