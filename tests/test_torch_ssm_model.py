"""The port's SSM family vs the reference ``repro.models.lm``: reduced
``mamba2-370m`` as ``reduced()`` builds it (a swiglu MLP after each
mixer, d_ff = 128) and with ``d_ff=0`` (no MLP and no ln2, as the full
width has none), on every backend; the hybrid's cases are in
``tests/test_torch_hybrid_model.py``, which runs these helpers on reduced
``jamba-1.5-large-398b``.

The reference parameter tree (``lm.init_params(cfg, PRNGKey(0))``) is
carried across leaf by leaf (``repro_torch.models.convert``), both
packages serve it as their engines do (``prepare_params`` /
``prequantize_params``), and the logits and caches are compared.
Tolerances, in fp32:

* logits: 1e-4 absolute on ``xla``, ``arrayflex`` and ``arrayflex_int8``
  (``tests/test_torch_model.py``'s fp32 contract: summation order and the
  last bits of exp/log1p/rsqrt through the layers); on ``arrayflex_w8a8``
  the reference's W8A8 policy (``docs/substrate.md``, "Tolerance
  policy"): 0.12 absolute for a dense/Mamba model, 2.5 with an MoE.
* the fp32 recurrent ``state``: 1e-4 absolute (W8A8: its policy bound).
* bf16 leaves (``conv`` and the hybrid's K/V): one bf16 step of each
  value, 2^-7 relative (an fp32 difference in the last bits can round to
  the neighbouring bf16 value), 1e-4 absolute.

Decode runs 12 steps at ragged per-row positions with the conv window
cached in fp32 on every backend, held to the tolerances above, and on
``xla`` and ``arrayflex`` (the casts do not depend on the backend) with
it cached in bf16 as served (every step casts the new window to bf16, in
both packages), the logits then held to 1e-3 of max(1, max |reference
logit|): an
fp32 difference in the last bits rounds one of the window's values to the
neighbouring bf16 value in one package only now and then (observed up to
3.1e-4 on reduced mamba2 on ``arrayflex``, 1.1e-3 at logits up to 3.6 on
the hybrid), while leaving the casts out would differ by about the
reference's own gap between its bf16-window decode and its fp32 forward,
2.0e-3 on reduced mamba2, whose logits stay below 1.  The hybrid's K/V
rows are cached in fp32 in both runs, so that no rounding flip of a K/V
row enters.  The reference's steps run under ``jax.jit`` (its eager scan
re-traces every step).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.kernels import substrate as ref_sub
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


BACKENDS = ["xla", "arrayflex", "arrayflex_int8", "arrayflex_w8a8"]
# (backend, conv window dtype) of the decode checks (module docstring)
DECODE_CASES = ([(b, "float32") for b in BACKENDS]
                + [("xla", "bfloat16"), ("arrayflex", "bfloat16")])
FP32_ATOL = 1e-4
W8A8_ATOL = {"dense": 0.12, "moe": 2.5}
BF16_STEP = 2.0 ** -7
BF16_WINDOW_TOL = 1e-3
DECODE_STEPS = 12
MAMBA_SITES = {"mamba.z", "mamba.xbc", "mamba.dt", "mamba.out"}
CASES = {"mamba2": ("mamba2-370m", {}),
         "mamba2-noffn": ("mamba2-370m", {"d_ff": 0}),
         "jamba": ("jamba-1.5-large-398b", {})}


def cfgs(case, backend="xla"):
    arch, kw = CASES[case]
    kw = dict(kw, gemm_backend=backend, compute_dtype="float32")
    return (dataclasses.replace(ref_reduced(ARCHS[arch]), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def build(case):
    """(reference tree, the port's converted tree) of ``case``."""
    rc, tc = cfgs(case)
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
    tp = convert.params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return rp, tp


def served(case, backend, trees):
    """Both packages' served trees on ``backend``."""
    rc, tc = cfgs(case, backend)
    rp, tp = trees
    return (rc, ref_lm.prequantize_params(rc, rp), tc,
            lm.prequantize_params(tc, lm.prepare_params(tc, tp)))


def logit_atol(case, backend):
    if backend != "arrayflex_w8a8":
        return FP32_ATOL
    return W8A8_ATOL["moe" if case == "jamba" else "dense"]


def assert_logits(got, want, atol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def assert_cache(got, want, atol):
    """Every leaf of every period entry: fp32 leaves to ``atol``, bf16
    leaves to one bf16 step of each value beside ``atol`` (the logits'
    tolerance: what moves the logits moves the leaves)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, t in g.items():
            ref = np.asarray(jnp.asarray(w[k], jnp.float32))
            assert t.dtype == getattr(torch, str(w[k].dtype)), k
            assert tuple(t.shape) == ref.shape, k
            if t.dtype == torch.bfloat16:
                np.testing.assert_allclose(t.float().numpy(), ref,
                                           rtol=BF16_STEP,
                                           atol=max(atol, FP32_ATOL))
            else:
                np.testing.assert_allclose(t.numpy(), ref, rtol=0,
                                           atol=atol)


def decode_caches(rc, tc, B, S, conv_dtype):
    """Zero decode caches of both packages: K/V rows in fp32, the conv
    window in ``conv_dtype`` (module docstring)."""
    rcache = ref_lm.init_cache(rc, B, S, dtype=jnp.float32)
    tcache = lm.init_cache(tc, B, S, dtype=torch.float32, device="cpu")
    rcache = tuple(dict(c, conv=c["conv"].astype(getattr(jnp, conv_dtype)))
                   if "conv" in c else c for c in rcache)
    tcache = tuple(dict(c, conv=c["conv"].to(getattr(torch, conv_dtype)))
                   if "conv" in c else c for c in tcache)
    return rcache, tcache


def check_forward(case, backend, trees):
    """``lm.forward`` logits of every position, its aux loss and its
    caches, and ``lm.prefill``'s last logits and caches against the
    reference forward's (its ``prefill`` is that forward's last row), both
    packages, S = 32 (one reduced chunk)."""
    rc, rq, tc, tq = served(case, backend, trees)
    toks = np.random.RandomState(0).randint(0, tc.vocab_size, (2, 32))
    atol = logit_atol(case, backend)
    rl, raux, rcache = ref_lm.forward(rc, rq, {"tokens": jnp.asarray(toks)},
                                      return_cache=True)
    tl, taux, tcache = lm.forward(tc, tq, {"tokens": torch.tensor(toks)},
                                  return_cache=True)
    assert_logits(tl, rl, atol)
    assert_cache(tcache, rcache, atol)
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5,
                               atol=1e-7)
    tlast, tcache = lm.prefill(tc, tq, {"tokens": torch.tensor(toks)})
    assert_logits(tlast, rl[:, -1], atol)
    assert_cache(tcache, rcache, atol)


@functools.lru_cache(maxsize=None)
def _ref_decode(rc):
    return jax.jit(functools.partial(ref_lm.decode_step, rc))


def check_decode(case, backend, trees, conv_dtype):
    """``DECODE_STEPS`` decode steps from the same tokens (the reference's
    argmax feeds the next) at ragged positions: logits every step, the
    whole cache after the last."""
    rc, rq, tc, tq = served(case, backend, trees)
    B, S = 2, 16
    rcache, tcache = decode_caches(rc, tc, B, S, conv_dtype)
    atol = logit_atol(case, backend)
    toks = [3, 5]
    for step in range(DECODE_STEPS):
        pos = [step, step + 2]
        rl, rcache = _ref_decode(rc)(rq, rcache,
                                     jnp.asarray(toks, jnp.int32),
                                     jnp.asarray(pos, jnp.int32))
        tl, tcache = lm.decode_step(tc, tq, tcache, torch.tensor(toks),
                                    torch.tensor(pos))
        scale = max(1.0, float(jnp.abs(rl).max()))
        logit_tol = (max(atol, BF16_WINDOW_TOL * scale)
                     if conv_dtype == "bfloat16" else atol)
        assert_logits(tl, rl, logit_tol)
        toks = [int(t) for t in np.argmax(np.asarray(rl), -1)]
    assert_cache(tcache, rcache, logit_tol)


def tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_shapes(v) for v in tree)
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


def check_layout(case, trees):
    """``init_params`` and ``init_cache`` lay out the reference's trees
    (leaf names, shapes, dtypes)."""
    rp, _ = trees
    rc, tc = cfgs(case)
    ours = lm.init_params(tc, seed=0, device="cpu")
    assert tree_shapes(ours) == jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), rp)
    want = ref_lm.init_cache(rc, 3, 20)
    got = lm.init_cache(tc, 3, 20, device="cpu")
    assert tree_shapes(got) == jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), want)


def check_dispatches(case, trees):
    """One decode step on ``arrayflex`` plans the same k at every site in
    both packages; the port dispatches each layer's sites once per layer
    of their kind (the reference traces its scanned sites once per
    sub-layer of the period)."""
    rc, rq, tc, tq = served(case, "arrayflex", trees)
    ref_sub.clear_plan_cache()
    substrate.clear_plan_cache()
    ref_lm.decode_step(rc, rq, ref_lm.init_cache(rc, 2, 16),
                       jnp.asarray([1, 2], jnp.int32),
                       jnp.asarray([0, 0], jnp.int32))
    lm.decode_step(tc, tq, lm.init_cache(tc, 2, 16, device="cpu"),
                   torch.tensor([1, 2]), torch.tensor([0, 0]))
    assert set(substrate.SITE_PLANS) == set(ref_sub.SITE_PLANS) >= \
        MAMBA_SITES
    for site, plan in substrate.SITE_PLANS.items():
        want = ref_sub.SITE_PLANS[site]
        assert (plan.M, plan.N, plan.T, plan.k) == \
            (want.M, want.N, want.T, want.k), site
    ns = lm.n_super(tc)
    for site, n in substrate.DISPATCH_COUNTS.items():
        per_trace = ref_sub.DISPATCH_COUNTS[site]
        assert n == per_trace * (1 if site == "unembed" else ns), site
    counts = dict(substrate.DISPATCH_COUNTS)
    ref_sub.clear_plan_cache()
    substrate.clear_plan_cache()
    return counts


@pytest.fixture(scope="module")
def mamba2():
    return {case: build(case) for case in ("mamba2", "mamba2-noffn")}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["mamba2", "mamba2-noffn"])
def test_forward_and_prefill_match_reference(mamba2, case, backend):
    check_forward(case, backend, mamba2[case])


@pytest.mark.parametrize("backend,conv_dtype", DECODE_CASES)
@pytest.mark.parametrize("case", ["mamba2", "mamba2-noffn"])
def test_decode_steps_match_reference(mamba2, case, backend, conv_dtype):
    check_decode(case, backend, mamba2[case], conv_dtype)


@pytest.mark.parametrize("case", ["mamba2", "mamba2-noffn"])
def test_layout_mirrors_reference(mamba2, case):
    check_layout(case, mamba2[case])
    blk = mamba2[case][1]["blocks"][0]
    if case == "mamba2-noffn":
        assert set(blk) == {"ln1", "mamba"}
    else:
        assert set(blk) == {"ln1", "mamba", "ln2", "mlp"}


@pytest.mark.parametrize("case", ["mamba2", "mamba2-noffn"])
def test_site_plans_and_dispatches_match_reference(mamba2, case):
    counts = check_dispatches(case, mamba2[case])
    L = cfgs(case)[1].n_layers
    assert {s: n for s, n in counts.items() if s in MAMBA_SITES} == \
        dict.fromkeys(MAMBA_SITES, L)
    assert ("mlp.wo" in counts) == (case == "mamba2")


@pytest.mark.parametrize("backend", ["arrayflex_int8", "arrayflex_w8a8"])
def test_quantized_tree_keeps_the_reference_exemptions(mamba2, backend):
    """``prequantize_params`` quantizes the four mamba ``w`` leaves, as
    the reference's does, and leaves ``conv_w`` (2-D, not a ``w``),
    ``conv_b``, ``dt_bias``, ``a_log``, ``D`` and ``norm`` alone; the
    codes and scales equal the reference's bit for bit."""
    rc, rq, tc, tq = served("mamba2-noffn", backend, mamba2["mamba2-noffn"])
    got, want = tq["blocks"][0]["mamba"], rq["blocks"][0]["mamba"]
    for name in ("z_proj", "xbc_proj", "dt_proj", "out_proj"):
        q = got[name]["w"]
        assert isinstance(q, substrate.QuantizedTensor), name
        assert np.array_equal(q.codes.numpy(), np.asarray(want[name]["w"]
                                                          .codes)), name
        assert np.array_equal(q.scale.numpy(), np.asarray(want[name]["w"]
                                                          .scale)), name
    for name in ("conv_w", "conv_b", "dt_bias", "a_log", "D"):
        assert isinstance(got[name], torch.Tensor), name
        assert got[name].dtype == torch.float32, name
    assert isinstance(got["norm"]["scale"], torch.Tensor)


def test_forward_raises_on_a_partial_chunk(mamba2):
    """S = 48 is not a multiple of the reduced chunk (32): both packages'
    ``lm.forward`` fail the scan's assertion; neither pads."""
    rc, rq, tc, tq = served("mamba2-noffn", "xla", mamba2["mamba2-noffn"])
    toks = np.ones((1, 48), np.int64)
    with pytest.raises(AssertionError):
        ref_lm.forward(rc, rq, {"tokens": jnp.asarray(toks)})
    with pytest.raises(AssertionError):
        lm.forward(tc, tq, {"tokens": torch.tensor(toks)})


def test_decode_step_advances_the_state_out_of_place(mamba2):
    """The input cache's recurrent leaves are not written; the returned
    cache holds new ones (what makes a retried step a clean one)."""
    _, _, tc, tq = served("mamba2-noffn", "arrayflex", mamba2["mamba2-noffn"])
    cache = lm.init_cache(tc, 2, 8, device="cpu")
    cache[0]["state"].normal_(generator=torch.Generator().manual_seed(1))
    before = [t.clone() for c in cache for t in c.values()]
    _, new = lm.decode_step(tc, tq, cache, torch.tensor([3, 4]),
                            torch.tensor([0, 1]))
    for t, b in zip((t for c in cache for t in c.values()), before):
        assert torch.equal(t, b)
    assert new is not cache
    assert not torch.equal(new[0]["state"], cache[0]["state"])
    assert new[0]["conv"].dtype == torch.bfloat16
