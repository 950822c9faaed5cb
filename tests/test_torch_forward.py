"""The port's full-sequence path vs the reference: ``lm.forward`` and
``lm.prefill`` on the reduced ``qwen2-0.5b`` and ``qwen3-moe-30b-a3b``,
through dense attention and through the chunked scan.

The reference parameter tree (``lm.init_params(cfg, PRNGKey(0))``) is
converted leaf by leaf (``convert.params_from_reference``); both packages
run the same numpy tokens in fp32.  The reference's Pallas kernels run in
interpret mode on the CPU; the port's wrappers run their plain versions.
Reduced configs set ``attn_dense_below = 4096``, so the chunked path is
reached by setting a small ``attn_dense_below`` and ``attn_kv_chunk`` in
both packages.  Tolerances:

* logits, fp32: 1e-4 absolute on xla, ref, arrayflex and arrayflex_int8
  (``tests/test_torch_model.py``'s fp32 contract: summation order and the
  last bits of exp/rsqrt/sin/cos through 2 layers); W8A8 0.12 absolute
  (dense) and 2.5 (MoE), the reference's W8A8 policy
  (``docs/substrate.md``; ``tests/test_w8a8_substrate.py``).
* MoE aux loss: 1e-6 absolute; routing (top-k expert ids per layer):
  equal.
* caches: bf16 in both packages, each value within one bf16 step
  (2^-7 relative at most) — fp32 K/V that agree to rounding can round to
  neighbouring bf16 values.
* teacher-forced ``decode_step`` (fp32 cache) against ``forward``, and
  ``prefill`` against ``prefill_step``: 1e-4 absolute, the same fp32
  contract within the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.kernels import substrate as ref_sub
from repro.models import lm as ref_lm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import substrate
from repro_torch.models import convert, lm
from repro_torch.nn import moe

DENSE, MOE = "qwen2-0.5b", "qwen3-moe-30b-a3b"
FP32_ATOL = 1e-4
W8A8_ATOL = {DENSE: 0.12, MOE: 2.5}
BF16_STEP = 2.0 ** -7
# attention path -> config fields that reach it in both packages
PATHS = {"dense": dict(attn_dense_below=4096),
         "chunked": dict(attn_dense_below=8, attn_kv_chunk=8)}
TOKENS = np.random.RandomState(0).randint(2, 512, (2, 20))


def _cfgs(arch, backend="xla", path="dense"):
    kw = dict(gemm_backend=backend, compute_dtype="float32", **PATHS[path])
    return (dataclasses.replace(ref_reduced(ARCHS[arch]), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


@pytest.fixture(scope="module")
def params():
    out = {}
    for arch in (DENSE, MOE):
        rc, tc = _cfgs(arch)
        rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
        out[arch] = rp, convert.params_from_reference(
            tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return out


def _trees(rc, tc, rp, tp):
    """The trees each package serves on this backend: int8 weights
    quantized once on the quantizing backends."""
    if not substrate.backend_quantizes(tc.gemm_backend):
        return rp, tp
    return (ref_lm.prequantize_params(rc, rp),
            lm.prequantize_params(tc, lm.prepare_params(tc, tp)))


def _forward_both(arch, backend, path, params, monkeypatch):
    """Both forwards with caches, the reference's top-k ids per layer
    (recorded from inside its trace) and each package's dispatch counts."""
    rc, tc = _cfgs(arch, backend, path)
    rp, tp = _trees(rc, tc, *params[arch])
    ref_topk = []
    real_top_k = jax.lax.top_k

    def top_k(x, k):
        vals, idx = real_top_k(x, k)
        jax.debug.callback(lambda i: ref_topk.append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx

    ref_sub.clear_plan_cache()
    substrate.clear_plan_cache()
    with monkeypatch.context() as mp:
        mp.setattr(jax.lax, "top_k", top_k)
        rl, ra, rcache = ref_lm.forward(rc, rp, {"tokens": jnp.asarray(
            TOKENS)}, return_cache=True)
        jax.effects_barrier()
    with moe.record_routing() as routing:
        tl, ta, tcache = lm.forward(tc, tp, {"tokens": torch.tensor(TOKENS)},
                                    return_cache=True)
    counts = dict(substrate.DISPATCH_COUNTS), dict(ref_sub.DISPATCH_COUNTS)
    ref_sub.clear_plan_cache()
    substrate.clear_plan_cache()
    return dict(rl=rl, ra=ra, rcache=rcache, tl=tl, ta=ta, tcache=tcache,
                ref_topk=ref_topk, topk=[idx for idx, _ in routing],
                counts=counts, tc=tc)


def _assert_caches(got, want, tc):
    B, S = TOKENS.shape
    layout = lm.init_cache(tc, B, S, device="cpu")
    assert len(got) == len(want) == len(layout)
    for g, w, lay in zip(got, want, layout):
        assert set(g) == set(w) == set(lay) == {"k", "v"}
        for name in ("k", "v"):
            assert g[name].shape == lay[name].shape == w[name].shape
            assert g[name].dtype == lay[name].dtype == torch.bfloat16
            want_np = np.asarray(w[name].astype(jnp.float32))
            np.testing.assert_allclose(g[name].float().numpy(), want_np,
                                       rtol=BF16_STEP, atol=0)


@pytest.mark.parametrize("path", ["dense", "chunked"])
@pytest.mark.parametrize("backend", ["xla", "ref", "arrayflex",
                                     "arrayflex_int8", "arrayflex_w8a8"])
@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_forward_matches_reference(arch, backend, path, params,
                                   monkeypatch):
    """Logits, aux loss, caches, routing and dispatch counts of one
    forward: the reference traces each scanned site once, the port
    dispatches it once per layer (the chunked path dispatches no
    attn.qk/attn.pv in either)."""
    r = _forward_both(arch, backend, path, params, monkeypatch)
    tc = r["tc"]
    want = np.asarray(r["rl"], np.float32)
    got = r["tl"].numpy()
    assert r["tl"].dtype == torch.float32 and got.shape == want.shape
    atol = (W8A8_ATOL[arch] if backend == "arrayflex_w8a8" else FP32_ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert r["ta"].dtype == torch.float32
    assert abs(float(r["ta"]) - float(r["ra"])) <= 1e-6
    if arch == DENSE:
        assert float(r["ta"]) == 0.0
        assert r["topk"] == r["ref_topk"] == []
    else:
        assert len(r["topk"]) == len(r["ref_topk"]) == tc.n_layers
        for got_idx, want_idx in zip(r["topk"], r["ref_topk"]):
            np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    _assert_caches(r["tcache"], r["rcache"], tc)
    counts, ref_counts = r["counts"]
    assert set(counts) == set(ref_counts)
    assert ("attn.qk" in counts) == (path == "dense")
    for site, n in counts.items():
        assert n == ref_counts[site] * (1 if site == "unembed"
                                        else tc.n_layers), site


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_prefill_is_forwards_last_row(arch, params):
    _, tc = _cfgs(arch, "arrayflex")
    tp = params[arch][1]
    toks = {"tokens": torch.tensor(TOKENS)}
    logits, aux, caches = lm.forward(tc, tp, toks)
    assert caches is None
    last, pcaches = lm.prefill(tc, tp, toks)
    torch.testing.assert_close(last, logits[:, -1], rtol=0, atol=0)
    _, _, fcaches = lm.forward(tc, tp, toks, return_cache=True)
    for a, b in zip(pcaches, fcaches):
        for name in ("k", "v"):
            assert torch.equal(a[name], b[name])


@pytest.mark.parametrize("path", ["dense", "chunked"])
@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_decode_matches_forward_logits(arch, path, params):
    """Teacher-forced decode reproduces the forward logits (the port's
    form of tests/test_models_smoke.py's check), in fp32 with an fp32
    cache.  MoE decode routes one global group of B tokens at capacity
    factor >= 2, forward one group per sequence: with B = 1 and ample
    capacity neither drops an assignment, so both compute the same."""
    _, tc = _cfgs(arch, "arrayflex", path)
    if arch == MOE:
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=8.0))
    tp = params[arch][1]
    toks = torch.tensor(TOKENS[:1, :12])
    S = toks.shape[1]
    full, _, fcaches = lm.forward(tc, tp, {"tokens": toks},
                                  return_cache=True)
    cache = lm.init_cache(tc, 1, S, dtype=torch.float32, device="cpu")
    steps = []
    for t in range(S):
        lg, cache = lm.decode_step(tc, tp, cache, toks[:, t],
                                   torch.tensor([t]))
        steps.append(lg)
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=0,
                               atol=FP32_ATOL)
    for a, b in zip(cache, fcaches):
        torch.testing.assert_close(a["k"].to(torch.bfloat16).float(),
                                   b["k"].float(), rtol=BF16_STEP, atol=0)


@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_prefill_matches_prefill_step(path, params):
    """``lm.prefill``'s last-token logits equal the serving engine's
    batched ``prefill_step`` on the same tokens (fp32 cache)."""
    _, tc = _cfgs(DENSE, "arrayflex", path)
    tp = params[DENSE][1]
    toks = torch.tensor(TOKENS)
    B, S = toks.shape
    last, _ = lm.prefill(tc, tp, {"tokens": toks})
    cache = lm.init_cache(tc, B, S, dtype=torch.float32, device="cpu")
    step, _ = lm.prefill_step(tc, tp, cache, toks,
                              torch.zeros(B, dtype=torch.int64),
                              torch.full((B,), S))
    torch.testing.assert_close(step, last, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_forward_never_calls_flash_attention(path, params, monkeypatch):
    """K3 stays off the model path, as in the reference: the chunked
    attention is a plain scan, and nothing reaches the flash wrapper's
    plain version (what a CPU call of the wrapper runs)."""
    _, tc = _cfgs(DENSE, "arrayflex", path)

    def refuse(*args, **kwargs):
        raise AssertionError("the model path reached flash attention")

    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    before = dict(fa.LAUNCHES)
    lm.forward(tc, params[DENSE][1], {"tokens": torch.tensor(TOKENS)})
    assert fa.LAUNCHES == before
