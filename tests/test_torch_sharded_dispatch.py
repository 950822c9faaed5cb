"""The sharded GEMM dispatch: each shard's GEMM its own launch at the
shard's shapes, over logical CPU meshes, against the unsharded dispatch
and the reference.

* ``substrate.gemm`` under the column-parallel, row-parallel and
  replicated-weight contexts ``parallel.sharding.gemm_shard_ctx`` derives,
  at tp2, tp4 and fsdp2_tp2, on fp32 and W8 (``arrayflex`` /
  ``arrayflex_int8``): equal to the port's unsharded dispatch (the
  reference's tolerance for its sharded-vs-unsharded dispatch, rtol 1e-5
  / atol 1e-4), with each epilogue piece of a row-parallel site in a case
  of its own (a bias or residual added per shard would count it once per
  shard), and one launch per distinct shard;
* ``batched_gemm`` (attention products) and ``expert_gemm`` (MoE banks,
  expert-parallel) under their contexts: equal to the unsharded dispatch
  bit for bit on every backend (per-element plans do not change);
* W8A8 under a mesh quantizes each shard's own x slice, so it is held to
  the reference's *sharded* W8A8 (one subprocess with eight host
  devices, a few ``substrate.gemm`` calls; it also serves the
  reference's pp = 2 chaos run to ``tests/test_torch_pipeline.py``'s
  question, see :func:`ref_multidev`);
* reduced qwen2 / qwen3-moe / mamba2 ``forward``, greedy streams and the
  serving engine under tp2, tp4 and fsdp2_tp2 against the reference's
  unsharded path, with its acceptance (rtol 1e-4 / atol 1e-3, identical
  streams).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.kernels import substrate as ref_sub
from repro.models import lm as ref_lm
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, substrate
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, lm
from repro_torch.parallel import sharding
from repro_torch.runtime.chaos import ChaosConfig
from repro_torch.serving import (DisaggServeConfig, DisaggServingEngine,
                                 ServeConfig, ServingEngine)
from repro_torch.serving.engine import Request


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"tp2": (1, 2), "tp4": (1, 4), "fsdp2_tp2": (2, 2)}
TOL = dict(rtol=1e-5, atol=1e-4)          # sharded vs unsharded dispatch
MODEL_TOL = dict(rtol=1e-4, atol=1e-3)    # the reference's acceptance


@pytest.fixture(autouse=True)
def _process_state():
    """Put back the site and dispatch logs and plan tallies both packages
    keep, and empty the port's plan memos (this file plans under new
    shard signatures)."""
    dicts = (substrate.DISPATCH_COUNTS, substrate.SITE_PLANS,
             ref_sub.DISPATCH_COUNTS, ref_sub.SITE_PLANS)
    tallies = (substrate.PLAN_CACHE_STATS, ref_sub.PLAN_CACHE_STATS)
    saved = [dict(d) for d in dicts]
    saved_tallies = [{k: dict(v) for k, v in t.items()} for t in tallies]
    yield
    substrate.clear_plan_cache()
    for d, v in zip(dicts + tallies, saved + saved_tallies):
        d.clear()
        d.update(v)


def _mesh(shape):
    with mesh_lib.host_devices(shape[0] * shape[1], "cpu"):
        return mesh_lib.make_host_mesh(*shape, strict=True)


class _Launches:
    """Counts the K1 / K2 wrapper calls made inside (each a kernel launch
    on the card; its plain version here)."""

    def __enter__(self):
        self.k1 = self.k2 = 0
        self._saved = ops.arrayflex_matmul, ops.arrayflex_expert_matmul
        mm, emm = self._saved

        def k1(*a, **kw):
            self.k1 += 1
            return mm(*a, **kw)

        def k2(*a, **kw):
            self.k2 += 1
            return emm(*a, **kw)

        ops.arrayflex_matmul, ops.arrayflex_expert_matmul = k1, k2
        return self

    def __exit__(self, *exc):
        ops.arrayflex_matmul, ops.arrayflex_expert_matmul = self._saved
        return False


# ----------------------------------------------------------- 2-D gemm
T, K, N = 8, 64, 48
# (site, epilogue kwargs): the column- and row-parallel kinds, the fused
# dual contraction, and each epilogue piece of a row-parallel site alone
CASES = {
    "col_plain": ("attn.wk", dict()),
    "col_all": ("attn.wq", dict(bias=1, epilogue="silu", residual=1,
                                norm_scale=1)),
    "col_swiglu": ("mlp.wi_gate+mlp.wi_up",
                   dict(w2=1, bias=1, bias2=1, epilogue="swiglu",
                        norm_scale=1)),
    "row_plain": ("attn.wo", dict()),
    "row_bias": ("attn.wo", dict(bias=1)),
    "row_silu": ("mlp.wo", dict(epilogue="silu")),
    "row_gelu": ("mamba.out", dict(epilogue="gelu")),
    "row_residual": ("mlp.wo", dict(residual=1)),
    "row_norm_scale": ("attn.wo", dict(norm_scale=1)),
    "row_swiglu": ("xattn.wo", dict(w2=1, bias=1, bias2=1,
                                    epilogue="swiglu")),
    "row_all": ("mlp.wo", dict(bias=1, epilogue="gelu", residual=1,
                               norm_scale=1)),
    "replicated": ("moe.router", dict(bias=1)),
}


def _operands(case, seed=0):
    """fp32 x (T, K), w (K, N) and the case's epilogue operands: biases,
    residual and norm scale of order one, so a piece counted per shard
    moves the output by order one."""
    g = torch.Generator().manual_seed(seed)
    site, kw = CASES[case]
    x = torch.randn(T, K, generator=g)
    w = torch.randn(K, N, generator=g) / K ** 0.5
    out = dict(epilogue=kw.get("epilogue", "none"))
    if kw.get("w2"):
        out["w2"] = torch.randn(K, N, generator=g) / K ** 0.5
    for name, shape in (("bias", (N,)), ("bias2", (N,)),
                        ("residual", (T, N))):
        if kw.get(name):
            out[name] = torch.randn(*shape, generator=g)
    if kw.get("norm_scale"):
        out["norm_scale"] = 0.5 + torch.rand(K, generator=g)
    return site, x, w, out


def _shards(ctx) -> int:
    mesh = ctx.mesh
    return len(substrate._shard_coords(mesh, ctx.x_spec, ctx.w_spec,
                                       ctx.out_spec))


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8"])
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_gemm_matches_unsharded(case, mesh, backend):
    """Equal to the unsharded dispatch; planned on the shard's shape (the
    reference's signature); one launch per distinct shard, two on a
    sharded contraction with a second one (each reduced apart).  A
    replicated-weight site shards only its rows over "data": on a
    TP-only mesh it has no context."""
    m = _mesh(MESHES[mesh])
    site, x, w, kw = _operands(case)
    ctx = sharding.gemm_shard_ctx(site, T, K, N, mesh=m)
    if case == "replicated" and m.shape["data"] == 1:
        assert ctx is None
        return
    assert ctx is not None and ctx.divides(T, K, N)
    want = substrate.gemm(x, w, site=site, backend=backend, **kw)
    with _Launches() as n:
        got = substrate.gemm(x, w, site=site, backend=backend, shard=ctx,
                             **kw)
    torch.testing.assert_close(got, want, **TOL)
    dual = 2 if ctx.reduce_axes and "w2" in kw else 1
    assert n.k1 == _shards(ctx) * dual
    plan = substrate.SITE_PLANS[site.split("+")[0]]
    assert plan.shard == ctx.signature()
    assert (plan.M_shard, plan.N_shard, plan.T_shard) == (
        N // plan.shard.cols, K // plan.shard.contraction,
        T // plan.shard.rows)
    assert substrate.DISPATCH_COUNTS[site] >= 1


def test_row_parallel_pieces_would_show_if_added_per_shard():
    """The cases above would catch a per-shard bias or residual: adding it
    tp times moves the output far outside the tolerance."""
    site, x, w, kw = _operands("row_all")
    want = substrate.gemm(x, w, site=site, backend="arrayflex", **kw)
    wrong = want + kw["residual"]         # a second residual join
    assert not torch.allclose(wrong, want, **TOL)


def test_quantized_weight_shards_and_memo():
    """A pre-quantized (codes, scales) weight shards its codes with the
    weight and its scales with the output columns; a column block is
    copied once and reused (keyed on the weight's storage: a fresh view
    of the same layer hits)."""
    m = _mesh((1, 2))
    site, x, w, kw = _operands("col_all")
    stacked = substrate.prequantize(torch.stack([w, 2 * w]))
    ctx = sharding.gemm_shard_ctx(site, T, K, N, mesh=m)
    substrate.clear_shard_cache()
    for step in range(3):
        got = substrate.gemm(x, stacked[1], site=site,
                             backend="arrayflex_int8", shard=ctx, **kw)
        want = substrate.gemm(x, stacked[1], site=site,
                              backend="arrayflex_int8", **kw)
        torch.testing.assert_close(got, want, **TOL)
    info = substrate.shard_cache_info()
    assert info["misses"] == 2 and info["hits"] == 4
    assert info["bytes"] == K * N        # two int8 column halves
    substrate.clear_shard_cache()


# ------------------------------------------------- batched and expert
@pytest.mark.parametrize("backend", ["xla", "arrayflex", "arrayflex_int8",
                                     "arrayflex_w8a8"])
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_batched_and_expert_gemm_shard_exactly(mesh, backend):
    """attn.qk / attn.pv over B*KV and the expert banks over E: each
    shard one launch over its slice, the result the unsharded one's bits
    (per-element plans and per-element quantization are unchanged)."""
    m = _mesh(MESHES[mesh])
    g = torch.Generator().manual_seed(1)
    for site, bkv in (("attn.qk", 8), ("attn.pv", 4)):
        q = torch.randn(bkv, 6, 16, generator=g)
        k = torch.randn(bkv, 16, 5, generator=g)
        ctx = sharding.batched_shard_ctx(bkv, mesh=m)
        want = substrate.batched_gemm(q, k, site=site, backend=backend,
                                      out_dtype=torch.float32)
        with _Launches() as n:
            got = substrate.batched_gemm(q, k, site=site, backend=backend,
                                         out_dtype=torch.float32,
                                         shard=ctx)
        assert torch.equal(got, want), site
        if backend != "xla":
            assert n.k2 == _shards(ctx)
    x = torch.randn(2, 4, 3, 16, generator=g)
    w = torch.randn(4, 16, 8, generator=g)
    ctx = sharding.expert_shard_ctx(4, mesh=m)
    want = substrate.expert_gemm(x, w, site="moe.wi_gate", backend=backend)
    with _Launches() as n:
        got = substrate.expert_gemm(x, w, site="moe.wi_gate",
                                    backend=backend, shard=ctx)
    assert torch.equal(got, want)
    if backend != "xla":
        assert n.k2 == _shards(ctx) == MESHES[mesh][1]
    # an indivisible expert count dispatches replicated
    assert sharding.expert_shard_ctx(3, mesh=m) is None


# ------------------------------------- W8A8: the reference's sharded run
W8A8_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.kernels import substrate
from repro.launch.mesh import make_host_mesh
from repro.parallel import sharding
spec = json.loads(sys.argv[1])
out = {"gemm": {}}
rng = np.random.RandomState(0)
T, K, N = spec["tkn"]
x = rng.randn(T, K).astype(np.float32)
w = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)
b = rng.randn(N).astype(np.float32)
r = rng.randn(T, N).astype(np.float32)
g = (0.5 + rng.rand(K)).astype(np.float32)
for name, (d, m) in spec["meshes"].items():
    mesh = make_host_mesh(d, m, strict=True)
    for site in spec["sites"]:
        ctx = sharding.gemm_shard_ctx(site, T, K, N, mesh=mesh)
        y = substrate.gemm(jnp.asarray(x), jnp.asarray(w), site=site,
                           backend="arrayflex_w8a8", bias=jnp.asarray(b),
                           epilogue="silu", residual=jnp.asarray(r),
                           norm_scale=jnp.asarray(g), shard=ctx)
        out["gemm"][name + "/" + site] = [
            np.asarray(y).tolist(), substrate.SITE_PLANS[site].k]
from repro.configs import ARCHS, reduced
from repro.models import lm
from repro.runtime.chaos import ChaosConfig
from repro.serving import DisaggServeConfig, DisaggServingEngine
from repro.serving.engine import Request
cfg = dataclasses.replace(reduced(ARCHS["llama3-8b"]),
                          compute_dtype="float32", gemm_backend="xla")
params = lm.init_params(cfg, jax.random.PRNGKey(0))
sc = DisaggServeConfig(max_batch=4, max_seq=64, seed=0, prefill_pods=2,
                       decode_pods=2, pp_stages=2,
                       chaos=ChaosConfig(**spec["chaos"]))
eng = DisaggServingEngine(cfg, params, sc)
reqs = [Request(prompt=p, max_new_tokens=n, rid=i)
        for p, n, i in spec["reqs"]]
for q in reqs:
    eng.submit(q)
eng.run_to_completion()
ch = eng._chaos
out["pp2"] = dict(tokens=[q.out_tokens for q in reqs],
                  outcomes=[q.outcome for q in reqs],
                  errors=[q.error.split(":")[0] for q in reqs],
                  log=[list(e) for e in ch.chaos_log],
                  draws=dict(ch.chaos_draws),
                  stats={k: eng.stats[k] for k in spec["stats"]})
json.dump(out, sys.stdout)
"""
W8A8_TKN = (8, 256, 384)
W8A8_SITES = ("attn.wo", "attn.wq")
# the pp = 2 chaos run: GEMM faults (retried), dropped K/V handoffs and
# non-finite logits on reduced llama3-8b, xla
PP_CHAOS = dict(seed=5, gemm_fault=0.1, kv_transfer=0.3, nan_logits=0.2)
PP_REQS = [([5, 7, 11], 3, 1), ([2, 3], 3, 2), ([31], 2, 3)]
PP_STATS = ("prefill_dispatches", "decode_dispatches", "kv_transfer_bytes",
            "transfer_retries", "kernel_fault_retries", "sample_retries",
            "outcome_ok", "outcome_failed")
_REF_MULTIDEV = {}


def ref_multidev():
    """The reference's runs that need several devices, from ONE
    subprocess with eight host devices: its sharded W8A8 ``gemm`` at
    :data:`W8A8_SITES` under each mesh (output and planned k), and its
    disaggregated engine at pp = 2 under :data:`PP_CHAOS` (streams,
    outcomes, chaos log and draws, stats).  Cached for the process."""
    if not _REF_MULTIDEV:
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
            env.get("PYTHONPATH", "")
        spec = dict(tkn=W8A8_TKN, meshes=MESHES, sites=W8A8_SITES,
                    chaos=PP_CHAOS, reqs=PP_REQS, stats=PP_STATS)
        out = subprocess.run([sys.executable, "-c", W8A8_SCRIPT,
                              json.dumps(spec)], capture_output=True,
                             text=True, timeout=240, env=env, cwd=REPO)
        assert out.returncode == 0, out.stderr[-3000:]
        _REF_MULTIDEV.update(json.loads(out.stdout))
    return _REF_MULTIDEV


@pytest.mark.parametrize("site", W8A8_SITES)
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_sharded_w8a8_matches_reference_sharded(mesh, site):
    """W8A8 at a row-parallel (each shard quantizes its own x slice's
    tiles) and a column-parallel site, every epilogue piece on: the
    reference's sharded output (1e-5 of its largest magnitude, the W8A8
    kernel tolerance of ``tests/test_torch_quant.py``) at its k."""
    want, want_k = ref_multidev()["gemm"][f"{mesh}/{site}"]
    rng = np.random.RandomState(0)
    t, k, n = W8A8_TKN
    x = torch.from_numpy(rng.randn(t, k).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype(np.float32))
    b = torch.from_numpy(rng.randn(n).astype(np.float32))
    r = torch.from_numpy(rng.randn(t, n).astype(np.float32))
    g = torch.from_numpy((0.5 + rng.rand(k)).astype(np.float32))
    ctx = sharding.gemm_shard_ctx(site, t, k, n, mesh=_mesh(MESHES[mesh]))
    got = substrate.gemm(x, w, site=site, backend="arrayflex_w8a8", bias=b,
                         epilogue="silu", residual=r, norm_scale=g,
                         shard=ctx)
    want = torch.tensor(want)
    assert substrate.SITE_PLANS[site].k == want_k
    assert (got - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


# ----------------------------------------------------- model level
_MODELS = {}


def _models(arch):
    """(reference cfg, params, port cfg, params): fp32 everywhere (the
    reference's multi-device suite's rule: cross-mesh differences are
    accumulation order only), the port's tree converted leaf by leaf."""
    if arch not in _MODELS:
        rc = ref_reduced(ARCHS[arch], compute_dtype="float32",
                         param_dtype="float32")
        tc = reduced(get_config(arch), compute_dtype="float32",
                     param_dtype="float32")
        rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
        tp = convert.params_from_reference(
            tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
        _MODELS[arch] = (rc, rp, tc, tp)
    return _MODELS[arch]


TOKS = np.random.RandomState(0).randint(2, 512, (2, 16))
_REF_LOGITS = {}


def _ref_forward(arch):
    if arch not in _REF_LOGITS:
        rc, rp, _, _ = _models(arch)
        logits, _, _ = ref_lm.forward(rc, rp, {"tokens": jnp.asarray(TOKS)})
        _REF_LOGITS[arch] = np.asarray(logits)
    return _REF_LOGITS[arch]


@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-30b-a3b",
                                  "mamba2-370m"])
def test_forward_under_mesh_matches_reference_unsharded(arch, mesh,
                                                        backend):
    """Acceptance: sharded logits match the reference's unsharded path
    for every family x mesh x backend cell."""
    _, _, tc, tp = _models(arch)
    cfg = dataclasses.replace(tc, gemm_backend=backend,
                              mesh_shape=MESHES[mesh])
    with mesh_lib.host_devices(4, "cpu"):
        got, _, _ = lm.forward(cfg, tp, {"tokens": torch.as_tensor(TOKS)})
    np.testing.assert_allclose(got.numpy(), _ref_forward(arch),
                               **MODEL_TOL)
    first = "mamba.z" if arch == "mamba2-370m" else "attn.wq"
    assert substrate.SITE_PLANS[first].shard.cols == MESHES[mesh][1]


_REF_STREAMS = {}


def _greedy(step_cfg, params, pkg, steps=5):
    """prefill_step of 8 tokens, then ``steps`` greedy decode steps (the
    reference's memoized per backend)."""
    if pkg == "ref":
        if step_cfg.gemm_backend not in _REF_STREAMS:
            _REF_STREAMS[step_cfg.gemm_backend] = _ref_greedy(
                step_cfg, params, steps)
        return _REF_STREAMS[step_cfg.gemm_backend]
    cache = lm.init_cache(step_cfg, 2, 16, device="cpu")
    logits, cache = lm.prefill_step(
        step_cfg, params, cache, torch.as_tensor(TOKS[:, :8]),
        torch.zeros(2, dtype=torch.int64), torch.full((2,), 8))
    out, tok = [], torch.argmax(logits, -1)
    for i in range(steps):
        out.append(tok.tolist())
        logits, cache = lm.decode_step(step_cfg, params, cache, tok,
                                       torch.tensor(8 + i))
        tok = torch.argmax(logits, -1)
    return out


def _ref_greedy(step_cfg, params, steps):
    cache = ref_lm.init_cache(step_cfg, 2, 16)
    logits, cache = ref_lm.prefill_step(
        step_cfg, params, cache, jnp.asarray(TOKS[:, :8]),
        jnp.zeros(2, jnp.int32), jnp.full(2, 8, jnp.int32))
    out, tok = [], jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(steps):
        out.append(np.asarray(tok).tolist())
        logits, cache = ref_lm.decode_step(step_cfg, params, cache, tok,
                                           jnp.int32(8 + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return out


@pytest.mark.parametrize("backend", ["xla", "arrayflex", "arrayflex_int8"])
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_greedy_stream_under_mesh_is_reference_unsharded(mesh, backend):
    """Prefill + decode greedy streams equal the reference's unsharded
    streams (W8: the reference's unsharded W8 streams)."""
    rc, rp, tc, tp = _models("qwen2-0.5b")
    rbe = "xla" if backend != "arrayflex_int8" else backend
    want = _greedy(dataclasses.replace(rc, gemm_backend=rbe), rp, "ref")
    cfg = dataclasses.replace(tc, gemm_backend=backend,
                              mesh_shape=MESHES[mesh])
    params = lm.prequantize_params(cfg, tp)
    with mesh_lib.host_devices(4, "cpu"):
        assert _greedy(cfg, params, "port") == want


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m"])
def test_moe_mamba_decode_step_tp2(arch):
    """One decode step at tp 2 (experts split over "model"; the SSM's
    projections column-parallel, its out_proj row-parallel) against the
    reference's unsharded step."""
    rc, rp, tc, tp = _models(arch)
    tok = np.asarray([3, 5])
    want, _ = ref_lm.decode_step(rc, rp, ref_lm.init_cache(rc, 2, 8),
                                 jnp.asarray(tok, jnp.int32), jnp.int32(0))
    cfg = dataclasses.replace(tc, gemm_backend="arrayflex",
                              mesh_shape=(1, 2))
    with mesh_lib.host_devices(2, "cpu"), _Launches() as n:
        got, _ = lm.decode_step(cfg, tp, lm.init_cache(cfg, 2, 8,
                                                        device="cpu"),
                                torch.as_tensor(tok), torch.tensor(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    if arch == "mamba2-370m":
        for site in ("mamba.z", "mamba.xbc", "mamba.dt"):
            assert substrate.SITE_PLANS[site].shard.cols == 2
        assert substrate.SITE_PLANS["mamba.out"].shard.contraction == 2
        assert n.k2 == 0
    else:
        # two shards a bank and a product (B*KV = 4 splits over tp 2)
        assert n.k2 == 2 * (3 + 2) * tc.n_layers


def test_engine_streams_under_mesh_match_reference():
    """The serving engine under (2, 2) and (1, 4) meshes serves the
    reference's unsharded engine's streams; too few devices raise at
    construction."""
    rc, rp, tc, tp = _models("qwen2-0.5b")
    prompts = [[5, 6, 7], [11, 12, 13, 14], [21, 22]]

    def run(eng, req):
        reqs = [req(prompt=p, max_new_tokens=4, rid=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        return [list(r.out_tokens) for r in reqs]

    want = run(RefEngine(rc, rp, RefServeConfig(max_batch=2, max_seq=32)),
               RefRequest)
    for mesh, backend in (((2, 2), "xla"), ((1, 4), "arrayflex")):
        cfg = dataclasses.replace(tc, gemm_backend=backend, mesh_shape=mesh)
        with pytest.raises(ValueError, match="--host-devices"):
            ServingEngine(cfg, tp, ServeConfig(max_batch=2, max_seq=32),
                          device="cpu")
        with mesh_lib.host_devices(4, "cpu"):
            eng = ServingEngine(cfg, tp, ServeConfig(max_batch=2,
                                                     max_seq=32),
                                device="cpu")
            assert eng.mesh.shape == dict(zip(("data", "model"), mesh))
            assert run(eng, Request) == want


def test_pp2_chaos_draws_match_reference_pp2():
    """The disaggregated engine at pp = 2 under seeded chaos (GEMM faults
    retried, dropped handoffs, non-finite logits) against the reference's
    own pp = 2 run: its streams, outcomes, error types, stats, and chaos
    log and draw counts entry for entry (the reference traces each role's
    pipelined step once, so a site draws once a step attempt; the port's
    stages run in turn and each label still draws once a sub-layer
    position)."""
    want = ref_multidev()["pp2"]
    rc = dataclasses.replace(ref_reduced(ARCHS["llama3-8b"]),
                             compute_dtype="float32")
    tc = dataclasses.replace(reduced(get_config("llama3-8b")),
                             compute_dtype="float32", gemm_backend="xla")
    tp = convert.params_from_reference(tc, jax.tree_util.tree_map(
        np.asarray, ref_lm.init_params(rc, jax.random.PRNGKey(0))),
        device="cpu")
    with mesh_lib.host_devices(4, "cpu"):
        eng = DisaggServingEngine(tc, tp, DisaggServeConfig(
            max_batch=4, max_seq=64, seed=0, prefill_pods=2, decode_pods=2,
            pp_stages=2, chaos=ChaosConfig(**PP_CHAOS)), device="cpu")
        reqs = [Request(prompt=p, max_new_tokens=n, rid=i)
                for p, n, i in PP_REQS]
        for q in reqs:
            eng.submit(q)
        eng.run_to_completion()
    ch = eng._chaos
    got = dict(tokens=[q.out_tokens for q in reqs],
               outcomes=[q.outcome for q in reqs],
               errors=[q.error.split(":")[0] for q in reqs],
               log=[list(e) for e in ch.chaos_log],
               draws=dict(ch.chaos_draws),
               stats={k: eng.stats[k] for k in PP_STATS})
    assert got == want
    assert any(e[0] == "substrate.dispatch" for e in got["log"])
