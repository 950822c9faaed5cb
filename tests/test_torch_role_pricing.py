"""Role-priced plans: the port's ``ShardSig`` / pricing-only ``ShardCtx``
and the pipeline-pricing scope against the reference's.

``substrate.plan_gemm(..., shard=ShardSig(...))`` must give the
reference's ``GemmPlan`` (depth, cycles, Eq.(6') predictions, per-shard
dims) over a grid of full-width qwen2-0.5b site shapes, row counts,
backends and signatures; the pinned per-role k table of
``tests/test_disagg.py`` must hold; the ``use_pp_pricing`` scope must
hand only the boundary site a pricing-only context; and ``lm.decode_step``
under a two-stage pipeline role (``pp_stages=2``, no mesh) must plan
``attn.wq`` at the reference's k — shallower than colocated for the decode
role, deeper for the prefill role, at the row counts where the role moves
it — with logits equal to the colocated step's (plans move k, never
values).  Plans are integers and exact; the predictions are
compared with ``pytest.approx``, as in ``tests/test_torch_kernels.py``.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.kernels import substrate as ref_sub
from repro.models import lm as ref_lm
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import arrayflex_gemm as ag
from repro_torch.kernels import ops, substrate
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, lm
from repro_torch.parallel import sharding


@pytest.fixture(autouse=True)
def _process_state():
    """Put back every process-wide log and counter a test touches (both
    packages' site and dispatch logs and plan tallies, the launch
    counters) and empty the port's plan memos, whose entries this file
    adds under new shard signatures."""
    dicts = (substrate.DISPATCH_COUNTS, substrate.SITE_PLANS,
             ref_sub.DISPATCH_COUNTS, ref_sub.SITE_PLANS, ag.LAUNCHES,
             fa.LAUNCHES)
    tallies = (substrate.PLAN_CACHE_STATS, ref_sub.PLAN_CACHE_STATS)
    saved = [dict(d) for d in dicts]
    saved_tallies = [{k: dict(v) for k, v in t.items()} for t in tallies]
    yield
    substrate.clear_plan_cache()
    for d, v in zip(dicts + tallies, saved + saved_tallies):
        d.clear()
        d.update(v)


# full-width qwen2-0.5b sites: (M = N_out, N = K, epilogue fields)
SITES = {
    "attn.wq": (896, 896, dict(bias=True, norm_scale=True)),
    "attn.wk": (128, 896, dict(bias=True, norm_scale=True)),
    "attn.wo": (896, 896, dict(residual=True)),
    "mlp.wi_gate+mlp.wi_up": (4864, 896, dict(kind="swiglu",
                                              norm_scale=True)),
    "mlp.wo": (896, 4864, dict(residual=True)),
    "unembed": (152064, 896, dict()),
}
ROWS = (4, 128, 2048)
BACKENDS = ("arrayflex", "arrayflex_int8", "arrayflex_w8a8", "xla")
# (rows, contraction, cols, reduce_ops, transfer_ops, transfer_cycles)
SIGS = [(1, 1, 1, 0, 0, 0), (2, 1, 1, 0, 0, 0), (1, 4, 1, 2, 0, 0),
        (1, 1, 8, 0, 0, 0), (2, 2, 2, 1, 0, 0), (1, 1, 1, 0, 1, 0),
        (1, 1, 1, 0, 3, 0), (1, 1, 1, 0, 0, 28), (1, 1, 1, 0, 0, 14336),
        (4, 2, 1, 1, 1, 112)]
PLAN_FIELDS = ("M", "N", "T", "backend", "k", "cycles", "precision",
               "M_shard", "N_shard", "T_shard")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("sig", SIGS, ids=lambda s: "-".join(map(str, s)))
def test_shard_plan_matches_reference(backend, sig):
    for site, (M, N, ep) in SITES.items():
        for T in ROWS:
            got = substrate.plan_gemm(M, N, T, backend,
                                      substrate.Epilogue(**ep),
                                      substrate.ShardSig(*sig))
            want = ref_sub.plan_gemm(M, N, T, backend, ref_sub.Epilogue(**ep),
                                     ref_sub.ShardSig(*sig))
            what = (site, T)
            assert [getattr(got, f) for f in PLAN_FIELDS] == \
                [getattr(want, f) for f in PLAN_FIELDS], what
            assert dataclasses.astuple(got.shard) == \
                dataclasses.astuple(want.shard), what
            assert got.t_pred_ps == pytest.approx(want.t_pred_ps), what
            assert got.t_conventional_ps == \
                pytest.approx(want.t_conventional_ps), what


def test_unsharded_plans_are_unchanged():
    """``shard=SHARD_NONE`` is the default key: the same plan object, with
    per-shard dims equal to the logical ones."""
    ep = substrate.Epilogue(bias=True, norm_scale=True)
    for T in ROWS:
        plain = substrate.plan_gemm(896, 896, T, "arrayflex", ep)
        assert substrate.plan_gemm(896, 896, T, "arrayflex", ep,
                                   substrate.SHARD_NONE) is plain
        assert (plain.M_shard, plain.N_shard, plain.T_shard) == (896, 896, T)
        assert plain.k == ops.plan_collapse(896, 896, T, epilogue_ops=2)


def test_plan_collapse_transfer_cycles_matches_reference():
    for T in ROWS:
        for cyc in (0, 28, 896, 14336):
            assert ops.plan_collapse(896, 896, T, epilogue_ops=1,
                                     transfer_cycles=cyc) == \
                ref_sub.ops.plan_collapse(896, 896, T, epilogue_ops=1,
                                          transfer_cycles=cyc)


def test_role_pricing_k_shift():
    """The reference's pinned table (``tests/test_disagg.py``): at the
    896 x 896 boundary site with one epilogue op and pp = 2, prefill's
    boundary op keeps or deepens best_k, decode's serialized ingress
    shallows it."""
    ep = substrate.Epilogue(kind="none", bias=True)
    assert ep.ops == 1

    def k(role, T):
        t_ops, t_cyc = sharding.pp_transfer_terms(role, 2, T, 896)
        sig = substrate.ShardSig(transfer_ops=t_ops, transfer_cycles=t_cyc)
        return substrate.plan_gemm(896, 896, T, backend="arrayflex",
                                   epilogue=ep, shard=sig).k

    assert (k("", 128), k("prefill", 128), k("decode", 128)) == (4, 4, 2)
    assert (k("", 2048), k("prefill", 2048), k("decode", 2048)) == (2, 2, 1)
    for T in (128, 2048):
        assert k("prefill", T) > k("decode", T)


def test_pricing_scope_targets_boundary_site():
    """Inside use_pp_pricing only PP_BOUNDARY_SITE gets the pricing-only
    ShardCtx, with the reference's terms; the scope is inert without a
    role or at pp <= 1, and gone once it exits."""
    for role, pp, rows in (("prefill", 2, 8), ("decode", 2, 4),
                           ("decode", 4, 128), ("prefill", 8, 2048)):
        with sharding.use_pp_pricing(role, pp), \
                ref_sharding.use_pp_pricing(role, pp):
            assert sharding.active_pp_pricing() == (role, pp)
            ctx = sharding.gemm_shard_ctx(sharding.PP_BOUNDARY_SITE,
                                          rows, 896, 896)
            ref = ref_sharding.gemm_shard_ctx(ref_sharding.PP_BOUNDARY_SITE,
                                              rows, 896, 896)
            assert ctx is not None and ctx.mesh is None
            assert (ctx.transfer_ops, ctx.transfer_cycles) == \
                (ref.transfer_ops, ref.transfer_cycles)
            assert dataclasses.astuple(ctx.signature()) == \
                dataclasses.astuple(ref.signature())
            assert ctx.divides(rows, 896, 896)
            assert sharding.gemm_shard_ctx("mlp.wo", rows, 896, 896) is None
            assert sharding.gemm_shard_ctx("unembed", rows, 896,
                                           152064) is None
    with sharding.use_pp_pricing("prefill", 2):
        ctx = sharding.gemm_shard_ctx(sharding.PP_BOUNDARY_SITE, 8, 896, 896)
        assert (ctx.transfer_ops, ctx.transfer_cycles) == (1, 0)
    with sharding.use_pp_pricing("decode", 2):
        ctx = sharding.gemm_shard_ctx(sharding.PP_BOUNDARY_SITE, 4, 896, 896)
        assert ctx.transfer_cycles > 0 and ctx.transfer_ops == 0
    for role, pp in (("", 2), ("decode", 1), ("prefill", 0)):
        with sharding.use_pp_pricing(role, pp):
            assert sharding.active_pp_pricing() is None
            assert sharding.gemm_shard_ctx(sharding.PP_BOUNDARY_SITE, 8,
                                           896, 896) is None
    assert sharding.active_pp_pricing() is None


def test_mesh_scope_refuses_a_sharding_mesh():
    """A mesh that needs more devices than exist raises the reference's
    ValueError (strict meshes, never clamped); fanned out, the scope
    activates the mesh ``mesh_shape`` declares.  A (pod, 1, 1) role mesh,
    ``gemm_sharding="none"`` and no mesh keep the pricing scope; an
    unknown shape or mode is the reference's ValueError, and
    ``gemm_shard_ctx`` with a mesh gives the reference's context."""
    cfg = reduced(get_config("qwen2-0.5b"))
    rcfg = ref_reduced(ARCHS["qwen2-0.5b"])
    for shape in ((2, 2), (1, 1), (1, 4), (2, 2, 1), (2, 1, 2)):
        n = int(np.prod(shape))
        if n > len(jax.devices()):
            with pytest.raises(ValueError, match="devices") as want:
                ref_sharding.mesh_from_config(
                    dataclasses.replace(rcfg, mesh_shape=shape))
            with pytest.raises(ValueError, match="devices") as got:
                with sharding.gemm_mesh_scope(
                        dataclasses.replace(cfg, mesh_shape=shape)):
                    pass
            assert str(got.value).split(";")[0] == \
                str(want.value).split(";")[0]
        with mesh_lib.host_devices(n, "cpu"):
            with sharding.gemm_mesh_scope(
                    dataclasses.replace(cfg, mesh_shape=shape)):
                mesh = sharding.active_gemm_mesh()
                assert tuple(mesh.shape.values()) == shape
                assert mesh.axis_names == (("data", "model") if len(shape)
                                           == 2 else ("pod", "data",
                                                      "model"))
    for bad, match in ((dict(mesh_shape=(2,)), "mesh_shape must be"),
                       (dict(gemm_sharding="tp"), "gemm_sharding")):
        for mod, c in ((sharding, cfg), (ref_sharding, rcfg)):
            with pytest.raises(ValueError, match=match):
                mod.mesh_from_config(dataclasses.replace(
                    c, mesh_shape=bad.get("mesh_shape", (2, 2)),
                    gemm_sharding=bad.get("gemm_sharding", "auto")))
    with mesh_lib.host_devices(2, "cpu"):
        for kw in (dict(mesh_shape=(2, 1, 1), pp_role="decode",
                        pp_stages=2),
                   dict(mesh_shape=(2, 2), gemm_sharding="none"), dict()):
            with sharding.gemm_mesh_scope(dataclasses.replace(cfg, **kw)):
                want = ("decode", 2) if kw.get("pp_role") else None
                assert sharding.active_pp_pricing() == want
                assert (sharding.active_gemm_mesh() is None) == \
                    (kw.get("mesh_shape") in (None, (2, 2)))
    stub = SimpleNamespace(shape={"data": 2, "model": 4},
                           axis_names=("data", "model"))
    got = sharding.gemm_shard_ctx("attn.wo", 4, 896, 896, mesh=stub)
    want = ref_sharding.gemm_shard_ctx("attn.wo", 4, 896, 896, mesh=stub)
    assert (got.x_spec, got.w_spec, got.out_spec, got.reduce_axes) == \
        (tuple(want.x_spec), tuple(want.w_spec), tuple(want.out_spec),
         tuple(want.reduce_axes))
    assert got.signature() == substrate.ShardSig(**dataclasses.asdict(
        want.signature()))


def test_dispatch_refuses_a_mesh_context():
    """A ShardCtx with a mesh runs each shard's GEMM at every dispatch
    entry and equals the unsharded dispatch; a pricing-only one plans
    under its signature and runs unsharded."""
    x, w = torch.randn(4, 16), torch.randn(16, 8)
    with mesh_lib.host_devices(2, "cpu"):
        mesh = mesh_lib.make_host_mesh(1, 2, strict=True)
    rows = substrate.ShardCtx(mesh, ("model", None), (None, None),
                              ("model", None))
    torch.testing.assert_close(
        substrate.gemm(x, w, site="attn.wo", backend="arrayflex",
                       shard=rows),
        substrate.gemm(x, w, site="attn.wo", backend="arrayflex"))
    s3 = ("model", None, None)
    torch.testing.assert_close(
        substrate.batched_gemm(torch.stack([x, x]), torch.stack([w, w]),
                               site="attn.qk", backend="arrayflex",
                               shard=substrate.ShardCtx(mesh, s3, s3, s3)),
        torch.stack([x @ w, x @ w]))
    ec = substrate.ShardCtx(mesh, (None, "model", None, None),
                            ("model", None, None), (None, "model", None, None))
    xe, we = torch.randn(1, 2, 4, 16), torch.randn(2, 16, 8)
    torch.testing.assert_close(
        substrate.expert_gemm(xe, we, site="moe.wo", backend="arrayflex",
                              shard=ec),
        substrate.expert_gemm(xe, we, site="moe.wo", backend="arrayflex"))
    ctx = sharding.pricing_shard_ctx(transfer_cycles=28)
    out = substrate.gemm(x, w, site="attn.wq", backend="arrayflex",
                         shard=ctx)
    torch.testing.assert_close(out, substrate.gemm(x, w, backend="ref"))
    assert substrate.SITE_PLANS["attn.wq"].shard == \
        substrate.ShardSig(transfer_cycles=28)
    torch.testing.assert_close(
        substrate.batched_gemm(x[None], w[None], site="attn.qk",
                               backend="arrayflex", shard=ctx)[0], x @ w)
    # an empty GEMM drops the context, as the reference's does
    substrate.gemm(x[:0], w, site="attn.wq", backend="arrayflex", shard=ctx)
    assert substrate.SITE_PLANS["attn.wq"].shard == substrate.SHARD_NONE


# lm.decode_step under a pipeline role, no mesh: reduced qwen2-0.5b, fp32,
# at row counts where the role moves attn.wq's k: on arrayflex at 128 rows
# the decode role plans k = 2 against the colocated 4; on arrayflex_int8
# at 1024 rows the prefill role plans 4 against 2
ROLE_CASES = [("arrayflex", "decode", 128), ("arrayflex_int8", "prefill",
                                              1024)]


@pytest.mark.parametrize("backend,role_name,rows", ROLE_CASES)
def test_decode_step_plans_boundary_site_under_role(backend, role_name,
                                                    rows):
    rc = dataclasses.replace(ref_reduced(ARCHS["qwen2-0.5b"]),
                             gemm_backend=backend, compute_dtype="float32")
    tc = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                             gemm_backend=backend, compute_dtype="float32")
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
    tp = lm.prequantize_params(tc, lm.prepare_params(
        tc, convert.params_from_reference(
            tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, rc.vocab_size, rows)
    pos = rng.integers(0, 16, rows)
    role = dict(pp_role=role_name, pp_stages=2)
    ks, logits = {}, {}
    for name, kw in (("colocated", {}), ("role", role)):
        cache = lm.init_cache(tc, rows, 32, dtype=torch.float32,
                              device="cpu")
        lg, _ = lm.decode_step(dataclasses.replace(tc, **kw), tp, cache,
                               torch.as_tensor(tok), torch.as_tensor(pos))
        plan = substrate.SITE_PLANS["attn.wq"]
        ks[name] = plan.k
        logits[name] = lg
        ref_cache = ref_lm.init_cache(rc, rows, 32, dtype=jnp.float32)
        ref_lm.decode_step(dataclasses.replace(rc, **kw), rp, ref_cache,
                           jnp.asarray(tok), jnp.asarray(pos))
        assert plan.k == ref_sub.SITE_PLANS["attn.wq"].k, name
        assert plan.shard.transfer_cycles == \
            ref_sub.SITE_PLANS["attn.wq"].shard.transfer_cycles, name
    if role_name == "decode":
        assert ks["role"] < ks["colocated"]
    else:
        assert ks["role"] > ks["colocated"]
    assert substrate.SITE_PLANS["mlp.wo"].shard == substrate.SHARD_NONE
    assert torch.equal(logits["role"], logits["colocated"])
