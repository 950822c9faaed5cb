"""The port's roofline model and dispatch-mode tracer against the
reference's roofline model and HLO analyzer.

``model_flops`` and ``RooflineTerms`` against the reference's; the tracer
on single ops (exact FLOPs and bytes); the tracer's FLOPs on the reduced
train / prefill / decode steps of seven families (B = 2, S = 32,
unsharded) against ``repro.roofline.hlo.analyze`` of the reference's
compiled steps — equal, except the two train steps with mamba layers,
where the gap is named and counted op by op; a kernel-backed step
against an ``xla`` one; the per-device split and the collective bytes on
a (2, 2) mesh of logical CPU devices against hand counts.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.models import api as ref_api
from repro.optim import OptConfig as RefOptConfig
from repro.roofline import hlo as ref_hlo
from repro.roofline import model as ref_roof
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import substrate
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, lm
from repro_torch.optim import OptConfig
from repro_torch.roofline import model as roof
from repro_torch.roofline import trace

B, S = 2, 32
FAMILIES = ["qwen2-0.5b", "qwen3-moe-30b-a3b", "mamba2-370m",
            "jamba-1.5-large-398b", "whisper-base", "llama-3.2-vision-90b",
            "mixtral-8x22b"]
KINDS = ["train", "prefill", "decode"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the model

@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_match_reference(arch, shape):
    from repro.configs import get_shape as ref_get_shape
    from repro_torch.configs import get_shape
    assert (roof.model_flops(get_config(arch), get_shape(shape))
            == ref_roof.model_flops(ref_get_config(arch),
                                    ref_get_shape(shape)))


@pytest.mark.parametrize("terms", [(1.0, 2.0, 3.0), (3.0, 2.0, 1.0),
                                   (0.5, 4.0, 0.25), (0.0, 0.0, 0.0),
                                   (2.0, 2.0, 1.0)])
def test_roofline_terms_match_reference(terms):
    ours, theirs = roof.RooflineTerms(*terms), ref_roof.RooflineTerms(*terms)
    assert ours.dominant == theirs.dominant
    assert ours.bound_s == theirs.bound_s
    assert ours.roofline_fraction == theirs.roofline_fraction


def test_constants_are_the_h100_datasheet():
    assert roof.PEAK_FLOPS_BF16 == 989.4e12
    assert roof.HBM_BW == 3.35e12
    assert roof.LINK_BW == 450e9
    assert roof.HBM_BYTES == 80 * 2**30
    hl = {"flops_per_device": 989.4e12, "hbm_bytes_per_device": 6.7e12,
          "collective_total_per_device": 450e9}
    t = roof.terms_from_analysis(hl)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 1.0)
    assert t.dominant == "memory"


# ---------------------------------------------------------------------------
# single ops

def _f32(*shape, grad=False):
    return torch.ones(shape, dtype=torch.float32, requires_grad=grad)


def test_mm_and_bmm_exact():
    a, b = _f32(3, 5), _f32(5, 7)
    r = trace.analyze(torch.mm, a, b)
    assert r["flops_per_device"] == 2 * 3 * 5 * 7
    assert r["hbm_bytes_per_device"] == 4 * (15 + 35 + 21)
    assert r["top_flops"] == [("mm", 2 * 3 * 5 * 7)]
    a, b = _f32(4, 3, 5), _f32(4, 5, 2)
    r = trace.analyze(torch.bmm, a, b)
    assert r["flops_per_device"] == 2 * 4 * 3 * 5 * 2
    assert r["hbm_bytes_per_device"] == 4 * (60 + 40 + 24)


def test_einsum_reaches_the_tracer_as_bmm():
    a, b = _f32(2, 3, 4, 5), _f32(2, 3, 5, 6)
    r = trace.analyze(lambda x, y: torch.einsum("bhik,bhkj->bhij", x, y),
                      a, b)
    assert r["flops_per_device"] == 2 * 2 * 3 * 4 * 5 * 6
    assert dict(r["top_flops"]) == {"bmm": 2 * 2 * 3 * 4 * 5 * 6}


def test_view_is_free():
    x = _f32(4, 6)
    r = trace.analyze(lambda t: t.view(6, 4).t()[1:3], x)
    assert r["hbm_bytes_per_device"] == 0
    assert r["flops_per_device"] == 0
    r = trace.analyze(lambda t: t.t().contiguous(), x)
    assert r["hbm_bytes_per_device"] == 2 * 4 * 24
    # reshape of a strided view: a clone, then an ``_unsafe_view`` (free)
    r = trace.analyze(lambda t: t.t().reshape(-1), x)
    assert r["hbm_bytes_per_device"] == 2 * 4 * 24


@pytest.mark.parametrize("groups", [1, 4])
def test_conv1d_forward_and_backward(groups):
    """F.conv1d's forward is 2 x out x (C_in / groups) x k; its backward
    books the input gradient and the weight gradient at the forward's
    FLOPs each (torch's stock counter books a grouped conv's weight
    gradient ``groups`` times over)."""
    Bz, C, L, k = 2, 8, 16, 3
    x = _f32(Bz, C, L, grad=True)
    w = _f32(C, C // groups, k, grad=True)
    out_len = L - k + 1
    fwd = 2 * Bz * C * out_len * (C // groups) * k
    r = trace.analyze(lambda a, b: F.conv1d(a, b, groups=groups), x, w)
    assert r["flops_per_device"] == fwd
    assert dict(r["top_flops"]) == {"convolution": fwd}

    def both(a, b):
        y = F.conv1d(a, b, groups=groups)
        return torch.autograd.grad(y.sum(), (a, b))

    r = trace.analyze(both, x, w)
    assert dict(r["top_flops"]) == {"convolution": fwd,
                                    "convolution_backward": 2 * fwd}

    def weight_only(a, b):
        y = F.conv1d(a.detach(), b, groups=groups)
        return torch.autograd.grad(y.sum(), (b,))

    r = trace.analyze(weight_only, x, w)
    assert dict(r["top_flops"])["convolution_backward"] == fwd


def test_memory_tracks_births_and_deaths():
    """Live bytes rise at each fresh result and fall when it dies; views
    of a storage count once; argument + temp + output is the peak."""
    x = torch.zeros(1024, dtype=torch.float32)          # 4 KiB argument

    def fn(t):
        a = t * 2                                     # +4 KiB
        v = a.view(32, 32)[:, :16]                    # view: +0
        b = torch.cat([a, a])                         # +8 KiB, peak 12
        del a, b
        e = torch.empty(512)                          # +2 KiB, no traffic
        e[:] = 1.0
        return v.sum() + e[0]                         # output: 4 B

    r = trace.analyze(fn, x)
    m = r["memory"]
    assert m["argument_bytes"] == 4096
    assert m["output_bytes"] == 4
    assert m["peak_bytes"] == 4096 + 12288
    assert m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"] \
        == m["peak_bytes"]
    assert m["alias_bytes"] == 0


def test_hooks_are_inert_without_a_tracer():
    assert trace._ACTIVE is None
    with trace.shard(mesh_lib.make_host_mesh(1, 1), {}) as got:
        assert got is None
    trace.collective("all-gather", torch.zeros(4), 4)   # no tracer: nothing
    assert trace._ACTIVE is None


# ---------------------------------------------------------------------------
# parity with the reference's HLO analyzer (reduced configs, unsharded)

def _ref_analysis(arch, kind):
    cfg = ref_reduced(ref_get_config(arch))
    shape = RefShape("t", S, B, kind)
    if kind == "train":
        opt = RefOptConfig()
        fn = ref_api.make_train_step(cfg, opt, 1)
        specs = (ref_api.abstract_params(cfg),
                 ref_api.abstract_opt_state(cfg, opt),
                 ref_api.batch_specs(cfg, shape))
    elif kind == "prefill":
        fn = ref_api.make_prefill_step(cfg)
        specs = (ref_api.abstract_params(cfg),
                 ref_api.batch_specs(cfg, shape, with_labels=False))
    else:
        fn = ref_api.make_serve_step(cfg)
        specs = (ref_api.abstract_params(cfg),) + tuple(
            ref_api.decode_specs(cfg, shape))
    return ref_hlo.analyze(jax.jit(fn).lower(*specs).compile().as_text())


def _port_step(cfg, kind):
    shape = ShapeConfig("t", S, B, kind)
    if kind == "train":
        opt = OptConfig()
        return api.make_train_step(cfg, opt, 1), (
            api.abstract_params(cfg), api.abstract_opt_state(cfg, opt),
            api.batch_specs(cfg, shape))
    if kind == "prefill":
        return api.make_prefill_step(cfg), (
            api.abstract_params(cfg),
            api.batch_specs(cfg, shape, with_labels=False))
    return api.make_serve_step(cfg), (
        (api.abstract_params(cfg),) + tuple(api.decode_specs(cfg, shape)))


def _mamba_train_gap(cfg) -> int:
    """port - reference FLOPs of one reduced train step with mamba layers,
    named op by op, per mamba layer:

    * the depthwise causal conv (``F.conv1d(groups=C)``): the port books
      the forward, the input gradient and the weight gradient at
      2·k·L·C·B each; the reference's compiled step books the input
      gradient over the padded length L + k - 1, and XLA:CPU lowers the
      weight gradient to a dense (k, C, C) convolution, C times the
      multiply-adds (2·k·L·C²·B);
    * the SSD scan (``nn.mamba.ssd_chunked``): the port's forward and its
      checkpointed recompute each run ``y_off``'s contraction against the
      zero initial state (2·B·S·H·P·N), which XLA folds away; the
      reference's backward runs two contractions of 2·B·S·H·N that
      torch's einsum backward does as elementwise products."""
    ssm = cfg.ssm
    C = cfg.d_inner + 2 * ssm.n_groups * ssm.d_state
    k, L = ssm.d_conv, S
    H, P, N = cfg.ssm_heads, ssm.head_dim, ssm.d_state
    port_conv = 3 * 2 * k * L * C * B
    ref_conv = (2 * k * L * C * B + 2 * k * (L + k - 1) * C * B
                + 2 * k * L * C * C * B)
    ssd = 2 * (2 * B * S * H * P * N) - 2 * (2 * B * S * H * N)
    n_mamba = sum(1 for i in range(cfg.n_layers) if not cfg.is_attn_layer(i))
    return n_mamba * (port_conv - ref_conv + ssd)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_flops_match_reference_hlo(arch, kind):
    cfg = reduced(get_config(arch))
    ref = _ref_analysis(arch, kind)
    fn, args = _port_step(cfg, kind)
    got = trace.analyze(fn, *args)
    assert got["unknown_trip_count"] is False
    if kind == "train" and cfg.ssm is not None:
        # the one gap: the mamba mixer's conv and SSD scan, op by op
        ssm = cfg.ssm
        C = cfg.d_inner + 2 * ssm.n_groups * ssm.d_state
        n_mamba = sum(1 for i in range(cfg.n_layers)
                      if not cfg.is_attn_layer(i))
        flops = dict(got["top_flops"])
        assert flops["convolution"] == n_mamba * 2 * ssm.d_conv * S * C * B
        assert flops["convolution_backward"] == 2 * flops["convolution"]
        assert (got["flops_per_device"] - ref["flops_per_device"]
                == _mamba_train_gap(cfg))
        return
    assert got["flops_per_device"] == ref["flops_per_device"]


def test_kernel_launches_count_like_xla():
    """A reduced qwen2 decode step on ``arrayflex`` (each K1 / K2 wrapper
    books its logical FLOPs; its plain version on the CPU is not counted
    again) counts the same FLOPs as on ``xla``, site by site."""
    base = reduced(get_config("qwen2-0.5b"))
    got = {}
    for backend in ("xla", "arrayflex"):
        cfg = dataclasses.replace(base, gemm_backend=backend)
        params = lm.init_params(cfg, seed=0, device="cpu")
        cache = lm.init_cache(cfg, B, S, device="cpu")
        tok = torch.zeros(B, dtype=torch.int32)
        pos = torch.tensor(3, dtype=torch.int32)
        with torch.no_grad():
            got[backend] = trace.analyze(
                lambda p, c, t, q: lm.decode_step(cfg, p, c, t, q),
                params, cache, tok, pos)
    assert got["arrayflex"]["flops_per_device"] \
        == got["xla"]["flops_per_device"] > 0
    assert dict(got["arrayflex"]["top_flops"]) \
        == dict(got["xla"]["top_flops"])
    assert {"attn.wq", "attn.qk", "attn.pv", "unembed"} \
        <= set(dict(got["arrayflex"]["top_flops"]))


# ---------------------------------------------------------------------------
# the mesh: per-device FLOPs and collective bytes on (2, 2) logical devices
# (meta ones for the abstract steps, CPU ones for a GEMM on real tensors)

def _meshed(cfg, mesh_shape):
    return dataclasses.replace(cfg, mesh_shape=mesh_shape)


@pytest.mark.parametrize("kind,remat", [("prefill", "none"),
                                        ("train", "none"), ("train", "full")])
def test_mesh_splits_each_site_over_its_shards(kind, remat):
    """On a (2, 2) mesh of meta devices every dispatched site of reduced
    qwen2 shards four ways: each device runs a quarter of each site's
    FLOPs (the backward where its forward ran; a remat recompute where
    its own scopes put it, not where the node that asked for it ran), the
    devices add up to the unsharded total, and only the home device
    gathers."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")), remat=remat)
    fn, args = _port_step(cfg, kind)
    flat = trace.analyze(fn, *args, per_device=True)
    with mesh_lib.host_devices(4, "meta"):
        fn, args = _port_step(_meshed(cfg, (2, 2)), kind)
        shard = trace.analyze(fn, *args, per_device=True, n_devices=4)
    per = shard["per_device"]
    assert sorted(per) == [0, 1, 2, 3]
    sites = flat["per_device"][0]["flops_by_label"]
    assert {"attn.wq", "mlp.wo", "attn.qk", "unembed"} <= set(sites)
    want = {s: f / 4 for s, f in sites.items()}
    if remat == "full":
        # torch's checkpoint stops its recompute once the last tensor the
        # backward saved is back: unsharded, a block's last GEMM (mlp.wo)
        # never reruns; sharded, its shards before the last one do
        passes = {i: per[i]["flops_by_label"]["mlp.wo"] / want["mlp.wo"]
                  for i in per}
        assert passes == {0: 4 / 3, 1: 4 / 3, 2: 4 / 3, 3: 1.0}
        want.pop("mlp.wo")
        for d in per.values():
            d["flops_by_label"].pop("mlp.wo")
    else:
        assert sum(d["flops"] for d in per.values()) \
            == flat["flops_per_device"]
        assert shard["devices"]["non_home_mean"]["flops"] \
            == flat["flops_per_device"] / 4
    for i, d in per.items():
        assert d["flops_by_label"] == want
        if i:
            assert d["collective_bytes"] == 0
    assert shard["devices"]["home"]["collective_bytes"] > 0
    assert shard["busiest_device"] == 0


@pytest.mark.parametrize("site,row_parallel", [("attn.wq", False),
                                               ("mlp.wo", True)])
def test_collective_bytes_match_hand_count(site, row_parallel):
    """One sharded GEMM on a (2, 2) mesh, by ``hlo.py``'s formulas: a
    column-parallel site gathers its (T, N) output from 4 blocks
    (all-gather: bytes x 3/4); a row-parallel one all-reduces each of its
    2 row blocks' fp32 partials over the 2 contraction shards (operand x
    2 x 1/2 each), then gathers the 2 fp32 row blocks (x 1/2)."""
    from repro_torch.parallel import sharding
    T, K, N = 8, 16, 12
    x = torch.ones(T, K, dtype=torch.bfloat16)
    w = torch.ones(K, N, dtype=torch.bfloat16)
    with mesh_lib.host_devices(4, "cpu"):
        mesh = mesh_lib.make_host_mesh(2, 2, strict=True)
        ctx = sharding.gemm_shard_ctx(site, T, K, N, mesh=mesh)
        assert bool(ctx.reduce_axes) == row_parallel
        r = trace.analyze(lambda a, b: substrate.gemm(a, b, site=site,
                                                      shard=ctx), x, w,
                          per_device=True)
    coll = r["per_device"][0]["collective_by_kind"]
    if row_parallel:
        block = (T // 2) * N * 4                      # fp32 partial
        assert coll == {"all-reduce": 2 * block * 2.0 * (2 - 1) / 2,
                        "all-gather": T * N * 4 * (2 - 1) / 2}
    else:
        assert coll == {"all-gather": T * N * 2 * (4 - 1) / 4}
    for i in range(4):
        assert r["per_device"][i]["flops"] == 2 * T * K * N / 4
    assert dict(r["top_coll"]) == {site: sum(coll.values())}
    # the gathered output is born on the home device
    assert r["memory"]["output_bytes"] == T * N * 2
