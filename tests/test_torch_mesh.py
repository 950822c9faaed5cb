"""The port's meshes and shard-context rules against the reference's.

``repro_torch.launch.mesh`` (logical devices, ``make_host_mesh`` clamps
and strict errors, the production and pod meshes) and the mesh half of
``repro_torch.parallel.sharding`` (``_maybe`` / ``_divisible``,
``mesh_from_config``, ``gemm_shard_ctx`` / ``batched_shard_ctx`` /
``expert_shard_ctx``) are held to the reference's functions.  The rules
read only a mesh's ``.shape`` and ``.axis_names``, so they are compared on
``SimpleNamespace`` stubs, as ``tests/test_sharded_substrate.py`` does; no
device is needed.  Meshes over several devices use logical CPU devices
(``host_devices(n, "cpu")``), the counterpart of the reference's
``--xla_force_host_platform_device_count``.
"""
import dataclasses
import itertools
from types import SimpleNamespace

import jax
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.kernels import substrate as ref_sub
from repro.launch import mesh as ref_mesh
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import substrate
from repro_torch.launch import mesh as mesh_lib
from repro_torch.parallel import sharding

STUBS = [SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)
         for names, sizes in (
             (("data", "model"), (2, 4)), (("data", "model"), (1, 2)),
             (("data", "model"), (2, 2)), (("data", "model"), (1, 4)),
             (("data", "model"), (3, 1)),
             (("pod", "data", "model"), (2, 1, 1)),
             (("pod", "data", "model"), (2, 2, 2)))]
STUB_IDS = ["x".join(map(str, s.shape.values())) for s in STUBS]


def _specs(ctx):
    """A context's specs as plain tuples (a JAX PartitionSpec is one)."""
    if ctx is None:
        return None
    return (tuple(ctx.x_spec), tuple(ctx.w_spec), tuple(ctx.out_spec),
            tuple(ctx.reduce_axes), ctx.transfer_ops, ctx.transfer_cycles)


# ------------------------------------------------------------- devices
def test_logical_devices_fan_out_round_robin():
    """host_devices(n, "cpu") is n CPU devices, scoped to its block; a
    fan-out below one device raises; the default is the physical
    devices (every card, else the CPU)."""
    base = mesh_lib.devices()
    with mesh_lib.host_devices(3, "cpu") as devs:
        assert devs == [torch.device("cpu")] * 3 == mesh_lib.devices()
        with mesh_lib.host_devices(5, "cpu"):
            assert len(mesh_lib.devices()) == 5
        assert len(mesh_lib.devices()) == 3
    assert mesh_lib.devices() == base == mesh_lib.physical_devices()
    with pytest.raises(ValueError, match=">= 1"):
        mesh_lib.fan_out(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.fan_out(2)


@pytest.mark.parametrize("n", [1, 4, 6])
def test_make_host_mesh_clamps_like_reference(n):
    """Degenerate (data, model) requests clamp as the reference's do: each
    axis at least 1, the product within the device count."""
    def ref_rule(d, m):
        d = max(1, min(d, n))
        return d, max(1, min(m, n // d))

    with mesh_lib.host_devices(n, "cpu"):
        for d, m in itertools.product((0, 1, 2, 3, n + 3, 99), repeat=2):
            mesh = mesh_lib.make_host_mesh(d, m)
            assert tuple(mesh.shape.values()) == ref_rule(d, m), (d, m)
            assert mesh.axis_names == ("data", "model")
            assert mesh.devices.shape == ref_rule(d, m)
    # the reference on its one in-process device follows the same rule
    assert len(jax.devices()) == 1
    for d, m in ((0, 1), (1, 0), (3, 2)):
        assert dict(ref_mesh.make_host_mesh(d, m).shape) == \
            mesh_lib.make_host_mesh(d, m).shape


def test_make_host_mesh_strict_raises_like_reference():
    """strict=True raises the reference's ValueErrors (the hint names the
    port's fan-out instead of XLA_FLAGS) and builds an exact fit."""
    n = len(jax.devices())
    for d, m in ((n + 1, 1), (0, 1), (1, 0)):
        with pytest.raises(ValueError) as want:
            ref_mesh.make_host_mesh(d, m, strict=True)
        with mesh_lib.host_devices(n, "cpu"):
            with pytest.raises(ValueError) as got:
                mesh_lib.make_host_mesh(d, m, strict=True)
        assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    with mesh_lib.host_devices(4, "cpu"):
        with pytest.raises(ValueError, match="--host-devices"):
            mesh_lib.make_host_mesh(4, 2, strict=True)
        assert mesh_lib.make_host_mesh(2, 2, strict=True).shape == \
            {"data": 2, "model": 2}


def test_production_and_pod_meshes_need_their_devices():
    """The production meshes raise unless 256 (512) devices exist; a pod
    window past the devices raises; fanned out, they are built with the
    reference's axes."""
    with pytest.raises(ValueError, match="needs 256 devices"):
        mesh_lib.make_production_mesh()
    with mesh_lib.host_devices(512, "cpu"):
        m = mesh_lib.make_production_mesh()
        assert m.shape == {"data": 16, "model": 16} and m.size == 256
        m = mesh_lib.make_production_mesh(multi_pod=True)
        assert m.shape == {"pod": 2, "data": 16, "model": 16}
    with mesh_lib.host_devices(3, "cpu"):
        with pytest.raises(ValueError, match="pod_offset=2 needs 4"):
            mesh_lib.pod_mesh(2, 1, 1, 2)
        w = mesh_lib.pod_mesh(2, 1, 1, 1)
        assert w.shape == {"pod": 2, "data": 1, "model": 1}
        assert w.device({"pod": 1}) == torch.device("cpu")


def test_mesh_from_config_matches_reference():
    """No mesh, gemm_sharding="none" and bad shapes/modes as the
    reference; a strict mesh per device list (one object each); a role
    mesh windowed at pod_offset."""
    cfg = reduced(get_config("qwen2-0.5b"))
    rcfg = ref_reduced(ARCHS["qwen2-0.5b"])
    for kw in (dict(), dict(mesh_shape=(1, 4), gemm_sharding="none")):
        assert sharding.mesh_from_config(dataclasses.replace(cfg, **kw)) \
            is None
        assert ref_sharding.mesh_from_config(
            dataclasses.replace(rcfg, **kw)) is None
    for kw, match in ((dict(gemm_sharding="wat"), "gemm_sharding"),
                      (dict(mesh_shape=(1, 2, 3, 4)), "mesh_shape must"),
                      (dict(mesh_shape=(2, 1)), "devices")):
        for mod, c in ((sharding, cfg), (ref_sharding, rcfg)):
            with pytest.raises(ValueError, match=match):
                mod.mesh_from_config(dataclasses.replace(c, **kw))
    with mesh_lib.host_devices(4, "cpu"):
        a = sharding.mesh_from_config(dataclasses.replace(
            cfg, mesh_shape=(2, 2)))
        assert a is sharding.mesh_from_config(dataclasses.replace(
            cfg, mesh_shape=(2, 2)))
        role = sharding.mesh_from_config(dataclasses.replace(
            cfg, mesh_shape=(2, 1, 1), pod_offset=2))
        assert role.shape == {"pod": 2, "data": 1, "model": 1}
        with pytest.raises(ValueError, match="pod_offset=3 needs 5"):
            sharding.mesh_from_config(dataclasses.replace(
                cfg, mesh_shape=(2, 1, 1), pod_offset=3))
    with mesh_lib.host_devices(8, "cpu"):
        b = sharding.mesh_from_config(dataclasses.replace(
            cfg, mesh_shape=(2, 2)))
        assert b is not a and b.shape == a.shape


# ------------------------------------------------- helpers and contexts
@pytest.mark.parametrize("stub", STUBS, ids=STUB_IDS)
def test_divisible_maybe_and_axes_match_reference(stub):
    for dim in (1, 2, 3, 4, 6, 7, 8, 12, 16):
        for axes in (None, "data", "model", "pod", ("pod", "data"),
                     ("data", "model"), ("pod", "data", "model")):
            assert sharding._divisible(dim, stub, axes) == \
                ref_sharding._divisible(dim, stub, axes), (dim, axes)
            assert sharding._maybe(dim, stub, axes) == \
                ref_sharding._maybe(dim, stub, axes), (dim, axes)
    assert sharding.batch_axes(stub) == ref_sharding.batch_axes(stub)
    assert sharding.all_axes(stub) == ref_sharding.all_axes(stub)


SITES = ("attn.wq", "attn.wk", "attn.wo", "xattn.wo", "mlp.wo",
         "mlp.wi_gate+mlp.wi_up", "mamba.z", "mamba.xbc", "mamba.dt",
         "mamba.out", "unembed", "moe.router", "frontend.img", "")


@pytest.mark.parametrize("stub", STUBS, ids=STUB_IDS)
def test_gemm_shard_ctx_matches_reference(stub):
    """Every site kind, over divisible and indivisible dims: the same
    specs, reduce axes and signature as the reference's context."""
    for site in SITES:
        for rows, K, N in itertools.product((1, 2, 6, 8), (6, 8, 64),
                                            (6, 8, 24)):
            got = sharding.gemm_shard_ctx(site, rows, K, N, mesh=stub)
            want = ref_sharding.gemm_shard_ctx(site, rows, K, N, mesh=stub)
            assert _specs(got) == _specs(want), (site, rows, K, N)
            if got is not None:
                assert got.signature() == substrate.ShardSig(
                    **dataclasses.asdict(want.signature()))
                assert got.divides(rows, K, N) == want.divides(rows, K, N)
    assert sharding.gemm_shard_ctx("attn.wq", 8, 8, 8) is None


@pytest.mark.parametrize("stub", STUBS, ids=STUB_IDS)
def test_batched_and_expert_ctx_match_reference(stub):
    for n in range(1, 17):
        assert _specs(sharding.batched_shard_ctx(n, mesh=stub)) == \
            _specs(ref_sharding.batched_shard_ctx(n, mesh=stub)), n
        assert _specs(sharding.expert_shard_ctx(n, mesh=stub)) == \
            _specs(ref_sharding.expert_shard_ctx(n, mesh=stub)), n
    assert sharding.batched_shard_ctx(8) is None
    assert sharding.expert_shard_ctx(8) is None


def test_pricing_scope_inside_a_role_mesh():
    """Under a (2, 1, 1) role mesh with a decode role the boundary site
    gets the reference's pricing-only context and no site shards."""
    stub = STUBS[5]
    for mod in (sharding, ref_sharding):
        with mod.use_gemm_mesh(stub), mod.use_pp_pricing("decode", 2):
            ctx = mod.gemm_shard_ctx("attn.wq", 4, 896, 896)
            assert ctx.mesh is None and ctx.transfer_cycles > 0
            assert mod.gemm_shard_ctx("attn.wo", 4, 896, 896) is None
            assert mod.batched_shard_ctx(4) is None
    with sharding.use_gemm_mesh(stub), sharding.use_pp_pricing("decode", 2):
        got = sharding.gemm_shard_ctx("attn.wq", 4, 896, 896)
    with ref_sharding.use_gemm_mesh(stub), \
            ref_sharding.use_pp_pricing("decode", 2):
        want = ref_sharding.gemm_shard_ctx("attn.wq", 4, 896, 896)
    assert _specs(got) == _specs(want)


def test_shard_ctx_signature_and_divides():
    stub = STUBS[0]
    ctx = substrate.ShardCtx(stub, ("data", None), (None, "model"),
                             ("data", "model"))
    want = ref_sub.ShardCtx(stub, ("data", None), (None, "model"),
                            ("data", "model"))
    assert ctx.signature() == substrate.ShardSig(
        **dataclasses.asdict(want.signature()))
    for dims in ((8, 5, 8), (7, 5, 8), (8, 5, 6)):
        assert ctx.divides(*dims) == want.divides(*dims)
    row = substrate.ShardCtx(stub, ("data", "model"), ("model", None),
                             ("data", None), reduce_axes=("model",))
    assert row.signature() == substrate.ShardSig(rows=2, contraction=4,
                                                 cols=1, reduce_ops=2)


# ------------------------------------------------------------ serve CLI
def test_serve_cli_tp2_in_process(capsys):
    """``--tp 2 --host-devices 2`` serves in process over a (1, 2) mesh
    and prints the ``mesh:`` line; the streams are the unsharded run's;
    without the fan-out the mesh raises."""
    from repro_torch.launch import serve
    args = ["--device", "cpu", "--gemm-backend", "arrayflex", "--requests",
            "2", "--max-new", "3"]
    want = serve.main(args)
    capsys.readouterr()
    got = serve.main(args + ["--tp", "2", "--host-devices", "2"])
    assert "mesh: data=1 x model=2 over 2 host devices" in \
        capsys.readouterr().out
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert [r.outcome for r in got] == ["ok", "ok"]
    with pytest.raises(ValueError, match="--host-devices"):
        serve.main(args + ["--tp", "2", "--fsdp", "2"])
