"""The port's spec tables, activation rules, elastic mesh shape, gradient
compression and abstract trees against the reference's.

In process: the reference's tables are computed against a
``jax.sharding.AbstractMesh`` (no host devices), the port's against its
own ``launch.mesh.DeviceMesh`` over logical CPU devices of the same
shape, for all ten reduced archs over (1, 1), (2, 2), (1, 4), (4, 1),
(8, 4) and a (2, 2, 2) pod mesh.  Every comparison is exact: a spec is
the reference's ``PartitionSpec`` as a tuple, leaf by leaf in the
reference's flatten order; compression codes, scales and errors bit for
bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.models import api as ref_api
from repro.models import lm as ref_lm
from repro.nn import attention as ref_attention
from repro.nn import mamba as ref_mamba
from repro.nn import moe as ref_moe
from repro.optim import OptConfig as RefOptConfig
from repro.parallel import compression as ref_comp
from repro.parallel import sharding as ref_sharding
from repro.runtime import elastic as ref_elastic
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, lm
from repro_torch.optim import OptConfig
from repro_torch.parallel import compression, sharding
from repro_torch.runtime import elastic

ARCH_LIST = sorted(REF_ARCHS)
MESHES = [(1, 1), (2, 2), (1, 4), (4, 1), (8, 4), (2, 2, 2)]
MESH_IDS = ["x".join(map(str, m)) for m in MESHES]
# a training cell and a decode cell (the batch divides every data axis
# above, the sequence every model axis; B = 1 takes the sequence branch
# of kv_cache_pspec)
SHAPES = [("train", 64, 8, "train"), ("decode", 128, 1, "decode")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models run fastest on one intra-op thread: the suite
    runs several workers on the machine's cores, and torch's default (a
    thread per core in each worker) oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_mesh(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return AbstractMesh(tuple(shape), names)


def port_mesh(shape):
    with mesh_lib.host_devices(int(np.prod(shape)), "cpu"):
        if len(shape) == 3:
            return mesh_lib.pod_mesh(*shape, 0)
        return mesh_lib.make_host_mesh(*shape, strict=True)


def ref_specs(tree):
    """(path key, spec tuple) of a reference spec tree in flatten order."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(spec)) for path, spec in flat]


def port_specs(tree, prefix=()):
    """(path key, spec) of a port spec tree, dict keys sorted (JAX's
    order)."""
    if sharding.is_spec(tree):
        return [("/".join(map(str, prefix)), tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in port_specs(tree[k], prefix + (k,))]
    return [kv for i, v in enumerate(tree)
            for kv in port_specs(v, prefix + (i,))]


def cfgs(arch):
    return ref_reduced(REF_ARCHS[arch]), reduced(get_config(arch))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_param_and_opt_pspecs_match_reference(arch, mesh):
    """``api.param_pspecs`` (``param_pspec_tree`` over the abstract tree,
    expert-parallel or TP expert specs by ``E % tp``) and
    ``api.opt_pspecs`` with and without master weights."""
    rc, tc = cfgs(arch)
    rm, tm = ref_mesh(mesh), port_mesh(mesh)
    assert port_specs(api.param_pspecs(tc, tm)) == \
        ref_specs(ref_api.param_pspecs(rc, rm))
    for master in (False, True):
        got = api.opt_pspecs(tc, OptConfig(master_weights=master), tm)
        want = ref_api.opt_pspecs(rc, RefOptConfig(master_weights=master),
                                  rm)
        assert port_specs(got) == ref_specs(want)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_input_and_cache_pspecs_match_reference(arch, mesh):
    """``batch_pspecs`` (with and without labels), ``cache_pspecs`` and
    ``decode_pspecs`` for a training and a decode shape."""
    rc, tc = cfgs(arch)
    rm, tm = ref_mesh(mesh), port_mesh(mesh)
    for shp in SHAPES:
        rs, ts = RefShape(*shp), ShapeConfig(*shp)
        for labels in (True, False):
            assert port_specs(api.batch_pspecs(tc, ts, tm,
                                               with_labels=labels)) == \
                ref_specs(ref_api.batch_pspecs(rc, rs, rm,
                                               with_labels=labels))
        assert port_specs(api.cache_pspecs(tc, ts, tm)) == \
            ref_specs(ref_api.cache_pspecs(rc, rs, rm))
        assert port_specs(api.decode_pspecs(tc, ts, tm)) == \
            ref_specs(ref_api.decode_pspecs(rc, rs, rm))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_activation_rules_match_reference(arch, mesh):
    """``activation_rules`` for a train and a decode pass, and without a
    config, as tuples."""
    rc, tc = cfgs(arch)
    rm, tm = ref_mesh(mesh), port_mesh(mesh)
    for B in (1, 6, 8, 32):
        for kind in ("train", "decode"):
            want = ref_sharding.activation_rules(rm, B, rc, kind)
            got = sharding.activation_rules(tm, B, tc, kind)
            assert got == {k: tuple(v) for k, v in want.items()}
        assert sharding.activation_rules(tm, B) == {
            k: tuple(v)
            for k, v in ref_sharding.activation_rules(rm, B).items()}


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_spec_functions_match_reference(mesh):
    """The five ``*_pspec`` functions over a grid of batches, cache
    lengths, heads and channels, stacked and not."""
    rm, tm = ref_mesh(mesh), port_mesh(mesh)
    for B in (1, 2, 3, 4, 8, 12, 64):
        assert sharding.token_pspec(tm, B) == \
            tuple(ref_sharding.token_pspec(rm, B))
        assert sharding.activation_pspec(tm, B) == \
            tuple(ref_sharding.activation_pspec(rm, B))
        for stacked in (True, False):
            for n in (1, 6, 16, 96, 128):
                assert sharding.kv_cache_pspec(tm, B, n, stacked=stacked) \
                    == tuple(ref_sharding.kv_cache_pspec(rm, B, n,
                                                         stacked=stacked))
                assert sharding.ssm_state_pspec(tm, B, n, stacked=stacked) \
                    == tuple(ref_sharding.ssm_state_pspec(rm, B, n,
                                                          stacked=stacked))
                assert sharding.conv_state_pspec(tm, B, n,
                                                 stacked=stacked) == \
                    tuple(ref_sharding.conv_state_pspec(rm, B, n,
                                                        stacked=stacked))


def test_named_binds_each_spec_to_the_mesh():
    tm = port_mesh((2, 2))
    tree = {"a": ("data", None), "b": ({"c": ()}, {"c": (None, "model")})}
    got = sharding.named(tree, tm)
    assert got["a"] == sharding.NamedSharding(tm, ("data", None))
    assert got["b"][1]["c"].spec == (None, "model")
    assert got["b"][0]["c"].mesh is tm


def test_largest_mesh_shape_matches_reference():
    for n in range(1, 65):
        for tp in range(1, 17):
            assert elastic.largest_mesh_shape(n, tp) == \
                ref_elastic.largest_mesh_shape(n, tp)


@pytest.mark.parametrize("n,tp", [(4, 1), (4, 2), (4, 3), (8, 4), (6, 4)])
def test_replan_mesh_over_logical_devices(n, tp):
    """``replan_mesh`` takes ``launch.mesh.devices()`` (a host_devices
    fan-out) and the reference's largest (data, model) shape."""
    with mesh_lib.host_devices(n, "cpu"):
        mesh, state = elastic.replan_mesh(model_parallel=tp)
    shape = ref_elastic.largest_mesh_shape(n, tp)
    assert state == elastic.ElasticState(n, shape, ("data", "model"))
    assert mesh.shape == dict(zip(("data", "model"), shape))
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}


def _grad_tree(seed):
    """A seeded tree of fp32 leaves over several magnitudes (and a zero
    leaf), with a seeded bf16 error tree."""
    rng = np.random.RandomState(seed)
    g = {"w": rng.randn(33, 17).astype(np.float32) * 3.0,
         "blocks": ({"a": (rng.randn(2, 64) * 1e-4).astype(np.float32)},
                    {"a": rng.standard_cauchy((5,)).astype(np.float32)}),
         "z": np.zeros((4,), np.float32),
         "t": (rng.rand(7) * 1e-30).astype(np.float32)}
    e = jax.tree.map(lambda x: (rng.randn(*x.shape) * 1e-3).astype(
        np.float32), g)
    return g, e


def _bits(x):
    x = np.asarray(x)
    return x.view({1: np.int8, 2: np.uint16, 4: np.uint32}[x.itemsize])


def _port_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compress_decompress_bit_equal_to_reference(seed):
    """``compress`` (codes, scales, new error) and ``decompress`` equal
    the reference's eager ones bit for bit, leaf by leaf."""
    g, e = _grad_tree(seed)
    re = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), e)
    rq, rs, rerr = ref_comp.compress(jax.tree.map(jnp.asarray, g), re)
    te = tree_lib.tree_map(lambda x: torch.tensor(x).to(torch.bfloat16), e)
    tq, ts, terr = compression.compress(
        tree_lib.tree_map(torch.tensor, g), te)
    for want, got in ((rq, tq), (rs, ts), (rerr, terr)):
        w = [_bits(x) for x in jax.tree.leaves(want)]
        gl = [_port_bits(x) for x in tree_lib.leaves(got)]
        assert len(w) == len(gl)
        for a, b in zip(w, gl):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        want = ref_comp.decompress(rq, rs, dt)
        got = compression.decompress(tq, ts, tdt)
        for a, b in zip(jax.tree.leaves(want), tree_lib.leaves(got)):
            assert np.array_equal(_bits(a), _port_bits(b))
    zero = compression.init_error(tree_lib.tree_map(torch.tensor, g))
    assert all(t.dtype == torch.bfloat16 and not t.any()
               for t in tree_lib.leaves(zero))


class _Allocations(TorchDispatchMode):
    """Counts the ops whose outputs are not on the meta device."""

    def __init__(self):
        super().__init__()
        self.off_meta = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_lib.leaves(list(out) if isinstance(out, (tuple, list))
                                 else [out]):
            if torch.is_tensor(t) and not t.is_meta:
                self.off_meta.append(str(func))
        return out


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_abstract_trees_allocate_nothing(arch):
    """``abstract_params`` / ``abstract_opt_state`` / ``decode_specs`` /
    ``batch_specs`` of the full-size config: every op's output on the
    meta device (no storage), the reference's leaf count."""
    cfg = get_config(arch)
    shp = ShapeConfig("train", 4096, 8, "train")
    with _Allocations() as watch:
        params = api.abstract_params(cfg)
        opt = api.abstract_opt_state(cfg, OptConfig(master_weights=True))
        cache, tok, pos = api.decode_specs(cfg, shp)
        batch = api.batch_specs(cfg, shp)
    assert watch.off_meta == []
    leaves = tree_lib.leaves([params, opt, cache, tok, pos, batch])
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in tree_lib.leaves(params)) > 0


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_abstract_shapes_and_dtypes_match_reference(arch):
    """The abstract parameter, optimizer, cache and batch trees of the
    reduced config: the reference's shapes and dtypes leaf by leaf."""
    rc, tc = cfgs(arch)
    rs, ts = RefShape("train", 64, 4, "train"), \
        ShapeConfig("train", 64, 4, "train")
    oc, roc = OptConfig(master_weights=True), RefOptConfig(
        master_weights=True)
    pairs = [(ref_api.abstract_params(rc), api.abstract_params(tc)),
             (ref_api.abstract_opt_state(rc, roc),
              api.abstract_opt_state(tc, oc)),
             (ref_api.decode_specs(rc, rs), api.decode_specs(tc, ts)),
             (ref_api.batch_specs(rc, rs), api.batch_specs(tc, ts)),
             (ref_api.batch_specs(rc, rs, with_labels=False),
              api.batch_specs(tc, ts, with_labels=False))]
    for want, got in pairs:
        w = jax.tree.leaves(want)
        g = tree_lib.leaves(got)
        assert [tuple(x.shape) for x in w] == [tuple(x.shape) for x in g]
        assert [str(x.dtype) for x in w] == \
            [str(x.dtype).replace("torch.", "") for x in g]
    assert api.dec_len(tc, ts) == ref_api.dec_len(rc, rs)


# ------------------------------------------------- the constrain points
CONSTRAIN_ARCHS = ["qwen2-0.5b", "qwen3-moe-30b-a3b", "mamba2-370m",
                   "whisper-base"]


def _ref_recorded(monkeypatch, rc, rp, batch, rules, n_micro):
    """(name, shape, spec) of every constrain call a rule applies to in
    the reference's loss (and its microbatch split), its constrain
    replaced in each module that imports it by a recorder that returns x
    (no mesh needed; traced only)."""
    seen = set()

    def record(x, name):
        spec = rules.get(name)
        if spec is not None:
            parts = list(spec) + [None] * (x.ndim - len(spec))
            seen.add((name, tuple(x.shape), tuple(parts[:x.ndim])))
        return x

    for mod in (ref_lm, ref_attention, ref_moe, ref_mamba):
        monkeypatch.setattr(mod, "constrain", record)
    monkeypatch.setattr(ref_sharding, "constrain", record)
    jax.eval_shape(lambda p, b: ref_lm.loss_fn(rc, p, b), rp, batch)
    n = n_micro
    for x in batch.values():
        b = x.shape[0] // n
        record(jnp.moveaxis(x.reshape((b, n) + x.shape[1:]), 1, 0),
               "micro_batch")
    return seen


@pytest.mark.parametrize("arch", CONSTRAIN_ARCHS)
def test_constrain_points_match_reference(arch, monkeypatch):
    """Under ``activation_rules`` of a (2, 2) mesh, the port's forward and
    microbatch split resolve the same (rule, shape, spec) set as the
    reference's constrain calls (hidden after the embedding and every
    sub-layer, logits, the attention q / k / v / scores, the MoE buffers,
    the mamba conv input and SSD x, the micro_batch split), and
    ``constrain`` returns its input itself."""
    rc, tc = cfgs(arch)
    rc = dataclasses.replace(rc, compute_dtype="float32")
    tc = dataclasses.replace(tc, compute_dtype="float32")
    rp = jax.eval_shape(lambda: ref_lm.init_params(rc,
                                                   jax.random.PRNGKey(0)))
    tp = lm.init_params(tc, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    B, S = 4, 32
    T = max(S // 8, 16) if tc.family == "audio" else S
    b = {"tokens": rng.randint(2, tc.vocab_size, (B, T)),
         "labels": rng.randint(2, tc.vocab_size, (B, T))}
    if tc.family == "audio":
        b["frames"] = rng.standard_normal((B, S, tc.d_frontend)).astype(
            np.float32)
    rules_ref = ref_sharding.activation_rules(ref_mesh((2, 2)), B, rc)
    want = _ref_recorded(monkeypatch, rc, rp,
                         {k: jnp.asarray(v) for k, v in b.items()},
                         rules_ref, 2)
    tb = {k: torch.tensor(v) for k, v in b.items()}
    rules = sharding.activation_rules(port_mesh((2, 2)), B, tc)
    seen = []
    real = sharding.constrain

    def spy(x, name):
        spec = sharding.constraint_spec(name, x.ndim)
        if spec is not None:
            seen.append((name, tuple(x.shape), spec))
        return real(x, name)

    monkeypatch.setattr(sharding, "constrain", spy)
    with sharding.use_activation_rules(rules):
        lm.loss_fn(tc, tp, tb)
        for m in range(2):
            api._micro(tb, 2, m)
    assert set(seen) == want
    x = torch.zeros(B, S, tc.d_model)
    with sharding.use_activation_rules(rules):
        assert real(x, "hidden") is x
    assert {n for n, _, _ in seen} >= {"hidden", "logits", "micro_batch"}
