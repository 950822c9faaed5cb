"""Sharded training in the port against the reference's multi-device run.

One subprocess with four host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) writes the
reference's numbers (:func:`ref_runs`):

* ``jax.value_and_grad(lm.loss_fn)`` and the AdamW step (n = 1) at
  ``mesh_shape`` (2, 2) and (1, 4), and the n = 2 microbatched
  ``api.make_train_step`` at (2, 2), where ``lm.loss_fn`` dispatches every GEMM under
  ``shard_map``: reduced qwen2-0.5b, qwen3-moe-30b-a3b (4 experts:
  expert-parallel at tp 2 and 4; 3 experts: the TP fallback) and
  mamba2-370m, fp32 compute on ``xla``;
* ``launch.train.main`` at ``--mesh-data 2 --mesh-model 2`` (the
  GSPMD route: ``make_host_mesh`` plus ``activation_rules`` under
  ``jax.jit``), fp32 compute;
* ``compressed_allreduce`` under ``shard_map`` over a 4-way "data" axis,
  one shard's gradients scaled 100x (each shard scales the summed codes
  by its own scale);
* whether ``jax.device_put`` under a ``NamedSharding`` raises, for a
  list of shapes and specs.

The port runs the same trees (the subprocess's initial trees, leaf by
leaf) under
``launch.mesh.host_devices(4, "cpu")``.  Tolerances (those of
``tests/test_torch_train.py``): the loss 1e-5; each gradient leaf and
each new first moment within 1e-4 of the reference leaf's largest |g|.
Each new parameter is held within PARAM_LR x the step's learning rate:
AdamW's first update is ``lr * g / (|g| + eps)``, so an update lost or
of the other sign moves an element by lr or 2 x lr, while these steps
measured at most 0.12 x lr (qwen2's embedding table at n = 2).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import substrate
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models import api, lm
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.parallel import compression, sharding
from repro_torch.runtime import elastic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_LR = 0.5
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# case -> (arch, config overrides): the MoE at 4 experts is
# expert-parallel at tp 2 and tp 4, at 3 experts it takes the
# tensor-parallel fallback
CASES = {"qwen2": ("qwen2-0.5b", {}),
         "moe_ep": ("qwen3-moe-30b-a3b", {}),
         "moe_tp": ("qwen3-moe-30b-a3b", {"moe_experts": 3}),
         "mamba2": ("mamba2-370m", {})}
# (case, mesh, n): the n = 1 step at both meshes, the n = 2 microbatched
# step at (2, 2), the TP fallback at (2, 2) (each reference step is a
# compile of a few seconds, many more in a loaded test run)
RUNS = [(case, mesh) for case in CASES for mesh in MESHES
        if case != "moe_tp" or mesh == "2x2"]
STEPS = [(case, mesh, 1) for case, mesh in RUNS] + [
    (case, "2x2", 2) for case in ("qwen2", "moe_ep", "mamba2")]
B, S = 4, 32
TOTAL_STEPS = 10
TRAIN_ARGV = ["--reduced", "--steps", "2", "--batch", "4", "--seq", "32",
              "--mesh-data", "2", "--mesh-model", "2", "--log-every", "1"]
# (shape, spec) pairs placed on a (2, 2) ("data", "model") mesh
RESHARD = [((4, 6), ("data", "model")), ((3, 4), ("data", None)),
           ((4, 3), (None, "model")), ((8,), (("data", "model"),)),
           ((6,), (("data", "model"),)), ((4, 4), ("data", "data")),
           ((4,), ("pod",)), ((4,), (None, None)), ((), ()),
           ((2, 2, 2), (None, "model", "data")), ((5, 4), (None, "data"))]

SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, reduced
from repro.launch import train
from repro.models import api, lm
from repro.optim import OptConfig, adamw_init, adamw_update
from repro.parallel import compression

spec = json.loads(sys.argv[1])
arrays, out = {}, {}


def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        arrays[prefix + "|" + key] = np.asarray(leaf, np.float32)


def cfg_of(arch, over, mesh):
    c = reduced(ARCHS[arch], compute_dtype="float32", gemm_backend="xla",
                mesh_shape=tuple(mesh))
    if over.get("moe_experts"):
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, num_experts=over["moe_experts"]))
    return c


batch = {k: jnp.asarray(np.asarray(v, np.int32))
         for k, v in spec["batch"].items()}
for case, mname in spec["runs"]:
    arch, over = spec["cases"][case]
    mesh = spec["meshes"][mname]
    cfg = cfg_of(arch, over, mesh)
    oc = OptConfig(total_steps=spec["total_steps"])
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    save(case + "/init", params)

    def step1(p, o, b):
        (loss, _), g = jax.value_and_grad(
            lambda p: lm.loss_fn(cfg, p, b), has_aux=True)(p)
        new_p, new_o, stats = adamw_update(p, g, o, oc)
        return loss, g, new_p, new_o["m"], stats["lr"]

    loss, g, new_p, m, lr = jax.jit(step1)(params,
                                           adamw_init(params, oc), batch)
    tag = case + "/" + mname
    out[tag + "/1"] = dict(loss=float(loss), lr=float(lr))
    save(tag + "/grads", g)
    save(tag + "/1/params", new_p)
    save(tag + "/1/m", m)
    if [case, mname, 2] not in spec["steps"]:
        continue
    new_p, new_o, met = jax.jit(api.make_train_step(cfg, oc, 2))(
        params, adamw_init(params, oc), batch)
    out[tag + "/2"] = dict(loss=float(met["loss"]), lr=float(met["lr"]))
    save(tag + "/2/params", new_p)
    save(tag + "/2/m", new_o["m"])

np.savez(spec["npz"], **arrays)
if not spec["rest"]:
    json.dump(out, sys.stdout)
    sys.exit(0)
build = train.build_config
train.build_config = lambda a: dataclasses.replace(build(a),
                                                   compute_dtype="float32")
out["train_main"] = train.main(spec["train_argv"])

mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
g = {k: jnp.asarray(np.asarray(v, np.float32))
     for k, v in spec["comp_grads"].items()}
e = {k: jnp.asarray(np.asarray(v, np.float32), jnp.bfloat16)
     for k, v in spec["comp_errs"].items()}


def body(g, e):
    m, ne = compression.compressed_allreduce(
        jax.tree.map(lambda x: x[0], g), jax.tree.map(lambda x: x[0], e),
        "data")
    return (jax.tree.map(lambda x: x[None], m),
            jax.tree.map(lambda x: x[None], ne))


means, errs = jax.jit(jax.shard_map(
    body, mesh=mesh, in_specs=(P("data"), P("data")),
    out_specs=(P("data"), P("data"))))(g, e)
for k in g:
    arrays["comp|mean|" + k] = np.asarray(means[k])
    arrays["comp|err|" + k] = np.asarray(errs[k].astype(jnp.float32))

mesh2 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
raises = []
for shape, sp in spec["reshard"]:
    try:
        jax.device_put(np.zeros(shape, np.float32),
                       NamedSharding(mesh2, P(*[tuple(a) if isinstance(a, list)
                                                else a for a in sp])))
        raises.append(False)
    except Exception:
        raises.append(True)
out["reshard"] = raises
np.savez(spec["npz"], **arrays)
json.dump(out, sys.stdout)
"""


def batch_np():
    rng = np.random.RandomState(0)
    return {"tokens": rng.randint(2, 512, (B, S)),
            "labels": rng.randint(2, 512, (B, S))}


def comp_trees():
    """Per-shard gradient and error trees (a leading shard axis of 4);
    shard 2's gradients 100x the others'."""
    rng = np.random.RandomState(7)
    g = {"w": rng.randn(4, 16, 24).astype(np.float32),
         "b": (rng.randn(4, 9) * 1e-3).astype(np.float32)}
    for v in g.values():
        v[2] *= 100.0
    e = {k: (rng.randn(*v.shape) * 1e-2).astype(np.float32)
         for k, v in g.items()}
    return g, e


_REF = {}


def ref_runs(tmpdir):
    """The reference's numbers from two concurrent subprocesses with four
    host devices each (the runs split between them; the second also runs
    ``train.main``, the compression and the placements), cached for the
    process: the JSON they print and the arrays of their npz files, keyed
    ``case/mesh/what|leaf path`` (``case/init|...``: the initial tree)."""
    if not _REF:
        g, e = comp_trees()
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
            env.get("PYTHONPATH", "")
        procs = []
        for i, runs in enumerate((RUNS[:4], RUNS[4:])):
            npz = os.path.join(tmpdir, f"ref_sharded_train_{i}.npz")
            spec = dict(cases=CASES, meshes=MESHES, runs=runs, rest=i == 1,
                        steps=STEPS,
                        total_steps=TOTAL_STEPS,
                        batch={k: v.tolist() for k, v in batch_np().items()},
                        train_argv=TRAIN_ARGV, reshard=RESHARD, npz=npz,
                        comp_grads={k: v.tolist() for k, v in g.items()},
                        comp_errs={k: v.tolist() for k, v in e.items()})
            procs.append((npz, subprocess.Popen(
                [sys.executable, "-c", SCRIPT, json.dumps(spec)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=REPO)))
        _REF.update(json={}, arrays={})
        for npz, proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            assert proc.returncode == 0, stderr[-3000:]
            _REF["json"].update(json.loads(stdout.strip().splitlines()[-1]))
            with np.load(npz) as z:
                _REF["arrays"].update({k: z[k] for k in z.files})
    return _REF


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return ref_runs(str(tmp_path_factory.mktemp("ref")))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models run fastest on one intra-op thread: the suite
    runs several workers on the machine's cores, and torch's default (a
    thread per core in each worker) oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_of(case, mesh):
    arch, over = CASES[case]
    tc = reduced(get_config(arch), compute_dtype="float32",
                 gemm_backend="xla", mesh_shape=mesh)
    if over.get("moe_experts"):
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, num_experts=over["moe_experts"]))
    return tc


def port_tree(case):
    """The reference's initial tree (``lm.init_params`` at PRNGKey(0), from
    the subprocess) in the port, leaf by leaf."""
    tc = cfg_of(case, ())
    arrays = _REF["arrays"]
    return tree_lib.map_with_path(
        lambda path, t: torch.from_numpy(
            arrays[f"{case}/init|{tree_lib.path_key(path)}"]).to(t.dtype),
        lm.init_params(tc, seed=0, device="cpu"))


def port_batch():
    return {k: torch.tensor(v) for k, v in batch_np().items()}


def assert_close(ref, prefix, tree, atol_of):
    """Leaf by leaf against the reference's arrays under ``prefix``."""
    want = {k.split("|", 1)[1]: v for k, v in ref["arrays"].items()
            if k.split("|", 1)[0] == prefix}
    got = {tree_lib.path_key(p): t.detach().float().numpy()
           for p, t in tree_lib.leaves_with_path(tree)}
    assert sorted(got) == sorted(want), prefix
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=0, atol=atol_of(w),
                                   err_msg=f"{prefix} {key}")


def _rel(w):
    return GRAD_RTOL * float(np.abs(w).max()) if w.size else 0.0


@pytest.mark.parametrize("case,mesh", RUNS, ids=[f"{c}-{m}" for c, m in RUNS])
def test_value_and_grad_under_mesh_matches_reference(ref, case, mesh):
    """The loss and every gradient leaf of the sharded dispatch (each
    shard's GEMM its own call: columns or the contraction over "model",
    rows over "data", expert-parallel banks) against the reference's
    ``shard_map`` run."""
    tc = cfg_of(case, MESHES[mesh])
    with mesh_lib.host_devices(4, "cpu"):
        (loss, _), grads = api.value_and_grad(tc, port_tree(case),
                                              port_batch())
    tag = f"{case}/{mesh}"
    assert abs(float(loss) - ref["json"][tag + "/1"]["loss"]) <= LOSS_ATOL
    assert_close(ref, tag + "/grads", grads, _rel)


@pytest.mark.parametrize("case,mesh,n_micro", STEPS,
                         ids=[f"{c}-{m}-{n}" for c, m, n in STEPS])
def test_train_step_under_mesh_matches_reference(ref, case, mesh, n_micro):
    """One AdamW step (n = 1, and n = 2 stride-split microbatches) under
    the mesh: the loss, the new first moments and the new parameters."""
    tc = cfg_of(case, MESHES[mesh])
    oc = OptConfig(total_steps=TOTAL_STEPS)
    tp = port_tree(case)
    with mesh_lib.host_devices(4, "cpu"):
        new_p, new_o, met = api.make_train_step(tc, oc, n_micro)(
            tp, adamw_init(tp, oc), port_batch())
    tag = f"{case}/{mesh}/{n_micro}"
    want = ref["json"][tag]
    assert abs(float(met["loss"]) - want["loss"]) <= LOSS_ATOL
    assert_close(ref, tag + "/m", new_o["m"], _rel)
    assert_close(ref, tag + "/params", new_p,
                 lambda w: PARAM_LR * want["lr"])


def test_train_main_on_a_mesh_matches_reference(ref, monkeypatch, capsys):
    """``train.main --mesh-data 2 --mesh-model 2`` under an outer
    ``host_devices(4)`` scope: the (2, 2) mesh is built, the loop runs
    under the activation rules and the GEMMs dispatch per shard; each
    step's loss against the reference's GSPMD run of the same CLI (its
    tree, fp32 compute in both)."""
    build = train.build_config
    monkeypatch.setattr(train, "build_config", lambda a: dataclasses.replace(
        build(a), compute_dtype="float32"))
    tree = port_tree("qwen2")
    monkeypatch.setattr(lm, "init_params",
                        lambda cfg, seed=0, device=None: tree)
    seen = []
    real = sharding.constrain

    def spy(x, name):
        if sharding.constraint_spec(name, x.ndim) is not None:
            seen.append(name)
        return real(x, name)

    monkeypatch.setattr(sharding, "constrain", spy)
    with mesh_lib.host_devices(4, "cpu"):
        losses = train.main(TRAIN_ARGV + ["--device", "cpu"])
    assert "mesh: data=2 x model=2 over 4 devices" in capsys.readouterr().out
    want = ref["json"]["train_main"]
    assert len(losses) == len(want) == 2
    np.testing.assert_allclose(losses, want, rtol=0, atol=LOSS_ATOL)
    assert substrate.SITE_PLANS["attn.wq"].shard.cols == 2
    assert substrate.SITE_PLANS["attn.wq"].shard.rows == 2
    assert {"hidden", "logits"} <= set(seen)


def test_compressed_allreduce_matches_reference_shard_map(ref):
    """Each shard's mean and new error bit for bit against the reference's
    ``compressed_allreduce`` under ``shard_map`` (XLA's compiled
    arithmetic: the scale times fp32(1/127), the residual one fused
    multiply-add)."""
    g, e = comp_trees()
    grads = [{k: torch.tensor(v[i]) for k, v in g.items()} for i in range(4)]
    errs = [{k: torch.tensor(v[i]).to(torch.bfloat16) for k, v in e.items()}
            for i in range(4)]
    means, new_errs = compression.compressed_allreduce(grads, errs)
    arrays = ref["arrays"]
    for k in g:
        for i in range(4):
            want = arrays["comp|mean|" + k][i]
            assert np.array_equal(means[i][k].numpy().view(np.uint32),
                                  want.view(np.uint32)), (k, i)
            assert np.array_equal(new_errs[i][k].float().numpy(),
                                  arrays["comp|err|" + k][i]), (k, i)


def test_compressed_allreduce_scales_by_each_shards_own_scale(ref):
    """The reference's behaviour, reproduced: shard i's "mean" is the int32
    sum of every shard's codes times shard i's OWN scale / n, so shards
    whose scales differ (shard 2's gradients are 100x the others') get
    different results — about 100x apart here, and not the mean of the
    gradients."""
    g, e = comp_trees()
    grads = [{k: torch.tensor(v[i]) for k, v in g.items()} for i in range(4)]
    errs = [{k: torch.tensor(v[i]).to(torch.bfloat16) for k, v in e.items()}
            for i in range(4)]
    means, _ = compression.compressed_allreduce(grads, errs)
    q, s, _ = zip(*[compression.compress(gr, er, compiled=True)
                    for gr, er in zip(grads, errs)])
    for k in g:
        summed = sum(qq[k].to(torch.int32) for qq in q)
        for i in range(4):
            want = summed.float() * s[i][k] / torch.tensor(4.0)
            assert torch.equal(means[i][k], want)
        assert float(s[2][k]) > 10 * float(s[0][k])
        assert not torch.equal(means[2][k], means[0][k])
        np.testing.assert_array_equal(means[2][k].numpy(),
                                      ref["arrays"]["comp|mean|" + k][2])
    with pytest.raises(ValueError, match="per shard"):
        compression.compressed_allreduce(grads, errs[:3])


@pytest.mark.parametrize("i", range(len(RESHARD)),
                         ids=[f"{s}-{p}" for s, p in RESHARD])
def test_reshard_raises_where_device_put_raises(ref, i):
    """``runtime.elastic.reshard`` on a (2, 2) mesh of logical devices
    raises exactly where the reference's ``jax.device_put`` under that
    ``NamedSharding`` raises, and otherwise returns the leaf on the mesh's
    home device."""
    shape, spec = RESHARD[i]
    with mesh_lib.host_devices(4, "cpu"):
        mesh, _ = elastic.replan_mesh(model_parallel=2)
    x = torch.zeros(shape)
    if ref["json"]["reshard"][i]:
        with pytest.raises(ValueError):
            elastic.reshard({"x": x}, {"x": spec}, mesh)
    else:
        out = elastic.reshard({"x": x}, {"x": spec}, mesh)
        assert out["x"] is x


def test_reshard_places_a_param_tree_under_its_specs(ref):
    """A reduced model's tree under ``api.param_pspecs`` (every
    non-dividing axis already dropped) reshards onto a replanned mesh
    without error, leaf for leaf."""
    tc = cfg_of("moe_ep", ())
    tp = port_tree("moe_ep")
    with mesh_lib.host_devices(4, "cpu"):
        mesh, state = elastic.replan_mesh(model_parallel=2)
    out = elastic.reshard(tp, api.param_pspecs(tc, mesh), mesh)
    assert state.mesh_shape == (2, 2)
    assert all(a is b for a, b in zip(tree_lib.leaves(out),
                                      tree_lib.leaves(tp)))


def test_weight_memo_is_bypassed_under_autograd(ref):
    """Under a mesh, a weight that requires a gradient takes a fresh
    column-block copy at every dispatch (the memo holds none), so a
    second ``value_and_grad`` on fresh leaves, and the second microbatch,
    get gradients equal to the first's; without gradients the memo is
    used as before."""
    tc = cfg_of("qwen2", (1, 2))
    tp = port_tree("qwen2")
    substrate.clear_shard_cache()
    with mesh_lib.host_devices(2, "cpu"):
        (l1, _), g1 = api.value_and_grad(tc, tp, port_batch())
        (l2, _), g2 = api.value_and_grad(tc, tp, port_batch())
        assert substrate.shard_cache_info()["blocks"] == 0
        b = port_batch()
        # the stride split gives each of two microbatches the batch b
        twice = {k: torch.repeat_interleave(v, 2, dim=0)
                 for k, v in b.items()}
        oc = OptConfig(total_steps=TOTAL_STEPS)
        _, o1, _ = api.make_train_step(tc, oc)(tp, adamw_init(tp, oc), b)
        _, o2, _ = api.make_train_step(tc, oc, 2)(tp, adamw_init(tp, oc),
                                                  twice)
        with torch.no_grad():
            lm.forward(tc, tp, b)
        assert substrate.shard_cache_info()["blocks"] > 0
    substrate.clear_shard_cache()
    assert float(l1) == float(l2)
    assert all(torch.equal(a, c) for a, c in zip(tree_lib.leaves(g1),
                                                 tree_lib.leaves(g2)))
    for a, c in zip(tree_lib.leaves(o1["m"]), tree_lib.leaves(o2["m"])):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-6)
