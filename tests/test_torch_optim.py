"""The port's AdamW (``repro_torch.optim``) against the reference's.

Both packages start from one parameter tree and are fed the same seeded
gradients step after step (so the optimizer alone is compared): the new
parameters, first and second moments, fp32 masters, step count,
gradient norm and learning rate agree within 1e-6 of each leaf's largest
|value| (the update runs in fp32 in the reference's operation order; the
last bits of XLA's and torch's fp32 elementwise ops may differ), with
fp32 and bf16 moments, with and without master weights (bf16 live
parameters), and with the clip active and not.  ``lr_schedule`` at 0,
in the warmup, at its end and past the end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import (OptConfig as RefOptConfig, adamw_init as ref_init,
                         adamw_update as ref_update,
                         lr_schedule as ref_lr)
from repro_torch import tree as tree_lib
from repro_torch.optim import OptConfig, adamw_init, adamw_update, lr_schedule
from test_torch_train import ref_leaves

RTOL = 1e-6
SHAPES = {"embed": {"table": (32, 8)},
          "blocks": ({"ln": {"scale": (3, 8)}, "w": (3, 8, 16),
                      "b": (3, 16)},),
          "final": {"scale": (8,)}}


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    if isinstance(shapes, tuple) and isinstance(shapes[0], dict):
        return tuple(_tree(v, fn) for v in shapes)
    return fn(shapes)


def _np_tree(rng, scale=1.0):
    return _tree(SHAPES, lambda s: (scale * rng.standard_normal(s))
                 .astype(np.float32))


def _port(np_tree, dtype):
    return _tree_map_np(lambda a: torch.tensor(a).to(dtype), np_tree)


def _ref(np_tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), np_tree)


def _tree_map_np(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map_np(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map_np(fn, v) for v in tree)
    return fn(tree)


def _close(got, want, what):
    got = [(tree_lib.path_key(p), t.float().numpy())
           for p, t in tree_lib.leaves_with_path(got)]
    want = ref_leaves(want)
    assert [k for k, _ in got] == [k for k, _ in want], what
    for (key, g), (_, w) in zip(got, want):
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale,
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped",
                                                           "clipped"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("master", [False, True])
def test_adamw_update_matches_reference(master, moments, grad_scale):
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=8, moment_dtype=moments,
              master_weights=master)
    rcfg, cfg = RefOptConfig(**kw), OptConfig(**kw)
    pdt = (jnp.bfloat16, torch.bfloat16) if master else \
        (jnp.float32, torch.float32)
    rng = np.random.RandomState(0)
    p0 = _np_tree(rng)
    rp, tp = _ref(p0, pdt[0]), _port(p0, pdt[1])
    rs, ts = ref_init(rp, rcfg), adamw_init(tp, cfg)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for step in range(1, 7):
        g = _np_tree(rng, grad_scale)
        rp, rs, rstats = ref_update(rp, _ref(g, pdt[0]), rs, rcfg)
        tp, ts, stats = adamw_update(tp, _port(g, pdt[1]), ts, cfg)
        assert int(ts["step"]) == int(rs["step"]) == step
        for k in ("grad_norm", "lr"):
            assert abs(float(stats[k]) / float(rstats[k]) - 1) <= RTOL, k
        _close(tp, rp, f"params step {step}")
        for k in ("m", "v") + (("master",) if master else ()):
            _close(ts[k], rs[k], f"{k} step {step}")
        leaf = tree_lib.leaves(ts["m"])[0]
        assert leaf.dtype == (torch.bfloat16 if moments == "bfloat16"
                              else torch.float32)
        assert tree_lib.leaves(tp)[0].dtype == pdt[1]
    assert ("master" in ts) == master
    if master:
        assert tree_lib.leaves(ts["master"])[0].dtype == torch.float32


def test_update_writes_no_input():
    cfg = OptConfig(warmup_steps=1)
    rng = np.random.RandomState(1)
    p = _port(_np_tree(rng), torch.float32)
    g = _port(_np_tree(rng), torch.float32)
    s = adamw_init(p, cfg)
    before = [t.clone() for t in tree_lib.leaves((p, s))]
    adamw_update(p, g, s, cfg)
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_lib.leaves((p, s))))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 150])
def test_lr_schedule_matches_reference(step):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100)
    want = float(ref_lr(RefOptConfig(**kw), jnp.int32(step)))
    got = lr_schedule(OptConfig(**kw), step)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= RTOL * max(abs(want), 1e-30)
    tensor_step = lr_schedule(OptConfig(**kw),
                              torch.tensor(step, dtype=torch.int32))
    assert float(tensor_step) == float(got)
