"""The port's data pipeline and checkpoints against the reference's.

* ``SyntheticLM`` / ``MemmapCorpus`` batches equal the reference's bit for
  bit, whole and sharded over hosts; the ``Prefetcher`` resumes at a
  step with the reference's batch.
* ``CheckpointManager`` round-trips a tree of tensors (fp32, bf16, int32)
  and numpy leaves bit for bit, keeps the newest ``keep`` steps, writes in
  the background (``save_async`` snapshots before it returns) and never
  leaves a half-written file visible.
* Across the packages: a checkpoint of (params, opt) that the reference
  wrote after one train step restores in the port bit for bit, and the
  port's next step matches the reference's next step within
  ``test_torch_train.py``'s tolerances; a checkpoint the port wrote
  restores in the reference bit for bit (bf16 leaves included).
* ``convert.opt_state_from_reference`` starts the port from the
  reference's optimizer state: the next step matches as above (the
  second moment, g squared, within twice the first's tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.data import (DataConfig as RefDataConfig,
                        MemmapCorpus as RefMemmap, SyntheticLM as RefSynth)
from repro.models import api as ref_api
from repro.optim import OptConfig as RefOptConfig, adamw_init as ref_init
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.data import (DataConfig, MemmapCorpus, SyntheticLM,
                              make_pipeline)
from repro_torch.models import api, convert, lm
from repro_torch.optim import OptConfig, adamw_init
from test_torch_train import (GRAD_RTOL, LOSS_ATOL, assert_tree_close,
                              batch_np, cfgs, port_batch, port_leaves,
                              ref_batch, ref_leaves, trees)

DC = dict(seq_len=16, global_batch=8, vocab_size=100, seed=7)


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_synthetic_batches_equal_reference(hosts):
    for h in range(hosts):
        for step in (0, 3, 17):
            got = SyntheticLM(DataConfig(**DC), h, hosts).batch_at(step)
            want = RefSynth(RefDataConfig(**DC), h, hosts).batch_at(step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("hosts", [1, 2])
def test_memmap_batches_equal_reference(tmp_path, hosts):
    path = str(tmp_path / "toks.bin")
    np.random.RandomState(0).randint(0, 1000, 5000).astype(
        np.int32).tofile(path)
    kw = dict(seq_len=16, global_batch=4, path=path)
    for h in range(hosts):
        got = MemmapCorpus(DataConfig(**kw), h, hosts).batch_at(5)
        want = RefMemmap(RefDataConfig(**kw), h, hosts).batch_at(5)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_resumes_at_the_reference_batch():
    pipe = make_pipeline(DataConfig(**DC), start_step=5)
    try:
        for step in (5, 6):
            got_step, batch = next(pipe)
            assert got_step == step
            np.testing.assert_array_equal(
                batch["tokens"],
                RefSynth(RefDataConfig(**DC)).batch_at(step)["tokens"])
    finally:
        pipe.close()


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(2, 3, generator=g),
            "blocks": ({"w": torch.randn(2, 2, generator=g)
                        .to(torch.bfloat16)},),
            "step": torch.tensor(7, dtype=torch.int32),
            "acc": np.float64(2.5)}


def _assert_equal(got, want):
    for (pg, g), (pw, w) in zip(tree_lib.leaves_with_path(got),
                                tree_lib.leaves_with_path(want)):
        assert pg == pw
        if torch.is_tensor(w):
            assert g.dtype == w.dtype and torch.equal(g, w), pg
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, tree)
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    template = tree_lib.tree_map(
        lambda t: torch.zeros_like(t) if torch.is_tensor(t)
        else np.float64(0), tree)
    restored, step = mgr.restore(template)
    assert step == 30
    _assert_equal(restored, tree)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000020_h0.npz", "ckpt_00000030_h0.npz", "manifest_h0.json"]


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.ones(4)}
    mgr.save_async(5, tree)
    tree["x"].add_(1.0)                  # the live tensor moves on
    mgr.wait()
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore({"x": torch.zeros(4)})
    assert torch.equal(restored["x"], torch.ones(4))
    assert CheckpointManager(str(tmp_path / "empty")).restore(tree) == \
        (None, None)


def test_save_pytree_is_atomic(tmp_path):
    path = str(tmp_path / "t.npz")
    save_pytree(_tree(), path)
    assert [p.name for p in tmp_path.iterdir()] == ["t.npz"]
    _assert_equal(load_pytree(_tree(), path), _tree())


@pytest.fixture(scope="module")
def one_ref_step():
    """The reduced qwen2 and the reference's state after one train step,
    the step's successor and its output."""
    rc, tc = cfgs("qwen2-0.5b")
    rp, _ = trees(rc, tc)
    roc = RefOptConfig(total_steps=10)
    step = jax.jit(ref_api.make_train_step(rc, roc))
    b1, b2 = batch_np(rc, seed=3), batch_np(rc, seed=4)
    rp1, ro1, _ = step(rp, ref_init(rp, roc), ref_batch(b1))
    rp2, ro2, rmet2 = step(rp1, ro1, ref_batch(b2))
    return dict(rc=rc, tc=tc, rp1=rp1, ro1=ro1, rp2=rp2, ro2=ro2,
                rmet2=rmet2, b2=b2)


def test_reference_checkpoint_restores_in_the_port(tmp_path, one_ref_step):
    r = one_ref_step
    RefManager(str(tmp_path)).save(1, {"params": r["rp1"], "opt": r["ro1"]})
    tc = r["tc"]
    oc = OptConfig(total_steps=10)
    params = lm.init_params(tc, seed=5, device="cpu")
    template = {"params": params, "opt": adamw_init(params, oc)}
    restored, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 1 and int(restored["opt"]["step"]) == 1
    assert restored["opt"]["step"].dtype == torch.int32
    for got, want in ((restored["params"], r["rp1"]),
                      (restored["opt"]["m"], r["ro1"]["m"]),
                      (restored["opt"]["v"], r["ro1"]["v"])):
        for (kg, g), (kw, w) in zip(port_leaves(got), ref_leaves(want)):
            assert kg == kw
            np.testing.assert_array_equal(g, w)
    p2, o2, met = api.make_train_step(tc, oc)(
        restored["params"], restored["opt"], port_batch(r["b2"]))
    rmet = r["rmet2"]
    assert abs(float(met["loss"]) - float(rmet["loss"])) <= LOSS_ATOL
    assert_tree_close(o2["m"], r["ro2"]["m"], GRAD_RTOL, "m")
    lr = float(rmet["lr"])
    for (key, g), (_, w) in zip(port_leaves(p2), ref_leaves(r["rp2"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr + 1e-7,
                                   err_msg=key)


def test_port_checkpoint_restores_in_the_reference(tmp_path, one_ref_step):
    r = one_ref_step
    tc = r["tc"]
    np_tree = jax.tree_util.tree_map(np.asarray, r["rp1"])
    params = convert.params_from_reference(tc, np_tree, device="cpu")
    oc = OptConfig(total_steps=10, moment_dtype="bfloat16")
    state = {"params": params, "opt": adamw_init(params, oc),
             "half": {"w": params["embed"]["table"].to(torch.bfloat16)}}
    CheckpointManager(str(tmp_path)).save(4, state)
    roc = RefOptConfig(total_steps=10, moment_dtype="bfloat16")
    template = {"params": jax.tree_util.tree_map(jnp.zeros_like, r["rp1"]),
                "opt": ref_init(r["rp1"], roc),
                "half": {"w": jnp.zeros(params["embed"]["table"].shape,
                                        jnp.bfloat16)}}
    restored, step = RefManager(str(tmp_path)).restore(template)
    assert step == 4
    assert restored["half"]["w"].dtype == jnp.bfloat16
    assert restored["opt"]["m"]["embed"]["table"].dtype == jnp.bfloat16
    for got, want in ((restored["params"], params),
                      (restored["half"], state["half"]),
                      (restored["opt"]["m"], state["opt"]["m"])):
        for (kg, g), (kw, w) in zip(ref_leaves(got), port_leaves(want)):
            assert kg == kw
            np.testing.assert_array_equal(g, w)


def test_opt_state_from_reference_continues_the_reference(one_ref_step):
    """``convert.opt_state_from_reference`` with ``params_from_reference``:
    the port's step from the reference's state after one step matches
    the reference's second step."""
    r = one_ref_step
    tc = r["tc"]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params = convert.params_from_reference(tc, to_np(r["rp1"]),
                                           device="cpu")
    opt = convert.opt_state_from_reference(tc, to_np(r["ro1"]),
                                           device="cpu")
    assert set(opt) == {"m", "v", "step"} and int(opt["step"]) == 1
    assert opt["step"].dtype == torch.int32
    p2, o2, met = api.make_train_step(tc, OptConfig(total_steps=10))(
        params, opt, port_batch(r["b2"]))
    assert abs(float(met["loss"]) - float(r["rmet2"]["loss"])) <= LOSS_ATOL
    assert_tree_close(o2["m"], r["ro2"]["m"], GRAD_RTOL, "m")
    # v holds g squared: twice g's relative error
    assert_tree_close(o2["v"], r["ro2"]["v"], 2 * GRAD_RTOL, "v")
