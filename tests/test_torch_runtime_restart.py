"""The checkpoint-restart loop of the port: ``runtime.FaultToleranceManager``
driving the port's ``checkpoint.CheckpointManager``.

The reference's ``tests/test_runtime.py`` restart and cold-restart cases
and ``tests/test_substrates.py``'s restart case, each run on the port and
on the reference with the same failures injected: the same steps,
restarts and final state.  Then a reduced qwen2-0.5b trained 8 steps on
the CPU with a failure at step 5 (checkpoints every 3 steps) ends with
parameters and optimizer state equal to an uninterrupted run's, bit for
bit.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.runtime import (FaultToleranceManager as RefFTM,
                           HeartbeatMonitor as RefMonitor)
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import api, lm
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.runtime import FaultToleranceManager, HeartbeatMonitor
from test_torch_train import cfgs

PACKAGES = {"port": (CheckpointManager, HeartbeatMonitor,
                     FaultToleranceManager),
            "reference": (RefManager, RefMonitor, RefFTM)}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class CountingSource:
    """batch_at(step) -> the step index: state == the sum of consumed
    batches, so a lost or replayed batch shows in the final sum."""

    def batch_at(self, step):
        return step


def _ftm(pkg, directory, ckpt_every=3, keep=3, **kw):
    mgr_cls, mon_cls, ftm_cls = PACKAGES[pkg]
    return ftm_cls(mgr_cls(str(directory), keep=keep),
                   mon_cls(1, clock=FakeClock()), ckpt_every=ckpt_every,
                   **kw)


def _step_fn(state, batch):
    return {"acc": state["acc"] + np.float64(batch)}


def _once(at, exc=RuntimeError, msg="simulated node failure"):
    fired = []

    def inject(step):
        if step == at and not fired:
            fired.append(step)
            raise exc(msg)
    return inject


def _both(tmp_path, fn):
    return {pkg: fn(pkg, tmp_path / pkg) for pkg in PACKAGES}


@pytest.mark.parametrize("fail_step", list(range(4, 10)))
def test_restart_resumes_exact_state(tmp_path, fail_step):
    def run(pkg, d):
        ft = _ftm(pkg, d)
        state, steps, restarts = ft.run(
            {"acc": np.float64(0)}, _step_fn, CountingSource(), 10,
            inject_failure=_once(fail_step))
        return float(state["acc"]), steps, restarts
    out = _both(tmp_path, run)
    assert out["port"] == out["reference"] == (sum(range(10)), 10, 1)


def test_failure_before_first_checkpoint_raises_by_default(tmp_path):
    def run(pkg, d):
        ft = _ftm(pkg, d)
        with pytest.raises(RuntimeError, match="early crash"):
            ft.run({"acc": np.float64(0)}, _step_fn, CountingSource(), 10,
                   inject_failure=_once(1, msg="early crash"))
        return ft.restarts, ft.cold_restarts
    out = _both(tmp_path, run)
    assert out["port"] == out["reference"] == (1, 0)


def test_cold_restart_opt_in_replays_from_zero(tmp_path):
    def run(pkg, d):
        ft = _ftm(pkg, d)
        state, steps, restarts = ft.run(
            {"acc": np.float64(0)}, _step_fn, CountingSource(), 10,
            inject_failure=_once(1), cold_restart="restart")
        return float(state["acc"]), steps, restarts, ft.cold_restarts
    out = _both(tmp_path, run)
    assert out["port"] == out["reference"] == (sum(range(10)), 10, 1, 1)


def test_resume_across_manager_instances(tmp_path):
    """A fresh manager over the same directory resumes from the durable
    step (process death, not an in-process restart)."""
    def run(pkg, d):
        ft1 = _ftm(pkg, d, max_restarts=0)
        with pytest.raises(OSError):
            ft1.run({"acc": np.float64(0)}, _step_fn, CountingSource(), 10,
                    inject_failure=_once(7, OSError, "process killed"))
        # the dead process's last background write ends before the next
        # process starts (in one process, its thread would race ft2's)
        ft1.ckpt_manager.wait()
        ft2 = _ftm(pkg, d)
        state, steps, restarts = ft2.run({"acc": np.float64(0)}, _step_fn,
                                         CountingSource(), 10)
        return float(state["acc"]), steps, restarts
    out = _both(tmp_path, run)
    assert out["port"] == out["reference"] == (sum(range(10)), 10, 0)


def test_fault_manager_restarts_from_checkpoint(tmp_path):
    """``test_substrates.py``'s case: ckpt every 5, a crash at 12, restart
    from 10; a tensor state counts the steps run."""
    def run(pkg, d):
        ft = _ftm(pkg, d, ckpt_every=5, keep=5)
        acc = (torch.zeros((), dtype=torch.float32) if pkg == "port"
               else np.float32(0.0))
        state, steps, restarts = ft.run(
            {"acc": acc}, lambda st, b: {"acc": st["acc"] + 1.0},
            CountingSource(), 20, inject_failure=_once(12))
        return float(state["acc"]), steps, restarts
    out = _both(tmp_path, run)
    assert out["port"] == out["reference"] == (20.0, 20, 1)


def _train(tmp_path, inject):
    """8 steps of reduced qwen2-0.5b (fp32, xla) under the restart loop,
    checkpoints every 3 steps."""
    _, tc = cfgs("qwen2-0.5b")
    oc = OptConfig(warmup_steps=2, total_steps=10)
    params = lm.init_params(tc, seed=0, device="cpu")
    step = api.make_train_step(tc, oc)
    data = SyntheticLM(DataConfig(seq_len=16, global_batch=2,
                                  vocab_size=tc.vocab_size, seed=0))

    def step_fn(state, batch):
        b = {k: torch.as_tensor(v, dtype=torch.int64)
             for k, v in batch.items()}
        p, o, _ = step(state["params"], state["opt"], b)
        return {"params": p, "opt": o}

    ft = _ftm("port", tmp_path, ckpt_every=3)
    state, steps, restarts = ft.run(
        {"params": params, "opt": adamw_init(params, oc)}, step_fn, data,
        8, inject_failure=inject)
    return state, steps, restarts


def test_train_restart_is_bit_exact(tmp_path):
    clean, steps, restarts = _train(tmp_path / "clean", None)
    assert (steps, restarts) == (8, 0)
    faulted, steps, restarts = _train(tmp_path / "faulted", _once(5))
    assert (steps, restarts) == (8, 1)
    assert int(faulted["opt"]["step"]) == int(clean["opt"]["step"]) == 8
    a, b = tree_lib.leaves(faulted), tree_lib.leaves(clean)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
