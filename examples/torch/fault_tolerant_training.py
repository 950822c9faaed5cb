"""Fault-tolerant training demo on the PyTorch port: the
FaultToleranceManager drives a train loop through an injected node
failure; training resumes from the last async checkpoint and reaches the
target step with no lost or duplicated batches (the data pipeline is a
pure function of the step index).

Runs on the card unless ``--device cpu`` is given.  ``run`` takes the step
count, the failing step (None: no failure) and the checkpoint cadence.

Run:  PYTHONPATH=src python examples/torch/fault_tolerant_training.py [--device cpu]
"""
import argparse
import shutil

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import api, lm
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.runtime import FaultToleranceManager, HeartbeatMonitor

CKPT_DIR = "results/ckpt_ft_example"


def run(device="cuda", steps: int = 40, fail_at=25, ckpt_every: int = 10,
        ckpt_dir: str = CKPT_DIR, log=print):
    """Train reduced qwen2-0.5b for ``steps`` steps under the
    FaultToleranceManager, one failure injected before step ``fail_at``.
    Returns the final state, the steps reached, the restarts and the last
    loss."""
    dev = resolve_device(device)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = reduced(ARCHS["qwen2-0.5b"])
    oc = OptConfig(total_steps=60)
    params = lm.init_params(cfg, seed=0, device=dev)
    opt = adamw_init(params, oc)
    dc = DataConfig(seq_len=64, global_batch=4, vocab_size=cfg.vocab_size)
    src = SyntheticLM(dc)
    train_step = api.make_train_step(cfg, oc)

    state = {"params": params, "opt": opt}
    last = {}

    def step_fn(st, batch):
        batch = {k: torch.as_tensor(v).to(dev, torch.int64)
                 for k, v in batch.items()}
        p, o, m = train_step(st["params"], st["opt"], batch)
        last["loss"] = float(m["loss"])
        return {"params": p, "opt": o}

    crashed = {"done": False}

    def inject(step):
        if step == fail_at and not crashed["done"]:
            crashed["done"] = True
            log(f"  !! injected node failure at step {step}")
            raise RuntimeError("simulated hardware failure")

    mgr = CheckpointManager(ckpt_dir, keep=3)
    ft = FaultToleranceManager(mgr, HeartbeatMonitor(1),
                               ckpt_every=ckpt_every)
    state, reached, restarts = ft.run(state, step_fn, src, steps,
                                      inject_failure=inject)
    log(f"reached step {reached} with {restarts} restart(s); "
        f"final loss {last['loss']:.4f}")
    assert reached == steps and restarts == (fail_at is not None)
    log("example complete")
    return dict(state=state, steps=reached, restarts=restarts,
                loss=last["loss"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
