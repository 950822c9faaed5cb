"""End-to-end trainer of the port.

Port of the reference's ``launch/train.py``: the same CLI and loop —
``lm.init_params``, AdamW, the deterministic data pipeline, async
checkpoints every ``--ckpt-every`` steps and resume from ``--ckpt-dir`` —
on one device.  It runs on the card unless given ``--device cpu`` (and
raises without one); the step is ``models.api.make_train_step`` in eager
PyTorch on the config's ``gemm_backend`` (``xla``, as the reference
trains: the collapse backends raise).

``--mesh-data`` / ``--mesh-model`` clamp to the devices of ``--device``'s
type, as the reference's ``make_host_mesh`` does; a mesh of more than one
device would need sharded training (ROADMAP Queue 1 item 7b) and raises
rather than train unsharded.

Example (the CPU smoke run):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced --steps 20 --batch 4 --seq 64
and full-width qwen2-0.5b on the card:
  PYTHONPATH=src python -m repro_torch.launch.train --steps 100
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, lm
from repro_torch.optim import OptConfig, adamw_init


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data-path", default="")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrayflex-report", action="store_true",
                    help="print the ArrayFlex GEMM plan for this model")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    return ap


def build_config(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
        overrides["head_dim"] = max(16, args.d_model // cfg.n_heads)
    if args.n_layers:
        overrides["n_layers"] = args.n_layers
    if args.d_ff:
        overrides["d_ff"] = args.d_ff
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def arrayflex_report(cfg, seq: int, batch: int) -> list:
    """The reference's ``--arrayflex-report`` lines, from the port's
    planner: the model's savings and its first eight GEMM plans."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import planner
    rep = planner.plan_model(cfg, ShapeConfig("train", seq, batch, "train"))
    lines = [f"ArrayFlex plan: latency saving "
             f"{rep['latency_saving']*100:.1f}% "
             f"power saving {rep['power_saving']*100:.1f}% "
             f"EDP gain {rep['edp_gain']:.2f}x"]
    for p in rep["plans"][:8]:
        lines.append(f"  {p.gemm.name:14s} M={p.gemm.M:6d} N={p.gemm.N:6d} "
                     f"T={p.gemm.T:8d} k={p.k} (khat={p.k_hat:.2f})")
    return lines


def host_mesh(data: int, model: int, device) -> mesh_lib.DeviceMesh:
    """The reference's clamped ``make_host_mesh(data, model)`` over the
    physical devices of ``device``'s type; more than one device raises."""
    n = len(mesh_lib.physical_devices(device.type))
    with mesh_lib.host_devices(n, device):
        mesh = mesh_lib.make_host_mesh(data, model)
    if mesh.size > 1:
        raise NotImplementedError(
            f"--mesh-data {data} --mesh-model {model} clamps to a "
            f"{dict(mesh.shape)} mesh: sharded training is not ported yet "
            f"(ROADMAP Queue 1 item 7b); train on one device")
    return mesh


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = build_config(args)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"layers={cfg.n_layers} d={cfg.d_model}")

    if args.arrayflex_report:
        for line in arrayflex_report(cfg, args.seq, args.batch):
            print(line)

    host_mesh(args.mesh_data, args.mesh_model, dev)
    opt_cfg = OptConfig(lr=args.lr, total_steps=max(args.steps, 10))
    params = lm.init_params(cfg, seed=args.seed, device=dev)
    opt_state = adamw_init(params, opt_cfg)
    train_step = api.make_train_step(cfg, opt_cfg)

    dc = DataConfig(seq_len=args.seq, global_batch=args.batch,
                    vocab_size=cfg.vocab_size, seed=args.seed,
                    path=args.data_path)
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        restored, rstep = ckpt.restore({"params": params, "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start_step = rstep
            print(f"resumed from step {start_step}")
    pipe = make_pipeline(dc, start_step=start_step)

    losses = []
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            _, batch = next(pipe)
            batch = {k: torch.as_tensor(v).to(dev, torch.int64)
                     for k, v in batch.items()}
            params, opt_state, metrics = train_step(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.time() - t0
                toks = args.batch * args.seq * (step - start_step + 1)
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"tok/s {toks/max(dt,1e-9):,.0f}")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save_async(step + 1,
                                {"params": params, "opt": opt_state})
        if ckpt:
            ckpt.wait()
    finally:
        pipe.close()
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
