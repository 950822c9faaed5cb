"""End-to-end driver: train a ~100M-param dense LM for a few hundred steps
on the synthetic pipeline, with checkpoints and the ArrayFlex GEMM plan
report — on the PyTorch port.

Run:  PYTHONPATH=src python examples/torch/train_lm.py [--steps 200] [--device cpu]

(~100M params: 8 layers x d_model 768 x vocab 32k, on the card by default.
On the CPU this takes a while at full size; --small trains a 10M model
instead.)  Each run starts afresh: the checkpoint directory is cleared
first, as fault_tolerant_training.py clears its own.
"""
import argparse
import shutil

from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import train

CKPT_DIR = "results/ckpt_example"


def run(device="cuda", steps: int = 200, small: bool = False,
        ckpt_dir: str = CKPT_DIR, log=print):
    """``train.main`` at the example's size on ``device``.  Returns the
    losses and the ``--arrayflex-report`` lines the trainer printed."""
    dev = resolve_device(device)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if small:
        argv = ["--arch", "qwen2-0.5b", "--reduced",
                "--d-model", "256", "--n-layers", "4", "--vocab", "8192",
                "--steps", str(steps), "--batch", "8", "--seq", "256"]
    else:
        argv = ["--arch", "qwen2-0.5b", "--reduced",
                "--d-model", "768", "--n-layers", "8", "--d-ff", "3072",
                "--vocab", "32768",
                "--steps", str(steps), "--batch", "8", "--seq", "512"]
    argv += ["--ckpt-dir", ckpt_dir, "--arrayflex-report",
             "--device", dev.type]
    args = train.build_argparser().parse_args(argv)
    report = train.arrayflex_report(train.build_config(args), args.seq,
                                    args.batch)
    losses = train.main(argv)
    assert losses[-1] < losses[0], "loss should decrease"
    log("example complete: loss decreased "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    return dict(argv=argv, report=report, losses=losses)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)
    return run(args.device, args.steps, args.small)


if __name__ == "__main__":
    main()
