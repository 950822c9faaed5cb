"""Serve a small model with batched requests through the continuous-batching
engine (prefill + fused decode ticks), reporting ArrayFlex's decode-regime
plan for the same model — on the PyTorch port.

Runs on the card unless ``--device cpu`` is given.  ``run(device,
reduced=False)`` serves qwen2-0.5b at its full published width instead
(``serve.py --no-reduced``).

Run:  PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]
"""
import argparse

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core import planner
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import serve


def run(device="cuda", reduced=True, log=print):
    """The decode plan's lines (to ``log``), then ``serve.main`` with the
    reference example's arguments on ``device``.  Returns the plan and
    the served requests."""
    dev = resolve_device(device)
    # the decode-regime ArrayFlex plan (small-T: where the paper's
    # technique pays off for LLMs — see benchmarks/paper_figs.py)
    cfg_full = ARCHS["qwen2-0.5b"]
    plan = planner.plan_model(cfg_full, SHAPES["decode_32k"])
    lines = [f"ArrayFlex decode plan for {cfg_full.name}: "
             f"latency -{plan['latency_saving']*100:.1f}%, "
             f"EDP {plan['edp_gain']:.2f}x vs fixed-pipeline SA"]
    ks = {}
    for p in plan["plans"]:
        ks.setdefault(p.k, []).append(p.gemm.name)
    for k, names in sorted(ks.items()):
        lines.append(f"  k={k}: {len(names)} GEMM kinds e.g. {names[:3]}")
    for line in lines:
        log(line)

    argv = ["--arch", "qwen2-0.5b", "--requests", "6", "--max-new", "16",
            "--device", dev.type] + ([] if reduced else ["--no-reduced"])
    reqs = serve.main(argv)
    assert all(len(r.out_tokens) == 16 for r in reqs)
    log("example complete")
    return dict(lines=lines, ks=ks, argv=argv,
                streams=[list(r.out_tokens) for r in reqs],
                outcomes=[r.outcome for r in reqs])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
