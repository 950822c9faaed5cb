"""Cluster-scale transparent pipelining (beyond-paper, DESIGN.md §3.3), on
the PyTorch port.

Plans the pipeline depth for a multi-pod deployment with the paper's
Eq.(6)/(7) math, then runs the actual GPipe schedule over a 4-way 'pod'
mesh (four logical devices: 4 x cuda:0 on one card, 4 x cpu with
``--device cpu``) and checks it against the sequential execution.

Run:  PYTHONPATH=src python examples/torch/pipeline_parallel.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.parallel import pipeline as cp


def run(device="cuda", log=print):
    """The planning rows and the GPipe run on ``device``; each printed
    line goes to ``log``.  Returns the rows and the run's max error."""
    dev = resolve_device(device)
    out = {"rows": []}
    log("=== pipeline-depth planning (Eq. 6/7 at pod scale) ===")
    for M in (4, 16, 64):
        c = cp.PipelineCost(n_pods=8, microbatches=M, layer_time_ms=2.0,
                            overhead_ms=0.5)
        p = cp.plan(c)
        out["rows"].append(dict(microbatches=M, **p))
        log(f"  microbatches={M:3d}: collapse k={p['k']} "
            f"(k_hat={p['k_hat']:.2f}) -> {p['stages']} stages, "
            f"latency {p['latency_ms']:.1f}ms "
            f"(vs {p['latency_ms_k1']:.1f}ms at k=1), "
            f"bubble {p['bubble_fraction']*100:.0f}%")

    log("\n=== executing the GPipe schedule on a 4-pod mesh ===")
    with mesh_lib.host_devices(4, dev.type):
        mesh = mesh_lib.pod_mesh(4, 1, 1, 0)
    rng = np.random.RandomState(0)
    w = torch.as_tensor(rng.randn(4, 16, 16) * 0.3, dtype=torch.float32,
                        device=dev)
    x = torch.as_tensor(rng.randn(8, 4, 16), dtype=torch.float32,
                        device=dev)

    def stage(wi, h):
        return torch.tanh(h @ wi)

    piped = cp.make_pipelined(stage, mesh)
    got = piped(list(w), x)
    want = x
    for i in range(4):
        want = torch.tanh(want @ w[i])
    err = float(torch.max(torch.abs(got - want)))
    out.update(err=err, out=got.cpu().numpy())
    log(f"  4 stages x 8 microbatches: max err vs sequential {err:.2e}")
    assert err < 1e-5
    log("example complete")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
