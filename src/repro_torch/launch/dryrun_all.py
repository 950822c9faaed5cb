"""Sweep orchestrator: run every (arch x shape x mesh) dry-run cell.

Port of the reference's ``launch/dryrun_all.py``.  Each cell runs in its
own subprocess of ``python -m repro_torch.launch.dryrun`` (failures must
not kill the sweep); a cell that outruns its timeout is recorded as
``timeout``.  Results land in results/dryrun_torch/<arch>_<shape>_<mesh>.json
(``DRYRUN_RESULTS`` overrides the directory, so a sweep never overwrites
the reference's results/dryrun) and are summarized to stdout.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--multi-pod-only]
      [--single-pod-only] [--arch A] [--shape S] [--force]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import ARCHS, SHAPES

RESULTS_DIR = os.environ.get("DRYRUN_RESULTS", "results/dryrun_torch")


def cell_path(arch, shape, multi_pod):
    mesh = "2pod" if multi_pod else "1pod"
    return os.path.join(RESULTS_DIR, f"{arch}_{shape}_{mesh}.json")


def run_cell(arch, shape, multi_pod, force=False, timeout=2400):
    out = cell_path(arch, shape, multi_pod)
    if not force and os.path.exists(out):
        try:
            with open(out) as f:
                r = json.load(f)
            if r.get("status") in ("ok", "skipped"):
                return r, True
        except (OSError, ValueError):
            pass
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", "src")
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
        if os.path.exists(out):
            with open(out) as f:
                return json.load(f), False
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "error",
                "error": (proc.stderr or proc.stdout)[-2000:]}, False
    except subprocess.TimeoutExpired:
        res = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
               "status": "timeout", "elapsed_s": time.time() - t0}
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
        return res, False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    meshes = [False, True]
    if args.multi_pod_only:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]
    cells = []
    for mp in meshes:
        for a in ARCHS:
            if args.arch and a != args.arch:
                continue
            for s in SHAPES:
                if args.shape and s != args.shape:
                    continue
                cells.append((a, s, mp))
    n_ok = n_skip = n_err = 0
    t_start = time.time()
    for i, (a, s, mp) in enumerate(cells):
        r, cached = run_cell(a, s, mp, force=args.force)
        st = r.get("status")
        tag = "cached" if cached else f"{r.get('compile_s', 0):.0f}s"
        if st == "ok":
            n_ok += 1
            roof = r.get("roofline", {})
            print(f"[{i+1}/{len(cells)}] OK   {a:26s} {s:12s} "
                  f"{'2pod' if mp else '1pod'} {tag:7s} "
                  f"mem={r['memory']['per_device_gib']:8.2f}GiB "
                  f"dom={roof.get('dominant', '?'):10s} "
                  f"useful={roof.get('useful_flops_ratio', 0):.3f}")
        elif st == "skipped":
            n_skip += 1
            print(f"[{i+1}/{len(cells)}] SKIP {a:26s} {s:12s} "
                  f"{'2pod' if mp else '1pod'} — {r.get('reason')}")
        else:
            n_err += 1
            print(f"[{i+1}/{len(cells)}] ERR  {a:26s} {s:12s} "
                  f"{'2pod' if mp else '1pod'} — "
                  f"{str(r.get('error', st))[:200]}")
        sys.stdout.flush()
    print(f"\nDone in {time.time()-t_start:.0f}s: "
          f"{n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
