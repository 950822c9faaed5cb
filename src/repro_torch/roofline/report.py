"""Generate the §Dry-run and §Roofline tables from the port's sweep
results (results/dryrun_torch/*.json), in the reference's row format.

Port of the reference's ``roofline/report.py``.  The dry-run table's
"fits" column is ``fits_80g_hbm`` (one NVIDIA H100 80GB HBM3), its time
column the seconds of the counted meta run (``compile_s``: the port
compiles nothing), and a timed-out cell shows its seconds.  Roofline
seconds are priced at the H100 datasheet (``roofline.model``), not
measured.

Usage: PYTHONPATH=src python -m repro_torch.roofline.report > tables.md
"""
from __future__ import annotations

import json
import os

RESULTS = os.environ.get("DRYRUN_RESULTS", "results/dryrun_torch")
ARCH_ORDER = [
    "jamba-1.5-large-398b", "mixtral-8x22b", "qwen3-moe-30b-a3b",
    "llama-3.2-vision-90b", "qwen2-0.5b", "llama3-8b", "qwen2.5-14b",
    "stablelm-12b", "whisper-base", "mamba2-370m",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh):
    out = {}
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            p = os.path.join(RESULTS, f"{a}_{s}_{mesh}.json")
            if os.path.exists(p):
                try:
                    with open(p) as f:
                        out[(a, s)] = json.load(f)
                except (OSError, ValueError):
                    pass
    return out


def fmt_s(x):
    if x == 0:
        return "0"
    if x < 0.001:
        return f"{x*1e6:.3g}us"
    if x < 1:
        return f"{x*1e3:.3g}ms"
    return f"{x:.3g}s"


def dryrun_table():
    lines = ["| arch | shape | mesh | status | run | GiB/device | fits |",
             "|---|---|---|---|---|---|---|"]
    for mesh in ("1pod", "2pod"):
        cells = load(mesh)
        for (a, s), r in cells.items():
            if r["status"] == "skipped":
                lines.append(f"| {a} | {s} | {mesh} | SKIP ({r['reason'][:40]}…) | | | |")
            elif r["status"] == "ok":
                m = r["memory"]
                lines.append(
                    f"| {a} | {s} | {mesh} | ok | {r['compile_s']:.0f}s | "
                    f"{m['per_device_gib']:.2f} | "
                    f"{'yes' if m['fits_80g_hbm'] else 'NO'} |")
            elif r["status"] == "timeout":
                lines.append(f"| {a} | {s} | {mesh} | timeout | "
                             f"{r.get('elapsed_s', 0):.0f}s | | |")
            else:
                lines.append(f"| {a} | {s} | {mesh} | {r['status']} | | | |")
    return "\n".join(lines)


def roofline_table():
    lines = ["| arch | shape | compute | memory | collective | dominant | "
             "MODEL/HLO | (+attn) | what would move the dominant term |",
             "|---|---|---|---|---|---|---|---|---|"]
    fixes = {
        "compute": "larger per-step tiles (deeper collapse), drop remat "
                   "recompute, TP attention heads",
        "memory": "shard the non-GEMM ops and caches over the mesh; fuse "
                  "attention / SSD inner loops into kernels",
        "collective": "keep GEMM outputs sharded instead of gathering them "
                      "on the home device; overlap gathers with compute",
    }
    cells = load("1pod")
    for (a, s), r in cells.items():
        if r["status"] != "ok":
            continue
        t = r["roofline"]
        lines.append(
            f"| {a} | {s} | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} | "
            f"**{t['dominant']}** | {t['useful_flops_ratio']:.3f} | "
            f"{t['useful_flops_ratio_with_attn']:.3f} | "
            f"{fixes[t['dominant']]} |")
    return "\n".join(lines)


def collective_breakdown(arch, shape, mesh="1pod"):
    p = os.path.join(RESULTS, f"{arch}_{shape}_{mesh}.json")
    with open(p) as f:
        r = json.load(f)
    return r["hlo"]["collective_bytes_per_device"]


def main():
    print("## §Dry-run\n")
    print(dryrun_table())
    print("\n## §Roofline (single-pod, per device; priced at the NVIDIA H100 "
          "80GB HBM3 datasheet, SXM5, 700 W)\n")
    print(roofline_table())


if __name__ == "__main__":
    main()
