"""One-command substrate-contract audit: ``python -m repro_torch.analysis.audit``.

Port of the reference's ``analysis/audit.py``.  Runs the three analysis
passes over the default matrix —

* models:   qwen2-0.5b (dense), qwen3-moe-30b-a3b (MoE), mamba2-370m (SSM)
* backends: xla, arrayflex, arrayflex_int8, arrayflex_w8a8
* meshes:   unsharded and TP2 (mesh ``(1, 2)`` over ``--host-devices``
  logical devices: ``launch.mesh.host_devices``)

— at ``reduced()`` smoke sizes, plus the kernel<->timing consistency
checks and the AST lint, and writes a machine-readable findings JSON.
Exit code 0 iff no error-severity finding (AF008 in-step weight
quantization warnings do not fail the run).

Runs on the card unless ``--device cpu`` (without a card it raises).
``--strict`` additionally turns strict audit on
(``substrate.strict_audit_scope``), so any site-label violation raises at
dispatch time while the entries run (the runtime twin of the AF007
finding).  Each cell's entries report their dispatches, kernel wrapper
calls and plain-version fallbacks under ``meta.cells``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

DEFAULT_MODELS = ("qwen2-0.5b", "qwen3-moe-30b-a3b", "mamba2-370m")
DEFAULT_BACKENDS = ("xla", "arrayflex", "arrayflex_int8", "arrayflex_w8a8")


def build_report(models, backends, meshes, run_lint=True, run_kernel=True,
                 device=None, host_devices: int = 2):
    """The full audit; importable for tests."""
    from repro_torch.analysis import ast_lint, dispatch_audit, kernel_check
    from repro_torch.analysis.findings import Finding, Report
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import mesh as mesh_lib

    report = Report(meta={
        "models": list(models), "backends": list(backends),
        "meshes": [list(m) for m in meshes],
        "passes": (["dispatch"] + (["kernel"] if run_kernel else [])
                   + (["lint"] if run_lint else [])),
    })
    cells = []
    for name in models:
        for backend in backends:
            for mesh in meshes:
                cfg = reduced(get_config(name))
                cfg = dataclasses.replace(
                    cfg, gemm_backend=backend, mesh_shape=tuple(mesh))
                tag = f"{name}/{backend}/" + (
                    "tp" + str(mesh[-1]) if mesh else "unsharded")
                entries: dict = {}
                scope = (mesh_lib.host_devices(max(host_devices, 2), device)
                         if mesh else contextlib.nullcontext())
                try:
                    with scope:
                        found = dispatch_audit.audit_model(
                            cfg, label=tag, device=device, meta=entries)
                except Exception as exc:   # a crashed run is itself a finding
                    found = [Finding(
                        "AF001", tag,
                        f"entry-point run failed: {type(exc).__name__}: "
                        f"{exc}", pass_name="dispatch")]
                report.extend(found)
                cells.append({"cell": tag, "findings": len(found),
                              "entries": entries})
    report.meta["cells"] = cells
    if run_kernel:
        report.extend(kernel_check.run())
    if run_lint:
        report.extend(ast_lint.run())
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="Audit the substrate contract: dispatch routing, "
                    "kernel/timing consistency, AST lint.")
    ap.add_argument("--models", nargs="*", default=list(DEFAULT_MODELS))
    ap.add_argument("--backends", nargs="*", default=list(DEFAULT_BACKENDS))
    ap.add_argument("--no-tp", action="store_true",
                    help="skip the TP2 sharded column")
    ap.add_argument("--no-lint", action="store_true")
    ap.add_argument("--no-kernel", action="store_true")
    ap.add_argument("--strict", action="store_true",
                    help="also enable strict audit while the entries run")
    ap.add_argument("--out", default=os.path.join("results", "audit",
                                                  "audit.json"))
    ap.add_argument("--host-devices", type=int, default=2,
                    help="logical devices for the TP column")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the kernels' "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.findings import CODES
    from repro_torch.kernels import substrate

    meshes = [()] if args.no_tp else [(), (1, 2)]
    with (substrate.strict_audit_scope() if args.strict
          else contextlib.nullcontext()):
        report = build_report(args.models, args.backends, meshes,
                              run_lint=not args.no_lint,
                              run_kernel=not args.no_kernel,
                              device=args.device,
                              host_devices=args.host_devices)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report.to_dict(), fh, indent=2)
    for f in report.errors:
        print(f)
    # warnings are expected in bulk (AF008 per raw weight); tally per code
    # here, full list in the JSON report
    tally: dict = {}
    for f in report.warnings:
        tally[f.code] = tally.get(f.code, 0) + 1
    for code in sorted(tally):
        print(f"[{code}][warning] x{tally[code]}: {CODES[code][1]}")
    print(f"{'OK' if report.ok else 'FAIL'}: {len(report.errors)} error(s), "
          f"{len(report.warnings)} warning(s)")
    print(f"report: {args.out}")
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
