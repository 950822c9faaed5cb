"""Finding / Report types shared by the three auditor passes.

Port of the reference's ``analysis/findings.py``: the same codes,
severities and JSON schema.  Every violation is a :class:`Finding` with a
stable machine-readable code (``AFxxx`` for the dispatch/kernel passes,
``AFLxx`` for the AST lint), a severity, and a location string.
:class:`Report` aggregates findings and serializes to the JSON the audit
CLI writes.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List

# code -> (default severity, one-line description): the reference's codes
# and severities; AF001 and AF004 name what they check in the port.
CODES: Dict[str, tuple] = {
    "AF001": ("error", "aten contraction (mm/bmm/addmm/convolution/...) "
                       "not attributable to a substrate dispatch site (raw "
                       "GEMM bypassed the planner)"),
    "AF002": ("error", "non-fp32 psum on a quantized/substrate contraction "
                       "path (the fp32-psum rule)"),
    "AF003": ("error", "in-step weight re-quantization: a cast to int8 "
                       "of a weight-shaped operand outside "
                       "substrate.quantize_weight"),
    "AF004": ("error", "CUDA kernel tensor-core MMA accumulates in a "
                       "non-fp32 float (s32 for int8 operands) — the "
                       "carry-save chain must be fp32"),
    "AF005": ("error", "kernel store boundary-op count drifted from "
                       "Epilogue.ops/d_epilogue_ps pricing"),
    "AF006": ("error", "plan-cache key incompleteness: a GemmCall/ShardSig/"
                       "BackendInfo field changes execution but is not "
                       "keyed or declared plan-irrelevant"),
    "AF007": ("error", "dispatch site label unknown to planner.model_gemms"),
    "AF008": ("warning", "weight quantization run inside the step via "
                         "substrate.quantize_weight (serve a pre-quantized "
                         "tree: lm.prequantize_params)"),
    "AFL01": ("error", "raw @/matmul/einsum/mm/F.linear GEMM in nn/, "
                       "models/ or serving/ outside the explicit "
                       "allowlist"),
    "AFL02": ("error", "substrate dispatch without a site= label, or with "
                       "a label unknown to the planner registry"),
    "AFL03": ("error", "owned mutable state touched outside its owner "
                       "module: substrate plan/dispatch caches outside "
                       "kernels/substrate.py, or paged-KV page-table/pool "
                       "state outside serving/engine.py+paged.py"),
}


@dataclass(frozen=True)
class Finding:
    code: str
    where: str                # file:line, or audit label (cfg/backend/entry)
    message: str
    pass_name: str = ""       # dispatch | kernel | lint
    severity: str = ""        # defaults from CODES

    def __post_init__(self):
        if not self.severity:
            sev = CODES.get(self.code, ("error", ""))[0]
            object.__setattr__(self, "severity", sev)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"[{self.code}][{self.severity}] {self.where}: "
                f"{self.message}")


@dataclass
class Report:
    """Aggregated findings of one auditor run."""

    findings: List[Finding] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def exit_code(self) -> int:
        return 0 if self.ok else 1

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
            "meta": self.meta,
            "findings": [f.to_dict() for f in self.findings],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def summary(self) -> str:
        lines = [str(f) for f in self.findings]
        lines.append(
            f"{'OK' if self.ok else 'FAIL'}: {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s)")
        return "\n".join(lines)
