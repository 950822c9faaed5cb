"""Static-analysis subsystem: the substrate contract auditor.

Port of the reference's ``analysis`` package.  Three passes, one CLI
(``python -m repro_torch.analysis.audit``):

* :mod:`repro_torch.analysis.dispatch_audit` — run the lm entry points
  under a ``TorchDispatchMode`` and verify every aten contraction is
  substrate-attributed, psums on quantized paths are fp32 and priced,
  pipeline hand-offs are priced, there is no rogue weight
  re-quantization, and every recorded site label is planner-known; it
  also counts the kernel wrappers' calls and any plain-version fallback
  on a CUDA tensor;
* :mod:`repro_torch.analysis.kernel_check` — compare the kernel store's
  boundary-op count against ``Epilogue.ops`` pricing, audit the plan-cache
  key for field completeness, and check that every tensor-core MMA of the
  CUDA sources accumulates in fp32 (s32 for int8);
* :mod:`repro_torch.analysis.ast_lint` — AST rules over
  ``src/repro_torch``: no raw GEMMs outside the substrate, ``site=``
  labels at dispatch calls, no owned-state mutation outside its owner.

Finding codes live in :mod:`repro_torch.analysis.findings`.
"""
from repro_torch.analysis.findings import CODES, Finding, Report

__all__ = ["Finding", "Report", "CODES"]
