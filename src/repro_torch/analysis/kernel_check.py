"""Kernel <-> timing-model consistency checker.

Port of the reference's ``analysis/kernel_check.py``.  Three static
checks, no kernel execution:

* **AF005, epilogue pricing** — ``arrayflex_gemm.store_phase`` is the
  single definition of the carry-propagate boundary math (the plain
  versions call it, and the CUDA kernels' stores do exactly its ops), and
  ``arrayflex_gemm.prologue_phase`` of the pre-contraction boundary (the
  fused rmsnorm scale).  For every valid ``Epilogue`` spec x
  quantization, run both under a ``TorchDispatchMode`` that sees each aten
  op and *count the boundary vector ops actually run* (bias adds, gate
  multiply, dequant multiplies, activation, prologue scale multiply) by
  tracking operand provenance from op to op.  The count must equal what the Eq.(5')
  timing term prices: ``Epilogue.ops`` plus ``Epilogue.contractions``
  dequant multiplies on a quantizing backend (the ``dequant_ops`` term of
  ``_plan_gemm_cached``).  A fused op added to the kernel boundary
  without repricing — or priced without being executed — fails here.
  Every operand is its own tensor: provenance is keyed by tensor
  identity, so operands sharing one tensor would merge it.

* **AF006, plan-key completeness** — every ``GemmCall``/``BackendInfo``
  field must be covered by the ``_plan_gemm_cached`` key or declared
  plan-irrelevant in ``substrate.CALL_FIELD_KEYING`` /
  ``BACKEND_FIELD_KEYING``; the declarations must reference real
  ``Epilogue``/``BackendInfo`` attributes; ``Epilogue``/``ShardSig`` key
  components must compare/hash on all fields; and the cached planner's
  signature must be exactly ``PLAN_KEY_PARAMS``.

* **AF004, fp32 accumulators** — the counterpart of the reference's
  Pallas fp32-scratch rule, over the CUDA sources
  (``kernels/csrc/*.cu`` / ``*.cuh``): every tensor-core MMA instruction
  string (``mma.sync…``, ``wgmma.mma_async…``) must accumulate in
  ``.f32``, or in ``.s32`` for integer operands.  Reads the sources only:
  no ``nvcc``.
"""
from __future__ import annotations

import dataclasses
import inspect
import re
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import substrate
from repro_torch.kernels.arrayflex_gemm import prologue_phase, store_phase
from repro_torch.roofline import trace as _trace

# the aten ops that make the activation's nonlinearity (silu, tanh-gelu
# and their decompositions)
_NONLINEAR = frozenset({"sigmoid", "silu", "gelu", "tanh", "erf", "exp",
                        "rsqrt"})

CSRC = Path(__file__).resolve().parent.parent / "kernels" / "csrc"


# ---------------------------------------------------------------------------
# AF005: provenance-counted boundary ops vs Epilogue.ops pricing

class _OpCount:
    def __init__(self):
        self.bias_adds = 0
        self.bias2_adds = 0
        self.gate_muls = 0
        self.dequant_muls = 0
        self.residual_adds = 0
        self.scale_muls = 0
        self.nonlinear = False

    @property
    def total(self) -> int:
        return (self.bias_adds + self.bias2_adds + self.gate_muls
                + self.residual_adds + self.scale_muls
                + int(self.nonlinear))


class _Provenance(TorchDispatchMode):
    """The reference's provenance rule, op by op: a result carries the
    union of its operands' provenance, and a boundary op is one whose
    operand IS exactly one named input.  Provenance is keyed by tensor
    identity; every tensor seen is kept alive, so no identity is reused
    while the mode runs."""

    def __init__(self, named, count: _OpCount):
        super().__init__()
        self.prov = {id(t): (t, frozenset({nm})) for nm, t in named.items()}
        self.count = count

    def _of(self, t):
        ent = self.prov.get(id(t))
        return frozenset() if ent is None else ent[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        sources = [self._of(t) for t in _trace._tensors((args, kwargs), [])]
        union = frozenset().union(*sources) if sources else frozenset()
        name = func.overloadpacket.__name__
        count = self.count
        if name == "add":
            # one operand IS the bias vector (exactly-{bias} provenance);
            # downstream adds merely inherit bias provenance and are the
            # activation's internal arithmetic, not a boundary op
            if any(s == {"bias"} for s in sources):
                count.bias_adds += 1
            elif any(s == {"bias2"} for s in sources):
                count.bias2_adds += 1
            elif any(s == {"residual"} for s in sources):
                count.residual_adds += 1
        elif name == "mul":
            if any(s == {"norm_scale"} for s in sources):
                count.scale_muls += 1
            elif any(s in ({"w_scale"}, {"w2_scale"}) for s in sources):
                count.dequant_muls += 1
            elif (any("y2" in s for s in sources)
                  and any("y2" not in s and "y" in s for s in sources)):
                count.gate_muls += 1
        elif name in _NONLINEAR:
            count.nonlinear = True
        for t in _trace._tensors(out, []):
            if id(t) not in self.prov:
                self.prov[id(t)] = (t, union)
        return out


def _run_count(fn, named: dict, count: _OpCount, **kwargs) -> None:
    """Run ``fn(**named, **kwargs)`` under :class:`_Provenance`."""
    with torch.no_grad(), _Provenance(named, count):
        fn(**named, **kwargs)


def _count_store_ops(store_fn: Callable, ep: substrate.Epilogue,
                     quant: bool, n: int = 8,
                     prologue_fn: Callable = prologue_phase) -> _OpCount:
    """Run ``store_fn`` (and, when the spec fuses the rmsnorm scale,
    ``prologue_fn``) on fp32 accumulators for ``ep`` and count the
    boundary ops they run.  ``prologue_fn`` takes ``x`` and
    ``norm_scale`` by keyword, ``store_fn`` its operands and
    ``activation``."""
    def row():
        return torch.zeros((1, n), dtype=torch.float32)

    def vec():
        return torch.zeros((n,), dtype=torch.float32)

    operands = {"y": row()}
    if ep.dual:
        operands["y2"] = row()
    if quant:
        operands["w_scale"] = vec()
        if ep.dual:
            operands["w2_scale"] = vec()
    if ep.bias:
        operands["bias"] = vec()
    if ep.bias2:
        operands["bias2"] = vec()
    if ep.residual:
        operands["residual"] = row()
    count = _OpCount()
    _run_count(store_fn, operands, count, activation=ep.activation)
    if ep.norm_scale:
        # the scale multiply rides the step prologue, not the store —
        # run it separately and fold its op count in
        _run_count(prologue_fn, {"x": row(), "norm_scale": vec()}, count)
    return count


def _valid_epilogues():
    for kind in substrate.EPILOGUE_KINDS:
        dual = kind == "swiglu"
        for bias in (False, True):
            for bias2 in ((False, True) if dual else (False,)):
                for residual in (False, True):
                    for norm_scale in (False, True):
                        yield substrate.Epilogue(
                            kind=kind, bias=bias, bias2=bias2,
                            residual=residual, norm_scale=norm_scale)


def check_epilogue_pricing(
        store_fn: Callable = store_phase,
        priced_ops: Optional[Callable] = None) -> List[Finding]:
    """AF005 over every valid Epilogue spec x quantization.

    ``priced_ops(ep, quant)`` is what the timing model charges at the
    collapsed-block boundary (default: the ``_plan_gemm_cached`` formula
    minus the shard reduce term, which has no kernel-side op to count).
    """
    if priced_ops is None:
        def priced_ops(ep, quant):
            return ep.ops + (ep.contractions if quant else 0)
    findings = []
    for ep in _valid_epilogues():
        for quant in (False, True):
            count = _count_store_ops(store_fn, ep, quant)
            measured = count.total + count.dequant_muls
            priced = priced_ops(ep, quant)
            if measured != priced:
                findings.append(Finding(
                    "AF005",
                    f"store_phase[kind={ep.kind}, bias={ep.bias}, "
                    f"bias2={ep.bias2}, residual={ep.residual}, "
                    f"norm_scale={ep.norm_scale}, quant={quant}]",
                    f"kernel boundary runs {measured} op(s) "
                    f"(bias={count.bias_adds}+{count.bias2_adds}, "
                    f"gate={count.gate_muls}, dequant={count.dequant_muls}, "
                    f"residual={count.residual_adds}, "
                    f"scale={count.scale_muls}, "
                    f"act={int(count.nonlinear)}) but the Eq.(5') pricing "
                    f"charges {priced}", pass_name="kernel"))
    return findings


# ---------------------------------------------------------------------------
# AF006: plan-cache key completeness

def _field_names(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


def check_plan_key(
        call_keying=None, backend_keying=None, key_params=None,
        plan_fn=None, call_cls=None, backend_cls=None,
        epilogue_cls=None, shard_cls=None) -> List[Finding]:
    """AF006: the declared keying metadata must exactly cover the
    dataclasses, reference real attributes, and match the cached
    planner's actual signature.  All arguments default to the live
    ``substrate`` objects; tests override them to seed drift.
    """
    call_keying = substrate.CALL_FIELD_KEYING if call_keying is None \
        else call_keying
    backend_keying = substrate.BACKEND_FIELD_KEYING if backend_keying is None \
        else backend_keying
    key_params = substrate.PLAN_KEY_PARAMS if key_params is None \
        else key_params
    plan_fn = substrate._plan_gemm_cached if plan_fn is None else plan_fn
    call_cls = substrate.GemmCall if call_cls is None else call_cls
    backend_cls = substrate.BackendInfo if backend_cls is None else backend_cls
    epilogue_cls = substrate.Epilogue if epilogue_cls is None else epilogue_cls
    shard_cls = substrate.ShardSig if shard_cls is None else shard_cls

    findings = []

    def af006(where, msg):
        findings.append(Finding("AF006", where, msg, pass_name="kernel"))

    # (1) GemmCall fields <-> CALL_FIELD_KEYING, exactly
    call_fields = _field_names(call_cls)
    for f in sorted(call_fields - set(call_keying)):
        af006(f"GemmCall.{f}",
              "field has no keying declaration in CALL_FIELD_KEYING — "
              "decide whether it must enter the plan key or is "
              "plan-irrelevant per-call data")
    for f in sorted(set(call_keying) - call_fields):
        af006(f"CALL_FIELD_KEYING[{f!r}]",
              "declaration references a field GemmCall no longer has")

    # (2) declarations must point at real key-side attributes
    for f, decl in call_keying.items():
        kind = decl.split(":", 1)[0].strip()
        if kind == "epilogue":
            attr = decl.split(":", 1)[1].split()[0].strip()
            if not hasattr(epilogue_cls, attr) \
                    and attr not in _field_names(epilogue_cls):
                af006(f"CALL_FIELD_KEYING[{f!r}]",
                      f"claims coverage via Epilogue.{attr}, which does "
                      f"not exist")
        elif kind == "backend":
            attr = decl.split(":", 1)[1].split()[0].strip()
            if attr not in _field_names(backend_cls):
                af006(f"CALL_FIELD_KEYING[{f!r}]",
                      f"claims coverage via BackendInfo.{attr}, which "
                      f"does not exist")
        elif kind != "operand":
            af006(f"CALL_FIELD_KEYING[{f!r}]",
                  f"unknown keying kind {kind!r} (want epilogue:/backend:/"
                  f"operand:)")

    # (3) BackendInfo fields <-> BACKEND_FIELD_KEYING, exactly
    backend_fields = _field_names(backend_cls)
    for f in sorted(backend_fields - set(backend_keying)):
        af006(f"BackendInfo.{f}",
              "field has no keying declaration in BACKEND_FIELD_KEYING")
    for f in sorted(set(backend_keying) - backend_fields):
        af006(f"BACKEND_FIELD_KEYING[{f!r}]",
              "declaration references a field BackendInfo no longer has")

    # (4) cached planner signature == the declared key, in order
    target = inspect.unwrap(plan_fn)
    params = tuple(inspect.signature(target).parameters)
    if params != tuple(key_params):
        af006("_plan_gemm_cached",
              f"cache-key signature {params} != declared PLAN_KEY_PARAMS "
              f"{tuple(key_params)}")

    # (5) hashable key components must compare on every field
    for cls in (epilogue_cls, shard_cls):
        for f in dataclasses.fields(cls):
            if not f.compare:
                af006(f"{cls.__name__}.{f.name}",
                      "field is excluded from __eq__/__hash__ but the "
                      "class is a plan-cache key component — two specs "
                      "differing only here would alias one plan")
    return findings


# ---------------------------------------------------------------------------
# AF004: the tensor-core accumulators of the CUDA sources

# a PTX tensor-core MMA instruction inside a string literal
_MMA = re.compile(r'"\s*((?:mma\.sync|wgmma\.mma_async)\.[A-Za-z0-9_.]*)')
_SHAPE = re.compile(r"m\d+n\d+k\d+")
_LAYOUTS = frozenset({"row", "col"})
_INT_OPERANDS = frozenset({"s8", "u8", "s4", "u4", "b1"})


def _accumulator(instr: str):
    """(accumulator type, A operand type) of an MMA instruction string:
    the types after its shape (``mma.sync``'s row/col layouts skipped) are
    D, A, B[, C]."""
    parts = instr.split(".")
    at = next((i for i, p in enumerate(parts) if _SHAPE.fullmatch(p)), None)
    if at is None:
        return None, None
    types = [p for p in parts[at + 1:] if p not in _LAYOUTS]
    if len(types) < 2:
        return None, None
    return types[0], types[1]


def check_mma_accumulators(paths: Optional[Sequence] = None,
                           root: Optional[Path] = None) -> List[Finding]:
    """AF004 over every MMA instruction string of ``paths`` (default: the
    ``.cu`` / ``.cuh`` files of ``kernels/csrc``): ``.f32`` accumulators
    for float operands, ``.s32`` for integer ones."""
    root = CSRC.parent.parent if root is None else Path(root)
    if paths is None:
        paths = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    findings = []
    for path in map(Path, paths):
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.name
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            for m in _MMA.finditer(line):
                acc, a = _accumulator(m.group(1))
                want = "s32" if a in _INT_OPERANDS else "f32"
                if acc != want:
                    findings.append(Finding(
                        "AF004", f"src/repro_torch/{rel}:{lineno}",
                        f"{m.group(1)} accumulates in .{acc} on .{a} "
                        f"operands; the carry-save chain must accumulate "
                        f"in .{want}", pass_name="kernel"))
    return findings


def run() -> List[Finding]:
    return (check_epilogue_pricing() + check_plan_key()
            + check_mma_accumulators())
