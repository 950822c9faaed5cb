"""Dispatch-mode routing audit: run the lm entry points and verify GEMM
routing.

The counterpart of the reference's ``analysis/jaxpr_audit.py``.  The
reference traces each entry point to a closed jaxpr and walks its
equations, each with the traceback of the Python code that staged it.
The port compiles nothing, so it runs the entry point itself under a
``TorchDispatchMode`` (:func:`record`), which sees every aten op the step
executes, and attributes each op it checks by the Python frames of its
call, innermost first (:func:`contract.classify_frames`).  The events that
have no aten op of their own — collectives, which the single-controller
mesh does with copies, and kernel launches, which go through ``ctypes`` —
arrive through the ``roofline.trace`` hooks the substrate and the
pipeline already call (the recorder is a ``trace.Listener``).  Checks:

* **AF001** every aten contraction (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv``, ``dot``, ``convolution``, ``_int_mm``, ...) must
  be attributable — via its frames — to the substrate dispatch layer or
  an explicit :data:`repro_torch.analysis.contract.ALLOWLIST` entry;
* **AF002** every psum (the fp32 partial sums of a sharded contraction,
  ``trace.collective("all-reduce", ...)``) on a substrate path, and under
  a quantizing backend every float psum anywhere, must be fp32; *and*
  (:func:`check_psum_boundaries`) every substrate psum under a quantizing
  backend must sit at a boundary the plan priced — some recorded
  ``SITE_PLANS`` entry carries ``ShardSig.reduce_ops > 0``; *and*
  (:func:`check_stage_boundaries`) every pipeline hand-off that
  ``parallel.pipeline.staged_step`` makes
  (``trace.collective("collective-permute", ...)``) must correspond to a
  recorded plan that priced the transfer (``ShardSig.transfer_ops`` or
  ``transfer_cycles`` non-zero somewhere);
* **AF003/AF008** a cast to int8 (``_to_copy``) of a weight-shaped (ndim
  >= 2) tensor: through ``substrate.quantize_weight`` / ``_quantize`` it
  is the known in-step weight quantization of a raw tree (warning
  AF008); on a declared W8A8 backend (``BackendInfo.act_quantize``) the
  dynamic activation casts — ``quantize_tile`` in the kernels' plain
  versions and the batched-QK ``_quantize`` of K in ``_batched_exec`` —
  are the priced Eq.(5') quantize boundary and are clean; anywhere else
  it is a rogue re-quantization (error AF003);
* **AF007** every site label recorded in ``substrate.DISPATCH_COUNTS``
  during the run must be known to ``planner.model_gemms``
  (``planner.site_registry``), and must belong to this config's own GEMM
  walk.

AF004 (fp32 accumulators) reads the CUDA sources instead
(:func:`repro_torch.analysis.kernel_check.check_mma_accumulators`): a
dispatch mode sees no kernel's registers.

**Kernel launches.**  The recorder counts each call of a ``trace.kernel``
wrapper (``arrayflex_gemm``, ``arrayflex_expert_gemm``,
``flash_attention``) per entry, beside the entry's substrate dispatches.
On a CUDA tensor an aten contraction under a wrapper's ``*_plain`` frame
is a **fallback** (the wrapper ran its plain version instead of its
kernel); :func:`audit_model` reports both in its ``meta``.

Entries and sizes are the reference's: ``forward``, ``decode_step`` and,
where ``lm.supports_batched_prefill``, ``prefill_step``, at B = 2, S = 8,
under ``torch.no_grad()`` with chaos inactive.  Each entry starts from
cleared plan, quantization and weight-block memos, so what it finds does
not depend on what ran before.  The audit runs on the card unless the
caller passes ``device="cpu"``; without a card it raises.
"""
from __future__ import annotations

import collections
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import contract
from repro_torch.analysis.findings import Finding
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import planner
from repro_torch.kernels import substrate
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import lm
from repro_torch.roofline import trace as _trace
from repro_torch.runtime import chaos

# the aten contractions (matmul, einsum and linear reach a dispatch mode
# as these)
CONTRACTIONS = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
    "convolution", "_convolution", "_int_mm", "_scaled_mm",
})
# the recorder's own frames, skipped when attributing an op
_OWN = frozenset({"analysis/dispatch_audit.py", "roofline/trace.py"})

B, S = 2, 8


@dataclass(frozen=True)
class Event:
    """One op the audit checks: ``kind`` is ``contraction``,
    ``int8_cast``, ``psum`` or ``permute``; ``frames`` its (file,
    function) Python frames, innermost first."""

    kind: str
    op: str
    frames: Tuple[Tuple[str, str], ...]
    shape: tuple = ()
    float_dtypes: tuple = ()
    cuda: bool = False


@dataclass
class Record:
    """What one audited run did — the port's counterpart of a closed
    jaxpr: the checked events, each kernel wrapper's calls, and the
    substrate's dispatch and plan logs as the run left them."""

    events: List[Event] = field(default_factory=list)
    launches: Dict[str, int] = field(default_factory=dict)
    dispatches: Dict[str, int] = field(default_factory=dict)
    site_plans: Dict[str, object] = field(default_factory=dict)


def _frames() -> Tuple[Tuple[str, str], ...]:
    out = []
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if contract.repro_rel(name) not in _OWN:
            out.append((name, f.f_code.co_name))
        f = f.f_back
    return tuple(out)


class _Recorder(TorchDispatchMode, _trace.Listener):
    """The mode :func:`record` runs a call under."""

    def __init__(self):
        super().__init__()
        self.events: List[Event] = []
        self.launches: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in CONTRACTIONS:
            ts = _trace._tensors(args, [])
            self.events.append(Event(
                "contraction", name, _frames(),
                shape=tuple(ts[0].shape) if ts else (),
                cuda=any(t.is_cuda for t in ts)))
        elif name == "_to_copy" and kwargs.get("dtype") == torch.int8:
            # every cast (``.to(dtype)``, ``.type``) reaches a dispatch
            # mode as _to_copy, its dtype a keyword
            x = args[0]
            if x.dtype != torch.int8 and x.dim() >= 2:
                self.events.append(Event("int8_cast", name, _frames(),
                                         shape=tuple(x.shape),
                                         cuda=x.is_cuda))
        return func(*args, **kwargs)

    # -- the roofline.trace hooks ---------------------------------------------
    def kernel(self, name, cost, fn, args, kwargs):
        self.launches[name] += 1
        return fn(*args, **kwargs)

    def collective(self, kind, t, n, t2=None):
        if kind not in ("all-reduce", "collective-permute"):
            return
        ts = _trace._tensors([t, t2], [])
        self.events.append(Event(
            "psum" if kind == "all-reduce" else "permute", kind, _frames(),
            float_dtypes=tuple(x.dtype for x in ts
                               if x.is_floating_point()),
            cuda=any(x.is_cuda for x in ts)))


def record(fn: Callable, *args, **kwargs) -> Record:
    """Run ``fn(*args, **kwargs)`` under the recorder; the dispatch and
    plan logs are copied as the run leaves them (clear them first:
    :func:`reset_memos`)."""
    rec = _Recorder()
    with _trace.listening(rec), rec:
        fn(*args, **kwargs)
    return Record(events=rec.events, launches=dict(rec.launches),
                  dispatches=dict(substrate.DISPATCH_COUNTS),
                  site_plans=dict(substrate.SITE_PLANS))


def reset_memos() -> None:
    """Clear the plan, quantization and weight-block memos and the
    site/dispatch logs: an entry audited after another then finds what
    it finds alone (``quantize_weight`` is memoized, and a memo hit casts
    nothing)."""
    substrate.clear_plan_cache()
    substrate.clear_quant_cache()
    substrate.clear_shard_cache()


# ---------------------------------------------------------------------------
# the checks

def _is_ours(frames, names) -> bool:
    return any(fn in names and contract.repro_rel(f) is not None
               for f, fn in frames)


def audit_record(rec: Record, *, quantized: bool = False,
                 act_quantized: bool = False,
                 label: str = "trace") -> List[Finding]:
    """AF001, AF002's dtype leg and AF003/AF008 over one run.

    ``act_quantized`` declares a W8A8 backend: dynamic activation
    quantization — ``quantize_tile`` in the kernels' plain versions and
    the batched-QK ``_quantize`` of K in ``_batched_exec`` — is then the
    priced quantize boundary, not an AF003/AF008 candidate."""
    findings: List[Finding] = []
    for ev in rec.events:
        if ev.kind == "contraction":
            verdict, where = contract.classify_frames(ev.frames)
            if verdict == "unattributed":
                findings.append(Finding(
                    "AF001", f"{label} @ {where}",
                    f"aten.{ev.op} not attributable to a substrate dispatch "
                    f"site or an ALLOWLIST entry (raw GEMM bypasses Eq.(6') "
                    f"planning)", pass_name="dispatch"))
        elif ev.kind == "psum":
            bad = [dt for dt in ev.float_dtypes if dt != torch.float32]
            if not bad:
                continue
            verdict, where = contract.classify_frames(ev.frames)
            if quantized or verdict == "substrate":
                findings.append(Finding(
                    "AF002", f"{label} @ {where}",
                    f"psum on {[str(d) for d in bad]} operands — sharded "
                    f"contraction reductions must accumulate in fp32",
                    pass_name="dispatch"))
        elif ev.kind == "int8_cast":
            if act_quantized and _is_ours(ev.frames,
                                          ("quantize_tile", "_batched_exec")):
                # declared W8A8 dynamic activation quantize: the per-tile
                # quantizer / the batched-QK quantize of K is the Eq.(5')
                # boundary the plan priced (actq_ops), by design re-run
                # per step — neither weight quantization nor a rogue cast
                continue
            _, where = contract.classify_frames(ev.frames)
            if _is_ours(ev.frames, ("quantize_weight", "_quantize")):
                findings.append(Finding(
                    "AF008", f"{label} @ {where}",
                    f"weight quantization of {ev.shape} run inside the step "
                    f"(substrate.quantize_weight on a raw weight) — re-run "
                    f"whenever the memo misses until params are "
                    f"pre-quantized", pass_name="dispatch"))
            else:
                findings.append(Finding(
                    "AF003", f"{label} @ {where}",
                    f"cast to int8 of a weight-shaped {ev.shape} operand "
                    f"outside substrate.quantize_weight (rogue "
                    f"re-quantization)", pass_name="dispatch"))
    return findings


def check_psum_boundaries(rec: Record, *, quantized: bool = False,
                          site_plans=None,
                          label: str = "trace") -> List[Finding]:
    """AF002, sharding-contract leg: every substrate psum under a
    quantizing backend must sit at a collapsed-block boundary the plan
    priced.

    A substrate-attributed float psum means ``_sharded_gemm`` took the
    reduce path, so the recorded plans (the run's ``SITE_PLANS``, or
    ``site_plans``) must include one whose ``ShardSig.reduce_ops > 0`` —
    the ``ceil(log2(shards))`` combine-tree adds entered the Eq.(5')
    argmin.  A psum with no priced reduce anywhere means the collapse
    depth was chosen as if the cross-shard combine were free."""
    if not quantized:
        return []
    plans = rec.site_plans if site_plans is None else site_plans
    priced = any(p.shard.reduce_ops > 0 for p in plans.values())
    findings: List[Finding] = []
    for ev in rec.events:
        if ev.kind != "psum" or not ev.float_dtypes:
            continue
        verdict, where = contract.classify_frames(ev.frames)
        if verdict != "substrate" or priced:
            continue
        findings.append(Finding(
            "AF002", f"{label} @ {where}",
            "substrate psum on the quantized path but no recorded site "
            "plan priced a reduce boundary (ShardSig.reduce_ops == 0 "
            "everywhere) — the collapse depth was chosen as if the "
            "cross-shard combine were free", pass_name="dispatch"))
    return findings


def check_stage_boundaries(rec: Record, *, site_plans=None,
                           label: str = "trace") -> List[Finding]:
    """AF002, pipeline-transfer leg: a stage hand-off must be priced by
    some recorded plan.

    ``parallel.pipeline.staged_step`` moves the activation stage to stage
    once per step; that hop is priced into the boundary site's plan by
    ``sharding.use_pp_pricing`` (prefill: Eq.(5') boundary ops; decode:
    Eq.(6'') serialized ingress cycles).  A hand-off from ``staged_step``
    while *no* recorded plan carries ``ShardSig.transfer_ops > 0`` or
    ``transfer_cycles > 0`` means the pipeline ran without a role pricing
    scope — the collapse depths were chosen as if the transfer were
    free."""
    plans = rec.site_plans if site_plans is None else site_plans
    priced = any(p.shard.transfer_ops > 0 or p.shard.transfer_cycles > 0
                 for p in plans.values())
    findings: List[Finding] = []
    for ev in rec.events:
        if ev.kind != "permute" or priced \
                or not _is_ours(ev.frames, ("staged_step",)):
            continue
        _, where = contract.classify_frames(ev.frames)
        findings.append(Finding(
            "AF002", f"{label} @ {where}",
            "stage-boundary collective_permute made by "
            "parallel.pipeline.staged_step but no recorded site plan "
            "priced the transfer (ShardSig.transfer_ops == "
            "transfer_cycles == 0 everywhere) — the pipeline hop never "
            "entered the Eq.(5')/(6'') argmin (missing "
            "sharding.use_pp_pricing role scope)", pass_name="dispatch"))
    return findings


def check_recorded_sites(cfg: Optional[ModelConfig] = None,
                         label: str = "trace",
                         counts=None) -> List[Finding]:
    """AF007 over ``substrate.DISPATCH_COUNTS`` (or ``counts``): every
    recorded label must be planner-known; with a ``cfg``, labels must
    also belong to that config's own ``model_gemms`` walk (plus the extra
    dispatch sites)."""
    known = planner.site_registry()
    if cfg is not None:
        own = set(planner.EXTRA_DISPATCH_SITES)
        for shape in (ShapeConfig("audit_train", 64, 2, "train"),
                      ShapeConfig("audit_decode", 64, 2, "decode")):
            own.update(g.name for g in planner.model_gemms(cfg, shape))
    else:
        own = known
    findings = []
    counts = substrate.DISPATCH_COUNTS if counts is None else counts
    for site in counts:
        for part in site.split("+"):
            if part not in known:
                findings.append(Finding(
                    "AF007", f"{label} @ site={site!r}",
                    f"dispatch label {part!r} unknown to "
                    f"planner.model_gemms", pass_name="dispatch"))
            elif part not in own:
                findings.append(Finding(
                    "AF007", f"{label} @ site={site!r}",
                    f"dispatch label {part!r} is not in this config's own "
                    f"GEMM walk", pass_name="dispatch"))
    return findings


def fallbacks(rec: Record) -> List[str]:
    """Where an aten contraction on a CUDA tensor ran under a kernel
    wrapper's ``*_plain`` frame: the wrapper took its plain version."""
    out = []
    for ev in rec.events:
        if ev.kind != "contraction" or not ev.cuda:
            continue
        for f, fn in ev.frames:
            rel = contract.repro_rel(f)
            if rel is not None and contract.is_substrate_file(rel) \
                    and fn.endswith("_plain"):
                out.append(f"{rel}:{fn} aten.{ev.op}")
                break
    return out


def _meta(rec: Record) -> dict:
    return {"dispatches": sum(rec.dispatches.values()),
            "sites": sorted(rec.dispatches),
            "launches": dict(rec.launches),
            "fallbacks": fallbacks(rec)}


# ---------------------------------------------------------------------------
# entry points

def _audit_entries(cfg: ModelConfig, entries, label: str,
                   meta: Optional[dict], pipeline: bool) -> List[Finding]:
    quantized = substrate.backend_quantizes(cfg.gemm_backend)
    act_quantized = substrate.backend_act_quantizes(cfg.gemm_backend)
    findings: List[Finding] = []
    with torch.no_grad(), chaos.scope(None):
        for entry, fn, args in entries:
            reset_memos()                # fresh memos and site log
            rec = record(fn, *args)
            cell = f"{label}/{entry}"
            findings.extend(audit_record(rec, quantized=quantized,
                                         act_quantized=act_quantized,
                                         label=cell))
            findings.extend(check_psum_boundaries(rec, quantized=quantized,
                                                  label=cell))
            if pipeline:
                findings.extend(check_stage_boundaries(rec, label=cell))
            findings.extend(check_recorded_sites(cfg, label=cell,
                                                 counts=rec.dispatches))
            if meta is not None:
                meta[entry] = _meta(rec)
    reset_memos()
    return findings


def _step_inputs(cfg: ModelConfig, dev):
    """The reference's audit inputs: zero tokens, a fresh cache of
    ``S`` positions, one decode token at position 1, a 4-token prefill
    chunk from position 0."""
    tokens = torch.zeros((B, S), dtype=torch.int64, device=dev)
    token = torch.zeros((B,), dtype=torch.int64, device=dev)
    pos = torch.ones((B,), dtype=torch.int64, device=dev)
    ptoks = torch.zeros((B, 4), dtype=torch.int64, device=dev)
    ppos = torch.zeros((B,), dtype=torch.int64, device=dev)
    lens = torch.full((B,), 4, dtype=torch.int64, device=dev)
    return tokens, token, pos, ptoks, ppos, lens


def audit_model(cfg: ModelConfig, label: str = "", *,
                prequantize: bool = False, device=None,
                meta: Optional[dict] = None) -> List[Finding]:
    """Run forward / decode_step / prefill_step for ``cfg`` under the
    recorder and run every check plus the dispatch-site cross-check.
    ``cfg`` carries the backend (``gemm_backend``) and mesh
    (``mesh_shape``; the caller provides its devices, e.g.
    ``launch.mesh.host_devices(2)`` for (1, 2)) under audit.

    ``prequantize`` audits the serving configuration: the parameter tree
    is pre-quantized with ``lm.prequantize_params`` before the run, so a
    quantizing backend should then give no AF008 (the serving engine
    dispatches this tree; the default ``False`` audits the raw tree,
    which is expected to carry AF008).  ``meta`` (a dict) receives each
    entry's dispatches, sites, kernel wrapper calls and fallbacks."""
    label = label or f"{cfg.name}/{cfg.gemm_backend}"
    dev = resolve_device(device)
    params = lm.init_params(cfg, seed=0, device=dev)
    if prequantize:
        params = lm.prequantize_params(cfg, params)
    tokens, token, pos, ptoks, ppos, lens = _step_inputs(cfg, dev)
    entries = [
        ("forward", lm.forward, (cfg, params, {"tokens": tokens})),
        ("decode_step", lm.decode_step,
         (cfg, params, lm.init_cache(cfg, B, S, device=dev), token, pos)),
    ]
    if lm.supports_batched_prefill(cfg):
        entries.append(("prefill_step", lm.prefill_step,
                        (cfg, params, lm.init_cache(cfg, B, S, device=dev),
                         ptoks, ppos, lens)))
    return _audit_entries(cfg, entries, label, meta, pipeline=False)


def audit_pipeline(cfg: ModelConfig, label: str = "", *, device=None,
                   meta: Optional[dict] = None) -> List[Finding]:
    """The audit over the pipeline-sharded entry points
    (``lm.decode_step_pp`` / ``lm.prefill_step_pp``): every colocated
    check plus :func:`check_stage_boundaries`.

    ``cfg`` must satisfy ``lm.supports_pipeline`` (pp_stages > 1, a
    (pp, data, model) mesh_shape) and the caller must provide the mesh's
    devices — the disaggregated engine's role configs qualify.  The
    serving tree is audited (pre-quantized on a quantizing backend), so a
    clean cell is also AF008-free."""
    label = label or (f"{cfg.name}/{cfg.gemm_backend}/"
                      f"{cfg.pp_role or 'unscoped'}-pp{cfg.pp_stages}")
    dev = resolve_device(device)
    params = lm.prequantize_params(cfg, lm.init_params(cfg, seed=0,
                                                       device=dev))
    _, token, pos, ptoks, ppos, lens = _step_inputs(cfg, dev)
    entries = [
        ("decode_step_pp", lm.decode_step_pp,
         (cfg, params, lm.init_cache(cfg, B, S, device=dev), token, pos)),
        ("prefill_step_pp", lm.prefill_step_pp,
         (cfg, params, lm.init_cache(cfg, B, S, device=dev), ptoks, ppos,
          lens)),
    ]
    return _audit_entries(cfg, entries, label, meta, pipeline=True)
