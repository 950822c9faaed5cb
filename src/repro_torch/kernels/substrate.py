"""GEMM execution substrate: one dispatch layer for every model GEMM.

Port of the reference's ``kernels/substrate.py``.  Every
dense contraction in nn/ and models/ routes through :func:`gemm` (or
:func:`batched_gemm` for the attention QK/PV products), which

  * resolves the GEMM's :class:`GemmPlan` from a process-wide **plan
    cache** keyed on ``(M, N, T, backend, epilogue, shard)`` — the
    Eq.(6') argmin runs once per shape, not once per serving step;
  * records the plan under the caller's **site label** (``attn.wq``,
    ``mlp.wo``, ``attn.qk``, ...), the names ``core.planner.model_gemms``
    emits, and counts the dispatch in :data:`DISPATCH_COUNTS`;
  * dispatches to a **backend** from a registry:

      ``xla``        plain ``torch.matmul`` in the operands' dtype (named
                     after the reference's backend so configs carry over),
      ``arrayflex``  the CUDA K-collapse kernel at the planned k (its plain
                     PyTorch version for CPU tensors),
      ``arrayflex_int8``  the same kernel on int8 weight codes (W8): the
                     dispatch swaps each weight for codes + per-output-
                     channel scales (a pre-quantized :class:`QuantizedTensor`
                     leaf, or the :func:`quantize_weight` memo), and the
                     dequant rides the kernel's store,
      ``arrayflex_w8a8``  W8 plus per-tile int8 activations in the kernel's
                     step prologue (W8A8); on the batched products only
                     ``attn.qk`` quantizes (:data:`BATCHED_ACTQ_SITES`),
      ``ref``        an fp32-everywhere oracle for equivalence tests.

:func:`expert_gemm` runs the MoE expert banks (``moe.wi_gate``,
``moe.wi_up``, ``moe.wo``): every expert of a site in one launch of the
expert kernel, on int8 codes under the quantizing backends.

The port runs eagerly, so :data:`DISPATCH_COUNTS` counts every dispatch a
step executes (one per layer and site), where the reference's jit-traced
count is one per traced site.  For the arrayflex backend one dispatch is
one kernel launch.

**Epilogues**: ``gemm(..., epilogue="silu"|"gelu"|"swiglu", bias=...,
w2=..., residual=..., norm_scale=...)`` fuses bias add, activation, the
dual-contraction gated multiply and the residual join into the arrayflex
kernel's store, and the rmsnorm scale into its step prologue.  Unfused
backends (xla/ref) apply the identical math as a pre/post-pass, so every
backend computes the same function.

Shape convention matches core.planner: ``gemm(x, w)`` with ``x: (..., K)``
and ``w: (K, N_out)`` is the planner GEMM ``X[T, M] = A[T, N] x B[N, M]``
with ``M = N_out``, ``N = K``, ``T = prod(leading dims)``.

**Chaos** (``substrate.dispatch``, :func:`_maybe_chaos_fault`): under an
active :mod:`repro_torch.runtime.chaos` engine each dispatch entry may
raise an injected :class:`~repro_torch.serving.errors.KernelFault` before
its backend runs, so the faulted site launches nothing.  The reference
draws while ``jax.jit`` traces a step — once per dispatch of its one
traced super-block (the ``lax.scan`` body: one layer, or the hybrid's
period of eight sub-layers), plus the unembed, and never again once the
trace is cached — and the serving engine reproduces that: inside
:func:`chaos_trace_scope` a site label draws on its first dispatch of
the attempt in each sub-layer position of the period
(:func:`chaos_sublayer`, which ``lm.decode_step`` sets; a label a
sub-layer dispatches twice, as a cross-attending one does attn.qk and
attn.pv, draws at each of its call sites there), and the engine runs a
step that has completed once with the point inactive.

**Sharded dispatch**: :func:`gemm`, :func:`batched_gemm` and
:func:`expert_gemm` take ``shard=`` (a :class:`ShardCtx`, derived per
site by ``parallel.sharding.gemm_shard_ctx`` and friends under the mesh
the lm entry points activate).  The plan cache is keyed on ``(M, N, T,
backend, epilogue, shard)``: the :class:`ShardSig` prices a sharded
dispatch's per-shard shape, its reduce tree and pipeline-stage transfer
terms, so ``best_k`` is picked for the GEMM each shard runs.  Where the
reference runs the backend inside ``jax.shard_map``, the port is a
single controller: each distinct shard's GEMM is its own kernel launch at
the shard's shapes on the shard's device (``DeviceMesh.device``), one
after another; the psum of a sharded contraction is an fp32 sum in fixed
shard order, the all-gather a copy of each block into the output on x's
device.  A strided weight block (a column slice) is copied contiguous
once per weight and block (:func:`shard_cache_info`).  A pricing-only
context (no mesh: a disaggregated role's boundary site under
``parallel.sharding.use_pp_pricing``) plans under its signature and
dispatches unsharded, as the reference's does.

**Audit hooks** (``repro_torch.analysis``): :data:`PLAN_KEY_PARAMS`,
:data:`CALL_FIELD_KEYING` and :data:`BACKEND_FIELD_KEYING` declare how the
plan key covers every ``GemmCall`` / ``BackendInfo`` field (AF006); under
strict audit (:class:`strict_audit_scope` or ``REPRO_STRICT_AUDIT=1``) a
dispatch whose site label is empty or unknown to ``planner.model_gemms``
raises ``[AF007]`` before its backend runs, and
:func:`check_dispatch_sites` checks the recorded labels after the fact.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import itertools
import math
import os
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import planner, timing
from repro_torch.kernels import ops
from repro_torch.kernels.runtime import to_device
from repro_torch.kernels.arrayflex_gemm import (INV_127, apply_epilogue,
                                                prologue_phase)
from repro_torch.roofline import trace as _trace
from repro_torch.runtime import chaos


# ---------------------------------------------------------------------------
# epilogue spec (hashable: lives in the plan-cache key and in GemmPlan)

EPILOGUE_KINDS = ("none", "silu", "gelu", "swiglu")


@dataclass(frozen=True)
class Epilogue:
    """What is fused after the contraction, at the carry-propagate store
    (and, for ``norm_scale``, in front of it as the step prologue).  Pure
    shape-level metadata, so the spec is hashable and keys the plan."""

    kind: str = "none"
    bias: bool = False
    bias2: bool = False
    residual: bool = False
    norm_scale: bool = False

    @property
    def dual(self) -> bool:
        return self.kind == "swiglu"

    @property
    def activation(self) -> str:
        return "silu" if self.kind == "swiglu" else self.kind

    @property
    def ops(self) -> int:
        """Fused vector ops at the collapsed-block boundary (Eq. 5' ``e``):
        one per activation, gate multiply, bias add, residual add, and
        prologue norm-scale multiply."""
        return ((self.activation != "none") + self.dual
                + self.bias + self.bias2 + self.residual
                + self.norm_scale)

    @property
    def contractions(self) -> int:
        return 2 if self.dual else 1


EPILOGUE_NONE = Epilogue()


@dataclass
class GemmCall:
    """Per-call execution context handed to backends (operand tensors are
    not part of the memoized plan)."""

    out_dtype: Any = None       # None -> operand dtype; else fp32-acc cast
    w2: Any = None              # second contraction (epilogue.dual)
    bias: Any = None            # (N_out,) fused bias
    bias2: Any = None           # (N_out,) fused bias on the w2 contraction
    residual: Any = None        # (T, N_out) residual joined after the epilogue
    norm_scale: Any = None      # (K,) rmsnorm gain fused as the x prologue
    w_scale: Any = None         # (N_out,) dequant of int8 w (quantizing backends)
    w2_scale: Any = None        # (N_out,) dequant of int8 w2


# ---------------------------------------------------------------------------
# plan-key introspection metadata (audited by analysis.kernel_check)
#
# The Eq.(6') plan cache keys on exactly these _plan_gemm_cached params;
# every GemmCall / BackendInfo field must either be covered by that key or
# be declared plan-irrelevant below.  analysis.kernel_check fails (AF006)
# on any dataclass field missing from its declaration table — adding a
# field to GemmCall/BackendInfo without deciding its keying story here is
# a build error, not silent plan-cache aliasing.

PLAN_KEY_PARAMS = ("M", "N", "T", "backend", "epilogue", "shard")

# GemmCall field -> keying declaration.  "epilogue:<attr>" means the field's
# presence is forced by that Epilogue attribute (which IS in the key);
# "backend:<attr>" likewise via BackendInfo (the backend name is in the
# key and re-registration evicts cached plans); "operand:" means the field
# is pure per-call runtime data that cannot change the planned k.
CALL_FIELD_KEYING = {
    "out_dtype": "operand: output cast only — the planned k is blind to the "
                 "store dtype (datapath precision rides the backend name)",
    "w2": "epilogue:dual — w2 present iff kind=='swiglu' (_epilogue_spec "
          "enforces the iff)",
    "bias": "epilogue:bias",
    "bias2": "epilogue:bias2",
    "w_scale": "backend:quantize — scales present iff the keyed backend "
               "quantizes (dequant_ops priced from BackendInfo.quantize)",
    "w2_scale": "backend:quantize",
    "residual": "epilogue:residual — residual present iff the keyed "
                "Epilogue spec carries the fused residual add",
    "norm_scale": "epilogue:norm_scale — the prologue rmsnorm gain is "
                  "present iff the keyed Epilogue spec prices it",
}

# BackendInfo field -> how the plan key covers it.  All metadata is carried
# by the backend *name* in the key: register_backend evicts cached plans on
# (re-)registration, so a name whose metadata changed cannot serve stale k.
BACKEND_FIELD_KEYING = {
    "fn": "identity: the name resolves fn at dispatch; plans never embed it",
    "collapse": "keyed-by-name: read inside _plan_gemm_cached",
    "precision": "keyed-by-name: read inside _plan_gemm_cached",
    "quantize": "keyed-by-name: read inside _plan_gemm_cached (dequant_ops)",
    "act_quantize": "keyed-by-name: read inside _plan_gemm_cached "
                    "(actq_ops — the Eq.(5') quantize boundary term)",
}


# ---------------------------------------------------------------------------
# strict-audit mode: routing violations become runtime errors
#
# REPRO_STRICT_AUDIT=1 (env) or the strict_audit_scope context manager turns
# an unknown/empty dispatch site label into a RuntimeError at dispatch time
# ([AF007], the finding code analysis.dispatch_audit reports for the same
# violation), raised before the dispatch launches anything — instead of a
# silent new DISPATCH_COUNTS key.

_STRICT_AUDIT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_strict_audit", default=None)


def strict_audit_enabled() -> bool:
    """Contextvar wins when set; else the REPRO_STRICT_AUDIT env var."""
    v = _STRICT_AUDIT.get()
    if v is not None:
        return bool(v)
    return os.environ.get("REPRO_STRICT_AUDIT", "") not in ("", "0")


class strict_audit_scope:
    """``with strict_audit_scope(): ...`` — site-label violations raise."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._token = None

    def __enter__(self):
        self._token = _STRICT_AUDIT.set(self.enabled)
        return self

    def __exit__(self, *exc):
        _STRICT_AUDIT.reset(self._token)
        return False


def _known_sites() -> frozenset:
    return planner.site_registry()


def check_dispatch_sites(counts: Optional[Dict[str, int]] = None) -> None:
    """Assert every recorded dispatch label is planner-known.

    The cheap DISPATCH_COUNTS <-> planner.model_gemms drift check: a
    dispatch under a site the planner does not know is an error, not a
    silent new dict key.  The serving engine runs it after a run under
    strict audit."""
    known = _known_sites()
    unknown = sorted(
        label
        for site in (counts if counts is not None else DISPATCH_COUNTS)
        for label in site.split("+") if label not in known)
    if unknown:
        raise RuntimeError(
            f"[AF007] dispatch site labels unknown to planner.model_gemms: "
            f"{unknown}; known sites: {sorted(known)}")


# ---------------------------------------------------------------------------
# weight quantization (the quantizing backends' memoized prologue)

# site labels whose weights stay fp32 under a quantizing backend: the
# router's logits feed a discrete top-k, where quantization noise would
# change which experts run instead of adding bounded output error.
QUANT_EXEMPT_SITES = frozenset({"moe.router"})

# id(weight) -> (weakref, int8 codes, fp32 scales).  Keyed on the weight
# tensor's identity: every dispatch after the first is a dict hit.  The
# weakref's death callback evicts the entry, and the ``ref() is w`` guard
# keeps a reused id from serving a stale quantization.
_QUANT_CACHE: Dict[int, tuple] = {}
QUANT_CACHE_STATS = {"hits": 0, "misses": 0}


def _quantize(w, *, compiled: bool = False):
    """Symmetric per-output-channel int8: codes in [-127, 127], fp32
    scales over the contraction axis (-2), ``scale = max(amax, 1e-12) /
    127`` and ``codes = clip(round(w / scale))`` with round half to even,
    so ``codes * scale`` recovers the weight to within scale/2.  Both
    divisions are IEEE divisions by tensors: PyTorch's CUDA division by a
    Python scalar multiplies by the reciprocal instead, which can round
    differently from the reference.

    ``compiled=True`` computes the scale as the reference's quantizer
    does inside a compiled step (the W8A8 ``attn.qk`` K^T quantize):
    ``max(amax, 1e-12) * fp32(1/127)``, which XLA puts in place of the
    division and which differs from it in the last bit at some amax.  The
    default division is the reference's eager weight quantizer
    (``prequantize_params``)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2)
    if compiled:
        scale = torch.clamp(amax, min=1e-12) * torch.full_like(amax, INV_127)
    else:
        scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(w32 / scale.unsqueeze(-2)), -127, 127)
    # elementwise ops keep a transposed input's strides: the kernels want
    # unit stride along N
    return q.to(torch.int8).contiguous(), scale


def quantize_weight(w):
    """(int8 codes, fp32 per-output-channel scales) for a weight tensor,
    memoized on the tensor's identity (``hits``/``misses`` in
    :data:`QUANT_CACHE_STATS`).

    A 2-D (K, N) weight quantizes per output column (scales (N,)); a
    stacked (..., K, N) one per (leading index, column).  PyTorch runs
    eagerly, so there is no traced path (the reference's ``traced``
    counter): a call hits the memo or quantizes once and stores.  A fresh
    view of a weight is a new tensor and misses; served trees avoid that
    by quantizing once at load (:func:`prequantize`)."""
    key = id(w)
    ent = _QUANT_CACHE.get(key)
    if ent is not None and ent[0]() is w:
        QUANT_CACHE_STATS["hits"] += 1
        return ent[1], ent[2]
    QUANT_CACHE_STATS["misses"] += 1
    q, s = _quantize(w)
    ref = weakref.ref(w, lambda _, k=key: _QUANT_CACHE.pop(k, None))
    _QUANT_CACHE[key] = (ref, q, s)
    return q, s


class QuantizedTensor:
    """A weight quantized once at load time: int8 ``codes`` and fp32
    per-output-channel ``scale`` (the :func:`_quantize` pair), one leaf of
    a parameter tree.

    ``lm.prequantize_params`` builds these from the compute-dtype cast of
    each weight, and the dispatch (:func:`gemm`) unpacks them.  Codes and
    scale move together (``to(device)``) and slice together (``t[l]``,
    along the leading stack axes of a (..., K, N) weight, as
    ``lm._layer`` takes a layer's view).  A dtype cast (``to(dtype)``) is
    a no-op: layers cast weights to the compute dtype before dispatch, and
    that cast is already in the codes."""

    __slots__ = ("codes", "scale")

    def __init__(self, codes, scale):
        self.codes = codes
        self.scale = scale

    @property
    def shape(self):
        return self.codes.shape

    @property
    def ndim(self):
        return self.codes.ndim

    def to(self, *args, **kwargs):
        device = kwargs.get("device")
        for a in args:
            if isinstance(a, (str, torch.device)):
                device = a
        if device is None:
            return self
        return QuantizedTensor(self.codes.to(device), self.scale.to(device))

    def __getitem__(self, idx):
        if self.codes.ndim < 3:
            raise TypeError("only a stacked (..., K, N) QuantizedTensor "
                            "slices, along its leading axes")
        return QuantizedTensor(self.codes[idx], self.scale[idx])

    def __repr__(self):
        return (f"QuantizedTensor(codes={tuple(self.codes.shape)}, "
                f"scale={tuple(self.scale.shape)})")


def prequantize(w) -> QuantizedTensor:
    """Quantize a weight now into a :class:`QuantizedTensor`, with the same
    :func:`_quantize` the dispatch memo runs, so the codes are the same
    either way.

    A stacked weight (a layer stack (n_super, K, N), or an MoE expert
    bank (n_super, E, K, N)) is quantized one leading index at a time into
    preallocated codes and scales, so its fp32 temporaries are one
    slice's, not the whole stack's (tens of GB for a full-width bank or a
    48-layer stack of 5120 x 13824 weights).  The codes are the same bit
    for bit: the amax runs over the contraction axis only."""
    if w.ndim <= 2:
        return QuantizedTensor(*_quantize(w))
    codes = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*w.shape[:-2], w.shape[-1]), dtype=torch.float32,
                        device=w.device)
    for i in range(w.shape[0]):
        q = prequantize(w[i])
        codes[i], scale[i] = q.codes, q.scale
    return QuantizedTensor(codes, scale)


def quantize_cache_info() -> Dict[str, int]:
    """hits / misses counters plus the memo's current size."""
    return dict(QUANT_CACHE_STATS, size=len(_QUANT_CACHE))


def clear_quant_cache():
    _QUANT_CACHE.clear()
    for k in QUANT_CACHE_STATS:
        QUANT_CACHE_STATS[k] = 0


# ---------------------------------------------------------------------------
# shard signature / context

@dataclass(frozen=True)
class ShardSig:
    """Post-partition signature of a sharded dispatch (plan-cache key part).

    ``rows``/``contraction``/``cols`` are the shard counts of the logical
    T / N / M dims; ``reduce_ops`` prices the contraction psum's combine
    tree (``ceil(log2(shards))`` boundary adds) into Eq.(5').

    ``transfer_ops``/``transfer_cycles`` price a pipeline-stage boundary
    into the plan: ``transfer_ops`` are boundary ALU stages on the period
    (k-independent, so they deepen the argmin like epilogue ops), while
    ``transfer_cycles`` serialize the incoming activation in front of the
    schedule (Eq. 6'': paid at the k-collapsed period, so they shallow
    it).  A throughput-bound prefill stage prices the egress tree, a
    latency-bound decode stage the ingress — which is how ``best_k``
    differs per serving role at the same (M, N, T).
    """

    rows: int = 1
    contraction: int = 1
    cols: int = 1
    reduce_ops: int = 0
    transfer_ops: int = 0
    transfer_cycles: int = 0


SHARD_NONE = ShardSig()


def _spec_shards(mesh, entry) -> int:
    """Total shard count a spec entry (None, an axis name or a tuple of
    them) induces under ``mesh`` (absent axes, or no mesh, count 1)."""
    from repro_torch.parallel.sharding import mesh_axis_size
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    n = 1
    for a in axes:
        n *= mesh_axis_size(mesh, a)
    return n


@dataclass(frozen=True)
class ShardCtx:
    """How one substrate dispatch runs under a mesh.

    ``x_spec``/``w_spec``/``out_spec`` are per-dim spec tuples of the
    operands as dispatched (x flattened to ``(T, K)`` for :func:`gemm`):
    each entry None (replicated), a mesh axis name or a tuple of them.
    ``reduce_axes`` names the mesh axes the contraction is sharded over.
    ``transfer_ops``/``transfer_cycles`` carry a pipeline-stage boundary
    price into the :class:`ShardSig`.

    A context with a mesh runs each distinct shard's GEMM as its own
    launch at the shard's shapes on the shard's device
    (``mesh.device(coord)``) and gathers the blocks on x's device.  A
    **pricing-only** context (``mesh is None``, replicated specs — built
    by ``parallel.sharding.pricing_shard_ctx``) keys and prices the plan
    with its signature and dispatches unsharded, as the reference's does.
    """

    mesh: Any
    x_spec: Any
    w_spec: Any
    out_spec: Any
    reduce_axes: tuple = ()
    transfer_ops: int = 0
    transfer_cycles: int = 0

    def axis_shards(self, entry) -> int:
        return _spec_shards(self.mesh, entry)

    def signature(self) -> ShardSig:
        """ShardSig for the 2-D :func:`gemm` entry (the plan-cache key)."""
        r = _spec_shards(self.mesh, tuple(self.reduce_axes) or None)
        return ShardSig(
            rows=self.axis_shards(self.x_spec[0]),
            contraction=self.axis_shards(self.x_spec[1]),
            cols=self.axis_shards(self.w_spec[1]),
            reduce_ops=math.ceil(math.log2(r)) if r > 1 else 0,
            transfer_ops=self.transfer_ops,
            transfer_cycles=self.transfer_cycles)

    def divides(self, T: int, K: int, N_out: int) -> bool:
        s = self.signature()
        return (T % s.rows == 0 and K % s.contraction == 0
                and N_out % s.cols == 0)


# ---------------------------------------------------------------------------
# shard execution (single controller: each shard's GEMM is its own launch
# at the shard's shapes, on the shard's device, one after another)

def _spec_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _shard_coords(mesh, *specs):
    """One coordinate (mesh axis name -> index) per distinct shard of a
    dispatch: every combination of the axes ``specs`` name, row-major in
    the mesh's axis order.  Axes no spec names would only replicate the
    same block, so they stay at index 0 (one launch a distinct block)."""
    used = {a for spec in specs for e in spec for a in _spec_axes(e)}
    names = [a for a in mesh.axis_names if a in used]
    return [dict(zip(names, idx)) for idx in itertools.product(
        *(range(mesh.shape[a]) for a in names))]


def _block_index(shape, spec, coord, mesh) -> tuple:
    """The slices of ``coord``'s block of an operand of ``shape`` laid out
    by ``spec`` (a dim split over several axes: the first axis major)."""
    from repro_torch.parallel.sharding import mesh_axis_size
    idx = []
    for size, entry in zip(shape, spec):
        n, i = 1, 0
        for a in _spec_axes(entry):
            s = mesh_axis_size(mesh, a)
            i = i * s + coord.get(a, 0)
            n *= s
        b = size // n
        idx.append(slice(i * b, (i + 1) * b))
    return tuple(idx)


def _call_block(t, spec, coord, mesh, dev):
    """A per-call operand's block on ``dev`` — an activation, a residual,
    a bias, a scale — contiguous (a column slice of a row-major
    activation is strided: it is copied each call)."""
    if t is None:
        return None
    return to_device(t[_block_index(t.shape, spec, coord, mesh)].contiguous(),
                     dev)


# id(base tensor) -> (weakref to it, {block key: contiguous block on its
# device}).  A weight's column block is strided in its row-major storage
# and a kernel wants it contiguous: it is copied once per (weight, block,
# device) and reused by every later dispatch.  Keyed on the storage a
# weight view lies in (the stacked layer tensor a per-layer view slices),
# so the per-step views of one served tree hit; the weakref's death
# callback evicts a tree's blocks with it.
_SHARD_CACHE: Dict[int, tuple] = {}
SHARD_CACHE_STATS = {"hits": 0, "misses": 0}


def _weight_block(w, spec, coord, mesh, dev):
    """A weight operand's block on ``dev``: the view itself when it is
    contiguous there (a row block, an expert slice), else the memoized
    contiguous copy.

    A weight that requires a gradient under grad mode (training) bypasses
    the memo: its copy is made anew at each dispatch.  A memoized copy
    would carry the autograd graph of the pass that made it, and serving
    it again — to a second microbatch, to remat's recomputation, or after
    ``models.api.value_and_grad`` made fresh leaves on the same storage —
    would send that gradient to a pass long done."""
    if w is None:
        return None
    blk = w[_block_index(w.shape, spec, coord, mesh)]
    if blk.device == dev and blk.is_contiguous():
        return blk
    if torch.is_grad_enabled() and w.requires_grad:
        return blk.contiguous().to(dev)
    base = w if w._base is None else w._base
    ent = _SHARD_CACHE.get(id(base))
    if ent is None or ent[0]() is not base:
        ent = (weakref.ref(base, lambda _, k=id(base):
                           _SHARD_CACHE.pop(k, None)), {})
        _SHARD_CACHE[id(base)] = ent
    key = (blk.storage_offset(), tuple(blk.shape), tuple(blk.stride()),
           str(dev))
    got = ent[1].get(key)
    if got is None:
        SHARD_CACHE_STATS["misses"] += 1
        got = ent[1][key] = blk.contiguous().to(dev)
    else:
        SHARD_CACHE_STATS["hits"] += 1
    return got


def place_weight(w, dev):
    """``w`` on ``dev``: itself when it lies there, else its memoized copy
    (a pipeline stage's weights on the stage's device)."""
    if isinstance(w, QuantizedTensor):
        return QuantizedTensor(place_weight(w.codes, dev),
                               place_weight(w.scale, dev))
    return _weight_block(w, (), {}, None, dev)


def shard_cache_info() -> Dict[str, int]:
    """hits / misses of the weight-block memo, the blocks it holds and
    their bytes."""
    blocks = [t for _, d in _SHARD_CACHE.values() for t in d.values()]
    return dict(SHARD_CACHE_STATS, blocks=len(blocks),
                bytes=sum(t.numel() * t.element_size() for t in blocks))


def clear_shard_cache():
    _SHARD_CACHE.clear()
    for k in SHARD_CACHE_STATS:
        SHARD_CACHE_STATS[k] = 0


def _assemble(blocks, shape, home):
    """The full tensor of ``blocks`` ((slices, block) pairs covering
    ``shape``) on ``home``: the all-gather (booked as one over the blocks,
    ``roofline.trace.collective``)."""
    out = None
    for idx, blk in blocks:
        if out is None:
            out = torch.empty(shape, dtype=blk.dtype, device=home)
        out[idx] = blk
    _trace.collective("all-gather", out, len(blocks))
    return out


@dataclass(frozen=True)
class GemmPlan:
    """One plan-cache entry: logical shape, epilogue, shard signature,
    chosen depth, and *per-shard* Eq.(6') predictions (ps) on the
    modelled ArrayFlex array."""

    M: int              # output columns (logical, pre-partition)
    N: int              # contraction (logical)
    T: int              # streamed rows (logical)
    backend: str
    k: int              # collapse depth the kernel runs with (1 off-ArrayFlex)
    t_pred_ps: float    # per-shard Eq.(6') model time at k
    t_conventional_ps: float  # per-shard fixed-pipeline SA baseline
    epilogue: Epilogue = EPILOGUE_NONE
    shard: ShardSig = SHARD_NONE
    M_shard: int = 0    # post-partition shape each device executes
    N_shard: int = 0
    T_shard: int = 0
    cycles: int = 0     # per-shard Eq.(4) cycles x fused contractions
    precision: str = "fp32"

    @property
    def saving(self) -> float:
        return 1.0 - self.t_pred_ps / self.t_conventional_ps


@functools.lru_cache(maxsize=None)
def _plan_gemm_cached(M: int, N: int, T: int, backend: str,
                      epilogue: Epilogue, shard: ShardSig) -> GemmPlan:
    info = _BACKEND_INFO.get(backend)
    collapse = info.collapse if info else False
    precision = info.precision if info else "fp32"
    params = timing.timing_for(precision)
    Ms = -(-M // shard.cols)
    Ns = -(-N // shard.contraction)
    Ts = -(-T // shard.rows)
    # a quantizing backend's per-output-channel dequant multiply is one
    # more boundary op per contraction; a W8A8 backend's per-tile
    # activation quantizer one more stage, priced with its own Eq.(5')
    # coefficient (d_actq_ps)
    dequant_ops = epilogue.contractions if (info and info.quantize) else 0
    actq_ops = 1 if (info and info.act_quantize) else 0
    # a pipeline-stage boundary prices like the TP psum: its egress tree
    # is boundary ALU ops on the period, its ingress serializes cycles
    e_ops = (epilogue.ops + shard.reduce_ops + shard.transfer_ops
             + dequant_ops)
    k = (ops.plan_collapse(Ms, Ns, Ts, epilogue_ops=e_ops,
                           precision=precision, actq_ops=actq_ops,
                           transfer_cycles=shard.transfer_cycles)
         if collapse else 1)
    return GemmPlan(
        M=M, N=N, T=T, backend=backend, k=k, epilogue=epilogue, shard=shard,
        M_shard=Ms, N_shard=Ns, T_shard=Ts, precision=precision,
        cycles=epilogue.contractions * timing.total_cycles(
            Ms, Ns, Ts, ops.SA_R, ops.SA_C, k),
        t_pred_ps=timing.t_abs_ps(Ms, Ns, Ts, ops.SA_R, ops.SA_C, k,
                                  params=params, epilogue_ops=e_ops,
                                  contractions=epilogue.contractions,
                                  actq_ops=actq_ops,
                                  extra_cycles=shard.transfer_cycles),
        t_conventional_ps=timing.t_abs_conventional_ps(
            Ms, Ns, Ts, ops.SA_R, ops.SA_C, params=params,
            contractions=epilogue.contractions, epilogue_ops=e_ops,
            actq_ops=actq_ops, extra_cycles=shard.transfer_cycles))


# backend name -> {"hits": n, "misses": n} of plan_gemm lookups.  Steady-
# state serving must be all hits.
PLAN_CACHE_STATS: Dict[str, Dict[str, int]] = {}


def plan_gemm(M: int, N: int, T: int, backend: str = "arrayflex",
              epilogue: Epilogue = EPILOGUE_NONE,
              shard: ShardSig = SHARD_NONE) -> GemmPlan:
    """Plan-cache entry point: Eq.(6') argmin once per
    (M, N, T, backend, epilogue, shard).  (M, N, T) are the logical dims;
    the argmin runs on the per-shard shape ``shard`` gives, with its
    reduce and transfer terms priced (:class:`ShardSig`).  Lookups are
    tallied per backend in :data:`PLAN_CACHE_STATS`."""
    before = _plan_gemm_cached.cache_info().misses
    plan = _plan_gemm_cached(M, N, T, backend, epilogue, shard)
    st = PLAN_CACHE_STATS.setdefault(backend, {"hits": 0, "misses": 0})
    missed = _plan_gemm_cached.cache_info().misses > before
    st["misses" if missed else "hits"] += 1
    return plan


@dataclass(frozen=True)
class PlanCacheInfo:
    """Aggregate lru stats plus the per-backend hit/miss tallies and the
    ``planner.attention_plan`` memo counters."""

    hits: int
    misses: int
    maxsize: Optional[int]
    currsize: int
    per_backend: Dict[str, Dict[str, int]] = field(default_factory=dict)
    attention_plan: Dict[str, int] = field(default_factory=dict)


def plan_cache_info() -> PlanCacheInfo:
    info = _plan_gemm_cached.cache_info()
    ap = planner.attention_plan.cache_info()
    return PlanCacheInfo(
        hits=info.hits, misses=info.misses, maxsize=info.maxsize,
        currsize=info.currsize,
        per_backend={b: dict(st) for b, st in PLAN_CACHE_STATS.items()},
        attention_plan={"hits": ap.hits, "misses": ap.misses,
                        "currsize": ap.currsize})


def clear_plan_cache():
    """Reset every plan memo this process holds (the Eq.(6') plan cache,
    its tallies, ``ops.plan_collapse`` and ``planner.attention_plan``) plus
    the site/dispatch logs.  The weight-quantization memo is not a plan and
    survives (``clear_quant_cache`` resets it)."""
    _plan_gemm_cached.cache_clear()
    PLAN_CACHE_STATS.clear()
    ops.plan_collapse.cache_clear()
    planner.attention_plan.cache_clear()
    SITE_PLANS.clear()
    DISPATCH_COUNTS.clear()


# ---------------------------------------------------------------------------
# backend registry

def _xla_backend(x2, w, plan: GemmPlan, call: GemmCall):
    ep = plan.epilogue
    # the unfused form of the prologue rmsnorm scale: the same expression
    # the kernel applies to each staged x element
    x2 = prologue_phase(x2, call.norm_scale)
    if call.out_dtype is None:
        # operand-dtype contraction(s), epilogue in the unfused layers' op
        # order (residual + out matches the layers' ``x + f(x)``)
        y = x2 @ w
        y2 = x2 @ call.w2 if ep.dual else None
        out = apply_epilogue(y, y2, call.bias, call.bias2, ep.activation)
        return out if call.residual is None else call.residual + out
    y = x2.float() @ w.float()
    y2 = x2.float() @ call.w2.float() if ep.dual else None
    out = apply_epilogue(y, y2, call.bias, call.bias2, ep.activation)
    if call.residual is not None:
        out = call.residual.float() + out
    return out.to(call.out_dtype)


def _arrayflex_backend(x2, w, plan: GemmPlan, call: GemmCall,
                       act_quant: bool = False):
    # On a quantizing backend w (and w2) arrive as int8 codes with
    # call.w_scale (call.w2_scale) from the dispatch; an exempt site passes
    # float weights and no scale and runs the float kernel.
    return ops.arrayflex_matmul(x2, w, w2=call.w2, bias=call.bias,
                                bias2=call.bias2, w_scale=call.w_scale,
                                w2_scale=call.w2_scale,
                                act_quant=act_quant
                                and call.w_scale is not None,
                                residual=call.residual,
                                norm_scale=call.norm_scale,
                                activation=plan.epilogue.activation,
                                k_collapse=plan.k, out_dtype=call.out_dtype)


def _arrayflex_w8a8_backend(x2, w, plan: GemmPlan, call: GemmCall):
    # the int8 backend's operands; every quantized site also runs the
    # kernel's per-tile activation quantizer and int8 x int8 -> int32 chain
    return _arrayflex_backend(x2, w, plan, call, act_quant=True)


def _ref_backend(x2, w, plan: GemmPlan, call: GemmCall):
    x32 = prologue_phase(x2, call.norm_scale).float()
    y = x32 @ w.float()
    y2 = x32 @ call.w2.float() if plan.epilogue.dual else None
    b = None if call.bias is None else call.bias.float()
    b2 = None if call.bias2 is None else call.bias2.float()
    out = apply_epilogue(y, y2, b, b2, plan.epilogue.activation)
    if call.residual is not None:
        out = call.residual.float() + out
    return out.to(call.out_dtype or x2.dtype)


@dataclass(frozen=True)
class BackendInfo:
    """Registry metadata driving planning and dispatch for one backend.
    ``collapse``: plans an Eq.(6') collapse depth (ArrayFlex kernels);
    others run k=1.  ``precision``: the datapath whose ``timing``
    coefficients price Eq.(5)-(7).  ``quantize``: the dispatch hands ``fn``
    int8 weight codes and scales (one more priced dequant op per
    contraction).  ``act_quantize``: the backend also quantizes activation
    tiles in the kernel (W8A8; one priced ``d_actq_ps`` stage); requires
    ``quantize``."""

    fn: Callable
    collapse: bool = False
    precision: str = "fp32"
    quantize: bool = False
    act_quantize: bool = False


_BACKENDS: Dict[str, Callable] = {}
_BACKEND_INFO: Dict[str, BackendInfo] = {}


def register_backend(name: str, fn: Callable, *, collapse: bool = False,
                     precision: str = "fp32", quantize: bool = False,
                     act_quantize: bool = False) -> None:
    """fn(x2: (T, K), w: (K, N_out), plan: GemmPlan, call: GemmCall)
    -> (T, N_out).  On a quantizing backend ``call.w_scale`` is None where
    the dispatch does not quantize (exempt sites, batched activation
    products): ``fn`` then gets float operands.  (Re-)registration evicts
    cached plans."""
    timing.timing_for(precision)     # fail fast on unknown precisions
    if act_quantize and not quantize:
        raise ValueError(
            f"backend {name!r}: act_quantize requires quantize — the W8A8 "
            f"int8 chain multiplies quantized activation tiles against "
            f"int8 weight codes")
    _BACKENDS[name] = fn
    _BACKEND_INFO[name] = BackendInfo(fn=fn, collapse=collapse,
                                      precision=precision, quantize=quantize,
                                      act_quantize=act_quantize)
    _plan_gemm_cached.cache_clear()
    PLAN_CACHE_STATS.clear()


def backends():
    return sorted(_BACKENDS)


def check_backend(name: str) -> None:
    """Validate a backend name against the registry (config-resolve time:
    the engine and serve.py call this before any dispatch)."""
    if name not in _BACKENDS:
        raise ValueError(
            f"unknown gemm backend {name!r}; registered: {backends()}")


def get_backend(name: str) -> Callable:
    check_backend(name)
    return _BACKENDS[name]


def backend_quantizes(name: str) -> bool:
    """Whether the registered backend consumes int8 weights (and so a
    pre-quantized parameter tree applies to it)."""
    check_backend(name)
    return _BACKEND_INFO[name].quantize


def backend_act_quantizes(name: str) -> bool:
    """Whether the registered backend also quantizes activation tiles
    (the W8A8 datapath)."""
    check_backend(name)
    return _BACKEND_INFO[name].act_quantize


def backend_collapses(name: str) -> bool:
    """Whether the registered backend runs the ArrayFlex kernels (plans a
    collapse depth): their CUDA launches record no autograd graph, so no
    training step may run on such a backend."""
    check_backend(name)
    return _BACKEND_INFO[name].collapse


register_backend("xla", _xla_backend)
register_backend("arrayflex", _arrayflex_backend, collapse=True)
register_backend("arrayflex_int8", _arrayflex_backend, collapse=True,
                 precision="int8", quantize=True)
register_backend("arrayflex_w8a8", _arrayflex_w8a8_backend, collapse=True,
                 precision="w8a8", quantize=True, act_quantize=True)
register_backend("ref", _ref_backend)

_BUILTIN_BACKENDS = {"xla": _xla_backend, "arrayflex": _arrayflex_backend,
                     "arrayflex_int8": _arrayflex_backend,
                     "arrayflex_w8a8": _arrayflex_w8a8_backend,
                     "ref": _ref_backend}

# builtin quantizing backend -> the fp32 ArrayFlex base that exempt sites
# and non-quantized batched products plan (and execute) instead, so the
# recorded plan prices the datapath that actually runs.
_QUANT_FP32_BASE = {"arrayflex_int8": "arrayflex",
                    "arrayflex_w8a8": "arrayflex"}

# Batched (activation x activation) sites the W8A8 backend quantizes:
# attn.qk only.  K^T quantizes per key column (one scale per key position,
# :func:`_quantize`) before the launch and q per tile in the kernel
# prologue; the logit error stays bounded relative to |q||k|.  attn.pv
# stays on the fp32 base: softmax puts most probabilities near zero, and
# per-tile int8 (resolution amax/127 with amax ~ 1) would zero the long
# tail of small weights that distinguishes outputs.
BATCHED_ACTQ_SITES = frozenset({"attn.qk"})


def _is_builtin(name: str) -> bool:
    """True when ``name`` still resolves to the built-in implementation."""
    return _BACKENDS.get(name) is _BUILTIN_BACKENDS.get(name)


# site label -> GemmPlan of the most recent dispatch through that site.  A
# fused dual-GEMM site like "mlp.wi_gate+mlp.wi_up" records the shared plan
# under BOTH component labels.
SITE_PLANS: Dict[str, GemmPlan] = {}

# site label (as passed, fused labels kept joined) -> number of substrate
# dispatches through that site.  For the arrayflex backend one dispatch ==
# one kernel launch.
DISPATCH_COUNTS: Dict[str, int] = {}


# the (sub-layer position, site label) pairs that already drew in this
# attempt of a step (None: every dispatch draws)
_CHAOS_SITES: contextvars.ContextVar[Optional[set]] = \
    contextvars.ContextVar("repro_torch_chaos_sites", default=None)
# the position in the period of the sub-layer now dispatching (None
# outside the layer stack: the unembed)
_CHAOS_SUBLAYER: contextvars.ContextVar[Optional[int]] = \
    contextvars.ContextVar("repro_torch_chaos_sublayer", default=None)
# site label -> its dispatches so far in this sub-layer (a cross-attending
# sub-layer dispatches attn.qk and attn.pv twice: its self- and its
# cross-attention, two call sites of the reference's trace)
_CHAOS_SEEN_HERE: contextvars.ContextVar[Optional[dict]] = \
    contextvars.ContextVar("repro_torch_chaos_seen_here", default=None)


@contextlib.contextmanager
def chaos_trace_scope():
    """One attempt of a serving step that has not yet completed: each site
    label draws at its first dispatch in each sub-layer position only (its
    n-th dispatch within one sub-layer at the first layer of that
    position), as the reference's trace of one super-block (``lax.scan``
    body) and the unembed draws once per dispatch."""
    token = _CHAOS_SITES.set(set())
    try:
        yield
    finally:
        _CHAOS_SITES.reset(token)


@contextlib.contextmanager
def chaos_sublayer(pos: int):
    """The dispatches inside are sub-layer ``pos`` of the period's."""
    token = _CHAOS_SUBLAYER.set(pos)
    seen = _CHAOS_SEEN_HERE.set({})
    try:
        yield
    finally:
        _CHAOS_SEEN_HERE.reset(seen)
        _CHAOS_SUBLAYER.reset(token)


def _maybe_chaos_fault(site: str) -> None:
    """Chaos injection point ``substrate.dispatch``: fail this GEMM launch
    when the ambient chaos engine says so (no-op — one contextvar read —
    when chaos is inactive).  Fires before the backend runs: the faulted
    site neither launches nor counts.  The errors module is imported
    lazily: serving imports substrate."""
    if chaos.active() is None:
        return
    seen = _CHAOS_SITES.get()
    if seen is not None:
        here = _CHAOS_SEEN_HERE.get()
        nth = 0
        if here is not None:
            nth = here.get(site, 0)
            here[site] = nth + 1
        key = (_CHAOS_SUBLAYER.get(), site, nth)
        if key in seen:
            return
        seen.add(key)
    if chaos.fire("substrate.dispatch", site):
        from repro_torch.serving.errors import KernelFault
        raise KernelFault(
            f"[chaos] injected GEMM launch fault at site {site!r} "
            f"(replayable: seed + draw index in the chaos log)")


def _record(site: str, plan: GemmPlan, launches: int = 1) -> None:
    """Log ``plan`` under ``site`` (every caller records before its
    backend runs, so a strict-audit violation launches nothing)."""
    if not site:
        if strict_audit_enabled():
            raise RuntimeError(
                "[AF007] unlabeled substrate dispatch under strict audit: "
                "every model GEMM must carry a planner site label")
        return
    if strict_audit_enabled():
        known = _known_sites()
        bad = [label for label in site.split("+") if label not in known]
        if bad:
            raise RuntimeError(
                f"[AF007] dispatch site {site!r} carries labels unknown to "
                f"planner.model_gemms: {bad}")
    for label in site.split("+"):
        SITE_PLANS[label] = plan
    DISPATCH_COUNTS[site] = DISPATCH_COUNTS.get(site, 0) + launches


def _epilogue_spec(epilogue: str, w2, bias, bias2, residual=None,
                   norm_scale=None) -> Epilogue:
    if epilogue not in EPILOGUE_KINDS:
        raise ValueError(f"unknown epilogue {epilogue!r}; "
                         f"supported: {EPILOGUE_KINDS}")
    if (epilogue == "swiglu") != (w2 is not None):
        raise ValueError("epilogue='swiglu' requires w2 (and only swiglu "
                         "takes a second contraction)")
    if bias2 is not None and w2 is None:
        raise ValueError("bias2 requires the w2 contraction")
    return Epilogue(kind=epilogue, bias=bias is not None,
                    bias2=bias2 is not None,
                    residual=residual is not None,
                    norm_scale=norm_scale is not None)


# ---------------------------------------------------------------------------
# dispatch

def _sharded_gemm(fn, x2, w, plan: GemmPlan, ctx: ShardCtx, call: GemmCall):
    """Run one planned 2-D GEMM over ``ctx``'s mesh: each distinct shard
    launches the per-shard GEMM through ``fn`` at the plan's k on its
    device, and the blocks gather on x's device.

    The (N_out,) operands — dequant scales and fused biases — follow the
    output-column axis: sliced on a column-parallel weight, whole on a
    row-parallel one; the residual is output-shaped and follows the
    output; the (K,) rmsnorm scale follows x's contraction axis, so each
    shard scales exactly the x columns it contracts.

    A sharded contraction (``ctx.reduce_axes``) runs the contraction(s)
    only on each shard, at the SAME k the reduce-priced plan picked, into
    fp32 partials that each shard dequantizes itself (per-column scales
    distribute over the K sum) — under W8A8 each shard quantizes its own
    x slice's tiles, as the reference's per-shard quantizer does.  The
    partials add in fp32 in fixed shard order (the psum); then bias,
    activation and gate, then the residual, then one cast — a bias or
    residual added per shard would count it once per shard.  The fused
    swiglu's second contraction reduces apart, before the gate.

    Each shard's slices and GEMM run on its logical device
    (``roofline.trace.shard``); the psum, the epilogue and the gather on
    the home device."""
    mesh = ctx.mesh
    reduce = bool(ctx.reduce_axes)
    col = (ctx.w_spec[1],)
    home = x2.device
    shape = (x2.shape[0], w.shape[-1])
    exec_plan = (dataclasses.replace(plan, epilogue=EPILOGUE_NONE)
                 if reduce else plan)
    blocks, partials = [], {}
    coords = _shard_coords(mesh, ctx.x_spec, ctx.w_spec, ctx.out_spec)
    for c in coords:
        dev = mesh.device(c)
        oi = _block_index(shape, ctx.out_spec, c, mesh)
        with _trace.shard(mesh, c):
            xs = _call_block(x2, ctx.x_spec, c, mesh, dev)
            ws = _weight_block(w, ctx.w_spec, c, mesh, dev)
            w2s = _weight_block(call.w2, ctx.w_spec, c, mesh, dev)
            ss = _call_block(call.w_scale, col, c, mesh, dev)
            s2s = _call_block(call.w2_scale, col, c, mesh, dev)
            gs = _call_block(call.norm_scale, (ctx.x_spec[1],), c, mesh, dev)
            if not reduce:
                y = fn(xs, ws, plan, GemmCall(
                    out_dtype=call.out_dtype, w2=w2s,
                    bias=_call_block(call.bias, col, c, mesh, dev),
                    bias2=_call_block(call.bias2, col, c, mesh, dev),
                    residual=_call_block(call.residual, ctx.out_spec, c,
                                         mesh, dev),
                    norm_scale=gs, w_scale=ss, w2_scale=s2s))
            else:
                pc = GemmCall(out_dtype=torch.float32, w_scale=ss,
                              norm_scale=gs)
                y = fn(xs, ws, exec_plan, pc)
                y2 = (None if w2s is None else fn(
                    xs, w2s, exec_plan, dataclasses.replace(pc, w_scale=s2s)))
        if not reduce:
            blocks.append((oi, to_device(y, home)))
            continue
        y = to_device(y, home)
        y2 = None if y2 is None else to_device(y2, home)
        key = tuple((sl.start, sl.stop) for sl in oi)
        if key in partials:                 # the psum, in shard order
            _, acc, acc2 = partials[key]
            y = acc + y
            y2 = None if y2 is None else acc2 + y2
        partials[key] = (oi, y, y2)
    if not reduce:
        return _assemble(blocks, shape, home)
    for _, y, y2 in partials.values():      # the psum of each block
        _trace.collective("all-reduce", y, len(coords) // len(partials), y2)
    y = _assemble([(oi, a) for oi, a, _ in partials.values()], shape, home)
    y2 = (None if plan.epilogue.contractions == 1 else _assemble(
        [(oi, a2) for oi, _, a2 in partials.values()], shape, home))
    out = apply_epilogue(
        y, y2, None if call.bias is None else call.bias.float(),
        None if call.bias2 is None else call.bias2.float(),
        plan.epilogue.activation)
    if call.residual is not None:    # the residual joins after the epilogue
        out = call.residual.float() + out
    return out.to(call.out_dtype or x2.dtype)


@_trace.sited
def gemm(x, w, *, site: str = "", backend: str = "xla", out_dtype=None,
         epilogue: str = "none", w2=None, bias=None, bias2=None,
         residual=None, norm_scale=None, shard: Optional[ShardCtx] = None):
    """The substrate entry: x (..., K) @ w (K, N_out) -> (..., N_out).

    ``out_dtype=None`` returns the operands' dtype with the backend's
    native accumulation; passing a dtype requests fp32 accumulation cast
    to it (the unembed/logits contract).  ``epilogue``, ``w2``, ``bias``,
    ``bias2``, ``residual`` and ``norm_scale`` fuse into one dispatch (one
    kernel launch on the arrayflex backends); a fused site label like
    ``"mlp.wi_gate+mlp.wi_up"`` records the shared plan under both names.

    On a quantizing backend (``arrayflex_int8`` / ``arrayflex_w8a8``) the
    dispatch swaps ``w`` (and ``w2``) for int8 codes + per-output-channel
    fp32 scales: a :class:`QuantizedTensor` is unpacked, a float weight
    goes through the :func:`quantize_weight` memo, and a site in
    :data:`QUANT_EXEMPT_SITES` keeps its float weight and plans on the
    fp32 base.

    ``shard`` (``parallel.sharding.gemm_shard_ctx``) plans on the
    post-partition per-shard (M, N, T), keyed in the plan cache by the
    shard signature, and runs each shard's GEMM as its own launch
    (:func:`_sharded_gemm`); the dispatch counts once in
    :data:`DISPATCH_COUNTS`, as the reference's traced shard_map does.  A
    pricing-only context plans under its signature — a pipeline role's
    transfer terms — and dispatches unsharded.  A context is dropped
    (replicated dispatch) when the GEMM is empty or its dims do not
    divide.
    """
    fn = get_backend(backend)
    _maybe_chaos_fault(site)
    info = _BACKEND_INFO[backend]
    if norm_scale is not None and tuple(norm_scale.shape) != (x.shape[-1],):
        raise ValueError(
            f"site {site!r}: norm_scale shape {tuple(norm_scale.shape)} "
            f"must be (K,) = ({x.shape[-1]},) — it scales x's contraction "
            f"axis")
    ep = _epilogue_spec(epilogue, w2, bias, bias2, residual, norm_scale)
    w_scale = w2_scale = None
    plan_backend = backend
    if isinstance(w, QuantizedTensor):
        if not info.quantize:
            raise ValueError(
                f"site {site!r}: pre-quantized weight dispatched on "
                f"non-quantizing backend {backend!r}")
        if site in QUANT_EXEMPT_SITES:
            raise ValueError(f"site {site!r} is quantization-exempt but "
                             f"received a pre-quantized weight")
        w, w_scale = w.codes, w.scale
        if isinstance(w2, QuantizedTensor):
            w2, w2_scale = w2.codes, w2.scale
    elif info.quantize and site in QUANT_EXEMPT_SITES:
        plan_backend = _QUANT_FP32_BASE.get(backend, plan_backend)
    elif info.quantize and w.shape[0] and w.shape[-1]:
        w, w_scale = quantize_weight(w)
        if w2 is not None:
            w2, w2_scale = quantize_weight(w2)
    lead = tuple(x.shape[:-1])
    K = x.shape[-1]
    N_out = w.shape[-1]
    x2 = x.reshape(math.prod(lead), K)   # explicit rows: K may be 0
    T = x2.shape[0]
    r2 = None if residual is None else residual.reshape(T, N_out)
    if shard is not None and (T * K * N_out == 0
                              or not shard.divides(T, K, N_out)):
        shard = None
    call = GemmCall(out_dtype=out_dtype, w2=w2, bias=bias, bias2=bias2,
                    residual=r2, norm_scale=norm_scale, w_scale=w_scale,
                    w2_scale=w2_scale)
    plan = plan_gemm(N_out, K, T, plan_backend, ep,
                     SHARD_NONE if shard is None else shard.signature())
    _record(site, plan)
    if shard is not None and shard.mesh is not None:
        out = _sharded_gemm(fn, x2, w, plan, shard, call)
    else:
        out = fn(x2, w, plan, call)
    return out.reshape(*lead, N_out)


def _batched_exec(x, w, plan: GemmPlan, backend: str, out_dtype):
    """Builtin batched execution (B, T, K) @ (B, K, N): ONE launch."""
    if backend == "arrayflex":
        return ops.arrayflex_expert_matmul(x, w, k_collapse=plan.k,
                                           out_dtype=out_dtype)
    if backend == "arrayflex_w8a8":
        # W8A8 QK: both operands are activations and both quantize — K^T
        # here, per (batch, key column), as the reference does outside its
        # kernel inside its compiled step (hence ``compiled``), and each q
        # tile in the kernel prologue; the per-key scales dequant at the
        # store
        qw, ws = _quantize(w, compiled=True)
        return ops.arrayflex_expert_matmul(x, qw, w_scale=ws, act_quant=True,
                                           k_collapse=plan.k,
                                           out_dtype=out_dtype)
    if backend == "ref":
        out = torch.matmul(x.float(), w.float())
        return out.to(out_dtype or x.dtype)
    if out_dtype is None:               # jnp.matmul's dtype promotion
        dt = torch.promote_types(x.dtype, w.dtype)
        return torch.matmul(x.to(dt), w.to(dt))
    return torch.matmul(x.float(), w.float()).to(out_dtype)


@_trace.sited
def batched_gemm(x, w, *, site: str = "", backend: str = "xla",
                 out_dtype=None, shard: Optional[ShardCtx] = None):
    """Batched GEMM: x (B, T, K) @ w (B, K, N) -> (B, T, N).

    The substrate path for attention QK/PV products (``attn.qk`` /
    ``attn.pv`` sites): every batch element runs the same planned shape,
    and the arrayflex backend executes ALL of them in one expert-batched
    kernel launch.  ``out_dtype`` follows the :func:`gemm` contract.  A
    custom (re-registered) backend runs the batch through its 2-D entry,
    B dispatches recorded against the shared plan.

    The operands are activations, not weights, so ``arrayflex_int8`` maps
    to its fp32 ArrayFlex base (kernel and plan).  ``arrayflex_w8a8``
    quantizes both operands on :data:`BATCHED_ACTQ_SITES` (``attn.qk``),
    planned on the w8a8 datapath; ``attn.pv`` runs on the fp32 base.

    ``shard`` (``parallel.sharding.batched_shard_ctx``) splits the batch
    dim over the mesh: each shard runs ONE launch over its batch slice on
    its device.  Batch sharding leaves the per-element (M, N, T), and so
    the plan, unchanged.  Custom backends, indivisible batches and a
    pricing-only context dispatch replicated.
    """
    check_backend(backend)
    _maybe_chaos_fault(site)
    if backend in _QUANT_FP32_BASE and not (
            _BACKEND_INFO[backend].act_quantize and _is_builtin(backend)
            and site in BATCHED_ACTQ_SITES):
        backend = _QUANT_FP32_BASE[backend]
    B, T, K = x.shape
    N_out = w.shape[-1]
    plan = plan_gemm(N_out, K, T, backend)
    if shard is not None and (shard.mesh is None or not _is_builtin(backend)
                              or B % shard.axis_shards(shard.x_spec[0])):
        shard = None
    if shard is not None:
        _record(site, plan)
        mesh, blocks = shard.mesh, []
        for c in _shard_coords(mesh, shard.x_spec, shard.w_spec,
                               shard.out_spec):
            dev = mesh.device(c)
            with _trace.shard(mesh, c):
                y = _batched_exec(
                    _call_block(x, shard.x_spec, c, mesh, dev),
                    _call_block(w, shard.w_spec, c, mesh, dev),
                    plan, backend, out_dtype)
            blocks.append((_block_index((B, T, N_out), shard.out_spec, c,
                                        mesh), to_device(y, x.device)))
        return _assemble(blocks, (B, T, N_out), x.device)
    if _is_builtin(backend):
        _record(site, plan)
        return _batched_exec(x, w, plan, backend, out_dtype)
    _record(site, plan, launches=B)
    fn = get_backend(backend)
    call = GemmCall(out_dtype=out_dtype)
    return torch.stack([fn(x[b], w[b], plan, call) for b in range(B)])


def _expert_exec(x, w, plan: GemmPlan, backend: str, w_scale=None,
                 act_quant: bool = False):
    """Builtin expert execution (G, E, C, K) @ (E, K, N): ONE launch.
    ``w_scale`` (E, N): int8 expert bank, dequantized per expert at the
    kernel's store.  ``act_quant`` (W8A8): the kernel also quantizes each
    activation tile in its prologue and runs the int8 x int8 -> int32
    chain."""
    if backend == "xla":
        return torch.einsum("gecd,edf->gecf", x, w)
    if backend == "ref":
        out = torch.einsum("gecd,edf->gecf", x.float(), w.float())
        return out.to(x.dtype)
    G, E, C, K = x.shape
    N_out = w.shape[-1]
    xe = x.transpose(0, 1).reshape(E, G * C, K).contiguous()
    out = ops.arrayflex_expert_matmul(xe, w, w_scale=w_scale,
                                      act_quant=act_quant,
                                      k_collapse=plan.k)
    return out.reshape(E, G, C, N_out).transpose(0, 1)


@_trace.sited
def expert_gemm(x, w, *, site: str = "", backend: str = "xla",
                shard: Optional[ShardCtx] = None):
    """Batched expert GEMM: x (G, E, C, K) @ w (E, K, N) -> (G, E, C, N).

    Every backend plans ONE (M=N, N=K, T=G*C) shape per site — the
    per-expert GEMMs of a capacity-buffered MoE layer are identical, so
    one plan covers all E of them.  The xla backend keeps the einsum; the
    arrayflex backends fold the dispatch groups into the row axis and run
    ALL experts in ONE launch of the expert kernel, whose leading grid
    axis is the expert axis.  A custom backend unrolls the expert axis
    through its 2-D entry: E dispatches recorded against the shared plan.

    A quantizing backend takes the bank as int8 codes + (E, N) scales: a
    :class:`QuantizedTensor` is unpacked, a float bank goes through the
    :func:`quantize_weight` memo.  Under W8A8 the expert kernel also
    quantizes its activation tiles whenever the bank is quantized.

    ``shard`` (``parallel.sharding.expert_shard_ctx``) runs
    expert-parallel: the expert axis splits over the mesh and each shard
    launches once over its experts on its device (the per-expert shape,
    and so the plan, unchanged); a quantized bank's (E, N) scales split
    with it.  Custom backends, indivisible expert counts and a
    pricing-only context dispatch replicated.
    """
    check_backend(backend)
    _maybe_chaos_fault(site)
    G, E, C, K = x.shape
    N_out = w.shape[-1]
    info = _BACKEND_INFO[backend]
    w_scale = None
    if isinstance(w, QuantizedTensor):
        if not info.quantize:
            raise ValueError(
                f"site {site!r}: pre-quantized expert bank dispatched on "
                f"non-quantizing backend {backend!r}")
        w, w_scale = w.codes, w.scale
    elif info.quantize and E and K and N_out:
        w, w_scale = quantize_weight(w)
    actq = bool(info.act_quantize and w_scale is not None)
    plan = plan_gemm(N_out, K, G * C, backend)
    if shard is not None and (shard.mesh is None or not _is_builtin(backend)
                              or E % shard.axis_shards(shard.x_spec[1])):
        shard = None
    if shard is not None:
        _record(site, plan)
        mesh, blocks = shard.mesh, []
        for c in _shard_coords(mesh, shard.x_spec, shard.w_spec,
                               shard.out_spec):
            dev = mesh.device(c)
            with _trace.shard(mesh, c):
                y = _expert_exec(
                    _call_block(x, shard.x_spec, c, mesh, dev),
                    _weight_block(w, shard.w_spec, c, mesh, dev), plan,
                    backend,
                    _call_block(w_scale, shard.w_spec[:1], c, mesh, dev),
                    actq)
            blocks.append((_block_index((G, E, C, N_out), shard.out_spec, c,
                                        mesh), to_device(y, x.device)))
        return _assemble(blocks, (G, E, C, N_out), x.device)
    if _is_builtin(backend):
        _record(site, plan)
        return _expert_exec(x, w, plan, backend, w_scale, actq)
    _record(site, plan, launches=E)
    fn = get_backend(backend)
    outs = [fn(x[:, e].reshape(G * C, K), w[e], plan,
               GemmCall(w_scale=None if w_scale is None else w_scale[e])
               ).reshape(G, C, N_out)
            for e in range(E)]
    return torch.stack(outs, dim=1)
