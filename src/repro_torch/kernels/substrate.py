"""GEMM execution substrate: one dispatch layer for every model GEMM.

Port of the reference's ``kernels/substrate.py`` (unsharded).  Every
dense contraction in nn/ and models/ routes through :func:`gemm` (or
:func:`batched_gemm` for the attention QK/PV products), which

  * resolves the GEMM's :class:`GemmPlan` from a process-wide **plan
    cache** keyed on ``(M, N, T, backend, epilogue)`` — the Eq.(6') argmin
    runs once per shape, not once per serving step;
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

Sharded dispatch (``ShardCtx``, and so expert parallelism), the strict
routing audit and chaos hooks are not ported yet.
"""
from __future__ import annotations

import functools
import math
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import planner, timing
from repro_torch.kernels import ops
from repro_torch.kernels.arrayflex_gemm import (INV_127, apply_epilogue,
                                                prologue_phase)


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

    A weight with more than three axes (a stacked MoE expert bank,
    (n_super, E, K, N)) is quantized one leading index at a time into
    preallocated codes and scales, so its fp32 temporaries are one
    slice's, not the whole stack's (tens of GB for a full-width bank).
    The codes are the same bit for bit: the amax runs over the
    contraction axis only."""
    if w.ndim <= 3:
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


@dataclass(frozen=True)
class GemmPlan:
    """One plan-cache entry: logical shape, epilogue, chosen depth, and the
    Eq.(6') predictions (ps) on the modelled ArrayFlex array."""

    M: int              # output columns
    N: int              # contraction
    T: int              # streamed rows
    backend: str
    k: int              # collapse depth the kernel runs with (1 off-ArrayFlex)
    t_pred_ps: float    # Eq.(6') model time at k
    t_conventional_ps: float  # fixed-pipeline SA baseline
    epilogue: Epilogue = EPILOGUE_NONE
    cycles: int = 0     # Eq.(4) cycles x fused contractions
    precision: str = "fp32"


@functools.lru_cache(maxsize=None)
def _plan_gemm_cached(M: int, N: int, T: int, backend: str,
                      epilogue: Epilogue) -> GemmPlan:
    info = _BACKEND_INFO.get(backend)
    collapse = info.collapse if info else False
    precision = info.precision if info else "fp32"
    params = timing.timing_for(precision)
    # a quantizing backend's per-output-channel dequant multiply is one
    # more boundary op per contraction; a W8A8 backend's per-tile
    # activation quantizer one more stage, priced with its own Eq.(5')
    # coefficient (d_actq_ps)
    dequant_ops = epilogue.contractions if (info and info.quantize) else 0
    actq_ops = 1 if (info and info.act_quantize) else 0
    e_ops = epilogue.ops + dequant_ops
    k = (ops.plan_collapse(M, N, T, epilogue_ops=e_ops, precision=precision,
                           actq_ops=actq_ops)
         if collapse else 1)
    return GemmPlan(
        M=M, N=N, T=T, backend=backend, k=k, epilogue=epilogue,
        precision=precision,
        cycles=epilogue.contractions * timing.total_cycles(
            M, N, T, ops.SA_R, ops.SA_C, k),
        t_pred_ps=timing.t_abs_ps(M, N, T, ops.SA_R, ops.SA_C, k,
                                  params=params, epilogue_ops=e_ops,
                                  contractions=epilogue.contractions,
                                  actq_ops=actq_ops),
        t_conventional_ps=timing.t_abs_conventional_ps(
            M, N, T, ops.SA_R, ops.SA_C, params=params,
            contractions=epilogue.contractions, epilogue_ops=e_ops,
            actq_ops=actq_ops))


# backend name -> {"hits": n, "misses": n} of plan_gemm lookups.  Steady-
# state serving must be all hits.
PLAN_CACHE_STATS: Dict[str, Dict[str, int]] = {}


def plan_gemm(M: int, N: int, T: int, backend: str = "arrayflex",
              epilogue: Epilogue = EPILOGUE_NONE) -> GemmPlan:
    """Plan-cache entry point: Eq.(6') argmin once per
    (M, N, T, backend, epilogue); lookups are tallied per backend in
    :data:`PLAN_CACHE_STATS`."""
    before = _plan_gemm_cached.cache_info().misses
    plan = _plan_gemm_cached(M, N, T, backend, epilogue)
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


def _record(site: str, plan: GemmPlan, launches: int = 1) -> None:
    if not site:
        return
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

def gemm(x, w, *, site: str = "", backend: str = "xla", out_dtype=None,
         epilogue: str = "none", w2=None, bias=None, bias2=None,
         residual=None, norm_scale=None):
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
    """
    fn = get_backend(backend)
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
    call = GemmCall(out_dtype=out_dtype, w2=w2, bias=bias, bias2=bias2,
                    residual=r2, norm_scale=norm_scale, w_scale=w_scale,
                    w2_scale=w2_scale)
    plan = plan_gemm(N_out, K, T, plan_backend, ep)
    _record(site, plan)
    return fn(x2, w, plan, call).reshape(*lead, N_out)


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


def batched_gemm(x, w, *, site: str = "", backend: str = "xla",
                 out_dtype=None):
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
    """
    check_backend(backend)
    if backend in _QUANT_FP32_BASE and not (
            _BACKEND_INFO[backend].act_quantize and _is_builtin(backend)
            and site in BATCHED_ACTQ_SITES):
        backend = _QUANT_FP32_BASE[backend]
    B, T, K = x.shape
    N_out = w.shape[-1]
    plan = plan_gemm(N_out, K, T, backend)
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


def expert_gemm(x, w, *, site: str = "", backend: str = "xla"):
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
    """
    check_backend(backend)
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
