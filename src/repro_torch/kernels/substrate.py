"""GEMM execution substrate: one dispatch layer for every model GEMM.

Port of the reference's ``kernels/substrate.py`` (unsharded, fp32/bf16
backends).  Every dense contraction in nn/ and models/ routes through
:func:`gemm` (or :func:`batched_gemm` for the attention QK/PV products),
which

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
      ``ref``        an fp32-everywhere oracle for equivalence tests.

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

Sharded dispatch (``ShardCtx``), the quantizing backends and chaos hooks
are not ported yet.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import planner, timing
from repro_torch.kernels import ops
from repro_torch.kernels.arrayflex_gemm import apply_epilogue, prologue_phase


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
    e_ops = epilogue.ops
    k = (ops.plan_collapse(M, N, T, epilogue_ops=e_ops, precision=precision)
         if collapse else 1)
    return GemmPlan(
        M=M, N=N, T=T, backend=backend, k=k, epilogue=epilogue,
        precision=precision,
        cycles=epilogue.contractions * timing.total_cycles(
            M, N, T, ops.SA_R, ops.SA_C, k),
        t_pred_ps=timing.t_abs_ps(M, N, T, ops.SA_R, ops.SA_C, k,
                                  params=params, epilogue_ops=e_ops,
                                  contractions=epilogue.contractions),
        t_conventional_ps=timing.t_abs_conventional_ps(
            M, N, T, ops.SA_R, ops.SA_C, params=params,
            contractions=epilogue.contractions, epilogue_ops=e_ops))


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
    the site/dispatch logs."""
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


def _arrayflex_backend(x2, w, plan: GemmPlan, call: GemmCall):
    return ops.arrayflex_matmul(x2, w, w2=call.w2, bias=call.bias,
                                bias2=call.bias2, residual=call.residual,
                                norm_scale=call.norm_scale,
                                activation=plan.epilogue.activation,
                                k_collapse=plan.k, out_dtype=call.out_dtype)


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
    coefficients price Eq.(5)-(7)."""

    fn: Callable
    collapse: bool = False
    precision: str = "fp32"


_BACKENDS: Dict[str, Callable] = {}
_BACKEND_INFO: Dict[str, BackendInfo] = {}


def register_backend(name: str, fn: Callable, *, collapse: bool = False,
                     precision: str = "fp32") -> None:
    """fn(x2: (T, K), w: (K, N_out), plan: GemmPlan, call: GemmCall)
    -> (T, N_out).  (Re-)registration evicts cached plans."""
    timing.timing_for(precision)     # fail fast on unknown precisions
    _BACKENDS[name] = fn
    _BACKEND_INFO[name] = BackendInfo(fn=fn, collapse=collapse,
                                      precision=precision)
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


register_backend("xla", _xla_backend)
register_backend("arrayflex", _arrayflex_backend, collapse=True)
register_backend("ref", _ref_backend)

_BUILTIN_BACKENDS = {"xla": _xla_backend, "arrayflex": _arrayflex_backend,
                     "ref": _ref_backend}


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
    kernel launch on the arrayflex backend); a fused site label like
    ``"mlp.wi_gate+mlp.wi_up"`` records the shared plan under both names.
    """
    fn = get_backend(backend)
    if norm_scale is not None and tuple(norm_scale.shape) != (x.shape[-1],):
        raise ValueError(
            f"site {site!r}: norm_scale shape {tuple(norm_scale.shape)} "
            f"must be (K,) = ({x.shape[-1]},) — it scales x's contraction "
            f"axis")
    ep = _epilogue_spec(epilogue, w2, bias, bias2, residual, norm_scale)
    lead = tuple(x.shape[:-1])
    K = x.shape[-1]
    N_out = w.shape[-1]
    x2 = x.reshape(math.prod(lead), K)   # explicit rows: K may be 0
    T = x2.shape[0]
    r2 = None if residual is None else residual.reshape(T, N_out)
    call = GemmCall(out_dtype=out_dtype, w2=w2, bias=bias, bias2=bias2,
                    residual=r2, norm_scale=norm_scale)
    plan = plan_gemm(N_out, K, T, backend, ep)
    _record(site, plan)
    return fn(x2, w, plan, call).reshape(*lead, N_out)


def _batched_exec(x, w, plan: GemmPlan, backend: str, out_dtype):
    """Builtin batched execution (B, T, K) @ (B, K, N): ONE launch."""
    if backend == "arrayflex":
        return ops.arrayflex_expert_matmul(x, w, k_collapse=plan.k,
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
    """
    check_backend(backend)
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
