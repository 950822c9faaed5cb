"""ArrayFlex planner: per-layer pipeline-depth selection + framework hooks.

Three planning surfaces:

1. ``plan_network``    — the paper's use-case: per-CNN-layer optimal k
                         (latency, power, EDP vs a conventional SA).
2. ``model_gemms``     — walks a transformer ModelConfig x ShapeConfig into
                         its (M, N, T) GEMM list so the same planner drives
                         LLM workloads (beyond-paper generalization).
3. ``attention_plan``  — maps the paper's cycles-vs-clock tradeoff onto the
                         KV-chunk size of the sequence-sharded attention and
                         the K-block collapse of the Pallas GEMM kernel:
                         steps = T/kc (fewer with bigger chunks) while
                         per-step cost grows affinely with kc — literally
                         Eq.(3) x Eq.(5) with (kc/base) playing k.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import List

from repro_torch.configs.base import ModelConfig, ShapeConfig, SSMConfig
from repro_torch.core import timing
from repro_torch.core.timing import TimingParams, DEFAULT_TIMING
from repro_torch.core import power as power_lib


@dataclass(frozen=True)
class GEMM:
    name: str
    M: int
    N: int
    T: int
    count: int = 1        # how many times this GEMM runs (e.g. layers)
    # fused-epilogue pricing (Eq. 5'/6'): vector ops at the collapsed-block
    # boundary and fused contraction count (2 = dual-GEMM swiglu)
    epilogue_ops: int = 0
    contractions: int = 1
    # pipeline-stage transfer pricing (disaggregated pod roles):
    # ``transfer_ops`` boundary send ops join the Eq.(5') per-step period
    # (a compute-bound prefill stage — pushes best_k DEEPER);
    # ``transfer_cycles`` serialize in front of the schedule at the
    # k-collapsed period (Eq. 6'', a latency-bound decode stage's ingress
    # — pushes best_k SHALLOWER).  model_gemms decorates the pipeline
    # boundary site with these from the config's pp role.
    transfer_ops: int = 0
    transfer_cycles: int = 0


@dataclass
class LayerPlan:
    gemm: GEMM
    k: int
    k_hat: float
    cycles: int
    clock_ghz: float
    t_abs_ps: float
    t_conventional_ps: float

    @property
    def saving(self) -> float:
        return 1.0 - self.t_abs_ps / self.t_conventional_ps


def plan_gemm(g: GEMM, R: int, C: int,
              tp: TimingParams = DEFAULT_TIMING,
              actq_ops: int = 0) -> LayerPlan:
    # transfer_ops price exactly like boundary epilogue ops (the same
    # Eq.(5') slot the substrate's shard.transfer_ops joins), and
    # transfer_cycles thread to the Eq.(6'') extra-cycles term — the
    # analytic table and the shard-keyed plan cache price identically.
    e = g.epilogue_ops + g.transfer_ops
    k = timing.best_k(g.M, g.N, g.T, R, C, tp, epilogue_ops=e,
                      actq_ops=actq_ops, extra_cycles=g.transfer_cycles)
    return LayerPlan(
        gemm=g, k=k, k_hat=timing.k_hat(R, C, g.T, tp),
        cycles=g.contractions * timing.total_cycles(g.M, g.N, g.T, R, C, k),
        clock_ghz=tp.clock_ghz(k, e, actq_ops),
        t_abs_ps=timing.t_abs_ps(g.M, g.N, g.T, R, C, k, tp,
                                 epilogue_ops=e,
                                 contractions=g.contractions,
                                 actq_ops=actq_ops,
                                 extra_cycles=g.transfer_cycles) * g.count,
        t_conventional_ps=timing.t_abs_conventional_ps(
            g.M, g.N, g.T, R, C, tp, contractions=g.contractions,
            epilogue_ops=e, actq_ops=actq_ops,
            extra_cycles=g.transfer_cycles) * g.count,
    )


def plan_gemm_precision(g: GEMM, R: int, C: int,
                        precision: str = "fp32") -> LayerPlan:
    """:func:`plan_gemm` priced for a datapath precision.

    ``int8`` uses ``timing.IntTimingParams`` (Eq. 5'/7 with the int8
    d_mul/d_CSA) and adds one dequant boundary op per contraction —
    exactly the pricing ``kernels.substrate`` applies for the
    ``arrayflex_int8`` backend, so the analytic table and the executed
    plan pick the same k.  ``w8a8`` uses ``timing.W8A8TimingParams``
    (int8 mul + int32-accumulate adder) and additionally prices the
    Eq.(5') activation-quantize boundary stage (``actq_ops=1``,
    ``d_actq_ps``) — the pricing the ``arrayflex_w8a8`` backend plans
    with."""
    tp = timing.timing_for(precision)
    actq = 0
    if precision in ("int8", "w8a8"):
        g = dataclasses.replace(g, epilogue_ops=g.epilogue_ops
                                + g.contractions)
    if precision == "w8a8":
        actq = 1
    return plan_gemm(g, R, C, tp, actq_ops=actq)


def precision_table(cfg: "ModelConfig", shape: "ShapeConfig",
                    R: int = 128, C: int = 128,
                    precisions=("fp32", "int8", "w8a8")) -> list:
    """Side-by-side per-GEMM plans across datapath precisions for one
    (model, shape) cell: every ``model_gemms`` entry with one
    :class:`LayerPlan` per precision.  This is where the quantized
    backends' planning story is visible analytically — the int8 datapath
    legitimately picks a different (usually deeper) k at the same shape,
    and the w8a8 datapath's quantize boundary term can deepen it again:
    the per-layer configurability the paper argues for, three ways."""
    return [{"gemm": g,
             "plans": {p: plan_gemm_precision(g, R, C, p)
                       for p in precisions}}
            for g in model_gemms(cfg, shape)]


def plan_network(gemms: List[GEMM], R: int, C: int,
                 tp: TimingParams = DEFAULT_TIMING,
                 pp=None) -> dict:
    pp = pp or power_lib.DEFAULT_POWER
    plans = [plan_gemm(g, R, C, tp) for g in gemms]
    t_af = sum(p.t_abs_ps for p in plans)
    t_cv = sum(p.t_conventional_ps for p in plans)
    e_af = sum(power_lib.power_arrayflex(p.k, tp, pp) * p.t_abs_ps
               for p in plans)
    e_cv = power_lib.power_conventional(tp, pp) * t_cv
    p_af, p_cv = e_af / t_af, e_cv / t_cv
    return {
        "plans": plans,
        "time_arrayflex_ps": t_af, "time_conventional_ps": t_cv,
        "latency_saving": 1.0 - t_af / t_cv,
        "avg_power_arrayflex": p_af, "avg_power_conventional": p_cv,
        "power_saving": 1.0 - p_af / p_cv,
        "edp_gain": (p_cv * t_cv ** 2) / (p_af * t_af ** 2),
    }


# ---------------------------------------------------------------------------
# transformer GEMM walker

def _postshard(g: GEMM, dp: int, tp: int, experts: int,
               qk_batch: int) -> GEMM:
    """Post-partition view of one analytic GEMM under a (data, model)
    mesh, mirroring ``parallel.sharding.gemm_shard_ctx``: column-parallel
    sites divide M by tp, row-parallel sites divide N by tp and price the
    boundary psum combine tree as epilogue ops, every 2-D site divides
    its streamed rows by dp, and the batched/expert sites divide their
    ``count`` by the shards of their batch/expert axis.  Indivisible axes
    replicate (dims unchanged) — the same fallback the dispatch takes.

    ``qk_batch`` is the runtime batch axis of the attention products
    (B*KV): the dispatch shards on it, NOT on the analytic count
    (n_attn*B*H), whose extra factors would claim sharding the runtime
    cannot perform (GQA under high TP).  The divisibility chain itself is
    ``sharding.batched_shard_count`` — the same function the dispatch
    uses."""
    from repro_torch.parallel.sharding import (_COL_SITES, _ROW_SITES,
                                               batched_shard_count)
    if g.name in ("attn.qk", "attn.pv"):
        return dataclasses.replace(
            g, count=g.count // batched_shard_count(qk_batch, dp, tp))
    if g.name in ("moe.wi_gate", "moe.wi_up", "moe.wo"):
        if tp > 1 and experts % tp == 0:
            return dataclasses.replace(g, count=g.count // tp)
        return g
    M, N, T, e = g.M, g.N, g.T, g.epilogue_ops
    if dp > 1 and T % dp == 0:
        T //= dp
    if g.name in _COL_SITES and tp > 1 and M % tp == 0:
        M //= tp
    elif g.name in _ROW_SITES and tp > 1 and N % tp == 0:
        N //= tp
        e += math.ceil(math.log2(tp))
    return dataclasses.replace(g, M=M, N=N, T=T, epilogue_ops=e)


def model_gemms(cfg: ModelConfig, shape: ShapeConfig) -> List[GEMM]:
    """Every GEMM one step of this (model, shape) cell executes.

    T is the streamed dimension (tokens), N the contraction, M the output.
    Attention score/PV products fold batch*heads into the tile count via
    ``count`` (the SA processes them back to back).

    When ``cfg.mesh_shape`` declares a (data, model) mesh (and
    ``gemm_sharding`` is not "none"), every entry is the *post-partition*
    per-device GEMM — the shape the sharded substrate actually executes —
    so the analytic table and the shard-keyed plan cache stay joined.
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    toks = shape.global_batch if shape.kind == "decode" else shape.tokens
    S_ctx = (min(shape.seq_len, cfg.sliding_window or shape.seq_len)
             if shape.kind == "decode" else shape.seq_len)
    out: List[GEMM] = []
    n_attn = n_mamba = n_moe = n_dense = n_cross = 0
    for i in range(cfg.n_layers):
        if cfg.is_attn_layer(i):
            n_attn += 1
        else:
            n_mamba += 1
        if cfg.is_moe_layer(i):
            n_moe += 1
        elif cfg.d_ff:
            n_dense += 1
        if cfg.is_cross_attn_layer(i) or cfg.family == "audio":
            n_cross += 1
    if n_attn:
        # the qkv projections carry the fused rmsnorm scale (ln1 rides the
        # kernel's step prologue — see nn/layers.rmsnorm_normalize): one
        # Eq.(5') boundary op each
        out += [
            GEMM("attn.wq", H * hd, d, toks, n_attn, epilogue_ops=1),
            GEMM("attn.wk", KV * hd, d, toks, n_attn, epilogue_ops=1),
            GEMM("attn.wv", KV * hd, d, toks, n_attn, epilogue_ops=1),
            GEMM("attn.wo", d, H * hd, toks, n_attn),
            # scores & PV: per (batch, head): A[T=S_q, N=hd] x B[hd, S_kv]
            GEMM("attn.qk", S_ctx, hd,
                 1 if shape.kind == "decode" else shape.seq_len,
                 n_attn * shape.global_batch * H),
            GEMM("attn.pv", hd, S_ctx,
                 1 if shape.kind == "decode" else shape.seq_len,
                 n_attn * shape.global_batch * H),
        ]
    if n_mamba:
        ssm = cfg.ssm or SSMConfig()
        d_in = cfg.d_inner
        bc = 2 * ssm.n_groups * ssm.d_state
        out += [
            GEMM("mamba.z", d_in, d, toks, n_mamba),
            GEMM("mamba.xbc", d_in + bc, d, toks, n_mamba),
            GEMM("mamba.dt", cfg.ssm_heads, d, toks, n_mamba),
            GEMM("mamba.out", d, d_in, toks, n_mamba),
        ]
    if n_dense:
        # the wi pair executes as ONE fused dual-GEMM swiglu launch (see
        # nn/layers.swiglu): each entry carries the Eq.(5') epilogue term
        # (silu + gate + the fused ln2 rmsnorm scale = 3 boundary ops) so
        # per-entry t_abs sums to exactly the fused plan's contractions=2
        # prediction and best_k matches the substrate's
        # plan_collapse(..., epilogue_ops=3) pick
        out += [
            GEMM("mlp.wi_gate", cfg.d_ff, d, toks, n_dense, epilogue_ops=3),
            GEMM("mlp.wi_up", cfg.d_ff, d, toks, n_dense, epilogue_ops=3),
            GEMM("mlp.wo", d, cfg.d_ff, toks, n_dense),
        ]
    if n_moe and cfg.moe:
        m = cfg.moe
        eff = m.expert_d_ff or cfg.d_ff
        cap_toks = int(toks * m.top_k * m.capacity_factor / m.num_experts)
        cap_toks = max(cap_toks, 1)
        out += [
            GEMM("moe.router", m.num_experts, d, toks, n_moe),
            GEMM("moe.wi_gate", eff, d, cap_toks, n_moe * m.num_experts),
            GEMM("moe.wi_up", eff, d, cap_toks, n_moe * m.num_experts),
            GEMM("moe.wo", d, eff, cap_toks, n_moe * m.num_experts),
        ]
    if n_cross:
        xl = (cfg.n_image_tokens if cfg.family == "vlm"
              else cfg.max_source_positions)
        out += [
            GEMM("xattn.wq", H * hd, d, toks, n_cross),
            GEMM("xattn.kv", 2 * KV * hd, d,
                 xl * shape.global_batch, n_cross),
            GEMM("xattn.wo", d, H * hd, toks, n_cross),
        ]
    out.append(GEMM("unembed", cfg.padded_vocab, d,
                    shape.global_batch if shape.kind == "decode"
                    else shape.tokens, 1))
    ms = tuple(getattr(cfg, "mesh_shape", ()) or ())
    sharding_on = getattr(cfg, "gemm_sharding", "auto") != "none"
    if len(ms) == 2 and (ms[0] > 1 or ms[1] > 1) and sharding_on:
        E = cfg.moe.num_experts if cfg.moe else 0
        out = [_postshard(g, ms[0], ms[1], E, shape.global_batch * KV)
               for g in out]
    elif len(ms) == 3 and sharding_on:
        # (pod, data, model) role mesh: the intra-role (data, model)
        # partition applies as above, then the pipeline boundary site is
        # decorated with the role's stage-transfer terms — the
        # post-partition per-stage view a disaggregated pod actually plans
        pp, dp, tp_ = ms
        if dp > 1 or tp_ > 1:
            E = cfg.moe.num_experts if cfg.moe else 0
            out = [_postshard(g, dp, tp_, E, shape.global_batch * KV)
                   for g in out]
        role = getattr(cfg, "pp_role", "")
        if pp > 1 and role:
            from repro_torch.parallel.sharding import (PP_BOUNDARY_SITE,
                                                       pp_transfer_terms)
            decorated = []
            for g in out:
                if g.name == PP_BOUNDARY_SITE:
                    t_ops, t_cyc = pp_transfer_terms(role, pp, g.T, g.N)
                    g = dataclasses.replace(g, transfer_ops=t_ops,
                                            transfer_cycles=t_cyc)
                decorated.append(g)
            out = decorated
    return out


def plan_model(cfg: ModelConfig, shape: ShapeConfig, R: int = 128,
               C: int = 128, tp: TimingParams = DEFAULT_TIMING) -> dict:
    return plan_network(model_gemms(cfg, shape), R, C, tp)


# ---------------------------------------------------------------------------
# dispatch-site registry (the substrate <-> planner naming contract)

# Dispatch sites the runtime labels but ``model_gemms`` does not walk:
#   frontend.img / frontend.audio — the VLM/audio frontend projections run
#     once per request, outside the per-step GEMM walk the analytic table
#     models (they are not part of any shape cell's steady-state cost);
#   mlp.wi — the biased gelu MLP variant nn.layers.gelu_mlp offers; no
#     registered arch uses it, but its dispatch label is contracted here so
#     the layer stays auditable.
EXTRA_DISPATCH_SITES = frozenset({"frontend.img", "frontend.audio",
                                  "mlp.wi"})


@functools.lru_cache(maxsize=None)
def site_registry() -> frozenset:
    """Every site label a substrate dispatch may legally carry: the union
    of ``model_gemms`` names over all registered archs (train + decode
    shapes, so every family branch is walked) plus
    :data:`EXTRA_DISPATCH_SITES`.  This is the single source of truth the
    strict-audit runtime check (``substrate._record``) and the jaxpr
    auditor validate dispatch labels against."""
    from repro_torch.configs import ARCHS        # late: configs -> planner cycle
    names = set(EXTRA_DISPATCH_SITES)
    shapes = (ShapeConfig("audit_train", 64, 2, "train"),
              ShapeConfig("audit_decode", 64, 2, "decode"))
    for cfg in ARCHS.values():
        for shape in shapes:
            names.update(g.name for g in model_gemms(cfg, shape))
    return frozenset(names)


# ---------------------------------------------------------------------------
# attention-chunk planning (the kv-scan analogue of pipeline collapse)

def attention_plan(seq_len: int, kv_len: int,
                   choices=(256, 512, 1024, 2048, 4096),
                   step_overhead: float = 1.0, per_elem: float = 1.0 / 1024,
                   waste: float = 0.0):
    """Pick the KV chunk size: minimize steps * (overhead + work-per-step),
    the Eq.(6) structure with kc as the collapse factor.  Costs are in
    arbitrary units; overhead models the per-step fixed latency (dispatch,
    pipeline fill) exactly like the d_base term of Eq.(5).

    Memoized (pure function of small scalars): jit re-traces and
    per-request serving calls hit the same shapes repeatedly.

    Ragged ``kv_len`` is costed exactly: ``floor(kv_len/kc)`` full chunks
    plus one remainder chunk that only pays for the elements it covers, so
    every choice competes on its true ceil-step cost (no candidate is
    skipped, no uncosted fallback).

    ``waste`` prices the allocation granularity of the choice: the trailing
    ``ceil(kv_len/kc)*kc - kv_len`` elements are reserved but never touched.
    At 0 (chunk planning) the term vanishes — a scan chunk costs nothing
    when skipped; for K/V *page* planning (:func:`page_plan`) those elements
    are resident pool memory and compete against per-step overhead."""
    return _attention_plan_cached(seq_len, kv_len, tuple(choices),
                                  step_overhead, per_elem, waste)


@functools.lru_cache(maxsize=None)
def _attention_plan_cached(seq_len, kv_len, choices, step_overhead,
                           per_elem, waste=0.0):
    if not choices:
        raise ValueError("attention_plan needs at least one chunk choice")
    best, best_cost = None, float("inf")
    for kc in choices:
        kc_eff = min(kc, kv_len)
        full, rem = divmod(kv_len, kc_eff)
        cost = full * (step_overhead + per_elem * kc_eff * seq_len)
        if rem:
            cost += step_overhead + per_elem * rem * seq_len
        if waste:
            alloc = (full + (1 if rem else 0)) * kc_eff
            cost += waste * per_elem * (alloc - kv_len)
        if cost < best_cost:
            best, best_cost = kc_eff, cost
    return best


attention_plan.cache_info = _attention_plan_cached.cache_info
attention_plan.cache_clear = _attention_plan_cached.cache_clear


# Candidate K/V page sizes for the paged serving engine (tokens per page).
# Powers of two so that any power-of-two max_seq is exactly tiled — the
# engine requires page | max_seq to keep the gathered logical cache view the
# same length as the dense cache (the bit-exactness contract).
PAGE_SIZE_CHOICES = (8, 16, 32, 64, 128, 256)


def page_plan(max_seq: int, expected_len: int = 0,
              choices=PAGE_SIZE_CHOICES, step_overhead: float = 1.0,
              per_elem: float = 1.0 / 1024, waste: float = 0.5):
    """Pick the K/V page size with the same Eq.(6) machinery that picks the
    attention chunk: steps = pages walked per sequence (each pays the fixed
    block-table/gather overhead, the d_base analogue) against per-page work
    plus the ``waste`` term — the trailing page fraction a sequence of
    ``expected_len`` tokens reserves but never fills.  Small pages waste no
    memory but multiply per-step overhead; one giant page is the dense
    layout.  Shares :func:`attention_plan`'s memo, so the serving zero-miss
    guarantee covers page planning too.

    Only divisors of ``max_seq`` compete (the paged/dense bit-exactness
    contract needs ``page * n_pages_per_seq == max_seq``); the argmin is
    rounded up to the next divisor when ``expected_len`` clips it."""
    expected_len = expected_len or max(1, max_seq // 2)
    divs = tuple(c for c in choices if c <= max_seq and max_seq % c == 0)
    if not divs:
        return max_seq
    kc = attention_plan(1, expected_len, choices=divs,
                        step_overhead=step_overhead, per_elem=per_elem,
                        waste=waste)
    for d in divs:
        if d >= kc:
            return d
    return divs[-1]
