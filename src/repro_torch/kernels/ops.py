"""Public GEMM wrappers: planner-driven kernel configuration.

Port of the reference's ``kernels/ops.py``.  ``arrayflex_matmul`` is the
ArrayFlex-scheduled GEMM: the collapse factor k comes from core.planner
(Eq. 6/7) for the GEMM's (M, N, T) shape, and an optional fused epilogue
(bias / activation / dual-GEMM gate / residual) rides the carry-propagate
store.  ``arrayflex_expert_matmul`` runs a stack of same-shape batched
GEMMs in one launch.  ``attention`` is flash attention with the planner's
KV chunk.

Ragged M/N need no padding here: the CUDA kernel masks its ragged edges
itself, so the result equals the reference's zero-padded one.  Ragged K is
exact for the same reason (masked K terms contribute exactly 0).  Under
W8A8 the reference's padded tiles also set the activation scales; the
kernel and its plain version derive them from those tiles
(``arrayflex_gemm.quant_tiles``), so nothing is padded for that either.

``plan_collapse`` is memoized: it is a pure function of small int tuples,
and per-request serving hits it with the same handful of shapes.
"""
from __future__ import annotations

import functools
import math

from repro_torch.core import planner, timing
from repro_torch.kernels.arrayflex_gemm import (arrayflex_gemm,
                                                arrayflex_expert_gemm)
from repro_torch.kernels.flash_attention import flash_attention

# The systolic tile the planner's Eq.(4) cycle counts schedule around (the
# reference's MXU geometry).  The plan, not the CUDA tile, uses it, so the
# port picks the same k as the reference for every shape.
SA_R = 128
SA_C = 128


@functools.lru_cache(maxsize=None)
def plan_collapse(M: int, K: int, T_rows: int, *, max_k: int = 4,
                  epilogue_ops: int = 0, precision: str = "fp32",
                  actq_ops: int = 0) -> int:
    """ArrayFlex pipeline depth for GEMM X[T,K] @ W[K,M] (Eq. 7 -> discrete).

    K is the contraction (the SA's R-tiled dim), M the output columns.
    ``epilogue_ops`` prices fused post-GEMM vector ops into the per-step
    period (Eq. 5'); ``precision`` selects the datapath's Eq.(5)
    coefficients; ``actq_ops`` prices the W8A8 activation-quantize boundary
    stage (Eq. 5' ``d_actq_ps``), which alone moves (896, 4864, 512) from
    k=2 to k=4 on the w8a8 datapath.  Identical to the reference's pick.
    (The reference's pipeline ``transfer_cycles`` term comes with the slice
    that ports sharded pipelines.)
    """
    k = timing.best_k(M, K, T_rows, SA_R, SA_C,
                      timing.timing_for(precision),
                      epilogue_ops=epilogue_ops, actq_ops=actq_ops)
    return max(1, min(max_k, k))


def _precision(quant: bool, act_quant: bool) -> str:
    return ("w8a8" if act_quant else "int8") if quant else "fp32"


def arrayflex_matmul(x, w, *, w2=None, bias=None, bias2=None, w_scale=None,
                     w2_scale=None, act_quant: bool = False, residual=None,
                     norm_scale=None, activation: str = "none",
                     k_collapse: int = 0, out_dtype=None):
    """Planner-configured GEMM with fused epilogue.  x: (..., K), w: (K, N).

        out = [residual +] act((g*x)@w [+ bias]) [* ((g*x)@w2 [+ bias2])]

    ``residual`` is output-shaped ``(..., N)``.  ``w_scale`` makes ``w``
    int8 codes (dequant at the store, ``w2_scale`` for ``w2``) and
    ``act_quant`` adds the W8A8 per-tile activation quantizer.  The
    unplanned ``k_collapse=0`` prices its own boundary ops (activation,
    gate, biases, residual, norm scale, one dequant per contraction) on the
    operands' datapath (fp32, int8 or w8a8 with its quantize stage) into
    Eq.(5') and plans k.  Covers every shape: an empty operand returns the
    epilogue of zeros.
    """
    lead = tuple(x.shape[:-1])
    K = x.shape[-1]
    N = w.shape[-1]
    T = math.prod(lead)
    x2 = x.reshape(T, K)
    quant = w_scale is not None
    if not k_collapse:
        n_ops = ((activation != "none") + (bias is not None)
                 + (bias2 is not None) + (w2 is not None)
                 + (residual is not None) + (norm_scale is not None)
                 + quant * (1 + (w2 is not None)))
        k_collapse = plan_collapse(N, K, T, epilogue_ops=n_ops,
                                   precision=_precision(quant, act_quant),
                                   actq_ops=int(act_quant))
    out = arrayflex_gemm(
        x2, w, w2=w2, bias=bias, bias2=bias2, w_scale=w_scale,
        w2_scale=w2_scale, act_quant=act_quant,
        residual=None if residual is None else residual.reshape(T, N),
        norm_scale=norm_scale, activation=activation,
        k_collapse=k_collapse, out_dtype=out_dtype)
    return out.reshape(*lead, N)


def arrayflex_expert_matmul(x, w, *, w_scale=None, act_quant: bool = False,
                            k_collapse: int = 0, out_dtype=None):
    """Planner-configured batched GEMM in ONE kernel launch.

    x: (E, T, K), w: (E, K, N) -> (E, T, N).  Every batch element shares
    one collapse depth k, planned for the common (N, K, T) shape.
    ``w_scale`` (E, N) makes ``w`` int8 codes; ``act_quant`` adds the W8A8
    per-tile activation quantizer."""
    E, T, K = x.shape
    N = w.shape[-1]
    quant = w_scale is not None
    if not k_collapse:
        k_collapse = plan_collapse(N, K, T, epilogue_ops=int(quant),
                                   precision=_precision(quant, act_quant),
                                   actq_ops=int(act_quant))
    return arrayflex_expert_gemm(x, w, w_scale=w_scale, act_quant=act_quant,
                                 k_collapse=k_collapse, out_dtype=out_dtype)


def attention(q, k, v, *, causal=True, window=0, kv_chunk: int = 0):
    """Flash attention with planner-chosen KV chunk.  (BH,S,D) layout.

    The KV length need not divide the chunk: the kernel masks the ragged
    tail, so the planner's pick is used as-is (a prime KV length does not
    degenerate to chunk=1)."""
    if not kv_chunk:
        kv_chunk = planner.attention_plan(q.shape[1], k.shape[1])
    return flash_attention(q, k, v, causal=causal, window=window,
                           kv_chunk=kv_chunk)
