"""Public GEMM wrappers: planner-driven kernel configuration.

Port of the reference's ``kernels/ops.py``.  ``arrayflex_matmul`` is the
ArrayFlex-scheduled GEMM: the collapse factor k comes from core.planner
(Eq. 6/7) for the GEMM's (M, N, T) shape, and an optional fused epilogue
(bias / activation / dual-GEMM gate / residual) rides the carry-propagate
store.  ``arrayflex_expert_matmul`` runs a stack of same-shape batched
GEMMs in one launch.

Ragged M/N need no padding here: the CUDA kernel masks its ragged edges
itself, so the result equals the reference's zero-padded one.  Ragged K is
exact for the same reason (masked K terms contribute exactly 0).

``plan_collapse`` is memoized: it is a pure function of small int tuples,
and per-request serving hits it with the same handful of shapes.
"""
from __future__ import annotations

import functools
import math

from repro_torch.core import timing
from repro_torch.kernels.arrayflex_gemm import (arrayflex_gemm,
                                                arrayflex_expert_gemm)

# The systolic tile the planner's Eq.(4) cycle counts schedule around (the
# reference's MXU geometry).  The plan, not the CUDA tile, uses it, so the
# port picks the same k as the reference for every shape.
SA_R = 128
SA_C = 128


@functools.lru_cache(maxsize=None)
def plan_collapse(M: int, K: int, T_rows: int, *, max_k: int = 4,
                  epilogue_ops: int = 0, precision: str = "fp32") -> int:
    """ArrayFlex pipeline depth for GEMM X[T,K] @ W[K,M] (Eq. 7 -> discrete).

    K is the contraction (the SA's R-tiled dim), M the output columns.
    ``epilogue_ops`` prices fused post-GEMM vector ops into the per-step
    period (Eq. 5'); ``precision`` selects the datapath's Eq.(5)
    coefficients.  Identical to the reference's pick.  (The reference's
    W8A8 ``actq_ops`` and pipeline ``transfer_cycles`` terms come with the
    slices that port those paths.)
    """
    k = timing.best_k(M, K, T_rows, SA_R, SA_C,
                      timing.timing_for(precision),
                      epilogue_ops=epilogue_ops)
    return max(1, min(max_k, k))


def arrayflex_matmul(x, w, *, w2=None, bias=None, bias2=None, residual=None,
                     norm_scale=None, activation: str = "none",
                     k_collapse: int = 0, out_dtype=None):
    """Planner-configured GEMM with fused epilogue.  x: (..., K), w: (K, N).

        out = [residual +] act((g*x)@w [+ bias]) [* ((g*x)@w2 [+ bias2])]

    ``residual`` is output-shaped ``(..., N)``.  The unplanned
    ``k_collapse=0`` prices its own boundary ops (activation, gate, biases,
    residual, norm scale) into Eq.(5') and plans k.  Covers every shape:
    an empty operand returns the epilogue of zeros.
    """
    lead = tuple(x.shape[:-1])
    K = x.shape[-1]
    N = w.shape[-1]
    T = math.prod(lead)
    x2 = x.reshape(T, K)
    if not k_collapse:
        n_ops = ((activation != "none") + (bias is not None)
                 + (bias2 is not None) + (w2 is not None)
                 + (residual is not None) + (norm_scale is not None))
        k_collapse = plan_collapse(N, K, T, epilogue_ops=n_ops)
    out = arrayflex_gemm(
        x2, w, w2=w2, bias=bias, bias2=bias2,
        residual=None if residual is None else residual.reshape(T, N),
        norm_scale=norm_scale, activation=activation,
        k_collapse=k_collapse, out_dtype=out_dtype)
    return out.reshape(*lead, N)


def arrayflex_expert_matmul(x, w, *, k_collapse: int = 0, out_dtype=None):
    """Planner-configured batched GEMM in ONE kernel launch.

    x: (E, T, K), w: (E, K, N) -> (E, T, N).  Every batch element shares
    one collapse depth k, planned for the common (N, K, T) shape."""
    E, T, K = x.shape
    N = w.shape[-1]
    if not k_collapse:
        k_collapse = plan_collapse(N, K, T)
    return arrayflex_expert_gemm(x, w, k_collapse=k_collapse,
                                 out_dtype=out_dtype)
