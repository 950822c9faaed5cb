"""Plain PyTorch oracles for the kernels: dense attention and the GEMM.

Port of the reference's ``kernels/ref.py``.  Where the reference asks for
``preferred_element_type=float32``, the operands are upcast before the
product: each product of two bf16 values is exact in fp32 and the sums are
fp32, as in the reference (``torch.einsum`` on bf16 tensors would return
bf16).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def gemm_ref(x, w, out_dtype=None):
    """fp32-accumulated matmul oracle for arrayflex_gemm."""
    out = x.float() @ w.float()
    return out.to(out_dtype or x.dtype)


def attention_ref(q, k, v, *, causal=True, window=0):
    """Dense softmax-attention oracle.  q: (BH,S,D), k/v: (BH,T,D)."""
    BH, S, D = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) * scale
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (cols <= rows)
    if window:
        ok = ok & (cols > rows - window)
    s = torch.where(ok[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(ok[None], p, 0.0)
    out = torch.einsum("bst,btd->bsd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
