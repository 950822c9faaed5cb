"""GQA attention through the GEMM substrate: the QK/PV products and decode.

Port of the reference's ``nn/attention.py`` (the substrate products and
the decode path).  The QK and PV contractions dispatch through the
substrate under the ``attn.qk`` / ``attn.pv`` site labels, and the
arrayflex backend runs all (batch x kv-head) products of a step in ONE
expert-batched kernel launch.  The reference's layouts are kept at these
functions: scores are (B, KV, g, S, T).

The dense full-sequence path, the chunked flash-style scan and the paged
gather/scatter are not ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import substrate

NEG_INF = -1e30


def qk_scores(qg, k, *, backend="xla"):
    """Attention scores via the substrate (site ``attn.qk``).

    qg: (B, S, KV, g, D) grouped queries; k: (B, T, KV, D).  Returns fp32
    scores laid out (B, KV, g, S, T), executed as a (B*KV)-batched GEMM
    with the g*S query rows streamed against each kv-head's K^T.
    Unscaled: callers apply 1/sqrt(D).  (The K^T operand is a transposed
    copy of the cache, as in the reference's layout.)
    """
    B, S, KV, g, D = qg.shape
    T = k.shape[1]
    qb = qg.permute(0, 2, 3, 1, 4).reshape(B * KV, g * S, D)
    kb = k.permute(0, 2, 3, 1).reshape(B * KV, D, T)
    s = substrate.batched_gemm(qb, kb, site="attn.qk", backend=backend,
                               out_dtype=torch.float32)
    return s.reshape(B, KV, g, S, T)


def pv_mix(w, v, *, backend="xla"):
    """Probability-weighted value mix via the substrate (site ``attn.pv``).

    w: (B, KV, g, S, T) attention weights (cast to v.dtype by callers);
    v: (B, T, KV, D).  Returns (B, S, KV, g, D) as a (B*KV)-batched GEMM.
    """
    B, KV, g, S, T = w.shape
    D = v.shape[-1]
    pb = w.reshape(B * KV, g * S, T)
    vb = v.permute(0, 2, 1, 3).reshape(B * KV, T, D)
    o = substrate.batched_gemm(pb, vb, site="attn.pv", backend=backend)
    return o.reshape(B, KV, g, S, D).permute(0, 3, 1, 2, 4)


def decode_attention(q, k_cache, v_cache, pos, *, backend="xla"):
    """Single-token attention against a linear KV cache.

    q: (B,1,H,D); caches (B,T,KV,D); pos: per-sequence (B,) int tensor (or
    a scalar).  Keys at positions <= pos are attended; QK and PV dispatch
    through the substrate (``attn.qk``/``attn.pv``).  Sliding-window ring
    buffers are not ported yet.
    """
    B, _, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qg = q.reshape(B, 1, KV, g, D)
    scale = 1.0 / math.sqrt(D)
    s = qk_scores(qg, k_cache, backend=backend) * scale
    idx = torch.arange(T, device=q.device)
    pos_v = torch.as_tensor(pos, device=q.device).expand(B)
    valid = idx[None, :] <= pos_v[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s.float(), dim=-1).to(v_cache.dtype)
    out = pv_mix(w, v_cache, backend=backend)
    return out.reshape(B, 1, H, D).to(q.dtype)
