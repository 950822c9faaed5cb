"""GQA attention: dense, chunked (flash-style) and decode paths.

Port of the reference's ``nn/attention.py``.  The dense and decode paths'
QK and PV contractions dispatch through the substrate under the
``attn.qk`` / ``attn.pv`` site labels, and the arrayflex backend runs all
(batch x kv-head) products of a step in ONE expert-batched kernel launch.
The chunked path is a plain loop over KV chunks with an online softmax and
dispatches nothing, as in the reference (its KV chunk is the collapse
analogue that ``planner.attention_plan`` picks).  The reference's layouts
are kept at these functions: q (B, S, H, D), k/v (B, T, KV, D), scores
(B, KV, g, S, T).

Where the reference asks for fp32 products of bf16 operands
(``preferred_element_type``), the chunked path upcasts the operands: each
product is exact in fp32 and the sums are fp32.

The paged K/V view (``gather_pages`` / ``scatter_pages``) is plain torch
indexing, as in the reference (no kernel computes it there).  Decode
against a sliding-window ring buffer takes ``window``
(:func:`decode_attention`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import substrate
from repro_torch.parallel import sharding

NEG_INF = -1e30


def qk_scores(qg, k, *, backend="xla"):
    """Attention scores via the substrate (site ``attn.qk``).

    qg: (B, S, KV, g, D) grouped queries; k: (B, T, KV, D).  Returns fp32
    scores laid out (B, KV, g, S, T), executed as a (B*KV)-batched GEMM
    with the g*S query rows streamed against each kv-head's K^T.
    Unscaled: callers apply 1/sqrt(D).  (The operands are contiguous
    copies in the reference's layout: K^T is a transposed copy of the
    cache.  With B = 1 the reshape alone would leave a strided view.)
    """
    B, S, KV, g, D = qg.shape
    T = k.shape[1]
    qb = qg.permute(0, 2, 3, 1, 4).reshape(B * KV, g * S, D).contiguous()
    kb = k.permute(0, 2, 3, 1).reshape(B * KV, D, T).contiguous()
    s = substrate.batched_gemm(qb, kb, site="attn.qk", backend=backend,
                               out_dtype=torch.float32,
                               shard=sharding.batched_shard_ctx(B * KV))
    return s.reshape(B, KV, g, S, T)


def pv_mix(w, v, *, backend="xla"):
    """Probability-weighted value mix via the substrate (site ``attn.pv``).

    w: (B, KV, g, S, T) attention weights (cast to v.dtype by callers);
    v: (B, T, KV, D).  Returns (B, S, KV, g, D) as a (B*KV)-batched GEMM.
    """
    B, KV, g, S, T = w.shape
    D = v.shape[-1]
    pb = w.reshape(B * KV, g * S, T).contiguous()
    vb = v.permute(0, 2, 1, 3).reshape(B * KV, T, D).contiguous()
    o = substrate.batched_gemm(pb, vb, site="attn.pv", backend=backend,
                               shard=sharding.batched_shard_ctx(B * KV))
    return o.reshape(B, KV, g, S, D).permute(0, 3, 1, 2, 4)


def dense_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_len=None, backend="xla"):
    """q: (B,S,H,D), k/v: (B,T,KV,D).  fp32 softmax.  Returns (B,S,H,D) in
    v's dtype.  QK and PV dispatch through the substrate
    (``attn.qk``/``attn.pv``); query rows sit at global positions
    ``q_offset + i`` and keys at or past ``kv_len`` are masked."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    qg = q.reshape(B, S, KV, g, D)
    scale = 1.0 / math.sqrt(D)
    scores = qk_scores(qg, k, backend=backend) * scale
    r = q_offset + torch.arange(S, device=q.device)[:, None]
    c = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (c <= r)
    if window:
        ok = ok & (c > r - window)
    if kv_len is not None:
        ok = ok & (c < kv_len)
    scores = torch.where(ok, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = pv_mix(w, v, backend=backend)
    return out.reshape(B, S, H, D)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      kv_chunk=1024):
    """Flash-style attention without a kernel: all query rows stay
    resident and KV is consumed in ``kv_chunk``-column chunks with an
    online softmax (fp32 o, m, l).  (The reference's ``q_chunk`` changes
    no number there and is not taken.)

    T need not divide ``kv_chunk``: the last chunk is shorter, which equals
    the reference's zero-pad-and-mask (a masked column contributes an
    exact 0), so a prime KV length runs in ``ceil(T/kc)`` steps."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    kv_chunk = min(kv_chunk, T)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qg = q.reshape(B, S, KV, g, D).float()
    rows = q_offset + torch.arange(S, device=dev)[:, None]    # global row ids
    o = torch.zeros((B, S, KV, g, D), dtype=torch.float32, device=dev)
    m = torch.full((B, S, KV, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, KV, g), dtype=torch.float32, device=dev)
    for col0 in range(0, T, kv_chunk):
        ks = k[:, col0:col0 + kv_chunk]
        vs = v[:, col0:col0 + kv_chunk]
        s = torch.einsum("bskgd,btkd->bkgst", qg, ks.float()) * scale
        cols = col0 + torch.arange(ks.shape[1], device=dev)[None, :]
        ok = torch.ones((S, ks.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            ok = ok & (cols <= rows)
        if window:
            ok = ok & (cols > rows - window)
        s = torch.where(ok, s, NEG_INF)                      # (B,KV,g,S,kc)
        m_new = torch.maximum(m, s.amax(dim=-1).permute(0, 3, 1, 2))
        p = torch.exp(s - m_new.permute(0, 2, 3, 1)[..., None])
        p = torch.where(ok, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1).permute(0, 3, 1, 2)
        pv = torch.einsum("bkgst,btkd->bskgd", p.to(vs.dtype).float(),
                          vs.float())
        o = o * corr[..., None] + pv
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, S, H, D).to(q.dtype)


def attention(q, k, v, *, causal=True, window=0, q_offset=0,
              kv_chunk=1024, dense_below=2048, backend="xla"):
    """Dense attention up to ``dense_below`` query rows, the chunked scan
    above.  ``backend`` applies to the dense path's substrate QK/PV
    dispatch only: the chunked scan has no substrate GEMMs or kernel
    launches to configure."""
    if q.shape[1] <= dense_below:
        return dense_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, backend=backend)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_chunk=kv_chunk)


def gather_pages(pool, block_tables):
    """Assemble per-sequence logical K/V views from a physical page pool.

    pool: (n_pages, page, KV, D); block_tables: (B, n_pg) int64 physical
    page ids.  Returns a (B, n_pg*page, KV, D) copy — the contiguous cache
    view the ``attn.qk``/``attn.pv`` dispatches consume, so a paged cache
    feeds the *same* GEMM plans as the dense one (the view length equals
    the dense cache length by the engine's page | max_seq contract)."""
    B, n_pg = block_tables.shape
    page = pool.shape[1]
    return pool.index_select(0, block_tables.reshape(-1)).reshape(
        (B, n_pg * page) + pool.shape[2:])


def scatter_pages(pool, block_tables, view):
    """Inverse of :func:`gather_pages`: write logical views back into the
    pool in place (and return it).  Rows may alias pages (shared prefixes,
    the scratch page); callers keep every aliased page's gathered bytes
    unchanged in each row's view, so whichever duplicate ``index_copy_``
    keeps (on the card the choice is unspecified), the pool gets the same
    bytes."""
    B, n_pg = block_tables.shape
    return pool.index_copy_(0, block_tables.reshape(-1),
                            view.reshape((B * n_pg,) + pool.shape[1:]))


def decode_attention(q, k_cache, v_cache, pos, *, window=0, backend="xla"):
    """Single-token attention against a linear or ring-buffered KV cache.

    q: (B,1,H,D); caches (B,T,KV,D); pos: per-sequence (B,) int tensor (or
    a scalar).  Linear cache (``window`` 0): keys at slots <= pos are
    attended.  Ring buffer (``window`` > 0, T = the cache length the
    window clamps to): slots below pos + 1 while the ring fills, every
    slot once pos + 1 >= T.  QK and PV dispatch through the substrate
    (``attn.qk``/``attn.pv``).
    """
    B, _, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    qg = q.reshape(B, 1, KV, g, D)
    scale = 1.0 / math.sqrt(D)
    s = qk_scores(qg, k_cache, backend=backend) * scale
    idx = torch.arange(T, device=q.device)
    pos_v = torch.as_tensor(pos, device=q.device).expand(B)
    if window:
        valid = ((idx[None, :] < torch.clamp(pos_v + 1, max=T)[:, None])
                 | (pos_v + 1 >= T)[:, None])               # ring full
    else:
        valid = idx[None, :] <= pos_v[:, None]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s.float(), dim=-1).to(v_cache.dtype)
    out = pv_mix(w, v_cache, backend=backend)
    return out.reshape(B, 1, H, D).to(q.dtype)
