"""Token-choice top-k MoE with grouped, sort-based, gather-only dispatch.

Port of the reference's ``nn/moe.py``.  Tokens are split into G
independent dispatch groups (G = batch by default; decode runs one global
group).  Within a group:

  1. router (site ``moe.router``, fp32 x and weights) -> top-k experts per
     token,
  2. a stable argsort of the flat (token, k) expert ids gives each
     assignment's rank within its expert,
  3. the per-expert capacity buffer is built with a GATHER from the sorted
     order; assignments ranked beyond capacity are dropped,
  4. the expert GEMMs ``moe.wi_gate``, ``moe.wi_up`` and ``moe.wo`` run
     every expert of a site in one launch (``substrate.expert_gemm``),
  5. results gather back to token order and combine with the router
     weights.

Every index operation follows the reference's: the top-k order (ties to
the lower expert id, as ``jax.lax.top_k``), the stable sorts, the capacity
``int(max(1, round(Tg * top_k * capacity_factor / E)))`` with Python's
round-half-to-even, and so the same dropped assignments.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import substrate
from repro_torch.nn import layers

# a list while :func:`record_routing` is active: each moe_apply call
# appends its (top-k expert ids, kept) pair
_ROUTING = None


@contextlib.contextmanager
def record_routing():
    """Collect the routing of every :func:`moe_apply` call made inside the
    block, in call order: one ``(top_idx, keep)`` pair per call, both
    (G, Tg, top_k) — the expert ids each token picked, and whether each
    assignment fit its expert's capacity."""
    global _ROUTING
    prev, _ROUTING = _ROUTING, []
    try:
        yield _ROUTING
    finally:
        _ROUTING = prev


def moe_init(gen, d_model, d_ff, num_experts, *, num_shared=0,
             dtype=torch.float32, device="cpu"):
    """Router (fp32 whatever ``dtype``: its logits feed a discrete top-k)
    and the (E, d, ff) / (E, ff, d) expert banks in ``dtype``."""
    p = {
        "router": layers.normal_init(gen, (d_model, num_experts), 0.02,
                                     torch.float32, device),
        "wi_gate": layers.normal_init(gen, (num_experts, d_model, d_ff),
                                      1.0 / np.sqrt(d_model), dtype, device),
        "wi_up": layers.normal_init(gen, (num_experts, d_model, d_ff),
                                    1.0 / np.sqrt(d_model), dtype, device),
        "wo": layers.normal_init(gen, (num_experts, d_ff, d_model),
                                 1.0 / np.sqrt(d_ff), dtype, device),
    }
    if num_shared:
        p["shared"] = layers.swiglu_init(gen, d_model, d_ff * num_shared,
                                         dtype, device)
    return p


def _top_k(probs, k: int):
    """``jax.lax.top_k`` on the last axis: the k largest, descending, equal
    values in increasing index order (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits, top_k):
    """Router logits -> (probs, renormalized top-k weights, top-k ids)."""
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = _top_k(probs, top_k)
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    return probs, top_vals, top_idx


def moe_apply(p, x, *, top_k, capacity_factor=1.25, groups=0,
              compute_dtype=torch.bfloat16, aux_loss_weight=0.01,
              backend="xla"):
    """x: (B, S, d) -> (y, aux_loss).  groups=0 -> one group per sequence."""
    B, S, d = x.shape
    T = B * S
    G = groups or B
    Tg = T // G
    E = p["router"].shape[1]
    TK = Tg * top_k
    cd = compute_dtype
    dev = x.device
    xf = x.reshape(G, Tg, d)

    logits = substrate.gemm(xf.float(), p["router"], site="moe.router",
                            backend=backend)
    probs, top_vals, top_idx = _route(logits, top_k)      # (G,Tg,k)

    flat_e = top_idx.reshape(G, TK)
    # per-expert assignment counts (a scatter: F.one_hot checks its ids on
    # the host, a device sync per call)
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))                  # (G,E)

    # ---- load-balance auxiliary loss (Switch-style), over all tokens
    me = torch.mean(probs, dim=(0, 1))
    ce = counts.sum(dim=0).float() / (T * top_k)
    aux = aux_loss_weight * E * torch.sum(me * ce)

    # ---- rank-in-expert via stable sort
    order = torch.argsort(flat_e, dim=-1, stable=True)      # (G,TK)
    sorted_e = torch.take_along_dim(flat_e, order, dim=-1)
    starts = torch.cumsum(counts, dim=-1) - counts           # (G,E)
    rank_sorted = (torch.arange(TK, device=dev)[None, :]
                   - torch.take_along_dim(starts, sorted_e, dim=-1))
    inv_order = torch.argsort(order, dim=-1, stable=True)
    rank = torch.take_along_dim(rank_sorted, inv_order, dim=-1)  # (G,TK)

    cap = int(max(1, round(Tg * top_k * capacity_factor / E)))
    keep = rank < cap
    if _ROUTING is not None:
        _ROUTING.append((top_idx, keep.reshape(G, Tg, top_k)))

    # ---- capacity buffer by GATHER from the sorted stream
    slots = torch.arange(cap, device=dev)
    slot_pos = starts[:, :, None] + slots[None, None, :]    # (G,E,cap)
    slot_valid = slots[None, None, :] < counts[:, :, None]
    slot_src = torch.take_along_dim(
        order, torch.clamp(slot_pos, max=TK - 1).reshape(G, E * cap),
        dim=-1).reshape(G, E, cap)
    slot_tok = slot_src // top_k                             # (G,E,cap)
    he = torch.take_along_dim(xf.to(cd),
                              slot_tok.reshape(G, E * cap)[:, :, None], dim=1)
    he = he.reshape(G, E, cap, d) * slot_valid[..., None].to(cd)

    # ---- expert GEMMs: every expert of a site in one dispatch (a
    # QuantizedTensor bank's dtype cast is a no-op)
    wg = p["wi_gate"].to(cd)
    wu = p["wi_up"].to(cd)
    wo = p["wo"].to(cd)
    hg = substrate.expert_gemm(he, wg, site="moe.wi_gate", backend=backend)
    hu = substrate.expert_gemm(he, wu, site="moe.wi_up", backend=backend)
    h = F.silu(hg) * hu
    hout = substrate.expert_gemm(h, wo, site="moe.wo", backend=backend)

    # ---- combine back (gather token slots, weight, sum over k)
    dst = torch.where(keep, flat_e * cap + rank, 0)          # (G,TK)
    y_rep = torch.take_along_dim(hout.reshape(G, E * cap, d),
                                 dst[:, :, None], dim=1)     # (G,TK,d)
    y_rep = y_rep * keep[..., None].to(cd)
    w = top_vals.reshape(G, TK, 1).to(cd)
    y = torch.sum((y_rep * w).reshape(G, Tg, top_k, d), dim=2)

    y = y.reshape(B, S, d)
    if "shared" in p:
        y = y + layers.swiglu(p["shared"], x.reshape(B, S, d), cd,
                              backend=backend)
    return y.to(x.dtype), aux


def _einsum(eq, a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def moe_apply_reference(p, x, *, top_k, compute_dtype=torch.float32):
    """O(T*E*d*ff) oracle: run every expert on every token, combine top-k.

    With ample capacity :func:`moe_apply` must agree with it to numerical
    tolerance (the tests hold the two together)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    _, top_vals, top_idx = _route(xf.float() @ p["router"], top_k)
    E = p["router"].shape[1]
    cd = compute_dtype
    g = _einsum("td,edf->tef", xf, p["wi_gate"].to(cd))
    u = _einsum("td,edf->tef", xf, p["wi_up"].to(cd))
    h = _einsum("tef,efd->ted", F.silu(g) * u, p["wo"].to(cd))
    mask = F.one_hot(top_idx, E).float()                     # (T,k,E)
    w = torch.einsum("tk,tke->te", top_vals, mask)
    y = _einsum("te,ted->td", w, h)
    if "shared" in p:
        y = y + layers.swiglu(p["shared"], xf, cd)
    return y.reshape(B, S, d).to(x.dtype)
