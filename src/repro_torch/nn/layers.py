"""Neural-net primitives on tensors: params are plain dicts of tensors.

Port of the reference's ``nn/layers.py``.  Every ``*_init`` takes an
explicit ``torch.Generator`` and device and returns a dict of tensors; the
matching apply function is a plain function of (params, inputs).  Every
GEMM dispatches through ``kernels.substrate`` under its planner site label,
with the site's shard context (``parallel.sharding.gemm_shard_ctx``) where
the reference derives one: ``linear``, ``unembed`` and ``swiglu``.

:func:`checkpointed` is the port's ``jax.checkpoint``: the model's remat
(``models.lm._remat``), each KV step of the chunked attention scan and
each SSD chunk run through it, and it checkpoints only under autograd.
"""
from __future__ import annotations

import contextvars
import math

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import substrate
from repro_torch.parallel import sharding


# ---------------------------------------------------------------- remat
def checkpointed(fn, *args, context_fn=None):
    """``fn(*args)``, checkpointed when autograd records it (grad mode on
    and a tensor among ``args`` requiring a gradient): the forward keeps
    only the inputs, and the backward pass runs ``fn`` again for the rest
    (``torch.utils.checkpoint``, non-reentrant: any nesting of arguments
    and outputs, tensors ``fn`` closes over included).  ``context_fn``:
    a selective policy (:func:`dots_saveable`).  Outside autograd it is
    ``fn(*args)`` itself, so serving and gradient-free forwards run
    unchanged.

    The recomputation runs in a copy of the context variables of the
    forward call (the GEMM-dispatch mesh, the activation rules, the
    pipeline pricing): the backward pass runs after the entry point has
    left its scopes, and recomputing outside them would dispatch other
    GEMMs than the forward did."""
    if not (torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad
            for t in tree_lib.leaves(list(args)))):
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    scope = contextvars.copy_context()
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(lambda *a: scope.run(fn, *a), *args,
                      use_reentrant=False, **kw)


def dots_saveable():
    """Selective-checkpoint contexts that save the outputs of the dots
    without batch dims (``mm`` / ``addmm``: the substrate's 2-D GEMMs) and
    recompute everything else, as the reference's
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    dots = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def normal_init(gen, shape, scale=0.02, dtype=torch.float32, device="cpu"):
    """``scale`` x a standard normal truncated to [-2, 2] (the reference's
    ``jax.random.truncated_normal``; the draws differ from JAX's), drawn
    in fp32 and scaled in place before the cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)


# ---------------------------------------------------------------- linear
def linear_init(gen, in_dim, out_dim, *, bias=False, dtype=torch.float32,
                device="cpu", scale=None):
    if scale is None:
        scale = 1.0 / np.sqrt(in_dim)
    p = {"w": normal_init(gen, (in_dim, out_dim), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def linear(p, x, compute_dtype=None, *, site="", backend="xla",
           residual=None, norm_scale=None):
    """Dense projection through the GEMM substrate.

    ``compute_dtype`` casts w and x as the reference does; on a weight
    that is already in that dtype (the serving engine casts every weight
    once, see ``models.lm.prepare_params``) the cast is a no-op, and since
    the cast is deterministic the numbers are the same either way.  A bias
    rides the fused epilogue, ``residual`` fuses the sublayer's
    ``residual + f(x)`` join, and ``norm_scale`` (the preceding rmsnorm's
    scale, with :func:`rmsnorm_normalize` doing the normalize) fuses into
    the kernel's step prologue.  The dispatch takes the site's shard
    context (a pipeline role's boundary pricing inside the lm entry
    points' scope)."""
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    shard = sharding.gemm_shard_ctx(site, math.prod(x.shape[:-1]),
                                    w.shape[0], w.shape[-1])
    return substrate.gemm(x, w, site=site, backend=backend,
                          bias=p.get("b"), residual=residual,
                          norm_scale=norm_scale, shard=shard)


# ---------------------------------------------------------------- norms
def rmsnorm_init(dim, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def rmsnorm_normalize(x, eps=1e-5):
    """The rmsnorm *normalize* alone — no elementwise scale.  Pairs with the
    substrate's fused ``norm_scale`` prologue, which applies the identical
    fp32 multiply-and-cast (``arrayflex_gemm.prologue_phase``)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt)


def layernorm_init(dim, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


# ---------------------------------------------------------------- embed
def embedding_init(gen, vocab, dim, dtype=torch.float32, device="cpu"):
    return {"table": normal_init(gen, (vocab, dim), 0.02, dtype, device)}


def embed(p, ids, compute_dtype=torch.bfloat16):
    return p["table"].to(compute_dtype)[ids]


def unembed(p, x, *, backend="xla"):
    """Logits against the embedding table (tied) — fp32 accumulation.

    A served tree (``models.lm.prepare_params``) carries ``table_t``, the
    table already cast to the compute dtype and transposed into a
    contiguous (d, V) weight, so no step re-reads the table to transpose
    it; the same cast and transpose give the same numbers.  A tree for a
    quantizing backend (``models.lm.prequantize_params``) carries
    ``table_q``, that transpose quantized, which is preferred."""
    w = p.get("table_q")
    if w is None:
        w = p.get("table_t")
    if w is None:
        w = p["table"].to(x.dtype).t().contiguous()
    shard = sharding.gemm_shard_ctx("unembed", math.prod(x.shape[:-1]),
                                    w.shape[0], w.shape[-1])
    return substrate.gemm(x, w, site="unembed", backend=backend,
                          out_dtype=torch.float32, shard=shard)


# ---------------------------------------------------------------- rope
def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta=1e6):
    """x: (..., S, H, D) with positions (..., S) broadcastable."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), device=x.device)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- mlp
def swiglu_init(gen, d_model, d_ff, dtype=torch.float32, device="cpu"):
    return {
        "wi_gate": linear_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "wi_up": linear_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "wo": linear_init(gen, d_ff, d_model, dtype=dtype, device=device),
    }


def swiglu(p, x, compute_dtype=torch.bfloat16, *, backend="xla",
           residual=None, norm_scale=None):
    """Gated MLP via the substrate's dual-GEMM swiglu epilogue:
    ``silu(x@Wg) * (x@Wu)`` is ONE dispatch (one kernel launch on the
    arrayflex backend), and ``residual`` fuses the sublayer's
    ``residual + mlp(x)`` join into the ``wo`` projection's store."""
    wg, wu = p["wi_gate"]["w"], p["wi_up"]["w"]
    if compute_dtype is not None:
        wg = wg.to(compute_dtype)
        wu = wu.to(compute_dtype)
        x = x.to(compute_dtype)
    shard = sharding.gemm_shard_ctx("mlp.wi_gate+mlp.wi_up",
                                    math.prod(x.shape[:-1]),
                                    wg.shape[0], wg.shape[-1])
    h = substrate.gemm(x, wg, w2=wu, epilogue="swiglu",
                       bias=p["wi_gate"].get("b"),
                       bias2=p["wi_up"].get("b"),
                       norm_scale=norm_scale,
                       site="mlp.wi_gate+mlp.wi_up", backend=backend,
                       shard=shard)
    return linear(p["wo"], h, compute_dtype, site="mlp.wo",
                  backend=backend, residual=residual)


def gelu_mlp_init(gen, d_model, d_ff, dtype=torch.float32, device="cpu"):
    return {"wi": linear_init(gen, d_model, d_ff, bias=True, dtype=dtype,
                              device=device),
            "wo": linear_init(gen, d_ff, d_model, bias=True, dtype=dtype,
                              device=device)}


def gelu_mlp(p, x, compute_dtype=torch.bfloat16, *, backend="xla",
             residual=None):
    """Biased MLP: the bias and the gelu (tanh approximation, the
    reference's ``jax.nn.gelu``) ride the ``mlp.wi`` GEMM's epilogue, and
    ``residual`` fuses the sublayer's join into ``mlp.wo``'s store."""
    wi = p["wi"]["w"]
    if compute_dtype is not None:
        wi = wi.to(compute_dtype)
        x = x.to(compute_dtype)
    h = substrate.gemm(x, wi, bias=p["wi"].get("b"), epilogue="gelu",
                       site="mlp.wi", backend=backend)
    return linear(p["wo"], h, compute_dtype, site="mlp.wo",
                  backend=backend, residual=residual)


# ---------------------------------------------------------------- loss
def softmax_xent(logits, labels, mask=None):
    """Mean token cross-entropy: fp32 logsumexp minus the gold logit.
    logits (..., V); labels int (...,); ``mask`` (...,) weights each token
    and the sum divides by the mask's total, floored at 1."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
