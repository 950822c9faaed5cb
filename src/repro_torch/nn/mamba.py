"""Mamba-2 (SSD, state-space duality) block — chunked matmul form + decode.

Port of the reference's ``nn/mamba.py``.  The chunked SSD algorithm
(arXiv:2405.21060 §6) splits the selective-SSM recurrence into
intra-chunk quadratic (matmul-shaped) terms and a small sequential
inter-chunk state scan; the scan, the depthwise causal conv and the
one-token recurrence are plain PyTorch here, as they are plain ``jnp`` in
the reference.  Every GEMM dispatches through ``layers.linear`` at the
sites ``mamba.z``, ``mamba.xbc``, ``mamba.dt`` and ``mamba.out``, so on
an ``arrayflex*`` backend each one is a K1 launch.  The state is fp32
whatever the compute dtype.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.nn import layers


def _inv_softplus(x):
    return np.log(np.expm1(x))


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no linear threshold)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def mamba_init(gen, d_model, ssm, dtype=torch.float32, device="cpu"):
    """ssm: configs.base.SSMConfig.  ``dt_bias`` and ``a_log`` come from
    ``np.random.RandomState(0)`` / ``(1)`` as in the reference, so they
    equal its leaves at every layer (``a_log`` up to the last bit of the
    fp32 log); the other leaves are drawn from ``gen``."""
    d_inner = ssm.expand * d_model
    H = d_inner // ssm.head_dim
    G, N, K = ssm.n_groups, ssm.d_state, ssm.d_conv
    conv_ch = d_inner + 2 * G * N
    dt = np.exp(np.random.RandomState(0).uniform(
        math.log(ssm.dt_min), math.log(ssm.dt_max), (H,)))
    a = np.random.RandomState(1).uniform(1.0, 16.0, (H,))

    def lin(i, o):
        return layers.linear_init(gen, i, o, dtype=dtype, device=device)

    p = {"z_proj": lin(d_model, d_inner),
         "xbc_proj": lin(d_model, conv_ch),
         "dt_proj": lin(d_model, H)}
    p.update({
        "dt_bias": torch.as_tensor(_inv_softplus(dt), dtype=torch.float32,
                                   device=device),
        "a_log": torch.log(torch.as_tensor(a, dtype=torch.float32,
                                           device=device)),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "conv_w": layers.normal_init(gen, (K, conv_ch), 0.1, dtype, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "norm": layers.rmsnorm_init(d_inner, dtype, device),
        "out_proj": lin(d_inner, d_model),
    })
    return {k: p[k] for k in ("z_proj", "xbc_proj", "dt_proj", "dt_bias",
                              "a_log", "D", "conv_w", "conv_b", "norm",
                              "out_proj")}


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B,S,ch), w: (K,ch): ``F.conv1d`` with
    ``groups=ch`` on a (B, ch, S) view, left-padded by K-1."""
    K, ch = w.shape
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))
    out = F.conv1d(xp, w.t().unsqueeze(1).to(x.dtype), groups=ch)
    return out.transpose(1, 2) + b.to(x.dtype)


def _segsum(dA):
    """dA: (..., c) -> (..., c, c) with out[i,j] = sum_{j<m<=i} dA[m]
    (-inf above the diagonal)."""
    cs = torch.cumsum(dA, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    c = dA.shape[-1]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dA.device))
    return torch.where(mask, seg, torch.tensor(-math.inf, dtype=seg.dtype,
                                               device=seg.device))


def ssd_chunked(x, dt, A, B_, C_, chunk):
    """Chunked SSD.  x:(B,S,H,P) dt:(B,S,H) A:(H,) B_/C_:(B,S,G,N).

    Returns y:(B,S,H,P) in x's dtype, final_state:(B,G,H/G,P,N) fp32.

    The chunks run in order, each reading and then advancing the carried
    state, and the intra-chunk contraction is staged so no (c, c, P)
    tensor is ever built: the peak is O(B*H*c^2) for one chunk."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    hg = H // G
    nc = S // chunk
    assert S % chunk == 0
    f32 = torch.float32
    A2 = A.reshape(G, hg)

    def cmajor(a, extra):
        return a.to(f32).reshape((Bsz, nc, chunk) + extra)

    xs = cmajor(x, (G, hg, P))
    dts = cmajor(dt, (G, hg))
    Bs = cmajor(B_, (G, N))
    Cs = cmajor(C_, (G, N))
    state = torch.zeros((Bsz, G, hg, P, N), dtype=f32, device=x.device)
    ys = []
    for i in range(nc):
        xc, dtc, Bc, Cc = xs[:, i], dts[:, i], Bs[:, i], Cs[:, i]
        dA = dtc * A2                                  # (B,c,G,hg)
        cs = torch.cumsum(dA, dim=1)
        cs_last = cs[:, -1]                            # (B,G,hg)
        # intra-chunk: w[b,g,h,c,d] = scores * L * dt  (no P dim yet)
        scores = torch.einsum("bcgs,bdgs->bgcd", Cc, Bc)      # (B,G,c,c)
        L = torch.exp(_segsum(torch.movedim(dA, 1, -1)))      # (B,G,hg,c,c)
        w = scores[:, :, None] * L \
            * torch.movedim(dtc, 1, -1)[..., None, :]         # (B,G,hg,c,c)
        y_diag = torch.einsum("bghcd,bdghp->bcghp", w, xc)
        # chunk state contribution
        decay = torch.exp(cs_last[:, None] - cs)              # (B,c,G,hg)
        st_chunk = torch.einsum("bcgs,bcgh,bcghp->bghps",
                                Bc, decay * dtc, xc)          # (B,G,hg,P,N)
        # inter-chunk: read incoming state, then update it
        y_off = torch.einsum("bcgs,bghps,bcgh->bcghp",
                             Cc, state, torch.exp(cs))
        state = state * torch.exp(cs_last)[..., None, None] + st_chunk
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y.to(x.dtype), state


def mamba_forward(p, x, ssm, compute_dtype=torch.bfloat16, backend="xla"):
    """Full-sequence forward.  x: (B,S,d) -> (y, final_state, conv_state)."""
    B, S, d = x.shape
    d_inner = ssm.expand * d
    H = d_inner // ssm.head_dim
    G, N = ssm.n_groups, ssm.d_state
    z = layers.linear(p["z_proj"], x, compute_dtype, site="mamba.z",
                      backend=backend)
    xbc_raw = layers.linear(p["xbc_proj"], x, compute_dtype,
                            site="mamba.xbc", backend=backend)
    K = ssm.d_conv
    if S >= K - 1:
        conv_state = xbc_raw[:, S - (K - 1):]
    else:
        conv_state = F.pad(xbc_raw, (0, 0, K - 1 - S, 0))
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :d_inner]
    Bmat = xbc[..., d_inner:d_inner + G * N].reshape(B, S, G, N)
    Cmat = xbc[..., d_inner + G * N:].reshape(B, S, G, N)
    dt = _softplus(
        layers.linear(p["dt_proj"], x, compute_dtype, site="mamba.dt",
                      backend=backend).float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    chunk = min(ssm.chunk_size, S)
    y, final_state = ssd_chunked(xs.reshape(B, S, H, ssm.head_dim),
                                 dt, A, Bmat, Cmat, chunk)
    y = y + (p["D"].reshape(H, 1) * xs.reshape(B, S, H, ssm.head_dim)
             .float()).to(y.dtype)
    y = y.reshape(B, S, d_inner)
    y = layers.rmsnorm(p["norm"], y * F.silu(z))
    return (layers.linear(p["out_proj"], y, compute_dtype, site="mamba.out",
                          backend=backend), final_state, conv_state)


def mamba_decode_step(p, x, state, conv_state, ssm,
                      compute_dtype=torch.bfloat16, backend="xla", out=None):
    """One-token step.  x: (B,d); state: (B,G,hg,P,N); conv_state: (B,K-1,ch).

    Returns (y, new_state, new_conv_state); the inputs are not written.
    The window is the concatenation of the cached (bf16 when served) conv
    state and the new fp32-or-bf16 row in their promoted type, as
    ``jnp.concatenate`` promotes.  ``out``: optional (state, conv)
    tensors that receive the new state and window (the window cast to
    ``out[1]``'s dtype) and are returned in their place, so a caller
    keeping them in a stacked buffer writes no copy."""
    B, d = x.shape
    d_inner = ssm.expand * d
    H = d_inner // ssm.head_dim
    G, N, P = ssm.n_groups, ssm.d_state, ssm.head_dim
    hg = H // G
    z = layers.linear(p["z_proj"], x, compute_dtype, site="mamba.z",
                      backend=backend)
    xbc = layers.linear(p["xbc_proj"], x, compute_dtype, site="mamba.xbc",
                        backend=backend)                           # (B,ch)
    wdt = torch.promote_types(conv_state.dtype, xbc.dtype)
    window = torch.cat([conv_state.to(wdt), xbc[:, None, :].to(wdt)],
                       dim=1)                                      # (B,K,ch)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(wdt))
    xbc = F.silu(conv_out + p["conv_b"].to(conv_out.dtype))
    new_conv_state = (window[:, 1:] if out is None
                      else out[1].copy_(window[:, 1:]))
    f32 = torch.float32
    xs = xbc[..., :d_inner].reshape(B, G, hg, P).to(f32)
    Bmat = xbc[..., d_inner:d_inner + G * N].reshape(B, G, N).to(f32)
    Cmat = xbc[..., d_inner + G * N:].reshape(B, G, N).to(f32)
    dt = _softplus(
        layers.linear(p["dt_proj"], x, compute_dtype, site="mamba.dt",
                      backend=backend).float()
        + p["dt_bias"]).reshape(B, G, hg)
    A = -torch.exp(p["a_log"]).reshape(G, hg)
    dec = torch.exp(dt * A)                                   # (B,G,hg)
    upd = torch.einsum("bgn,bgh,bghp->bghpn", Bmat, dt, xs)
    new_state = torch.add(state * dec[..., None, None], upd,
                          out=None if out is None else out[0])
    y = torch.einsum("bgn,bghpn->bghp", Cmat, new_state)
    y = y + p["D"].reshape(G, hg, 1) * xs
    y = y.reshape(B, d_inner).to(compute_dtype)
    y = layers.rmsnorm(p["norm"], y * F.silu(z))
    return (layers.linear(p["out_proj"], y, compute_dtype, site="mamba.out",
                          backend=backend), new_state, new_conv_state)
