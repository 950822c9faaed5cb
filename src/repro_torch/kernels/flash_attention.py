"""Fused flash-attention forward: the Hopper kernel's wrapper and its plain
version.

Port of the reference's ``kernels/flash_attention.py``.  The Pallas TPU
kernel ``_kernel`` becomes two hand-written CUDA kernels in
``csrc/flash_attention.cu`` (the design notes are at the top of that
file), picked by the operand type (:func:`attention_kernel`):
``flash_attention_tc`` on the tensor cores for bf16, the FFMA
``flash_attention_fwd`` for fp32.  Scores and probabilities never reach
device memory: q, k and v are read and o is written (and, where
:func:`kv_splits` splits a chunk's columns across blocks at short S, one
fp32 partial per split and row).

Layout: q (BH, S, D), k/v (BH, T, D); callers fold batch x heads (GQA
callers repeat or fold kv heads).  KV is consumed in ``kv_chunk``-column
chunks with an online softmax; causal and sliding-window masks come from
global row/column ids, and a ragged last chunk is masked past T.

:func:`flash_attention` launches the kernel for CUDA tensors (or raises)
and takes :func:`flash_attention_plain` only for CPU tensors.  The plain
version mirrors the reference kernel chunk for chunk: fp32 scores, the
finite ``NEG_INF`` mask, ``p`` cast to v's dtype before the PV product,
``o / max(l, 1e-30)`` cast once to q's dtype.  ``LAUNCHES`` counts kernel
launches, and nothing else: ``flash_attention`` every K3 launch,
``flash_attention_tc`` those of the tensor-core kernel (one launch is one
call of the C entry: one kernel, or the split path's three).
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

# kernel launches in this process (plain-version calls launch nothing)
LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0}

MAX_HEAD_DIM = 128
# the tensor-core kernel's tiles (csrc/flash_attention.cu TQ, TKV)
TC_QUERY_ROWS = 64
TC_KV_COLS = 64
# a split covers at least this many sub-tiles, so its launch pays off
MIN_SPLIT_SUBTILES = 4


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def attention_kernel(dtype) -> str:
    """The kernel :func:`flash_attention` launches for q, k, v of
    ``dtype``: bf16 -> ``flash_attention_tc`` (tensor cores, bf16 products
    into fp32 sums), fp32 -> ``flash_attention_fwd`` (FFMA: tensor cores
    give no IEEE fp32).  The choice follows the operand type only, never a
    failed build or launch."""
    if dtype == torch.bfloat16:
        return "flash_attention_tc"
    if dtype == torch.float32:
        return "flash_attention_fwd"
    raise ValueError(f"flash_attention: dtype {dtype} must be float32 or "
                     f"bfloat16")


def kv_splits(BH: int, S: int, T: int, kv_chunk: int, n_sm: int) -> int:
    """How many column ranges the tensor-core kernel splits each KV chunk
    into: 1 while the query tiles alone (ceil(S / 64) x BH blocks) fill
    the ``n_sm`` SMs; otherwise enough splits to fill them, each at least
    ``MIN_SPLIT_SUBTILES`` sub-tiles of 64 columns of the (clamped)
    chunk."""
    if min(BH, S, T, kv_chunk, n_sm) < 1:
        raise ValueError(f"kv_splits needs positive sizes, got BH {BH}, "
                         f"S {S}, T {T}, kv_chunk {kv_chunk}, n_sm {n_sm}")
    blocks = -(-S // TC_QUERY_ROWS) * BH
    subtiles = -(-min(kv_chunk, T) // TC_KV_COLS)
    if blocks >= n_sm or subtiles < 2 * MIN_SPLIT_SUBTILES:
        return 1
    return min(-(-n_sm // blocks), subtiles // MIN_SPLIT_SUBTILES)


def _check(q, k, v, bq: int, kv_chunk: int) -> int:
    """``kv_chunk`` clamped to T as the reference clamps it; raises on
    what the reference asserts against (``S % min(bq, S)``) and on
    mismatched or empty shapes."""
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("flash_attention takes q (BH, S, D), k/v (BH, T, D)")
    BH, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != D:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    T = k.shape[1]
    if min(BH, S, T, D) < 1:
        raise ValueError(f"flash_attention needs non-empty operands, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}")
    bq = min(bq, S)
    kv_chunk = min(kv_chunk, T)
    if bq < 1 or kv_chunk < 1:
        raise ValueError(f"bq and kv_chunk must be >= 1, got {bq}, "
                         f"{kv_chunk}")
    if S % bq:
        raise ValueError(f"flash_attention: S = {S} is not a multiple of "
                         f"the query block bq = {bq}")
    return kv_chunk


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          bq: int = 128, kv_chunk: int = 128):
    """Plain PyTorch version of :func:`flash_attention`, the reference
    kernel's arithmetic chunk for chunk (all query rows at once: the
    reference's row blocks are independent)."""
    kv_chunk = _check(q, k, v, bq, kv_chunk)
    BH, S, D = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    rows = torch.arange(S, device=dev)[:, None]
    qf = q.float()
    o = torch.zeros((BH, S, D), dtype=torch.float32, device=dev)
    m = torch.full((BH, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((BH, S), dtype=torch.float32, device=dev)
    for c0 in range(0, T, kv_chunk):
        ks = k[:, c0:c0 + kv_chunk]
        vs = v[:, c0:c0 + kv_chunk]
        s = torch.einsum("bsd,btd->bst", qf, ks.float()) * scale
        cols = c0 + torch.arange(ks.shape[1], device=dev)[None, :]
        ok = torch.ones((S, ks.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            ok = ok & (cols <= rows)
        if window:
            ok = ok & (cols > rows - window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bst,btd->bsd", p.to(vs.dtype).float(), vs.float())
        o = o * corr[..., None] + pv
        m = m_new
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


_BOUND = None


def _lib():
    """The built kernel library with its C signature declared."""
    global _BOUND
    if _BOUND is None:
        from repro_torch.kernels import build
        lib = build.library("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [i, p, p, p, p, i, i, i, i, i, i,
                                            i, ctypes.c_float, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_tc.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                           ctypes.c_float, i, p, p, p, p]
        lib.flash_attention_tc.restype = i
        lib.flash_attention_tc_smem.argtypes = [i]
        lib.flash_attention_tc_smem.restype = ctypes.c_longlong
        _BOUND = lib
    return _BOUND


def _launch(q, k, v, causal: bool, window: int, kv_chunk: int,
            n_split: int = 1):
    """Launch the kernel :func:`attention_kernel` names for q's type on
    checked CUDA operands, and count it.  ``n_split`` (tensor-core kernel
    only) splits each chunk's columns across that many blocks, with fp32
    scratch for the per-split partials."""
    BH, S, D = q.shape
    T = k.shape[1]
    entry = attention_kernel(q.dtype)
    if n_split < 1 or (n_split > 1 and entry != "flash_attention_tc"):
        raise ValueError(f"flash_attention: n_split {n_split} needs >= 1 "
                         f"(> 1 only on the tensor-core kernel)")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / math.sqrt(D)
    if entry == "flash_attention_tc":
        parts = [None] * 3
        if n_split > 1:
            rows = BH * -(-T // kv_chunk) * n_split * S
            f32 = dict(dtype=torch.float32, device=q.device)
            parts = [torch.empty(rows, **f32), torch.empty(rows, **f32),
                     torch.empty(rows * D, **f32)]
        rc = _lib().flash_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S,
            T, D, kv_chunk, int(bool(causal)), int(window), scale, n_split,
            *(None if t is None else t.data_ptr() for t in parts), stream)
    else:
        rc = _lib().flash_attention_fwd(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH,
            S, T, D, kv_chunk, int(bool(causal)), int(window), scale, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    LAUNCHES["flash_attention"] += 1
    if entry == "flash_attention_tc":
        LAUNCHES["flash_attention_tc"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int = 128, kv_chunk: int = 128):
    """q: (BH, S, D); k/v: (BH, T, D).  Returns (BH, S, D) in q's dtype.

    T need not divide ``kv_chunk``: the last chunk is masked past the true
    length, so the planner's chunk pick runs as-is.  ``bq`` is the
    reference's query block: it changes no number, but ``S`` must be a
    multiple of ``min(bq, S)`` as the reference asserts.

    CUDA tensors launch the kernel :func:`attention_kernel` names for
    their type (q, k, v of one dtype, fp32 or bf16, contiguous, D <= 128;
    bf16 at the :func:`kv_splits` split of this card's SMs) or raise; CPU
    tensors run :func:`flash_attention_plain`."""
    kv_chunk = _check(q, k, v, bq, kv_chunk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     bq=bq, kv_chunk=kv_chunk)
    name = "flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    for arg, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: {arg} dtype {t.dtype} differs from "
                             f"q's {q.dtype}")
    entry = attention_kernel(q.dtype)
    BH, S, D = q.shape
    T = k.shape[1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} > {MAX_HEAD_DIM}")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k and v must be contiguous")
    n_split = 1
    if entry == "flash_attention_tc":
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        n_split = kv_splits(BH, S, T, kv_chunk, n_sm)
    return _launch(q, k, v, causal, window, kv_chunk, n_split)
