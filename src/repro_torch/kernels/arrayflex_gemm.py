"""ArrayFlex GEMM: the Hopper kernels' wrappers and their plain versions.

Port of the reference's ``kernels/arrayflex_gemm.py``.  The Pallas TPU
kernels ``_kernel`` and ``_expert_kernel`` become the hand-written CUDA
kernels ``af_gemm`` and ``af_expert_gemm`` in ``csrc/arrayflex_gemm.cu``
(the design notes are at the top of that file).  What stays the same is the
schedule's meaning: K is consumed in ``ceil(K / (bk * k_collapse))`` serial
main-loop steps of ``k_collapse`` sub-dots each into an fp32 accumulator,
the rmsnorm scale rides each step's prologue (:func:`prologue_phase`), and
the boundary math runs once at the carry-propagate store
(:func:`store_phase`): bias -> activation -> gate multiply -> residual ->
one cast.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain PyTorch version (``*_plain``) only for CPU tensors.  The plain
version computes ``x.float() @ w.float()`` with the same prologue and
store, cast once: the CPU tests hold it against the reference, and the
on-card checks hold the kernel against it.  ``LAUNCHES`` counts kernel
launches, and nothing else.

The int8-weight and W8A8 forms of the reference kernel are not ported yet.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Epilogue activations applicable at the carry-propagate boundary.
ACTIVATIONS = ("none", "silu", "gelu")

# wrapper name -> kernel launches in this process (plain-version calls and
# empty operands launch nothing and do not count)
LAUNCHES = {"arrayflex_gemm": 0, "arrayflex_expert_gemm": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"none": 0, "silu": 1, "gelu": 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _act(y, activation: str):
    if activation == "none":
        return y
    if activation == "silu":
        return F.silu(y)
    if activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; torch to erf
        return F.gelu(y, approximate="tanh")
    raise ValueError(f"unknown epilogue activation {activation!r}; "
                     f"supported: {ACTIVATIONS}")


def apply_epilogue(y, y2=None, bias=None, bias2=None, activation="none"):
    """The epilogue's reference semantics, shared by every backend:

        out = act(y [+ bias]) [* (y2 [+ bias2])]

    Operates in the dtype of ``y`` (fp32 at the kernel store; the operands'
    dtype on the unfused xla path)."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    out = _act(y, activation)
    if y2 is not None:
        if bias2 is not None:
            y2 = y2 + bias2.to(y2.dtype)
        out = out * y2
    return out


def prologue_phase(x, norm_scale):
    """The step prologue's boundary math, the single definition of the
    fused rmsnorm scale: multiply x by the per-input-channel ``g`` in fp32
    and cast back to the operand dtype (the CUDA kernel does exactly this
    to each staged x element), so fused and unfused paths agree."""
    if norm_scale is None:
        return x
    return (x.float() * norm_scale.float()).to(x.dtype)


def store_phase(y, y2=None, bias=None, bias2=None, activation="none",
                residual=None):
    """The carry-propagate boundary math in execution order: the fused
    epilogue on the fp32 accumulator(s), then the residual join.  The
    single definition of what the kernel store applies."""
    out = apply_epilogue(
        y, y2,
        None if bias is None else bias.float(),
        None if bias2 is None else bias2.float(),
        activation)
    if residual is not None:
        out = residual.float() + out
    return out


# ---------------------------------------------------------------------------
# kernel library binding

_BOUND = None


def _lib():
    """The built kernel library, with every C signature declared (pointers
    and the stream as ``c_void_p``, so ctypes never truncates them)."""
    global _BOUND
    if _BOUND is None:
        from repro_torch.kernels import build
        lib = build.library("arrayflex_gemm")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.af_gemm.argtypes = [i, i, p, p, p, p, p, p, p, p, i, i, i,
                                ll, ll, ll, ll, i, i, p]
        lib.af_gemm.restype = i
        lib.af_expert_gemm.argtypes = [i, i, i, p, p, p, i, i, i, i, i, p]
        lib.af_expert_gemm.restype = i
        _BOUND = lib
    return _BOUND


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _check_cuda(name: str, device, **tensors) -> None:
    for arg, t in tensors.items():
        if t is not None and t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on {device}")


def _check_rows(name: str, **tensors) -> None:
    for arg, t in tensors.items():
        if t is not None and t.numel() and t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg} needs unit stride along its "
                             f"last axis, got strides {t.stride()}")


def _fp32_vec(t):
    """A (N,)/(K,) boundary vector as the kernel reads it: contiguous fp32
    (exact — store_phase/prologue_phase cast it to fp32 anyway)."""
    return None if t is None else t.float().contiguous()


# ---------------------------------------------------------------------------
# single-GEMM kernel (optionally dual-contraction) with fused epilogue

def arrayflex_gemm_plain(x, w, *, w2=None, bias=None, bias2=None,
                         residual=None, norm_scale=None,
                         activation: str = "none", k_collapse: int = 1,
                         out_dtype=None):
    """Plain PyTorch version of :func:`arrayflex_gemm`: the same prologue,
    an fp32 product, the same store, one cast.  ``k_collapse`` changes
    only the summation schedule, so it does not enter here."""
    xs = prologue_phase(x, norm_scale).float()
    y = xs @ w.float()
    y2 = xs @ w2.float() if w2 is not None else None
    out = store_phase(y, y2, bias, bias2, activation, residual)
    return out.to(out_dtype or x.dtype)


def arrayflex_gemm(x, w, *, w2=None, bias=None, bias2=None, residual=None,
                   norm_scale=None, activation: str = "none",
                   k_collapse: int = 1, out_dtype=None):
    """X[M,K] @ W[K,N] with K-collapse depth ``k_collapse`` and the fused
    prologue/epilogue:

        out = [residual +] act((g*X)@W [+ bias]) [* ((g*X)@W2 [+ bias2])]

    ``norm_scale`` (``g``, (K,)) scales each staged x element in fp32 and
    rounds back to the operand dtype; ``bias``/``bias2`` are (N,);
    ``residual`` is (M, N) in x's dtype; ``w2`` (same shape as ``w``) turns
    on the dual contraction (with ``activation="silu"``: the one-kernel
    swiglu).  Every shape is covered: ragged M/N/K edges are masked in the
    kernel, and an empty M, N or K returns the epilogue of zeros.

    CUDA tensors launch ``af_gemm`` (fp32 or bf16 operands, fp32 or bf16
    out, unit stride along each operand's last axis) or raise; CPU tensors
    run :func:`arrayflex_gemm_plain`.
    """
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} @ "
                         f"w {tuple(w.shape)}")
    if k_collapse < 1:
        raise ValueError(f"k_collapse must be >= 1, got {k_collapse}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown epilogue activation {activation!r}; "
                         f"supported: {ACTIVATIONS}")
    dual = w2 is not None
    if dual and w2.shape != w.shape:
        raise ValueError(f"w2 {tuple(w2.shape)} must match w "
                         f"{tuple(w.shape)}")
    if bias2 is not None and not dual:
        raise ValueError("bias2 requires w2 (the dual contraction)")
    for name, b in (("bias", bias), ("bias2", bias2)):
        if b is not None and tuple(b.shape) != (N,):
            raise ValueError(f"{name} must be ({N},), got {tuple(b.shape)}")
    if residual is not None and tuple(residual.shape) != (M, N):
        raise ValueError(f"residual must be ({M}, {N}), got "
                         f"{tuple(residual.shape)}")
    if norm_scale is not None and tuple(norm_scale.shape) != (K,):
        raise ValueError(f"norm_scale must be ({K},), got "
                         f"{tuple(norm_scale.shape)}")
    out_dtype = out_dtype or x.dtype
    if M == 0 or N == 0 or K == 0:      # empty operand: epilogue of zeros
        zero = torch.zeros((M, N), dtype=torch.float32, device=x.device)
        return store_phase(zero, zero if dual else None, bias, bias2,
                           activation, residual).to(out_dtype)
    if x.device.type == "cpu":
        return arrayflex_gemm_plain(
            x, w, w2=w2, bias=bias, bias2=bias2, residual=residual,
            norm_scale=norm_scale, activation=activation,
            k_collapse=k_collapse, out_dtype=out_dtype)
    name = "arrayflex_gemm"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _check_cuda(name, x.device, w=w, w2=w2, bias=bias, bias2=bias2,
                residual=residual, norm_scale=norm_scale)
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: operands and output must be float32 or "
                         f"bfloat16, got x {x.dtype}, out {out_dtype}")
    for arg, t in (("w", w), ("w2", w2), ("residual", residual)):
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"{name}: {arg} dtype {t.dtype} must match x "
                             f"dtype {x.dtype}")
    _check_rows(name, x=x, w=w, w2=w2, residual=residual)
    if dual and w2.stride() != w.stride():
        raise ValueError(f"{name}: w2 strides {w2.stride()} must match w "
                         f"strides {w.stride()}")
    bias, bias2, g = _fp32_vec(bias), _fp32_vec(bias2), _fp32_vec(norm_scale)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    rc = _lib().af_gemm(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], _ptr(x), _ptr(w),
        _ptr(w2), _ptr(bias), _ptr(bias2), _ptr(residual), _ptr(g),
        _ptr(out), M, N, K, x.stride(0), w.stride(0),
        residual.stride(0) if residual is not None else 0, out.stride(0),
        k_collapse, _ACT_CODE[activation], _stream(x.device))
    _check_rc(rc, name)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# expert-batched kernel: the batch/expert axis is the leading grid dimension

def arrayflex_expert_gemm_plain(x, w, *, k_collapse: int = 1,
                                out_dtype=None):
    """Plain PyTorch version of :func:`arrayflex_expert_gemm`."""
    return torch.matmul(x.float(), w.float()).to(out_dtype or x.dtype)


def arrayflex_expert_gemm(x, w, *, k_collapse: int = 1, out_dtype=None):
    """Batched per-expert GEMM in ONE launch: X[E,T,K] @ W[E,K,N] ->
    [E,T,N], the same collapse chain as :func:`arrayflex_gemm` and no
    epilogue.  Empty E/T/N/K returns exact zeros.

    CUDA tensors launch ``af_expert_gemm`` (contiguous operands; x/w dtypes
    fp32/fp32, bf16/bf16 or fp32/bf16; fp32 or bf16 out) or raise; CPU
    tensors run :func:`arrayflex_expert_gemm_plain`."""
    E, T, K = x.shape
    E2, K2, N = w.shape
    if E != E2 or K != K2:
        raise ValueError(f"expert gemm mismatch: x {tuple(x.shape)} @ "
                         f"w {tuple(w.shape)}")
    if k_collapse < 1:
        raise ValueError(f"k_collapse must be >= 1, got {k_collapse}")
    out_dtype = out_dtype or x.dtype
    if E == 0 or T == 0 or N == 0 or K == 0:
        return torch.zeros((E, T, N), dtype=out_dtype, device=x.device)
    if x.device.type == "cpu":
        return arrayflex_expert_gemm_plain(x, w, k_collapse=k_collapse,
                                           out_dtype=out_dtype)
    name = "arrayflex_expert_gemm"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _check_cuda(name, x.device, w=w)
    if ((x.dtype, w.dtype) not in ((torch.float32, torch.float32),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.float32, torch.bfloat16))
            or out_dtype not in _DTYPE_CODE):
        raise ValueError(f"{name}: unsupported dtypes x {x.dtype}, "
                         f"w {w.dtype}, out {out_dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    out = torch.empty((E, T, N), dtype=out_dtype, device=x.device)
    rc = _lib().af_expert_gemm(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _DTYPE_CODE[out_dtype],
        _ptr(x), _ptr(w), _ptr(out), E, T, K, N, k_collapse,
        _stream(x.device))
    _check_rc(rc, name)
    LAUNCHES[name] += 1
    return out

