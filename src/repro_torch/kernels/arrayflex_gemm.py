"""ArrayFlex GEMM: the Hopper kernels' wrappers and their plain versions.

Port of the reference's ``kernels/arrayflex_gemm.py``.  The Pallas TPU
kernels ``_kernel`` and ``_expert_kernel`` become hand-written CUDA kernels
in ``csrc/arrayflex_gemm.cu`` (the design notes are at the top of that
file), one C entry per operand form:

  ``af_gemm``           ``_kernel`` on fp32 operands (FFMA; at decode,
                        M <= 16, a narrow tile: K in 16 fixed warp slices,
                        16-byte ``cp.async`` staging, one or two
                        contractions, any N, the width from M and N; above,
                        the wide tile: 128 x 128 blocks of 8 x 8 outputs a
                        thread, 64 x 64 where that grid is small, two
                        blocks an SM, a ring of 2-4 steps);
  ``af_gemm_tc``        ``_kernel`` on bf16 operands (tensor cores,
                        ``mma.sync`` bf16 x bf16 -> fp32);
  ``af_gemm_q``         ``_kernel`` on int8 weight codes: W8 on fp32 x
                        (FFMA, dequant at the store; the narrow and wide
                        tiles of ``af_gemm``, the codes staged as int8 and
                        widened exactly to fp32 in the chain) or, with
                        ``act_quant``, W8A8 (per-tile int8 x, int8 x int8
                        -> int32 products: at M <= 16 the W8A8 narrow tile,
                        ``__dp4a``, x quantized once a block in the
                        launch's prologue, the codes streamed through warp
                        rings, the width from M and N; above, x quantized
                        once a call into scratch, then the int8 tensor-core
                        tile, ``mma.sync`` s8 x s8 -> s32);
  ``af_gemm_q_tc``      ``_kernel``'s W8 form on bf16 x (the tensor-core
                        kernel of ``af_gemm_tc``, the codes widened to bf16
                        in registers, dequant at the store);
  ``af_expert_gemm``    ``_expert_kernel`` on fp32 x (fp32 or bf16 w; FFMA,
                        a narrow decode tile at T <= 16, the wide tile
                        above);
  ``af_expert_gemm_tc`` ``_expert_kernel`` on bf16 operands (the tensor-core
                        kernel of ``af_gemm_tc``, the expert axis on the
                        grid's z);
  ``af_expert_gemm_q``  ``_expert_kernel`` on int8 weight codes: the
                        int8-only form (MoE expert banks under W8, fp32 or
                        bf16 x, dequant per (expert, column) at the store;
                        at T <= 16 the narrow tile of ``af_gemm``, x staged
                        in its own type and the codes widened exactly to
                        fp32, the width from T, N and E; above, fp32 x on
                        the wide FFMA tile) or, with
                        ``act_quant``, W8A8 (at T <= 16 the W8A8 narrow
                        tile of ``af_gemm_q``, the width from T, N and E;
                        above, its quantize pass and int8 tensor-core
                        tile, the expert on the grid's z);
  ``af_expert_gemm_q_tc`` ``_expert_kernel``'s int8-only form on bf16 x
                        above 16 rows (the MoE banks of a prefill under
                        W8: the tensor-core kernel of ``af_gemm_q_tc``, the
                        expert on the grid's z).

What stays the same is the schedule's meaning: K is consumed in
``ceil(K / (bk * k_collapse))`` serial main-loop steps of ``k_collapse``
sub-dots each into an fp32 accumulator, the rmsnorm scale rides each step's
prologue (:func:`prologue_phase`), and the boundary math runs once at the
carry-propagate store (:func:`store_phase`): dequant -> bias -> activation
-> gate multiply -> residual -> one cast.  Under W8A8 the step prologue
also quantizes the x tile (:func:`quantize_tile`) and each step's int32
partial folds into the fp32 accumulator times that tile's scale.  Above 16
rows the kernel quantizes x once a call, into scratch the wrapper
allocates (:func:`w8a8_scratch`, laid out as :func:`w8a8_quantize_plain`
says), before its products.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain PyTorch version (``*_plain``) only for CPU tensors.  The plain
version computes the same function with the same prologue and store, cast
once: the CPU tests hold it against the reference, and the on-card checks
hold the kernel against it.  ``LAUNCHES`` counts kernel launches per form,
and nothing else; the operand types pick the kernels by the written
rules of :func:`gemm_kernel`, :func:`gemm_q_kernel`,
:func:`expert_gemm_kernel` and :func:`expert_gemm_q_kernel`, and
``arrayflex_gemm_tc`` / ``arrayflex_gemm_int8_tc`` /
``arrayflex_expert_gemm_tc`` / ``arrayflex_expert_gemm_int8_tc`` count the
launches that ran the tensor-core kernel (subsets of ``arrayflex_gemm`` /
``arrayflex_gemm_int8`` / ``arrayflex_expert_gemm`` /
``arrayflex_expert_gemm_int8``, which count every launch of their form).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import check_no_grad
from repro_torch.roofline import trace as _trace

# Epilogue activations applicable at the carry-propagate boundary.
ACTIVATIONS = ("none", "silu", "gelu")

# kernel form -> kernel launches in this process (plain-version calls and
# empty operands launch nothing and do not count)
LAUNCHES = {"arrayflex_gemm": 0, "arrayflex_gemm_tc": 0,
            "arrayflex_gemm_int8": 0, "arrayflex_gemm_int8_tc": 0,
            "arrayflex_gemm_w8a8": 0, "arrayflex_expert_gemm": 0,
            "arrayflex_expert_gemm_tc": 0,
            "arrayflex_expert_gemm_int8": 0,
            "arrayflex_expert_gemm_int8_tc": 0,
            "arrayflex_expert_gemm_w8a8": 0}

# The reference kernel's tiles as ``ops.arrayflex_matmul`` launches it
# (bm = bk = 128).  Under W8A8 they decide the numbers, not only the
# schedule: each (bm, kk) x tile gets its own quantization scale.
QUANT_BM = 128
QUANT_BK = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the rows (M, or T) at or below which every form takes a narrow tile
NARROW_ROWS = 16
_ACT_CODE = {"none": 0, "silu": 1, "gelu": 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gemm_kernel(dtype) -> str:
    """The kernel that :func:`arrayflex_gemm`'s float form launches for
    operands of ``dtype``: bf16 -> ``af_gemm_tc`` (tensor cores, bf16
    products into fp32 sums, the reference matrix unit's arithmetic), fp32
    -> ``af_gemm`` (FFMA: tensor cores give no IEEE fp32; its C entry
    takes the narrow decode tile, K in 16 fixed slices, for every launch
    at M <= 16 -- one or two contractions, any N -- and the wide tile,
    8 x 8 fmaf chains a thread, for larger M).  The choice follows the
    operand type only, never a failed build or launch."""
    if dtype == torch.bfloat16:
        return "af_gemm_tc"
    if dtype == torch.float32:
        return "af_gemm"
    raise ValueError(f"arrayflex_gemm: operands must be float32 or "
                     f"bfloat16, got {dtype}")


def gemm_q_kernel(x_dtype, act_quant: bool) -> str:
    """The kernel that :func:`arrayflex_gemm`'s int8 forms (``w_scale``
    given) launch for x of ``x_dtype``: W8 on bf16 x -> ``af_gemm_q_tc``
    (tensor cores: the codes widen exactly to bf16, bf16 products into fp32
    sums, as the reference widens them to x's type for its matrix unit),
    W8 on fp32 x -> ``af_gemm_q`` (FFMA: tensor cores give no IEEE fp32;
    its C entry takes ``af_gemm``'s narrow decode tile at M <= 16 and its
    wide tile for larger M, the codes widened exactly to fp32 as they
    leave shared memory); W8A8 (``act_quant``) on either x type ->
    ``af_gemm_q`` (int8 x int8 -> int32; its C entry takes the W8A8 narrow
    tile, ``__dp4a``, at M <= 16, and for larger M quantizes x once into
    scratch and runs the int8 tensor-core tile, ``mma.sync`` s8 x s8 ->
    s32; both give the plain version's bits where the store is the
    dequant alone).  The choice follows the types only, never a failed
    build or launch."""
    if x_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"arrayflex_gemm: int8 forms take float32 or "
                         f"bfloat16 x, got {x_dtype}")
    if act_quant or x_dtype == torch.float32:
        return "af_gemm_q"
    return "af_gemm_q_tc"


def expert_gemm_kernel(x_dtype, w_dtype) -> str:
    """The kernel that :func:`arrayflex_expert_gemm`'s float form launches
    for x of ``x_dtype`` and w of ``w_dtype``: bf16 x bf16 ->
    ``af_expert_gemm_tc`` (tensor cores, as :func:`gemm_kernel`), fp32 x
    with fp32 w, or with a bf16 K/V cache, -> ``af_expert_gemm`` (FFMA:
    an fp32 operand has no IEEE fp32 tensor-core product; its C entry
    takes the narrow decode tile, K in 16 fixed slices, at T <= 16, and
    the wide tile above).  The choice follows the operand types only,
    never a failed build or launch."""
    if x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16:
        return "af_expert_gemm_tc"
    if x_dtype == torch.float32 and w_dtype in (torch.float32,
                                                torch.bfloat16):
        return "af_expert_gemm"
    raise ValueError(f"arrayflex_expert_gemm: unsupported dtypes x "
                     f"{x_dtype}, w {w_dtype} (bf16 x bf16, or fp32 x with "
                     f"fp32 or bf16 w)")


def expert_gemm_q_kernel(x_dtype, act_quant: bool, T: int) -> str:
    """The kernel that :func:`arrayflex_expert_gemm`'s int8 forms
    (``w_scale`` given) launch for x of ``x_dtype`` at T rows an expert:
    the int8-only form (the MoE banks under W8) on bf16 x above
    NARROW_ROWS -> ``af_expert_gemm_q_tc`` (tensor cores: the codes widen
    exactly to bf16, bf16 products into fp32 sums, as :func:`gemm_q_kernel`
    names for K1's W8 form on bf16 x); at T <= NARROW_ROWS on either x
    type, and on fp32 x above -> ``af_expert_gemm_q`` (FFMA: its narrow
    tile, then its wide tile); W8A8 (``act_quant``) on either x type ->
    ``af_expert_gemm_q`` (the W8A8 narrow tile, then the quantize pass and
    the int8 tensor-core tile).  The choice follows the types and T only,
    never a failed build or launch."""
    if x_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"arrayflex_expert_gemm: int8 forms take float32 "
                         f"or bfloat16 x, got {x_dtype}")
    if not act_quant and x_dtype == torch.bfloat16 and T > NARROW_ROWS:
        return "af_expert_gemm_q_tc"
    return "af_expert_gemm_q"


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
    and cast back to the operand dtype (the CUDA kernels do exactly this
    to each staged x element), so fused and unfused paths agree."""
    if norm_scale is None:
        return x
    return (x.float() * norm_scale.float()).to(x.dtype)


# fp32(1 / 127): the reference's quantizer runs only inside its compiled
# kernel, where XLA turns ``max(amax, eps) / 127`` into a multiply by this
# constant — which rounds differently from the division at some amax, and
# so moves codes that sit at a rounding tie (common with bf16 x)
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_tile(x, eps: float = 1e-12):
    """Dynamic symmetric activation quantization, the single definition of
    the W8A8 step prologue's quantizer (the CUDA kernels inline it).

    Reduces over the last two axes: ``x`` is one (bm, kk) tile, or a batch
    of them.  Returns ``(codes, scale)``: int8 codes in [-127, 127] and one
    fp32 scale per tile, ``scale = max(amax, eps) * fp32(1/127)`` as the
    reference's compiled kernel computes it, and
    ``codes = clip(round(x / scale))`` with an IEEE division (by a tensor:
    PyTorch's CUDA division by a Python scalar multiplies by the
    reciprocal) and round half to even, so ``codes * scale`` is within
    ``scale / 2`` of x.  An all-zero tile quantizes to zeros, so zero
    padding contributes exactly 0."""
    x32 = x.float()
    amax = x32.abs().amax(dim=(-2, -1))
    scale = torch.clamp(amax, min=eps) * torch.full_like(amax, INV_127)
    codes = torch.clamp(torch.round(x32 / scale[..., None, None]), -127, 127)
    return codes.to(torch.int8), scale


def store_phase(y, y2=None, w_scale=None, w2_scale=None, bias=None,
                bias2=None, activation="none", residual=None):
    """The carry-propagate boundary math in execution order: dequant the
    fp32 accumulator(s) by the per-output-channel weight scale(s), the
    fused epilogue, then the residual join.  The single definition of what
    the kernel store applies."""
    if w_scale is not None:
        y = y * w_scale.float()
    if y2 is not None and w2_scale is not None:
        y2 = y2 * w2_scale.float()
    out = apply_epilogue(
        y, y2,
        None if bias is None else bias.float(),
        None if bias2 is None else bias2.float(),
        activation)
    if residual is not None:
        out = residual.float() + out
    return out


def quant_tiles(M: int, K: int, k_collapse: int):
    """``(bm, kk)``: the reference's W8A8 activation-quantization tile for
    an (M, K) x.  ``bm`` is M when M <= 128, else 128 rows of the
    zero-padded ``round_up(M, 128)`` (``ops.arrayflex_matmul``'s clamp);
    ``kk`` is one main-loop step of the exact K tiling,
    ``n_steps = ceil(K / (128 k))``, ``kk = ceil(K / (n_steps k)) * k``."""
    bm = M if M <= QUANT_BM else QUANT_BM
    n_steps = -(-K // (QUANT_BK * k_collapse))
    kk = -(-K // (n_steps * k_collapse)) * k_collapse
    return bm, kk


def _w8a8_accumulate(xs, ws, k_collapse: int):
    """The W8A8 chain's fp32 accumulator for each weight in ``ws``.

    ``xs`` (..., M, K) is x after the prologue; each weight (..., K, N)
    holds int8 codes.  x is zero-padded to whole (bm, kk) tiles and each
    tile quantized with :func:`quantize_tile`; per K-step the exact
    integer product (in float64: every partial is an integer far below
    2^53) folds into the accumulator as ``acc + float(iacc) * scale``, in
    increasing step order, as the kernel does."""
    *lead, M, K = xs.shape
    bm, kk = quant_tiles(M, K, k_collapse)
    R, S = -(-M // bm), -(-K // kk)
    xp = torch.zeros((*lead, R * bm, S * kk), dtype=torch.float32,
                     device=xs.device)
    xp[..., :M, :K] = xs
    tiles = xp.reshape(*lead, R, bm, S, kk).transpose(-3, -2)
    codes, scale = quantize_tile(tiles)           # (.., R, S, bm, kk), (.., R, S)
    codes = codes.double()
    accs = []
    for w in ws:
        N = w.shape[-1]
        wp = torch.zeros((*w.shape[:-2], S * kk, N), dtype=torch.float64,
                         device=w.device)
        wp[..., :K, :] = w
        iacc = codes @ wp.reshape(*w.shape[:-2], 1, S, kk, N)
        acc = torch.zeros((*lead, R, bm, N), dtype=torch.float32,
                          device=xs.device)
        for s in range(S):
            acc = acc + iacc[..., s, :, :].float() * scale[..., s, None, None]
        accs.append(acc.reshape(*lead, R * bm, N)[..., :M, :])
    return accs


# ---------------------------------------------------------------------------
# W8A8 above 16 rows: the scratch the kernel quantizes x into

# code columns of one int8 tensor-core sub-tile (mma.m16n8k32's depth)
W8A8_SUB = 32
# the rows at or below which W8A8 takes the narrow tile (no scratch)
W8A8_NARROW_ROWS = 16


def w8a8_code_cols():
    """Position p of a 32-column code group -> the x column (from the
    group's start) whose code sits there: positions 4t..4t+3 of each
    16-column half hold columns 2t, 2t+1, 2t+8, 2t+9 (``qt_col`` in
    ``csrc/arrayflex_gemm.cu``), the K order in which the int8 tensor-core
    tile's byte permutes hand its B fragments the w rows."""
    return [16 * (p // 16) + 2 * ((p % 16) // 4) + (p & 1)
            + 8 * ((p >> 1) & 1) for p in range(W8A8_SUB)]


def w8a8_scratch(rows: int, K: int, k_collapse: int, batch: int = 1):
    """The scratch one W8A8 launch above 16 rows quantizes x into (the C
    entry's ``qt_layout``; ``af_w8a8_scratch_bytes`` gives its size): for
    x of ``batch`` x (rows, K) on the reference's tiles
    (:func:`quant_tiles`: ``bm`` rows by ``kk`` columns), ``steps`` K
    steps and ``rtiles`` row tiles; codes [batch][rows][steps * kk32]
    int8, each step padded with zero codes to ``kk32``, ``kk`` rounded up
    to whole 32-column sub-tiles (``ldc`` bytes a row), then from the next
    16-byte boundary (``scales_off``) one fp32 scale a (batch, row tile,
    step); ``nbytes`` in all."""
    bm, kk = quant_tiles(rows, K, k_collapse)
    steps, rtiles = -(-K // kk), -(-rows // bm)
    kk32 = -(-kk // W8A8_SUB) * W8A8_SUB
    ldc = steps * kk32
    codes = batch * rows * ldc
    scales_off = -(-codes // 16) * 16
    return dict(bm=bm, kk=kk, kk32=kk32, steps=steps, rtiles=rtiles,
                ldc=ldc, codes_bytes=codes, scales_off=scales_off,
                nbytes=scales_off + 4 * batch * rtiles * steps)


def w8a8_quantize_plain(xs, k_collapse: int):
    """Plain PyTorch version of the W8A8 quantize pass: ``xs`` (..., M,
    K), x after the prologue, quantized on the reference's tiles exactly
    as :func:`_w8a8_accumulate` does (:func:`quantize_tile` of the
    zero-padded (bm, kk) tiles), laid out as the kernel's scratch
    (:func:`w8a8_scratch`): codes (..., M, steps * kk32) int8 -- each step
    padded with zero codes to kk32, each 32-column group in
    :func:`w8a8_code_cols`'s order -- and scales (..., rtiles, steps)
    fp32."""
    *lead, M, K = xs.shape
    lay = w8a8_scratch(M, K, k_collapse)
    bm, kk, kk32 = lay["bm"], lay["kk"], lay["kk32"]
    R, S = lay["rtiles"], lay["steps"]
    xp = torch.zeros((*lead, R * bm, S * kk), dtype=torch.float32,
                     device=xs.device)
    xp[..., :M, :K] = xs
    tiles = xp.reshape(*lead, R, bm, S, kk).transpose(-3, -2)
    codes, scale = quantize_tile(tiles)           # (.., R, S, bm, kk), (.., R, S)
    padded = torch.zeros((*lead, R, S, bm, kk32), dtype=torch.int8,
                         device=xs.device)
    padded[..., :kk] = codes
    cols = w8a8_code_cols()
    order = [p - p % W8A8_SUB + cols[p % W8A8_SUB] for p in range(kk32)]
    padded = padded[..., torch.tensor(order, device=xs.device)]
    out = padded.transpose(-3, -2).reshape(*lead, R * bm, S * kk32)
    return out[..., :M, :].contiguous(), scale


def w8a8_quantize(x, *, norm_scale=None, k_collapse: int = 1):
    """The W8A8 quantize pass above 16 rows alone: ``x`` (M, K), or (E,
    T, K) contiguous, with the prologue's ``norm_scale``, into
    ``(codes, scales)`` as :func:`w8a8_quantize_plain` lays them out.  CUDA
    tensors launch the pass (``af_w8a8_quantize``; M, or T, above 16) into
    one scratch buffer and return views of it; CPU tensors run the plain
    version.  The main path never calls it (the W8A8 GEMM launches the same
    pass itself), so it counts no launch: it times and checks the pass on
    its own."""
    check_no_grad("w8a8_quantize", x, norm_scale)
    lead, (M, K) = x.shape[:-2], x.shape[-2:]
    if x.device.type == "cpu":
        return w8a8_quantize_plain(prologue_phase(x, norm_scale), k_collapse)
    if x.dim() not in (2, 3) or M <= W8A8_NARROW_ROWS or x.dtype not in \
            _DTYPE_CODE or (x.dim() == 3 and not x.is_contiguous()):
        raise ValueError(f"w8a8_quantize: x (M, K) or contiguous (E, T, K) "
                         f"of float32 or bfloat16 with more than "
                         f"{W8A8_NARROW_ROWS} rows, got {tuple(x.shape)} "
                         f"{x.dtype}")
    _check_rows("w8a8_quantize", x=x)
    E = x.shape[0] if x.dim() == 3 else 1
    lay = w8a8_scratch(M, K, k_collapse, E)
    scratch = torch.empty(lay["nbytes"], dtype=torch.uint8, device=x.device)
    g = _fp32_vec(norm_scale)
    rc = _lib().af_w8a8_quantize(
        _DTYPE_CODE[x.dtype], _ptr(x), _ptr(g), _ptr(scratch), lay["nbytes"],
        M, K, x.stride(-2), M * K if x.dim() == 3 else 0, E, lay["bm"],
        lay["kk"], _stream(x.device))
    _check_rc(rc, "w8a8_quantize")
    codes = scratch[:lay["codes_bytes"]].view(torch.int8).view(
        *lead, M, lay["ldc"])
    scales = scratch[lay["scales_off"]:].view(torch.float32).view(
        *lead, lay["rtiles"], lay["steps"])
    return codes, scales


def _w8a8_scratch_for(x, rows: int, K: int, k_collapse: int, batch: int):
    """(scratch, nbytes) of one W8A8 launch: a buffer above 16 rows,
    none at or below (the narrow tile quantizes in its own prologue)."""
    if rows <= W8A8_NARROW_ROWS:
        return None, 0
    nbytes = w8a8_scratch(rows, K, k_collapse, batch)["nbytes"]
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device), nbytes


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
        lib.af_gemm_tc.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i,
                                   ll, ll, ll, ll, i, i, p]
        lib.af_gemm_tc.restype = i
        lib.af_gemm_tc_smem.argtypes = [i, i, i, i, i]
        lib.af_gemm_tc_smem.restype = ll
        lib.af_narrow_smem.argtypes = [i, i, i, i, i, i, i, i]
        lib.af_narrow_smem.restype = ll
        lib.af_narrow_cols.argtypes = [i, i, i, i]
        lib.af_narrow_cols.restype = i
        lib.af_w8a8_cols.argtypes = [i, i, i]
        lib.af_w8a8_cols.restype = i
        lib.af_w8a8_smem.argtypes = [i, i, i, i, i, i]
        lib.af_w8a8_smem.restype = ll
        lib.af_w8a8_scratch_bytes.argtypes = [i, i, i, i, i]
        lib.af_w8a8_scratch_bytes.restype = ll
        lib.af_w8a8_tc_cols.argtypes = [i, i, i, i]
        lib.af_w8a8_tc_cols.restype = i
        lib.af_w8a8_tc_smem.argtypes = [i, i, i, i, i, i, i]
        lib.af_w8a8_tc_smem.restype = ll
        lib.af_w8a8_quantize.argtypes = [i, p, p, p, ll, i, i, ll, ll, i,
                                         i, i, p]
        lib.af_w8a8_quantize.restype = i
        lib.af_gemm_q.argtypes = [i, i, i, p, p, p, p, p, p, p, p, p, p,
                                  i, i, i, ll, ll, ll, ll, i, i, i, i, p,
                                  ll, p]
        lib.af_gemm_q.restype = i
        lib.af_gemm_q_tc.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i,
                                     i, ll, ll, ll, ll, i, i, p]
        lib.af_gemm_q_tc.restype = i
        lib.af_expert_gemm.argtypes = [i, i, i, p, p, p, i, i, i, i, i, p]
        lib.af_expert_gemm.restype = i
        lib.af_expert_gemm_tc.argtypes = [i, p, p, p, i, i, i, i, i, p]
        lib.af_expert_gemm_tc.restype = i
        lib.af_expert_gemm_q.argtypes = [i, i, i, p, p, p, p, i, i, i, i,
                                         i, i, i, p, ll, p]
        lib.af_expert_gemm_q.restype = i
        lib.af_expert_gemm_q_tc.argtypes = [i, p, p, p, p, i, i, i, i, i, p]
        lib.af_expert_gemm_q_tc.restype = i
        lib.af_ffma_smem.argtypes = [i, i, i, i, i, i]
        lib.af_ffma_smem.restype = ll
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


def _check_dtypes(name: str, want, **tensors) -> None:
    for arg, t in tensors.items():
        if t is not None and t.dtype != want:
            raise ValueError(f"{name}: {arg} dtype {t.dtype} must be {want}")


def _fp32_vec(t):
    """A boundary vector as the kernel reads it: contiguous fp32 (exact —
    store_phase/prologue_phase cast it to fp32 anyway)."""
    return None if t is None else t.float().contiguous()


# ---------------------------------------------------------------------------
# single-GEMM kernel (optionally dual-contraction) with fused epilogue

def arrayflex_gemm_plain(x, w, *, w2=None, bias=None, bias2=None,
                         w_scale=None, w2_scale=None, act_quant: bool = False,
                         residual=None, norm_scale=None,
                         activation: str = "none", k_collapse: int = 1,
                         out_dtype=None):
    """Plain PyTorch version of :func:`arrayflex_gemm`: the same prologue,
    an fp32 product (exact int8 codes under W8), the same store, one cast.
    ``k_collapse`` changes only the summation schedule of the float forms;
    under ``act_quant`` it sets the quantization tiles
    (:func:`quant_tiles`)."""
    xs = prologue_phase(x, norm_scale)
    ws = [w] if w2 is None else [w, w2]
    if act_quant:
        accs = _w8a8_accumulate(xs, ws, k_collapse)
    else:
        accs = [xs.float() @ v.float() for v in ws]
    out = store_phase(accs[0], accs[1] if w2 is not None else None,
                      w_scale, w2_scale, bias, bias2, activation, residual)
    return out.to(out_dtype or x.dtype)


def _gemm_cost(x, w, *, w2=None, bias=None, bias2=None, w_scale=None,
               w2_scale=None, residual=None, norm_scale=None, **_):
    """(logical FLOPs, operand bytes) of one :func:`arrayflex_gemm` call,
    for ``roofline.trace``: 2·M·N·K per contraction."""
    flops = 2 * x.shape[0] * x.shape[1] * w.shape[1] * (1 + (w2 is not None))
    return flops, _trace.nbytes(x, w, w2, bias, bias2, w_scale, w2_scale,
                                residual, norm_scale)


@_trace.kernel(_gemm_cost)
def arrayflex_gemm(x, w, *, w2=None, bias=None, bias2=None, w_scale=None,
                   w2_scale=None, act_quant: bool = False, residual=None,
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

    ``w_scale`` ((N,) fp32) makes ``w`` int8 codes whose effective weight is
    ``w * w_scale`` per output column; the dequant multiply runs at the
    store, before the bias (exact: the scale factors out of the K sum).  A
    dual contraction takes its own ``w2_scale``.  ``act_quant`` (requires
    ``w_scale``) is W8A8: each (bm, kk) x tile of the reference's tiling
    (:func:`quant_tiles`) is quantized with :func:`quantize_tile` after the
    prologue, the chain runs int8 x int8 -> int32, and each step's partial
    folds in times its tile's scale.

    CUDA tensors launch the kernel :func:`gemm_kernel` names for their
    type (``af_gemm_tc`` on bf16 operands, ``af_gemm`` on fp32) or, with
    ``w_scale``, the one :func:`gemm_q_kernel` names (``af_gemm_q_tc`` for
    W8 on bf16 x, ``af_gemm_q`` for W8 on fp32 x and for W8A8) — fp32 or
    bf16 out, unit stride along each operand's last axis — or raise; CPU
    tensors run :func:`arrayflex_gemm_plain`.
    """
    check_no_grad("arrayflex_gemm", x, w, w2, bias, bias2, residual,
                  norm_scale)
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
    quant = w_scale is not None
    if w2_scale is not None and not (quant and dual):
        raise ValueError("w2_scale requires both w_scale and w2")
    if quant and dual and w2_scale is None:
        raise ValueError("int8 dual contraction needs w2_scale for w2")
    if act_quant and not quant:
        raise ValueError("act_quant (W8A8) requires int8 weights (w_scale)")
    for name, b in (("bias", bias), ("bias2", bias2), ("w_scale", w_scale),
                    ("w2_scale", w2_scale)):
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
        return store_phase(zero, zero if dual else None, bias=bias,
                           bias2=bias2, activation=activation,
                           residual=residual).to(out_dtype)
    if x.device.type == "cpu":
        return arrayflex_gemm_plain(
            x, w, w2=w2, bias=bias, bias2=bias2, w_scale=w_scale,
            w2_scale=w2_scale, act_quant=act_quant, residual=residual,
            norm_scale=norm_scale, activation=activation,
            k_collapse=k_collapse, out_dtype=out_dtype)
    name = ("arrayflex_gemm_w8a8" if act_quant else
            "arrayflex_gemm_int8" if quant else "arrayflex_gemm")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _check_cuda(name, x.device, w=w, w2=w2, w_scale=w_scale,
                w2_scale=w2_scale, bias=bias, bias2=bias2, residual=residual,
                norm_scale=norm_scale)
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: x and the output must be float32 or "
                         f"bfloat16, got x {x.dtype}, out {out_dtype}")
    _check_dtypes(name, torch.int8 if quant else x.dtype, w=w, w2=w2)
    _check_dtypes(name, x.dtype, residual=residual)
    _check_rows(name, x=x, w=w, w2=w2, residual=residual)
    if dual and w2.stride() != w.stride():
        raise ValueError(f"{name}: w2 strides {w2.stride()} must match w "
                         f"strides {w.stride()}")
    bias, bias2, g = _fp32_vec(bias), _fp32_vec(bias2), _fp32_vec(norm_scale)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ldr = residual.stride(0) if residual is not None else 0
    if quant:
        entry = gemm_q_kernel(x.dtype, act_quant)
        s, s2 = _fp32_vec(w_scale), _fp32_vec(w2_scale)
        if entry == "af_gemm_q_tc":
            rc = _lib().af_gemm_q_tc(
                _DTYPE_CODE[out_dtype], _ptr(x), _ptr(w), _ptr(w2), _ptr(s),
                _ptr(s2), _ptr(bias), _ptr(bias2), _ptr(residual), _ptr(g),
                _ptr(out), M, N, K, x.stride(0), w.stride(0), ldr,
                out.stride(0), k_collapse, _ACT_CODE[activation],
                _stream(x.device))
        else:
            qbm, qkk = quant_tiles(M, K, k_collapse) if act_quant else (0, 0)
            scratch, nbytes = (_w8a8_scratch_for(x, M, K, k_collapse, 1)
                               if act_quant else (None, 0))
            rc = _lib().af_gemm_q(
                _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], int(act_quant),
                _ptr(x), _ptr(w), _ptr(w2), _ptr(s), _ptr(s2), _ptr(bias),
                _ptr(bias2), _ptr(residual), _ptr(g), _ptr(out), M, N, K,
                x.stride(0), w.stride(0), ldr, out.stride(0), k_collapse,
                _ACT_CODE[activation], qbm, qkk, _ptr(scratch), nbytes,
                _stream(x.device))
    else:
        entry = gemm_kernel(x.dtype)
        ptrs = (_ptr(x), _ptr(w), _ptr(w2), _ptr(bias), _ptr(bias2),
                _ptr(residual), _ptr(g), _ptr(out), M, N, K, x.stride(0),
                w.stride(0), ldr, out.stride(0), k_collapse,
                _ACT_CODE[activation], _stream(x.device))
        if entry == "af_gemm_tc":
            rc = _lib().af_gemm_tc(_DTYPE_CODE[out_dtype], *ptrs)
        else:
            rc = _lib().af_gemm(_DTYPE_CODE[x.dtype],
                                _DTYPE_CODE[out_dtype], *ptrs)
    _check_rc(rc, name)
    LAUNCHES[name] += 1
    if entry in ("af_gemm_tc", "af_gemm_q_tc"):
        LAUNCHES[name + "_tc"] += 1
    return out


# ---------------------------------------------------------------------------
# expert-batched kernel: the batch/expert axis is the leading grid dimension

def arrayflex_expert_gemm_plain(x, w, *, w_scale=None, act_quant: bool = False,
                                k_collapse: int = 1, out_dtype=None):
    """Plain PyTorch version of :func:`arrayflex_expert_gemm`."""
    if act_quant:
        (y,) = _w8a8_accumulate(x, [w], k_collapse)
    else:
        y = torch.matmul(x.float(), w.float())
    out = store_phase(y, w_scale=None if w_scale is None
                      else w_scale.unsqueeze(-2))
    return out.to(out_dtype or x.dtype)


def _expert_gemm_cost(x, w, *, w_scale=None, **_):
    """(logical FLOPs, operand bytes) of one :func:`arrayflex_expert_gemm`
    call, for ``roofline.trace``: 2·T·N·K per expert."""
    flops = 2 * x.shape[0] * x.shape[1] * x.shape[2] * w.shape[-1]
    return flops, _trace.nbytes(x, w, w_scale)


@_trace.kernel(_expert_gemm_cost)
def arrayflex_expert_gemm(x, w, *, w_scale=None, act_quant: bool = False,
                          k_collapse: int = 1, out_dtype=None):
    """Batched per-expert GEMM in ONE launch: X[E,T,K] @ W[E,K,N] ->
    [E,T,N], the same collapse chain as :func:`arrayflex_gemm` and no
    epilogue.  ``w_scale`` ((E, N) fp32) makes ``w`` int8 codes dequantized
    per (expert, output column) at the store; ``act_quant`` (requires
    ``w_scale``) adds the W8A8 per-tile x quantizer, each expert's rows
    tiled as :func:`quant_tiles` says.  Empty E/T/N/K returns exact zeros.

    CUDA tensors launch the kernel :func:`expert_gemm_kernel` names for
    their types (contiguous operands; ``af_expert_gemm_tc`` on bf16/bf16,
    ``af_expert_gemm`` on fp32/fp32 or fp32/bf16: the narrow FFMA tile at
    T <= 16, the wide one above) or, with ``w_scale``, the one
    :func:`expert_gemm_q_kernel` names (int8 w): the int8-only form of the
    MoE expert banks on ``af_expert_gemm_q`` at T <= 16 (the narrow FFMA
    tile, fp32 or bf16 x) and above on fp32 x (the wide FFMA tile), and on
    ``af_expert_gemm_q_tc`` above 16 rows on bf16 x (the tensor cores) —
    each output the same bits at every ``k_collapse`` and every E — or
    W8A8 under ``act_quant`` on ``af_expert_gemm_q``, at T <= 16 on the
    W8A8 narrow tile and above on the int8 tensor-core tile, both of whose
    outputs are the same bits at every E — fp32 or bf16 out — or raise;
    CPU tensors run :func:`arrayflex_expert_gemm_plain`."""
    check_no_grad("arrayflex_expert_gemm", x, w)
    E, T, K = x.shape
    E2, K2, N = w.shape
    if E != E2 or K != K2:
        raise ValueError(f"expert gemm mismatch: x {tuple(x.shape)} @ "
                         f"w {tuple(w.shape)}")
    if k_collapse < 1:
        raise ValueError(f"k_collapse must be >= 1, got {k_collapse}")
    quant = w_scale is not None
    if quant and tuple(w_scale.shape) != (E, N):
        raise ValueError(f"w_scale must be ({E}, {N}), got "
                         f"{tuple(w_scale.shape)}")
    if act_quant and not quant:
        raise ValueError("act_quant (W8A8) requires int8 weights (w_scale)")
    out_dtype = out_dtype or x.dtype
    if E == 0 or T == 0 or N == 0 or K == 0:
        return torch.zeros((E, T, N), dtype=out_dtype, device=x.device)
    if x.device.type == "cpu":
        return arrayflex_expert_gemm_plain(
            x, w, w_scale=w_scale, act_quant=act_quant,
            k_collapse=k_collapse, out_dtype=out_dtype)
    name = ("arrayflex_expert_gemm_w8a8" if act_quant else
            "arrayflex_expert_gemm_int8" if quant else
            "arrayflex_expert_gemm")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _check_cuda(name, x.device, w=w, w_scale=w_scale)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    out = torch.empty((E, T, N), dtype=out_dtype, device=x.device)
    if quant:
        if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
            raise ValueError(f"{name}: unsupported dtypes x {x.dtype}, "
                             f"out {out_dtype}")
        _check_dtypes(name, torch.int8, w=w)
        entry = expert_gemm_q_kernel(x.dtype, act_quant, T)
        s = _fp32_vec(w_scale)
        if entry == "af_expert_gemm_q_tc":
            rc = _lib().af_expert_gemm_q_tc(
                _DTYPE_CODE[out_dtype], _ptr(x), _ptr(w), _ptr(s), _ptr(out),
                E, T, K, N, k_collapse, _stream(x.device))
        else:
            qbm, qkk = (quant_tiles(T, K, k_collapse) if act_quant
                        else (0, 0))
            scratch, nbytes = (_w8a8_scratch_for(x, T, K, k_collapse, E)
                               if act_quant else (None, 0))
            rc = _lib().af_expert_gemm_q(
                _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], int(act_quant),
                _ptr(x), _ptr(w), _ptr(s), _ptr(out), E, T, K, N, k_collapse,
                qbm, qkk, _ptr(scratch), nbytes, _stream(x.device))
    else:
        entry = expert_gemm_kernel(x.dtype, w.dtype)
        if out_dtype not in _DTYPE_CODE:
            raise ValueError(f"{name}: unsupported dtypes x {x.dtype}, "
                             f"w {w.dtype}, out {out_dtype}")
        if entry == "af_expert_gemm_tc":
            rc = _lib().af_expert_gemm_tc(
                _DTYPE_CODE[out_dtype], _ptr(x), _ptr(w), _ptr(out), E, T, K,
                N, k_collapse, _stream(x.device))
        else:
            rc = _lib().af_expert_gemm(
                _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
                _DTYPE_CODE[out_dtype], _ptr(x), _ptr(w), _ptr(out), E, T, K,
                N, k_collapse, _stream(x.device))
    _check_rc(rc, name)
    LAUNCHES[name] += 1
    if entry.endswith("_tc"):
        LAUNCHES[name + "_tc"] += 1
    return out
