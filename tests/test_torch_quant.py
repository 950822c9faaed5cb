"""The port's quantizing backends vs the reference: ``arrayflex_int8`` (W8:
int8 weight codes, dequant at the store) and ``arrayflex_w8a8`` (W8A8:
also per-tile int8 activations and an int8 x int8 -> int32 chain).

Inputs come from numpy with a fixed seed.  The reference's Pallas kernels
run in interpret mode on the CPU; the port's wrappers run their plain
versions on CPU tensors.  Tolerances:

* quantizers (``_quantize``, ``quantize_tile``, ``prequantize_params``):
  bit for bit — elementwise IEEE ops and an exact max.
* W8 GEMM: 1e-5 relative to max |ref| — fp32 sums of exact products
  (int8 codes times fp32 or bf16 x) taken in another order.
* W8A8 GEMM: 1e-5 relative to max |ref|.  Codes, scales and int32
  partials are equal; the reference's interpret run lets XLA's CPU
  backend contract the per-step fold ``acc + iacc * scale`` and the
  store's dequant-then-bias into FMAs, while the port rounds each op as
  the reference's code reads, so results differ by an fp32 rounding per
  step (observed below 1e-7 relative).
* model logits (reduced qwen2-0.5b, fp32): W8 1e-4 absolute, the fp32
  contract of ``tests/test_torch_model.py``; W8A8 0.12 absolute, the
  reference's dense W8A8 tolerance (``tests/test_w8a8_substrate.py``).
  W8A8 scales follow the tile geometry, so W8A8 streams are held to
  run-to-run identity, never to the fp32 streams.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.kernels import ops as ref_ops
from repro.kernels import substrate as ref_sub
from repro.models import lm as ref_lm
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import arrayflex_gemm as ag
from repro_torch.kernels import ops, substrate
from repro_torch.launch import serve
from repro_torch.models import convert, lm
from repro_torch.serving import Request, ServeConfig, ServingEngine

ref_ag = importlib.import_module("repro.kernels.arrayflex_gemm")

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GEMM_RTOL = 1e-5
W8_LOGIT_ATOL = 1e-4
W8A8_LOGIT_ATOL = 0.12
QUANT_BACKENDS = ["arrayflex_int8", "arrayflex_w8a8"]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, JNP[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH[dtype])


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_rel(got, want, rtol=GEMM_RTOL):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 48), (2, 130, 7), (5, 1)])
def test_quantize_weight_bit_equal_to_reference(shape, dtype):
    rng = np.random.RandomState(len(shape) + shape[-1])
    a = rng.randn(*shape) * np.exp(rng.randn(*shape[:-2], 1, shape[-1]))
    a[..., 0] = 0.0                          # an all-zero column
    wj, wt = _pair(a, dtype)
    qj, sj = ref_sub._quantize(wj)
    qt, st = substrate._quantize(wt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


# bf16 values whose fp32 quotient by 127 differs from their product with
# fp32(1/127) in the last bit: as amax they give eager and compiled
# quantizers different scales
DIV_MUL_SPLIT = (0.55859375, 0.5625, 0.68359375, 1.1171875, 1.125)


@pytest.mark.parametrize("shape", [(8, 64, 256), (2, 16, 7), (1, 5, 3)])
def test_kt_quantize_bit_equal_to_compiled_reference(shape):
    """The W8A8 ``attn.qk`` K^T quantize runs inside the reference's
    compiled step, where XLA computes the scale as
    ``max(amax, eps) * fp32(1/127)``; the port's ``compiled`` quantizer
    gives its codes and scales bit for bit on bf16 K^T, including columns
    whose amax splits division from multiplication.  The eager default
    keeps the division (the reference's eager ``prequantize_params``)."""
    rng = np.random.RandomState(shape[-1])
    a = rng.randn(*shape) * 0.3
    for j, v in enumerate(DIV_MUL_SPLIT[:shape[-1]]):
        a[..., 0, j] = v                     # amax of column j
    kj, kt = _pair(a, "bfloat16")
    cj, sj = jax.jit(ref_sub._quantize)(kj)
    ct, st = substrate._quantize(kt, compiled=True)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    eager = substrate._quantize(kt)[1]
    np.testing.assert_array_equal(eager.numpy(),
                                  np.asarray(ref_sub._quantize(kj)[1]))
    assert not torch.equal(eager, st)        # the split really occurs
    # the W8A8 attn.qk dispatch quantizes K^T with the compiled form
    q = torch.from_numpy(rng.randn(shape[0], 3, shape[1]).astype(np.float32))
    got = substrate.batched_gemm(q, kt, site="attn.qk",
                                 backend="arrayflex_w8a8")
    k = substrate.SITE_PLANS["attn.qk"].k
    want = ops.arrayflex_expert_matmul(q, ct, w_scale=st, act_quant=True,
                                       k_collapse=k)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    substrate.clear_plan_cache()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 512), (4, 448), (7, 64), (3, 5)])
def test_quantize_tile_bit_equal_to_reference(shape, dtype):
    """Against the reference quantizer as its kernel runs it: compiled,
    where XLA computes the scale as ``max(amax, eps) * fp32(1/127)``
    (the eager division can differ in the last bit, and move a code that
    sits at a rounding tie)."""
    ref_q = jax.jit(ref_ag.quantize_tile)
    rng = np.random.RandomState(shape[0] * shape[1])
    for trial in range(20):
        xj, xt = _pair(rng.randn(*shape) * 3.0, dtype)
        cj, sj = ref_q(xj)
        ct, st = ag.quantize_tile(xt)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert float(st) == float(sj)
    # a batch of tiles quantizes each tile on its own
    cb, sb = ag.quantize_tile(torch.stack([xt, 2 * xt, 0 * xt]))
    np.testing.assert_array_equal(cb[0].numpy(), np.asarray(cj))
    assert float(sb[1]) == float(ref_q(2 * xj)[1])
    assert not cb[2].any()


@pytest.mark.parametrize("M,K,k,want", [
    (4, 896, 4, (4, 448)), (1024, 896, 2, (128, 224)), (200, 130, 4, (128, 132)),
    (128, 4864, 1, (128, 128)), (7, 64, 4, (7, 64)), (129, 300, 3, (128, 300))])
def test_quant_tiles_follow_reference_tiling(M, K, k, want):
    """bm: ops.arrayflex_matmul's clamp; kk: the kernel's exact K tiling
    (n_steps = ceil(K / (128 k)), kk = ceil(K / (n_steps k)) k)."""
    assert ag.quant_tiles(M, K, k) == want


# ------------------------------------------------------------ GEMM forms

SHAPES = [(4, 896, 200), (200, 130, 96), (37, 300, 130), (129, 64, 64)]
FLAGS = {"plain": {},
         "qkv": dict(bias=True, norm_scale=True),
         "swiglu_all": dict(dual=True, activation="silu", bias=True,
                            bias2=True, residual=True, norm_scale=True),
         "gelu_residual": dict(activation="gelu", residual=True)}


def _quant_operands(M, K, N, dtype, seed, **flags):
    rng = np.random.RandomState(seed)
    x = _pair(rng.randn(M, K), dtype)
    kw_j, kw_t = {}, {}
    for name, scale_name in (("w", "w_scale"), ("w2", "w2_scale")):
        if name == "w2" and not flags.get("dual"):
            continue
        wj = jnp.asarray(rng.randn(K, N) / np.sqrt(K), JNP[dtype])
        qj, sj = ref_sub._quantize(wj)
        kw_j[name], kw_j[scale_name] = qj, sj
        kw_t[name], kw_t[scale_name] = _t(qj), _t(sj)
    for name, shape in (("bias", (N,)), ("bias2", (N,)),
                        ("norm_scale", (K,))):
        if flags.get(name):
            kw_j[name], kw_t[name] = _pair(1.0 + 0.1 * rng.randn(*shape),
                                           "float32")
    if flags.get("residual"):
        kw_j["residual"], kw_t["residual"] = _pair(rng.randn(M, N), dtype)
    return x, kw_j, kw_t


@pytest.mark.parametrize("act_quant", [False, True], ids=["w8", "w8a8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("mkn", SHAPES)
def test_quant_gemm_plain_vs_reference(mkn, k, dtype, act_quant):
    """Ragged M/N/K, M > 128 with a ragged last row tile (200, 129) and a
    ragged last K step (130, 300) at every k; fp32 out, so the tolerance
    is that of fp32 sums."""
    M, K, N = mkn
    (xj, xt), kj, kt = _quant_operands(M, K, N, dtype, M + K + N + k,
                                       bias=True, norm_scale=True)
    want = ref_ops.arrayflex_matmul(xj, kj.pop("w"), act_quant=act_quant,
                                    k_collapse=k, out_dtype=jnp.float32,
                                    **kj)
    got = ag.arrayflex_gemm(xt, kt.pop("w"), act_quant=act_quant,
                            k_collapse=k, out_dtype=torch.float32, **kt)
    _close_rel(got, want)


@pytest.mark.parametrize("act_quant", [False, True], ids=["w8", "w8a8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FLAGS))
def test_quant_epilogues_plain_vs_reference(name, dtype, act_quant):
    """Each store form (dual + both biases + residual + norm scale at
    once among them) on a ragged M > 128 shape, output in x's dtype
    (bf16: one bf16 step, 2^-8, as two fp32 results may round apart)."""
    flags = dict(FLAGS[name])
    act = flags.pop("activation", "none")
    (xj, xt), kj, kt = _quant_operands(200, 130, 96, dtype, len(name),
                                       **flags)
    want = ref_ops.arrayflex_matmul(xj, kj.pop("w"), act_quant=act_quant,
                                    activation=act, k_collapse=4, **kj)
    got = ag.arrayflex_gemm(xt, kt.pop("w"), act_quant=act_quant,
                            activation=act, k_collapse=4, **kt)
    assert got.dtype == TORCH[dtype]
    _close_rel(got, want, GEMM_RTOL if dtype == "float32" else 2.0 ** -8)


# decode shapes (M <= 16) where W8 on fp32 x runs the narrow FFMA tile on
# the card: the dual swiglu with w2_scale and bias2, a residual, ragged N,
# and N > 4096 at a small K (the unembed's width class)
W8_DECODE = [((4, 96, 4864), "swiglu_all"), ((4, 600, 96), "gelu_residual"),
             ((3, 37, 130), "qkv"), ((7, 200, 60), "swiglu_all"),
             ((16, 64, 5000), "plain"), ((4, 32, 8200), "gelu_residual")]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mkn,name", W8_DECODE)
def test_w8_decode_plain_vs_reference(mkn, name, k):
    """W8 on fp32 x at the decode shapes, each store form, output in x's
    dtype: fp32 sums of exact products in another order (1e-5 of max
    |ref|)."""
    M, K, N = mkn
    flags = dict(FLAGS[name])
    act = flags.pop("activation", "none")
    (xj, xt), kj, kt = _quant_operands(M, K, N, "float32", M + K + N + k,
                                       **flags)
    want = ref_ops.arrayflex_matmul(xj, kj.pop("w"), activation=act,
                                    k_collapse=k, **kj)
    got = ag.arrayflex_gemm(xt, kt.pop("w"), activation=act, k_collapse=k,
                            **kt)
    assert got.dtype == torch.float32
    _close_rel(got, want)


# decode shapes (M <= 16) where W8A8 runs the W8A8 narrow tile on the card:
# W8_DECODE's store forms (the dual swiglu with w2_scale and bias2, a
# residual with the norm scale, ragged N, N > 4096 at a small K) and K =
# 300, whose quantization step (100 columns at k = 1, 300 at k = 4) is not
# a multiple of 32, so a step boundary falls inside a 32-row sub-tile
W8A8_DECODE = W8_DECODE + [((5, 300, 70), "qkv"), ((1, 300, 200), "plain")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mkn,name", W8A8_DECODE)
def test_w8a8_decode_plain_vs_reference(mkn, name, k, dtype):
    """W8A8 at the decode shapes, each store form, output in x's dtype:
    the same codes, scales and int32 partials as the reference, the fold
    rounded per op where the interpret run contracts it (1e-5 of max
    |ref|; bf16: one bf16 step, 2^-8, as two fp32 results may round
    apart)."""
    M, K, N = mkn
    flags = dict(FLAGS[name])
    act = flags.pop("activation", "none")
    (xj, xt), kj, kt = _quant_operands(M, K, N, dtype, M + K + N + k,
                                       **flags)
    want = ref_ops.arrayflex_matmul(xj, kj.pop("w"), act_quant=True,
                                    activation=act, k_collapse=k, **kj)
    got = ag.arrayflex_gemm(xt, kt.pop("w"), act_quant=True, activation=act,
                            k_collapse=k, **kt)
    assert got.dtype == TORCH[dtype]
    _close_rel(got, want, GEMM_RTOL if dtype == "float32" else 2.0 ** -8)


def _bank_operands(E, T, K, N, seed):
    """An MoE expert bank: bf16 x rows, int8 codes with (expert, column)
    scales quantized from fp32 weights."""
    rng = np.random.RandomState(seed)
    xj, xt = _pair(rng.randn(E, T, K), "bfloat16")
    qj, sj = ref_sub._quantize(jnp.asarray(rng.randn(E, K, N) / np.sqrt(K),
                                           jnp.float32))
    return (xj, xt), (qj, sj), (_t(qj), _t(sj))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("etkn", [(16, 1, 256, 96), (8, 1, 96, 256),
                                  (6, 4, 300, 70)])
def test_expert_w8a8_bank_plain_vs_reference(etkn, k):
    """K2's W8A8 form at the MoE banks' decode shape (E experts of one
    capacity row, bf16 x, per-(expert, column) scales) and at T = 4 with a
    quantization step that is not a multiple of 32 (K = 300); fp32 out."""
    E, T, K, N = etkn
    (xj, xt), (qj, sj), (qt, st) = _bank_operands(E, T, K, N, E + T + K + k)
    want = ref_ops.arrayflex_expert_matmul(xj, qj, w_scale=sj,
                                           act_quant=True, k_collapse=k,
                                           out_dtype=jnp.float32)
    got = ops.arrayflex_expert_matmul(xt, qt, w_scale=st, act_quant=True,
                                      k_collapse=k, out_dtype=torch.float32)
    assert tuple(got.shape) == (E, T, N)
    _close_rel(got, want)


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", [(16, 1, 256, 96), (5, 7, 300, 70)])
def test_expert_w8a8_plain_bits_do_not_depend_on_E(etkn, out):
    """Each expert's rows are their own quantization tile, so an expert's
    output in an E-expert call is the same bits as its own one-expert
    call: the property the card's W8A8 narrow tile is held to."""
    E, T, K, N = etkn
    _, _, (q, s) = _bank_operands(E, T, K, N, E * T + K)
    x = torch.from_numpy(np.random.RandomState(K).randn(E, T, K)).to(
        torch.bfloat16)
    whole = ag.arrayflex_expert_gemm(x, q, w_scale=s, act_quant=True,
                                     k_collapse=4, out_dtype=out)
    for e in range(E):
        one = ag.arrayflex_expert_gemm(x[e:e + 1], q[e:e + 1],
                                       w_scale=s[e:e + 1], act_quant=True,
                                       k_collapse=4, out_dtype=out)
        assert torch.equal(whole[e:e + 1], one), e


def test_w8a8_single_step_is_bit_exact():
    """One K step and no bias: no op is left for XLA to contract, so the
    plain W8A8 version equals the reference's interpret run bit for bit —
    codes, scales, int32 partials and the dequant all agree."""
    (xj, xt), kj, kt = _quant_operands(200, 100, 130, "float32", 3)
    want = ref_ops.arrayflex_matmul(xj, kj["w"], w_scale=kj["w_scale"],
                                    act_quant=True, k_collapse=1)
    got = ag.arrayflex_gemm(xt, kt["w"], w_scale=kt["w_scale"],
                            act_quant=True, k_collapse=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("etkn", [(8, 7, 64, 256), (2, 300, 64, 130),
                                  (3, 5, 130, 70)])
def test_expert_w8a8_plain_vs_reference(etkn, dtype):
    """K2's W8A8 form at attn.qk's decode shape (E = B*KV, T = g rows,
    K = head_dim, N = cache length), a ragged T > 128 and a ragged K;
    K^T quantized per (batch, column) as the substrate does."""
    E, T, K, N = etkn
    rng = np.random.RandomState(E + T + K + N)
    xj, xt = _pair(rng.randn(E, T, K), dtype)
    kj = jnp.asarray(rng.randn(E, K, N), jnp.bfloat16)
    qj, sj = ref_sub._quantize(kj)
    for k in (1, 2, 4):
        want = ref_ops.arrayflex_expert_matmul(
            xj, qj, w_scale=sj, act_quant=True, k_collapse=k,
            out_dtype=jnp.float32)
        got = ops.arrayflex_expert_matmul(
            xt, _t(qj), w_scale=_t(sj), act_quant=True, k_collapse=k,
            out_dtype=torch.float32)
        assert tuple(got.shape) == (E, T, N)
        _close_rel(got, want)


def test_expert_int8_plain_vs_reference():
    """The int8-only K2 form (MoE banks): its plain version against the
    reference (tests/test_torch_moe.py covers it at more shapes)."""
    rng = np.random.RandomState(0)
    xj, xt = _pair(rng.randn(2, 9, 40), "float32")
    qj, sj = ref_sub._quantize(jnp.asarray(rng.randn(2, 40, 24),
                                           jnp.float32))
    want = ref_ops.arrayflex_expert_matmul(xj, qj, w_scale=sj, k_collapse=2)
    got = ops.arrayflex_expert_matmul(xt, _t(qj), w_scale=_t(sj),
                                      k_collapse=2)
    _close_rel(got, want)


# --------------------------------------------- W8A8 above 16 rows: layout

def _tile_model(xs, ws, k):
    """The int8 tensor-core tile's arithmetic in plain torch, over the
    scratch the quantize pass writes (``w8a8_quantize_plain``): per step,
    its kk32 padded code columns against the w rows each column meets
    (position p of the step's 32-column group j: row s kk + 32 j +
    ``w8a8_code_cols()[p]``, zero past K; the padding's codes are zero, so
    the next step's rows they meet add nothing), an exact integer partial
    (in float64), folded into fp32 as acc + float(iacc) * scale of the
    row's tile, in step order."""
    *lead, M, K = xs.shape
    lay = ag.w8a8_scratch(M, K, k)
    codes, scales = ag.w8a8_quantize_plain(xs, k)
    S, kk, kk32 = lay["steps"], lay["kk"], lay["kk32"]
    cols = ag.w8a8_code_cols()
    rows = torch.tensor([s * kk + p - p % 32 + cols[p % 32]
                         for s in range(S) for p in range(kk32)])
    row_scale = scales[..., torch.arange(M) // lay["bm"], :]   # (.., M, S)
    accs = []
    for w in ws:
        wx = torch.zeros((*w.shape[:-2], (S - 1) * kk + kk32, w.shape[-1]),
                         dtype=torch.float64)
        wx[..., :K, :] = w
        wl = wx[..., rows, :]
        acc = torch.zeros((*lead, M, w.shape[-1]), dtype=torch.float32)
        for s in range(S):
            sl = slice(s * kk32, (s + 1) * kk32)
            iacc = codes[..., sl].double() @ wl[..., sl, :]
            acc = acc + iacc.float() * row_scale[..., s, None]
        accs.append(acc)
    return accs


def _codes(rng, *shape):
    return torch.from_numpy(rng.randint(-127, 128, size=shape).astype(
        np.int8))


@pytest.mark.parametrize("x_form", ["float32", "bfloat16", "float32+g",
                                    "bfloat16+g"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("K", [64, 300, 896, 4864])
@pytest.mark.parametrize("M", [17, 64, 100, 128, 130, 1024])
def test_w8a8_tile_layout_gives_plain_bits(M, K, k, x_form):
    """Above 16 rows the card quantizes x once into scratch (codes per
    step padded to whole 32-column sub-tiles and permuted inside each
    group, scales per row tile and step) and runs int8 sub-tiles: the
    model of that layout gives ``_w8a8_accumulate``'s bits, for both
    contractions of the dual.  M: one short tile, one whole, ragged last
    tiles, the prefill chunk; K = 300: steps of 100, 152 or 300 columns,
    none a whole sub-tile."""
    dtype, g = x_form.split("+")[0], x_form.endswith("+g")
    rng = np.random.RandomState(M + K + k)
    x = torch.from_numpy(rng.randn(M, K)).to(TORCH[dtype])
    gs = (torch.from_numpy(1.0 + 0.1 * rng.randn(K)).float() if g
          else None)
    xs = ag.prologue_phase(x, gs)
    ws = [_codes(rng, K, 40), _codes(rng, K, 40)]
    want = ag._w8a8_accumulate(xs, ws, k)
    got = _tile_model(xs, ws, k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("K", [300, 896])
@pytest.mark.parametrize("M", [17, 130, 1024])
def test_w8a8_tile_layout_vs_reference(M, K, k, dtype):
    """The layout model through the store (the dual swiglu with both
    scales and biases, the residual, the norm scale; fp32 out) against
    the reference's W8A8 ``arrayflex_matmul`` in interpret mode: 1e-5 of
    max |ref| (the interpret run contracts the fold into FMAs)."""
    (xj, xt), kj, kt = _quant_operands(M, K, 48, dtype, M + K + k,
                                       **FLAGS["swiglu_all"])
    want = ref_ops.arrayflex_matmul(xj, kj.pop("w"), act_quant=True,
                                    activation="silu", k_collapse=k,
                                    out_dtype=jnp.float32, **kj)
    y, y2 = _tile_model(ag.prologue_phase(xt, kt["norm_scale"]),
                        [kt["w"], kt["w2"]], k)
    got = ag.store_phase(y, y2, kt["w_scale"], kt["w2_scale"], kt["bias"],
                         kt["bias2"], "silu", kt["residual"])
    _close_rel(got, want)


@pytest.mark.parametrize("T", [17, 37, 300])
@pytest.mark.parametrize("E", [1, 3, 8])
def test_w8a8_expert_tile_layout_gives_plain_bits(E, T):
    """K2 (attn.qk above 16 query rows): each expert's rows their own
    quantization tiles, the layout model over the expert axis gives
    ``_w8a8_accumulate``'s bits at k = 1, 2, 4 and a K that is not a whole
    sub-tile, and through the dequant agrees with the reference."""
    rng = np.random.RandomState(E * T)
    xj, xt = _pair(rng.randn(E, T, 130), "bfloat16")
    qj, sj = ref_sub._quantize(jnp.asarray(rng.randn(E, 130, 70),
                                           jnp.bfloat16))
    q, s = _t(qj), _t(sj)
    for k in (1, 2, 4):
        (want,) = ag._w8a8_accumulate(xt, [q], k)
        (got,) = _tile_model(xt, [q], k)
        assert torch.equal(got, want), k
    ref = ref_ops.arrayflex_expert_matmul(xj, qj, w_scale=sj, act_quant=True,
                                          k_collapse=2, out_dtype=jnp.float32)
    (y,) = _tile_model(xt, [q], 2)
    _close_rel(ag.store_phase(y, w_scale=s.unsqueeze(-2)), ref)


@pytest.mark.parametrize("M,K,k,E", [
    (17, 64, 1, 1), (1024, 896, 2, 1), (1024, 896, 4, 1), (1024, 4864, 2, 1),
    (1024, 4864, 4, 1), (130, 300, 1, 1), (1000, 300, 8, 1), (1792, 64, 2, 8),
    (37, 131, 4, 7), (300, 77, 1, 5)])
def test_w8a8_scratch_follows_quant_tiles(M, K, k, E):
    """The wrapper's scratch layout of one launch above 16 rows:
    ``quant_tiles``' tile, whole steps covering K, each step rounded up to
    whole 32-column sub-tiles, codes [E][M][steps * kk32], then fp32
    scales [E][row tiles][steps] from a 16-byte boundary; and the plain
    quantize pass fills exactly that layout."""
    lay = ag.w8a8_scratch(M, K, k, E)
    assert (lay["bm"], lay["kk"]) == ag.quant_tiles(M, K, k)
    assert (lay["steps"] - 1) * lay["kk"] < K <= lay["steps"] * lay["kk"]
    assert lay["rtiles"] == -(-M // lay["bm"])
    assert lay["kk32"] % 32 == 0 and lay["kk"] <= lay["kk32"] < \
        lay["kk"] + 32
    assert lay["ldc"] == lay["steps"] * lay["kk32"]
    assert lay["codes_bytes"] == E * M * lay["ldc"]
    assert lay["scales_off"] % 16 == 0 and \
        0 <= lay["scales_off"] - lay["codes_bytes"] < 16
    assert lay["nbytes"] == lay["scales_off"] + \
        4 * E * lay["rtiles"] * lay["steps"]
    x = torch.from_numpy(np.random.RandomState(K).randn(E, M, K)).float()
    codes, scales = ag.w8a8_quantize(x, k_collapse=k)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert tuple(codes.shape) == (E, M, lay["ldc"])
    assert tuple(scales.shape) == (E, lay["rtiles"], lay["steps"])


def test_w8a8_quantize_plain_layout():
    """The scratch's codes are ``quantize_tile``'s codes of each (row tile,
    step) tile, each step padded with zeros to kk32 and each 32-column
    group in ``w8a8_code_cols``' order (columns 2t, 2t+1, 2t+8, 2t+9 at
    positions 4t..4t+3 of each half); the scales are the tiles'."""
    cols = ag.w8a8_code_cols()
    assert sorted(cols) == list(range(32))
    assert cols[:8] == [0, 1, 8, 9, 2, 3, 10, 11]
    assert cols[16:20] == [16, 17, 24, 25]
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(200, 300)).float()
    gs = torch.from_numpy(1.0 + 0.1 * rng.randn(300)).float()
    codes, scales = ag.w8a8_quantize(x, norm_scale=gs, k_collapse=1)
    xs = ag.prologue_phase(x, gs)
    lay = ag.w8a8_scratch(200, 300, 1)                # kk 100, kk32 128
    assert (lay["kk"], lay["kk32"], lay["steps"]) == (100, 128, 3)
    for t in range(lay["rtiles"]):
        for s in range(lay["steps"]):
            r0, c0 = t * 128, s * 100
            tile = torch.zeros(128, 100)
            part = xs[r0:r0 + 128, c0:c0 + 100]
            tile[:part.shape[0], :part.shape[1]] = part
            want, scale = ag.quantize_tile(tile)
            assert torch.equal(scales[t, s], scale)
            got = codes[r0:r0 + 128, s * 128:(s + 1) * 128]
            back = torch.zeros_like(got)
            for p in range(128):
                back[:, p - p % 32 + cols[p % 32]] = got[:, p]
            assert torch.equal(back[:, :100], want[:part.shape[0]])
            assert not back[:, 100:].any()


def test_quant_wrapper_validation():
    x, q, s = torch.zeros(4, 8), torch.zeros(8, 4, dtype=torch.int8), \
        torch.ones(4)
    with pytest.raises(ValueError, match="act_quant"):
        ag.arrayflex_gemm(x, q, act_quant=True)
    with pytest.raises(ValueError, match="w2_scale requires"):
        ag.arrayflex_gemm(x, q, w2_scale=s)
    with pytest.raises(ValueError, match="needs w2_scale"):
        ag.arrayflex_gemm(x, q, w2=q, w_scale=s, activation="silu")
    with pytest.raises(ValueError, match="w_scale must be"):
        ag.arrayflex_gemm(x, q, w_scale=torch.ones(5))
    with pytest.raises(ValueError, match="w_scale must be"):
        ag.arrayflex_expert_gemm(x[None], q[None], w_scale=s)
    with pytest.raises(ValueError, match="act_quant"):
        ag.arrayflex_expert_gemm(x[None], q[None], act_quant=True)
    with pytest.raises(ValueError, match="unsupported device"):
        ag.arrayflex_gemm(x.to("meta"), q.to("meta"), w_scale=s.to("meta"))


def test_quant_plain_versions_count_no_launches():
    before = dict(ag.LAUNCHES)
    x, q, s = torch.ones(4, 8), torch.ones(8, 4, dtype=torch.int8), \
        torch.ones(4)
    ag.arrayflex_gemm(x, q, w_scale=s)
    ag.arrayflex_gemm(x, q, w_scale=s, act_quant=True)
    ag.arrayflex_expert_gemm(x[None], q[None], w_scale=s[None],
                             act_quant=True)
    ag.arrayflex_expert_gemm(x[None], q[None], w_scale=s[None])
    assert ag.LAUNCHES == before
    assert set(ag.LAUNCHES) == {
        "arrayflex_gemm", "arrayflex_gemm_tc", "arrayflex_gemm_int8",
        "arrayflex_gemm_int8_tc", "arrayflex_gemm_w8a8",
        "arrayflex_expert_gemm",
        "arrayflex_expert_gemm_tc", "arrayflex_expert_gemm_int8",
        "arrayflex_expert_gemm_w8a8"}


# ------------------------------------------------------------ planning

def test_pinned_w8a8_pick():
    """docs/substrate.md pins (896, 4864, 512): k=2 under fp32, k=4 on the
    w8a8 datapath once its quantize stage is priced — in both packages."""
    assert ops.plan_collapse(896, 4864, 512) == 2
    for kw in (dict(precision="w8a8", actq_ops=1),
               dict(precision="int8"), dict(precision="w8a8")):
        assert ops.plan_collapse(896, 4864, 512, **kw) == \
            ref_ops.plan_collapse(896, 4864, 512, **kw)
    assert ops.plan_collapse(896, 4864, 512, precision="w8a8",
                             actq_ops=1) == 4


SITES = {"attn.wq": ((896, 896), dict(bias=True, norm_scale=True)),
         "attn.wk": ((128, 896), dict(bias=True, norm_scale=True)),
         "attn.wo": ((896, 896), dict()),
         "mlp.wi_gate+mlp.wi_up": ((4864, 896),
                                   dict(kind="swiglu", norm_scale=True)),
         "mlp.wo": ((896, 4864), dict(residual=True)),
         "unembed": ((152064, 896), dict())}


@pytest.mark.parametrize("backend", QUANT_BACKENDS)
@pytest.mark.parametrize("site", sorted(SITES))
@pytest.mark.parametrize("T", [4, 512, 1024])
def test_site_plans_match_reference_quantized(site, T, backend):
    """Full-width qwen2-0.5b sites plan the same k, precision, cycles and
    predictions in both substrates on both quantizing backends (dequant
    and quantize terms priced)."""
    (M, N), ep = SITES[site]
    got = substrate.plan_gemm(M, N, T, backend, substrate.Epilogue(**ep))
    want = ref_sub.plan_gemm(M, N, T, backend, ref_sub.Epilogue(**ep))
    assert (got.k, got.precision, got.cycles) == \
        (want.k, want.precision, want.cycles)
    assert got.t_pred_ps == pytest.approx(want.t_pred_ps)
    assert got.t_conventional_ps == pytest.approx(want.t_conventional_ps)


def test_register_backend_validates_quant_flags():
    with pytest.raises(ValueError, match="act_quantize requires quantize"):
        substrate.register_backend("bad", lambda *a: None, act_quantize=True)
    assert "bad" not in substrate.backends()
    assert substrate.backend_quantizes("arrayflex_int8")
    assert not substrate.backend_act_quantizes("arrayflex_int8")
    assert substrate.backend_act_quantizes("arrayflex_w8a8")
    assert not substrate.backend_quantizes("arrayflex")


# ------------------------------------------------------------ dispatch

def test_dispatch_quantizes_through_the_memo():
    substrate.clear_quant_cache()
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(3, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    out1 = substrate.gemm(x, w, site="attn.wo", backend="arrayflex_int8")
    out2 = substrate.gemm(x, w, site="attn.wo", backend="arrayflex_int8")
    assert substrate.quantize_cache_info() == {"hits": 1, "misses": 1,
                                               "size": 1}
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)
    q, s = substrate._quantize(w)
    torch.testing.assert_close(out1, (x @ q.float()) * s, rtol=1e-6,
                               atol=1e-6)
    pre = substrate.gemm(x, substrate.prequantize(w), site="attn.wo",
                         backend="arrayflex_int8")
    torch.testing.assert_close(pre, out1, rtol=0, atol=0)
    with pytest.raises(ValueError, match="non-quantizing"):
        substrate.gemm(x, substrate.prequantize(w), backend="arrayflex")
    with pytest.raises(ValueError, match="quantization-exempt"):
        substrate.gemm(x, substrate.prequantize(w), site="moe.router",
                       backend="arrayflex_int8")
    substrate.gemm(x, w, site="moe.router", backend="arrayflex_w8a8")
    assert substrate.SITE_PLANS["moe.router"].precision == "fp32"
    del w
    assert substrate.quantize_cache_info()["size"] == 0   # evicted
    substrate.clear_plan_cache()
    substrate.clear_quant_cache()


def test_quantized_tensor_moves_and_slices_together():
    w = torch.randn(3, 16, 8)
    qt = substrate.prequantize(w)
    assert qt.shape == (3, 16, 8) and qt.ndim == 3
    assert qt.to(torch.bfloat16) is qt                 # no-op dtype cast
    assert qt.to("cpu").codes.device.type == "cpu"
    layer = qt[1]
    q1, s1 = substrate._quantize(w[1])
    assert torch.equal(layer.codes, q1) and torch.equal(layer.scale, s1)
    with pytest.raises(TypeError, match="stacked"):
        layer[0]


# ------------------------------------------------------------ model

def _cfgs(backend):
    rc = dataclasses.replace(ref_reduced(ARCHS["qwen2-0.5b"]),
                             gemm_backend=backend, compute_dtype="float32")
    tc = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                             gemm_backend=backend, compute_dtype="float32")
    return rc, tc


@pytest.fixture(scope="module")
def params():
    rc, tc = _cfgs("xla")
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
    tp = convert.params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return rp, tp


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prequantize_params_bit_equal_to_reference(dtype, params):
    """Every quantized leaf (the table_q leaf included) holds the
    reference's codes and scales; the converted reference tree holds the
    same QuantizedTensors."""
    rc, tc = _cfgs("arrayflex_int8")
    rc = dataclasses.replace(rc, compute_dtype=dtype)
    tc = dataclasses.replace(tc, compute_dtype=dtype)
    rp, tp = params
    want = ref_lm.prequantize_params(rc, rp)
    got = lm.prequantize_params(tc, tp)
    conv = convert.params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, want), device="cpu")
    w_leaves = dict(_leaves(want))
    n_q = 0
    for tree in (got, conv):
        for path, leaf in _leaves(tree):
            if not isinstance(leaf, substrate.QuantizedTensor):
                continue
            ref_leaf = w_leaves[path]
            assert leaf.codes.dtype == torch.int8
            np.testing.assert_array_equal(leaf.codes.numpy(),
                                          np.asarray(ref_leaf.codes))
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(ref_leaf.scale))
            n_q += 1
    # 7 weights per layer stack (wq, wk, wv, wo, wi_gate, wi_up, wo) +
    # table_q, in both trees
    assert n_q == 2 * 8
    assert "table_q" in got["embed"]
    assert lm.prequantize_params(dataclasses.replace(
        tc, gemm_backend="arrayflex"), tp) is tp


def _step_both(backend, params):
    """One prefill_step + one decode_step in both packages: logits of the
    active prefill rows and of the decode step, plus the port's plans."""
    rc, tc = _cfgs(backend)
    rp, tp = params
    rq = ref_lm.prequantize_params(rc, rp)
    tq = lm.prequantize_params(tc, lm.prepare_params(tc, tp))
    B, S = 3, 16
    toks = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 0, 0], [9, 0, 0, 0, 0]])
    lens, pos = np.array([5, 3, 1]), np.array([0, 2, 0])
    ref_sub.clear_plan_cache()
    substrate.clear_plan_cache()
    rl, rcache = ref_lm.prefill_step(rc, rq, ref_lm.init_cache(rc, B, S),
                                     jnp.asarray(toks), jnp.asarray(pos),
                                     jnp.asarray(lens))
    tl, tcache = lm.prefill_step(tc, tq, lm.init_cache(tc, B, S,
                                                       device="cpu"),
                                 torch.tensor(toks), torch.tensor(pos),
                                 torch.tensor(lens))
    nxt = np.array([11, 12, 13])
    rd, _ = ref_lm.decode_step(rc, rq, rcache, jnp.asarray(nxt),
                               jnp.asarray(pos + lens))
    td, _ = lm.decode_step(tc, tq, tcache, torch.tensor(nxt),
                           torch.tensor(pos + lens))
    want = np.concatenate([np.asarray(rl), np.asarray(rd)])
    got = torch.cat([tl, td]).float().numpy()
    plans = dict(substrate.SITE_PLANS), dict(ref_sub.SITE_PLANS)
    substrate.clear_plan_cache()
    ref_sub.clear_plan_cache()
    return got, want, plans


@pytest.mark.parametrize("backend,atol", [
    ("arrayflex_int8", W8_LOGIT_ATOL), ("arrayflex_w8a8", W8A8_LOGIT_ATOL)])
def test_step_logits_and_plans_match_reference(backend, atol, params):
    got, want, (plans, ref_plans) = _step_both(backend, params)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert set(plans) == set(ref_plans)
    for site, plan in plans.items():
        ref = ref_plans[site]
        assert (plan.M, plan.N, plan.T, plan.k, plan.precision) == \
            (ref.M, ref.N, ref.T, ref.k, ref.precision), site
    prec = "w8a8" if backend == "arrayflex_w8a8" else "fp32"
    assert plans["attn.qk"].precision == prec
    assert plans["attn.pv"].precision == "fp32"
    assert plans["attn.wq"].precision == backend.split("_")[1]


def _run_port(tc, tp, **sc):
    eng = ServingEngine(tc, tp, ServeConfig(**dict(dict(
        max_batch=2, max_seq=32), **sc)), device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=4, rid=i)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


PROMPTS = [[5, 6, 7], [11, 12, 13, 14], [21, 22]]


def test_int8_greedy_streams_match_reference_engine(params):
    """W8: greedy streams identical to the reference engine's, the same
    dispatch structure, and every dispatch counted per layer."""
    rc, tc = _cfgs("arrayflex_int8")
    rp, tp = params
    ref_sub.clear_plan_cache()
    ref = RefEngine(rc, rp, RefServeConfig(max_batch=2, max_seq=32))
    rreqs = [RefRequest(prompt=p, max_new_tokens=4, rid=i)
             for i, p in enumerate(PROMPTS)]
    for r in rreqs:
        ref.submit(r)
    ref.run_to_completion()
    ref_counts = dict(ref_sub.DISPATCH_COUNTS)
    substrate.clear_plan_cache()
    streams, eng = _run_port(tc, tp)
    assert streams == [r.out_tokens for r in rreqs]
    steps = eng.stats["prefill_dispatches"] + eng.stats["decode_dispatches"]
    assert set(substrate.DISPATCH_COUNTS) == set(ref_counts)
    for site, n in substrate.DISPATCH_COUNTS.items():
        assert n == steps * (1 if site == "unembed" else tc.n_layers), site
    assert isinstance(eng.params["blocks"][0]["attn"]["wq"]["w"],
                      substrate.QuantizedTensor)
    substrate.clear_plan_cache()
    ref_sub.clear_plan_cache()


def test_w8a8_streams_identical_run_to_run(params):
    """W8A8: per-tile scales make the tile geometry part of the numbers,
    so streams are held to run-to-run identity per serving configuration
    (never to the fp32 streams); the dispatch counts match the reference
    engine's per-layer structure."""
    _, tc = _cfgs("arrayflex_w8a8")
    a, eng = _run_port(tc, params[1])
    counts = dict(substrate.DISPATCH_COUNTS)
    substrate.clear_plan_cache()
    b, _ = _run_port(tc, params[1])
    assert a == b
    assert all(len(s) == 4 for s in a)
    steps = eng.stats["prefill_dispatches"] + eng.stats["decode_dispatches"]
    assert counts == {site: steps * (1 if site == "unembed" else tc.n_layers)
                      for site in counts}
    assert set(counts) == {"attn.wq", "attn.wk", "attn.wv", "attn.qk",
                           "attn.pv", "attn.wo", "mlp.wi_gate+mlp.wi_up",
                           "mlp.wo", "unembed"}
    substrate.clear_plan_cache()


@pytest.mark.parametrize("backend", QUANT_BACKENDS)
def test_serve_cli_quantized_on_cpu(backend, capsys):
    reqs = serve.main(["--device", "cpu", "--requests", "2", "--max-new",
                       "3", "--gemm-backend", backend])
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)
    out = capsys.readouterr().out
    assert f"quantized: {backend} serves int8 weights" in out
    assert ("W8A8" in out) == (backend == "arrayflex_w8a8")
