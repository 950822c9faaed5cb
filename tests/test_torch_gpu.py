"""The port's CUDA kernels (float, W8 and W8A8 forms, K2's int8-only form
of the MoE expert banks, and K3 flash attention) against their plain
versions, and the full-sequence ``lm.prefill`` against the ``ref``
backend, on the card.  bf16 K1 float, W8 K1 on bf16 x, bf16 K2 float and
bf16 K3 run the tensor-core kernels, fp32 the FFMA ones (``gemm_kernel``
/ ``gemm_q_kernel`` / ``expert_gemm_kernel`` / ``attention_kernel``); the
per-kernel launch counters show which ran.  Also the resilient engine on
the card: a transient GEMM fault, a crash restored from a snapshot and
preemption against a clean run's streams.

    pytest -m gpu tests/test_torch_gpu.py

Every test here needs a CUDA card and ``nvcc``; without a card each test
skips with that reason (decided inside the ``cuda`` fixture, so every
pytest worker collects the same tests).  Tolerances, relative to the
largest |value| of the plain output: fp32 1e-5 (fp32 sums in another
order); bf16 one bf16 step, 2^-8 (two fp32 sums may round to neighbouring
bf16 values).  The int8 forms' bf16 checks take that step exactly at the
largest |value| (2^(floor(log2 v) - 7)), which 2^-8 v understates by up
to 2x just below a power of two.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import planner
from repro_torch.kernels import arrayflex_gemm as ag
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, substrate
from repro_torch.models import lm
from repro_torch.runtime.chaos import ChaosConfig
from repro_torch.serving import (EngineCrash, Request, ServeConfig,
                                 ServingEngine)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dt):
    torch.cuda.synchronize()
    scale = max(want.float().abs().max().item(), 1.0)
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == want.shape and err <= TOL[dt] * scale, (err, scale)


def _close_step(got, want, dt):
    """``_close`` with the bf16 tolerance one bf16 step at max |want|."""
    torch.cuda.synchronize()
    scale = max(want.float().abs().max().item(), 1.0)
    err = (got.float() - want.float()).abs().max().item()
    tol = (TOL[dt] * scale if dt == torch.float32
           else 2.0 ** (math.floor(math.log2(scale)) - 7))
    assert got.shape == want.shape and err <= tol, (err, scale, tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("mkn", [(4, 896, 896), (37, 130, 200),
                                 (300, 896, 4864), (1, 64, 152064 // 64)])
@pytest.mark.parametrize("flags", ["none", "qkv", "swiglu", "residual",
                                   "gelu_bias2", "f32_out"])
def test_arrayflex_gemm_matches_plain(cuda, dt, k, mkn, flags):
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + K + N + k)

    def r(*s, dtype=dt):
        return torch.randn(*s, generator=g, device=cuda).to(dtype)

    x, w = r(M, K), r(K, N)
    kw = {"none": {},
          "qkv": dict(bias=r(N, dtype=torch.float32),
                      norm_scale=r(K, dtype=torch.float32)),
          "swiglu": dict(w2=r(K, N), activation="silu",
                         norm_scale=r(K, dtype=torch.float32)),
          "residual": dict(residual=r(M, N)),
          "gelu_bias2": dict(w2=r(K, N), activation="gelu",
                             bias=r(N, dtype=torch.float32),
                             bias2=r(N, dtype=torch.float32)),
          "f32_out": dict(out_dtype=torch.float32)}[flags]
    before = dict(ag.LAUNCHES)
    got = ag.arrayflex_gemm(x, w, k_collapse=k, **kw)
    tc = int(dt == torch.bfloat16)          # the tensor-core kernel ran
    assert ag.LAUNCHES == dict(
        before, arrayflex_gemm=before["arrayflex_gemm"] + 1,
        arrayflex_gemm_tc=before["arrayflex_gemm_tc"] + tc)
    _close(got, ag.arrayflex_gemm_plain(x, w, **kw), dt)


def _tc_operands(g, M, K, N, flags):
    def r(*s, dtype=torch.bfloat16):
        return torch.randn(*s, generator=g, device="cuda").to(dtype)

    kw = {"qkv": dict(bias=r(N, dtype=torch.float32),
                      norm_scale=1.0 + 0.1 * r(K, dtype=torch.float32)),
          "swiglu": dict(w2=r(K, N) * K ** -0.5, activation="silu",
                         norm_scale=1.0 + 0.1 * r(K, dtype=torch.float32)),
          "residual": dict(residual=r(M, N))}[flags]
    return r(M, K), r(K, N) * K ** -0.5, kw


@pytest.mark.parametrize("mkn,flags", [
    ((4, 896, 896), "qkv"), ((4, 896, 4864), "swiglu"),
    ((4, 4864, 896), "residual"), ((37, 130, 200), "swiglu"),
    ((300, 896, 4864), "swiglu"), ((1024, 4864, 896), "residual"),
    ((200, 896, 128), "qkv")])
def test_arrayflex_gemm_tc_bit_identical_across_k(cuda, mkn, flags):
    """The tensor-core K1 takes its k16 products in increasing K order
    whatever k_collapse (and whatever its ring depth, which k changes), so
    its bf16 output is the same bits at k = 1, 2, 4, 8; and it matches the
    plain version."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M * N + K)
    x, w, kw = _tc_operands(g, M, K, N, flags)
    outs = []
    for k in (1, 2, 4, 8):
        before = ag.LAUNCHES["arrayflex_gemm_tc"]
        outs.append(ag.arrayflex_gemm(x, w, k_collapse=k, **kw))
        assert ag.LAUNCHES["arrayflex_gemm_tc"] == before + 1
    torch.cuda.synchronize()
    for k, got in zip((2, 4, 8), outs[1:]):
        assert torch.equal(got, outs[0]), f"k={k} differs from k=1"
    _close_step(outs[0], ag.arrayflex_gemm_plain(x, w, **kw),
                torch.bfloat16)


@pytest.mark.parametrize("mkn", [(4, 896, 896), (37, 130, 200),
                                 (300, 264, 136)])
def test_arrayflex_gemm_tc_scalar_staging(cuda, mkn):
    """Operands whose base is not 16-byte aligned stage through the scalar
    path of the same kernel: the same main loop, so the same bits as the
    aligned copies (and the plain version's numbers)."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + 3 * K + N)
    x, w, kw = _tc_operands(g, M, K, N, "swiglu")
    kw["residual"] = torch.randn(M, N, generator=g, device=cuda).to(
        torch.bfloat16)

    def shifted(t):                     # same values, base 2 bytes off
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    want = ag.arrayflex_gemm(x, w, k_collapse=2, **kw)
    got = ag.arrayflex_gemm(shifted(x), shifted(w), k_collapse=2,
                            **dict(kw, w2=shifted(kw["w2"]),
                                   residual=shifted(kw["residual"])))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _close_step(got, ag.arrayflex_gemm_plain(x, w, **kw), torch.bfloat16)


# K2's site shapes (E, T, K, N): qwen2-0.5b attn.qk / attn.pv at decode
# (B = 4), at the prefill chunk and at the 2048-token prefill (B = 1);
# qwen3-moe-30b-a3b's attention at decode (max_seq 64) and its expert banks
# (128 experts of one capacity row); then ragged T / N / K, and T = 1
K2_SHAPES = [(8, 7, 64, 256), (8, 7, 256, 64), (8, 1792, 64, 256),
             (8, 1792, 256, 64), (2, 14336, 64, 2048), (2, 14336, 2048, 64),
             (16, 8, 128, 64), (16, 8, 64, 128), (128, 1, 2048, 768),
             (128, 1, 768, 2048), (3, 5, 130, 70), (5, 1, 100, 36),
             (4, 300, 72, 200)]


@pytest.mark.parametrize("combo", ["f32", "bf16", "f32xbf16"])
@pytest.mark.parametrize("etkn", K2_SHAPES)
def test_arrayflex_expert_gemm_matches_plain(cuda, combo, etkn):
    """K2's float form at every site shape: bf16 x bf16 on the tensor-core
    kernel, fp32 x (fp32 or bf16 w) on the FFMA kernel, one launch each;
    fp32 out within 1e-5 of max |plain| (fp32 sums in another order)."""
    E, T, K, N = etkn
    dx, dw = {"f32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.bfloat16),
              "f32xbf16": (torch.float32, torch.bfloat16)}[combo]
    g = torch.Generator(device=cuda).manual_seed(T + K)
    x = torch.randn(E, T, K, generator=g, device=cuda).to(dx)
    w = torch.randn(E, K, N, generator=g, device=cuda).to(dw)
    before = dict(ag.LAUNCHES)
    got = ag.arrayflex_expert_gemm(x, w, k_collapse=2,
                                   out_dtype=torch.float32)
    tc = int(combo == "bf16")               # the tensor-core kernel ran
    assert ag.LAUNCHES == dict(
        before, arrayflex_expert_gemm=before["arrayflex_expert_gemm"] + 1,
        arrayflex_expert_gemm_tc=before["arrayflex_expert_gemm_tc"] + tc)
    _close(got, ag.arrayflex_expert_gemm_plain(x, w,
                                               out_dtype=torch.float32),
           torch.float32)


def _bf16(g, *shape, scale=1.0):
    return (scale * torch.randn(*shape, generator=g, device="cuda")).to(
        torch.bfloat16)


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", K2_SHAPES)
def test_expert_gemm_tc_bit_identical_across_k(cuda, out, etkn):
    """The tensor-core K2 takes every accumulator's k16 products in
    increasing K order whatever k_collapse, so its output is the same bits
    at k = 1, 2, 4; and it holds the plain version (bf16 out: one bf16
    step at max |value|)."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E * T + K + N)
    x, w = _bf16(g, E, T, K), _bf16(g, E, K, N, scale=K ** -0.5)
    outs = [ag.arrayflex_expert_gemm(x, w, k_collapse=k, out_dtype=out)
            for k in (1, 2, 4)]
    torch.cuda.synchronize()
    for k, got in zip((2, 4), outs[1:]):
        assert torch.equal(got, outs[0]), f"k={k} differs from k=1"
    _close_step(outs[0], ag.arrayflex_expert_gemm_plain(x, w, out_dtype=out),
                torch.bfloat16 if out == torch.bfloat16 else torch.float32)


@pytest.mark.parametrize("etkn", [(128, 1, 2048, 768), (8, 7, 64, 256),
                                  (6, 5, 130, 70), (3, 300, 100, 64)])
def test_expert_gemm_tc_bits_do_not_depend_on_E(cuda, etkn):
    """An expert's output in an E-expert launch is the same bits as its
    own one-expert launch, including experts whose base is not 16-byte
    aligned in the E-expert tensor (T * K not a multiple of 8: they stage
    through the scalar path there, the cp.async path alone)."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E + T * K + N)
    x, w = _bf16(g, E, T, K), _bf16(g, E, K, N, scale=K ** -0.5)
    for out in (torch.float32, torch.bfloat16):
        whole = ag.arrayflex_expert_gemm(x, w, k_collapse=2, out_dtype=out)
        for e in sorted({0, 1, E // 2, E - 1}):
            one = ag.arrayflex_expert_gemm(x[e:e + 1].clone(),
                                           w[e:e + 1].clone(), k_collapse=2,
                                           out_dtype=out)
            torch.cuda.synchronize()
            assert torch.equal(whole[e:e + 1], one), (out, e)


@pytest.mark.parametrize("etkn", [(8, 7, 64, 256), (128, 1, 768, 2048),
                                  (4, 300, 72, 200)])
def test_expert_gemm_tc_misaligned_base(cuda, etkn):
    """Operands whose base is 2 bytes off a 16-byte boundary (every batch
    element misaligned) stage through the scalar path of the same kernel:
    the same bits as the aligned copies."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E + T + K + N)
    x, w = _bf16(g, E, T, K), _bf16(g, E, K, N, scale=K ** -0.5)

    def shifted(t):                     # same values, base 2 bytes off
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    for out in (torch.float32, torch.bfloat16):
        want = ag.arrayflex_expert_gemm(x, w, k_collapse=4, out_dtype=out)
        got = ag.arrayflex_expert_gemm(shifted(x), shifted(w), k_collapse=4,
                                       out_dtype=out)
        torch.cuda.synchronize()
        assert torch.equal(got, want), out


# fp32 K1 at decode M (the narrow FFMA tile): the MoE router (4, 2048,
# 128), qwen2-0.5b's attention projections, ragged M / N / K, then the
# sites past N = 4096 and qwen3-moe-30b-a3b's attn.wo (the 32- and
# 16-column widths): the dual swiglu's (4, 896, 4864) and both models'
# unembeds
NARROW_SHAPES = [(4, 2048, 128), (4, 896, 896), (4, 896, 128), (1, 64, 8),
                 (16, 1000, 130), (3, 37, 4096), (7, 2050, 60),
                 (4, 896, 4864), (4, 4096, 2048), (4, 896, 152064),
                 (4, 2048, 152064), (16, 300, 5000)]


@pytest.mark.parametrize("mkn", NARROW_SHAPES)
@pytest.mark.parametrize("flags", ["none", "qkv", "residual_bf16_out",
                                   "swiglu"])
def test_fp32_narrow_tile_bit_identical_across_k(cuda, mkn, flags):
    """The FFMA K1's narrow decode tile sums fixed K slices (one warp
    each, each an fmaf chain in increasing K order) and adds the slices
    in order: the same bits at k = 1, 2, 4, 8, one launch of the FFMA K1
    each, and within 1e-5 of max |plain| (fp32 sums in another order);
    the dual contraction (swiglu) keeps two sets of chains."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + K + N)

    def r(*s):
        return torch.randn(*s, generator=g, device=cuda)

    x, w = r(M, K), r(K, N) * K ** -0.5
    kw = {"none": {},
          "qkv": dict(bias=r(N), norm_scale=1.0 + 0.1 * r(K)),
          "residual_bf16_out": dict(residual=r(M, N),
                                    out_dtype=torch.bfloat16),
          "swiglu": dict(w2=r(K, N) * K ** -0.5, activation="silu",
                         norm_scale=1.0 + 0.1 * r(K))}[flags]
    outs = []
    for k in (1, 2, 4, 8):
        before = dict(ag.LAUNCHES)
        outs.append(ag.arrayflex_gemm(x, w, k_collapse=k, **kw))
        assert ag.LAUNCHES == dict(
            before, arrayflex_gemm=before["arrayflex_gemm"] + 1)
    torch.cuda.synchronize()
    for k, got in zip((2, 4, 8), outs[1:]):
        assert torch.equal(got, outs[0]), f"k={k} differs from k=1"
    _close_step(outs[0], ag.arrayflex_gemm_plain(x, w, **kw),
                kw.get("out_dtype", torch.float32))


def test_fp32_narrow_tile_takes_any_k(cuda):
    """A deep k_collapse at M = 16 (steps of more sub-tiles than a warp's
    ring holds) runs the same tile: the same bits as k = 1."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(16, 2048, generator=g, device=cuda)
    w = torch.randn(2048, 128, generator=g, device=cuda) * 2048 ** -0.5
    outs = [ag.arrayflex_gemm(x, w, k_collapse=k) for k in (1, 16, 64)]
    torch.cuda.synchronize()
    assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0])
    _close(outs[0], ag.arrayflex_gemm_plain(x, w), torch.float32)


def test_narrow_width_rule(cuda):
    """K1's narrow-tile width: the widest of its weight type's widths whose
    grid fills the card (at least 128 blocks), else the narrowest; int8's
    128 columns at M <= 4 only; K2 keeps 32.  The shared memory each launch
    takes fits one SM at every k."""
    lib = ag._lib()
    f32, i8 = 0, 2
    for (M, N, w_dtype), want in {
            (4, 152064, f32): 32, (4, 4864, f32): 32, (4, 4096, f32): 32,
            (4, 2048, f32): 16, (4, 896, f32): 8, (4, 128, f32): 8,
            (4, 152064, i8): 128, (5, 152064, i8): 64, (16, 20000, i8): 64,
            (4, 4864, i8): 32, (4, 4096, i8): 32, (4, 2048, i8): 16,
            (4, 896, i8): 16, (1, 8, i8): 16}.items():
        assert lib.af_narrow_cols(M, N, w_dtype, 0) == want, (M, N, w_dtype)
    assert lib.af_narrow_cols(1, 768, 0, 1) == 32
    assert lib.af_narrow_cols(17, 128, 0, 0) == -1
    for M, K, N in [(4, 896, 4864), (4, 896, 152064), (16, 4864, 896),
                    (16, 2048, 20000), (1, 64, 8)]:
        for w_dtype in (f32, i8):
            for dual in (0, 1):
                for k in (1, 2, 4, 8, 64):
                    smem = lib.af_narrow_smem(M, N, K, k, w_dtype, dual, 0,
                                              0)
                    assert 0 < smem <= 232448, (M, K, N, w_dtype, dual, k)
    assert lib.af_narrow_smem(17, 128, 64, 1, f32, 0, 0, 0) == -1


def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ag.arrayflex_gemm(x, x.t().contiguous())
    x = torch.zeros(8, 4, device=cuda).t()            # column-major rows
    with pytest.raises(ValueError, match="unit stride"):
        ag.arrayflex_gemm(x, torch.zeros(8, 4, device=cuda))


def _serve_reduced(backend, arch="qwen2-0.5b"):
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              gemm_backend=backend)
    params = lm.init_params(cfg, seed=0)
    eng = ServingEngine(cfg, params, ServeConfig(max_batch=2, max_seq=32))
    reqs = [Request(prompt=[5, 6, 7], max_new_tokens=3, rid=0),
            Request(prompt=[9, 10], max_new_tokens=3, rid=1)]
    for r in reqs:
        eng.submit(r)
    ag.reset_launches()
    eng.run_to_completion()
    steps = eng.stats["prefill_dispatches"] + eng.stats["decode_dispatches"]
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)
    return cfg.n_layers, steps


def test_engine_launches_every_kernel(cuda):
    """bf16 serving: every K1 and K2 launch on the tensor-core kernels."""
    L, steps = _serve_reduced("arrayflex")
    assert ag.LAUNCHES == dict(
        {name: 0 for name in ag.LAUNCHES},
        arrayflex_gemm=(6 * L + 1) * steps,
        arrayflex_gemm_tc=(6 * L + 1) * steps,
        arrayflex_expert_gemm=2 * L * steps,
        arrayflex_expert_gemm_tc=2 * L * steps)


PAGED_PROMPTS = [[5, 6, 7], [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
                 [21], [31, 32, 33, 34, 35], [41, 42, 43, 44, 45, 46, 47, 48]]


def _serve_streams(cfg, params, **sc):
    eng = ServingEngine(cfg, params, ServeConfig(max_batch=2, max_seq=32,
                                                 **sc))
    reqs = [Request(prompt=p, max_new_tokens=4, rid=i)
            for i, p in enumerate(PAGED_PROMPTS)]
    for r in reqs:
        eng.submit(r)
    ag.reset_launches()
    eng.run_to_completion()
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    steps = eng.stats["prefill_dispatches"] + eng.stats["decode_dispatches"]
    return [r.out_tokens for r in reqs], steps, dict(ag.LAUNCHES)


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8"])
@pytest.mark.parametrize("page,prefix", [(8, False), (8, True), (0, False)])
def test_paged_streams_equal_dense_on_the_kernels(cuda, backend, page,
                                                  prefix):
    """Reduced qwen2-0.5b in bf16 on the kernels: the paged engine's greedy
    streams equal the dense engine's, and it launches the dense engine's
    K1 and K2 forms per step, every one on the tensor-core kernels."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                              gemm_backend=backend)
    params = lm.init_params(cfg, seed=0)
    dense, d_steps, d_launches = _serve_streams(cfg, params)
    paged, steps, launches = _serve_streams(
        cfg, params, kv_pages=24, page_size=page, prefix_cache=prefix)
    assert paged == dense
    L, k1 = cfg.n_layers, ("arrayflex_gemm" if backend == "arrayflex"
                           else "arrayflex_gemm_int8")
    assert launches == dict({name: 0 for name in ag.LAUNCHES},
                            **{k1: (6 * L + 1) * steps,
                               k1 + "_tc": (6 * L + 1) * steps,
                               "arrayflex_expert_gemm": 2 * L * steps,
                               "arrayflex_expert_gemm_tc": 2 * L * steps})
    assert d_launches[k1] == (6 * L + 1) * d_steps


# ---------------------------------------------------------------- int8 forms

def _quant_operands(g, M, K, N, dt, flags):
    def r(*s, dtype=dt):
        return torch.randn(*s, generator=g, device="cuda").to(dtype)

    q, s = substrate._quantize(r(K, N))
    kw = dict(w=q, w_scale=s)
    if flags in ("swiglu", "all"):
        kw["w2"], kw["w2_scale"] = substrate._quantize(r(K, N))
        kw["activation"] = "silu"
    if flags in ("qkv", "all"):
        kw["bias"] = r(N, dtype=torch.float32)
        kw["norm_scale"] = 1.0 + 0.1 * r(K, dtype=torch.float32)
    if flags in ("residual", "all"):
        kw["residual"] = r(M, N)
    if flags == "all":
        kw["bias2"] = r(N, dtype=torch.float32)
    return r(M, K), kw


@pytest.mark.parametrize("act_quant", [False, True], ids=["w8", "w8a8"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("mkn,flags", [
    ((4, 896, 896), "qkv"), ((4, 896, 4864), "swiglu"),
    ((4, 4864, 896), "residual"), ((1024, 896, 4864), "swiglu"),
    ((1024, 4864, 896), "residual"), ((4, 896, 152064 // 16), "none"),
    ((200, 130, 96), "all"), ((37, 300, 130), "all")])
def test_quant_gemm_matches_plain(cuda, act_quant, dt, k, mkn, flags):
    """K1(c) W8 and K1(d) W8A8 at the main path's site shapes (decode
    M = 4, the prefill chunk M = 1024) and ragged ones, one launch of the
    form's own kernel per call."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + K + N + k)
    x, kw = _quant_operands(g, M, K, N, dt, flags)
    w = kw.pop("w")
    name = "arrayflex_gemm_w8a8" if act_quant else "arrayflex_gemm_int8"
    counted = [name] + (["arrayflex_gemm_int8_tc"]       # W8 on bf16 x
                        if not act_quant and dt == torch.bfloat16 else [])
    before = dict(ag.LAUNCHES)
    got = ag.arrayflex_gemm(x, w, act_quant=act_quant, k_collapse=k, **kw)
    assert ag.LAUNCHES == dict(before, **{n: before[n] + 1 for n in counted})
    _close_step(got, ag.arrayflex_gemm_plain(x, w, act_quant=act_quant,
                                             k_collapse=k, **kw), dt)


@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", [(8, 7, 64, 256), (8, 1792, 64, 256),
                                  (3, 300, 130, 70)])
def test_expert_w8a8_matches_plain(cuda, dx, etkn):
    """K2's W8A8 form at attn.qk's decode and prefill shapes, K^T
    quantized per (batch, key column) as the substrate does."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(T + K)
    x = torch.randn(E, T, K, generator=g, device=cuda).to(dx)
    q, s = substrate._quantize(torch.randn(E, K, N, generator=g,
                                           device=cuda).to(torch.bfloat16))
    for k in (1, 2, 4):
        before = ag.LAUNCHES["arrayflex_expert_gemm_w8a8"]
        got = ag.arrayflex_expert_gemm(x, q, w_scale=s, act_quant=True,
                                       k_collapse=k, out_dtype=torch.float32)
        assert ag.LAUNCHES["arrayflex_expert_gemm_w8a8"] == before + 1
        _close(got, ag.arrayflex_expert_gemm_plain(
            x, q, w_scale=s, act_quant=True, k_collapse=k,
            out_dtype=torch.float32), torch.float32)


# the MoE expert sites at full width (E = 128 experts, one capacity row
# each at decode): moe.wi_gate / wi_up, moe.wo; and a ragged multi-step one
MOE_SHAPES = [(128, 1, 2048, 768), (128, 1, 768, 2048), (4, 9, 300, 70),
              (6, 1, 130, 70)]


@pytest.mark.parametrize("form", ["float", "int8", "w8a8"])
@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", MOE_SHAPES)
def test_expert_forms_match_plain_at_moe_shapes(cuda, form, dx, etkn):
    """K2 on the expert banks: the float form (bf16 banks, on the
    tensor-core kernel), the int8-only form (W8) and the W8A8 form, several
    main-loop steps at every k, one launch of the form's own kernel per
    call."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(T + K + N)
    x = torch.randn(E, T, K, generator=g, device=cuda).to(dx)
    w = (torch.randn(E, K, N, generator=g, device=cuda) * K ** -0.5).to(
        torch.bfloat16 if form == "float" else torch.float32)
    if form == "float":
        x, kw, name = x.to(torch.bfloat16), {}, "arrayflex_expert_gemm"
    else:
        w, s = substrate._quantize(w)
        kw = dict(w_scale=s, act_quant=form == "w8a8")
        name = f"arrayflex_expert_gemm_{form}"
    counted = [name] + (["arrayflex_expert_gemm_tc"] if form == "float"
                        else [])
    for k in (1, 2, 4):
        before = dict(ag.LAUNCHES)
        got = ag.arrayflex_expert_gemm(x, w, k_collapse=k,
                                       out_dtype=torch.float32, **kw)
        assert ag.LAUNCHES == dict(before,
                                   **{n: before[n] + 1 for n in counted})
        _close(got, ag.arrayflex_expert_gemm_plain(
            x, w, k_collapse=k, out_dtype=torch.float32, **kw),
            torch.float32)


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8",
                                     "arrayflex_w8a8"])
def test_moe_engine_launches_every_kernel(cuda, backend):
    """Reduced qwen3-moe-30b-a3b: per layer 4 attention K1, the router on
    the float K1, attn.qk/attn.pv on K2 and the three expert sites on the
    backend's K2 form; the unembed once per step.  Every bf16 float-form
    launch (and every W8 K1 launch) is on a tensor-core kernel, the fp32
    router on the FFMA K1."""
    L, steps = _serve_reduced(backend, "qwen3-moe-30b-a3b")
    want = {name: 0 for name in ag.LAUNCHES}
    if backend == "arrayflex":
        want.update(arrayflex_gemm=(5 * L + 1) * steps,
                    arrayflex_gemm_tc=(4 * L + 1) * steps,
                    arrayflex_expert_gemm=5 * L * steps,
                    arrayflex_expert_gemm_tc=5 * L * steps)
    elif backend == "arrayflex_int8":
        want.update(arrayflex_gemm_int8=(4 * L + 1) * steps,
                    arrayflex_gemm_int8_tc=(4 * L + 1) * steps,
                    arrayflex_gemm=L * steps,
                    arrayflex_expert_gemm_int8=3 * L * steps,
                    arrayflex_expert_gemm=2 * L * steps,
                    arrayflex_expert_gemm_tc=2 * L * steps)
    else:
        want.update(arrayflex_gemm_w8a8=(4 * L + 1) * steps,
                    arrayflex_gemm=L * steps,
                    arrayflex_expert_gemm_w8a8=4 * L * steps,
                    arrayflex_expert_gemm=L * steps,
                    arrayflex_expert_gemm_tc=L * steps)
    assert ag.LAUNCHES == want


def test_quant_kernel_refuses_float_weights(cuda):
    x = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        ag.arrayflex_gemm(x, torch.zeros(8, 4, device=cuda),
                          w_scale=torch.ones(4, device=cuda))


@pytest.mark.parametrize("backend", ["arrayflex_int8", "arrayflex_w8a8"])
def test_quant_engine_launches_every_kernel(cuda, backend):
    """Every weight GEMM on the form's kernel (W8 on bf16 x: the tensor-core
    kernel); attn.qk on K2's W8A8 form under arrayflex_w8a8, on the float
    K2 otherwise; attn.pv on the float K2 (bf16 operands: the tensor-core
    kernel)."""
    L, steps = _serve_reduced(backend)
    want = {name: 0 for name in ag.LAUNCHES}
    if backend == "arrayflex_int8":
        want.update(arrayflex_gemm_int8=(6 * L + 1) * steps,
                    arrayflex_gemm_int8_tc=(6 * L + 1) * steps,
                    arrayflex_expert_gemm=2 * L * steps,
                    arrayflex_expert_gemm_tc=2 * L * steps)
    else:
        want.update(arrayflex_gemm_w8a8=(6 * L + 1) * steps,
                    arrayflex_expert_gemm_w8a8=L * steps,
                    arrayflex_expert_gemm=L * steps,
                    arrayflex_expert_gemm_tc=L * steps)
    assert ag.LAUNCHES == want


# W8 K1 on bf16 x (the tensor-core kernel on int8 codes) at every W8 site
# shape of both models: qwen2-0.5b at decode (M = 4) and at the prefill
# chunk (M = 1024), qwen3-moe-30b-a3b at decode; the unembed keeps B rows
# (fp32 logits); then ragged M / N / K
W8_TC_SITES = [
    ((4, 896, 896), "qkv"), ((4, 896, 128), "qkv"), ((4, 896, 4864), "swiglu"),
    ((4, 4864, 896), "residual"), ((4, 896, 152064), "f32_out"),
    ((1024, 896, 896), "qkv"), ((1024, 896, 128), "qkv"),
    ((1024, 896, 4864), "swiglu"), ((1024, 4864, 896), "residual"),
    ((4, 2048, 4096), "qkv"), ((4, 2048, 512), "qkv"),
    ((4, 4096, 2048), "residual"), ((4, 2048, 152064), "f32_out"),
    ((37, 130, 200), "all"), ((5, 100, 36), "all"), ((300, 264, 136), "all"),
    ((16, 72, 24), "swiglu")]


def _w8_tc_operands(g, M, K, N, flags):
    x, kw = _quant_operands(g, M, K, N, torch.bfloat16,
                            "none" if flags == "f32_out" else flags)
    if flags == "f32_out":
        kw["out_dtype"] = torch.float32
    return x, kw


@pytest.mark.parametrize("mkn,flags", W8_TC_SITES)
def test_w8_tc_bit_identical_across_k(cuda, mkn, flags):
    """W8 on bf16 x runs the tensor-core kernel (one launch each, counted
    under both ``arrayflex_gemm_int8`` and ``arrayflex_gemm_int8_tc``); its
    accumulators take their k16 products in increasing K order whatever
    k_collapse, so the output is the same bits at k = 1, 2, 4; and it holds
    the plain version within one bf16 step at max |value|."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + 7 * K + N)
    x, kw = _w8_tc_operands(g, M, K, N, flags)
    w = kw.pop("w")
    outs = []
    for k in (1, 2, 4):
        before = dict(ag.LAUNCHES)
        outs.append(ag.arrayflex_gemm(x, w, k_collapse=k, **kw))
        assert ag.LAUNCHES == dict(
            before, arrayflex_gemm_int8=before["arrayflex_gemm_int8"] + 1,
            arrayflex_gemm_int8_tc=before["arrayflex_gemm_int8_tc"] + 1)
    torch.cuda.synchronize()
    for k, got in zip((2, 4), outs[1:]):
        assert torch.equal(got, outs[0]), f"k={k} differs from k=1"
    _close_step(outs[0], ag.arrayflex_gemm_plain(x, w, **kw),
                kw.get("out_dtype", torch.bfloat16))


@pytest.mark.parametrize("mkn", [(4, 896, 4864), (1024, 896, 4864),
                                 (37, 130, 200), (300, 264, 136)])
def test_w8_tc_misaligned_base(cuda, mkn):
    """x, the residual and the int8 codes (w and w2) off their 16-byte
    boundary stage through the scalar path of the same kernel: the same
    bits as the aligned copies, with the dual swiglu's two scales, both
    biases and the residual."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + K + 3 * N)
    x, kw = _w8_tc_operands(g, M, K, N, "all")
    w = kw.pop("w")

    def shifted(t):                     # same values, base one element off
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    want = ag.arrayflex_gemm(x, w, k_collapse=2, **kw)
    got = ag.arrayflex_gemm(shifted(x), shifted(w), k_collapse=2,
                            **dict(kw, w2=shifted(kw["w2"]),
                                   residual=shifted(kw["residual"])))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _close_step(got, ag.arrayflex_gemm_plain(x, w, **kw), torch.bfloat16)


# W8 K1 on fp32 x at M <= 16 (the narrow FFMA tile on int8 codes): every
# W8 decode site of qwen2-0.5b (qkv with bias and norm scale, the dual
# swiglu with w2_scale, mlp.wo with its residual, the unembed with fp32
# logits) and of qwen3-moe-30b-a3b, ragged M / K / N with every epilogue
# flag, then the 64- and 128-column widths (M > 4 at a wide N; the dual at
# 16384 columns)
W8_F32_SITES = [
    ((4, 896, 896), "qkv"), ((4, 896, 128), "qkv"), ((4, 896, 4864), "swiglu"),
    ((4, 4864, 896), "residual"), ((4, 896, 152064), "f32_out"),
    ((4, 2048, 4096), "qkv"), ((4, 2048, 512), "qkv"),
    ((4, 4096, 2048), "residual"), ((4, 2048, 152064), "f32_out"),
    ((3, 37, 130), "all"), ((7, 2050, 60), "all"), ((16, 1000, 130), "all"),
    ((8, 96, 20000), "all"), ((16, 300, 9000), "residual"),
    ((4, 256, 16384), "all")]


def _w8_f32_operands(g, M, K, N, flags):
    x, kw = _quant_operands(g, M, K, N, torch.float32,
                            "none" if flags == "f32_out" else flags)
    if flags == "f32_out":
        kw["out_dtype"] = torch.float32
    return x, kw


@pytest.mark.parametrize("mkn,flags", W8_F32_SITES)
def test_w8_fp32_narrow_bit_identical_across_k(cuda, mkn, flags):
    """W8 on fp32 x at decode runs the narrow FFMA tile on the int8 codes
    (one ``arrayflex_gemm_int8`` launch each, none on a tensor-core
    kernel): fixed K slices of fmaf chains on codes widened exactly to
    fp32, the scales first at the store, so the same bits at k = 1, 2, 4,
    8; and within 1e-5 of max |plain| (fp32 sums in another order)."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + 5 * K + N)
    x, kw = _w8_f32_operands(g, M, K, N, flags)
    w = kw.pop("w")
    outs = []
    for k in (1, 2, 4, 8):
        before = dict(ag.LAUNCHES)
        outs.append(ag.arrayflex_gemm(x, w, k_collapse=k, **kw))
        assert ag.LAUNCHES == dict(
            before, arrayflex_gemm_int8=before["arrayflex_gemm_int8"] + 1)
    torch.cuda.synchronize()
    for k, got in zip((2, 4, 8), outs[1:]):
        assert torch.equal(got, outs[0]), f"k={k} differs from k=1"
    _close(outs[0], ag.arrayflex_gemm_plain(x, w, **kw), torch.float32)


@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("mkn", [(4, 896, 896), (4, 896, 4864),
                                 (3, 37, 130), (4, 256, 16384),
                                 (8, 96, 20000)])
def test_fp32_narrow_misaligned_base(cuda, form, mkn):
    """fp32 x, the residual and w / w2 (fp32 or int8 codes) one element off
    their 16-byte boundary stage through the narrow tile's scalar path
    into the same main loop: the same bits as the aligned copies, with the
    dual swiglu's scales, both biases and the residual."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + K + 7 * N)
    x, kw = _quant_operands(g, M, K, N, torch.float32, "all")
    if form == "float":                 # the dequantized weights
        s, s2 = kw.pop("w_scale"), kw.pop("w2_scale")
        kw["w"], kw["w2"] = kw["w"].float() * s, kw["w2"].float() * s2
    w = kw.pop("w")

    def shifted(t):                     # same values, base one element off
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    want = ag.arrayflex_gemm(x, w, k_collapse=2, **kw)
    got = ag.arrayflex_gemm(shifted(x), shifted(w), k_collapse=2,
                            **dict(kw, w2=shifted(kw["w2"]),
                                   residual=shifted(kw["residual"])))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _close(got, ag.arrayflex_gemm_plain(x, w, **kw), torch.float32)


# fp32 K2 at T <= 16 (the narrow FFMA tile): the fp32 MoE banks (128
# experts of one capacity row), qwen2-0.5b's decode attn.qk / attn.pv (B x
# KV = 8, g = 7 query rows) and qwen3-moe-30b-a3b's (16 x 8, max_seq 64),
# then ragged T / K / N and 16 rows
K2_NARROW_SHAPES = [(128, 1, 2048, 768), (128, 1, 768, 2048),
                    (8, 7, 64, 256), (8, 7, 256, 64), (16, 8, 128, 64),
                    (16, 8, 64, 128), (3, 5, 130, 70), (5, 1, 100, 36),
                    (2, 16, 1000, 130)]


def _f32_expert_operands(g, E, T, K, N, dw):
    x = torch.randn(E, T, K, generator=g, device="cuda")
    w = (torch.randn(E, K, N, generator=g, device="cuda") * K ** -0.5).to(dw)
    return x, w


@pytest.mark.parametrize("dw", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", K2_NARROW_SHAPES)
def test_fp32_expert_narrow_bit_identical_across_k(cuda, dw, etkn):
    """fp32 K2 at T <= 16 sums fixed K slices (one warp each, each an fmaf
    chain in increasing K order) and adds the slices in order: the same
    bits at k = 1, 2, 4, one launch of the FFMA K2 each (none on the
    tensor cores), and within 1e-5 of max |plain| (fp32 sums in another
    order); bf16 w (a bf16 K/V cache) widens exactly."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E + T + K + N)
    x, w = _f32_expert_operands(g, E, T, K, N, dw)
    outs = []
    for k in (1, 2, 4):
        before = dict(ag.LAUNCHES)
        outs.append(ag.arrayflex_expert_gemm(x, w, k_collapse=k))
        assert ag.LAUNCHES == dict(
            before, arrayflex_expert_gemm=before["arrayflex_expert_gemm"] + 1)
    torch.cuda.synchronize()
    for k, got in zip((2, 4), outs[1:]):
        assert torch.equal(got, outs[0]), f"k={k} differs from k=1"
    _close(outs[0], ag.arrayflex_expert_gemm_plain(x, w), torch.float32)


@pytest.mark.parametrize("dw", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", [(128, 1, 2048, 768), (128, 1, 768, 2048),
                                  (8, 7, 64, 256), (7, 3, 130, 70)])
def test_fp32_expert_narrow_bits_do_not_depend_on_E(cuda, dw, etkn):
    """An expert's output in an E-expert launch is the same bits as its
    own one-expert launch, including experts whose base is not 16-byte
    aligned in the E-expert tensor (T * K not a multiple of 4: they stage
    through the scalar path there), at fp32 and at bf16 output."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E * T + K + N)
    x, w = _f32_expert_operands(g, E, T, K, N, dw)
    for out in (torch.float32, torch.bfloat16):
        whole = ag.arrayflex_expert_gemm(x, w, k_collapse=4, out_dtype=out)
        for e in sorted({0, 1, E // 2, E - 1}):
            one = ag.arrayflex_expert_gemm(x[e:e + 1].clone(),
                                           w[e:e + 1].clone(), k_collapse=4,
                                           out_dtype=out)
            torch.cuda.synchronize()
            assert torch.equal(whole[e:e + 1], one), (out, e)


# K2's int8-only form at T <= 16 (the narrow FFMA tile on int8 codes, x
# staged in its own type): the MoE banks at decode (128 experts of one
# capacity row) and at T = 4, 5 and 16, then ragged K and N on a few
# experts (the 16- to 64-column widths)
K2_INT8_NARROW_SHAPES = [(128, 1, 2048, 768), (128, 1, 768, 2048),
                         (128, 4, 2048, 768), (128, 5, 768, 2048),
                         (128, 16, 2048, 768), (5, 1, 100, 36),
                         (3, 4, 130, 70), (4, 5, 37, 200), (6, 16, 1000, 130)]


def _int8_expert_operands(g, E, T, K, N, dx):
    x = torch.randn(E, T, K, generator=g, device="cuda").to(dx)
    q, s = substrate._quantize(torch.randn(E, K, N, generator=g,
                                           device="cuda") * K ** -0.5)
    return x, q, s


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", K2_INT8_NARROW_SHAPES)
def test_int8_expert_narrow_bit_identical_across_k(cuda, out, dx, etkn):
    """K2's int8-only form at T <= 16 sums fixed K slices (one warp each,
    an fmaf chain in increasing K order on codes widened exactly to fp32,
    fp32 or bf16 x widened exactly) and adds the slices in order, each
    expert's scales first at the store: the same bits at k = 1, 2, 4, one
    ``arrayflex_expert_gemm_int8`` launch each, and within the plain
    version's tolerance (fp32 1e-5 of max |value|, bf16 one step)."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E + 3 * T + K + N)
    x, q, s = _int8_expert_operands(g, E, T, K, N, dx)
    outs = []
    for k in (1, 2, 4):
        before = dict(ag.LAUNCHES)
        outs.append(ag.arrayflex_expert_gemm(x, q, w_scale=s, k_collapse=k,
                                             out_dtype=out))
        assert ag.LAUNCHES == dict(
            before, arrayflex_expert_gemm_int8=before[
                "arrayflex_expert_gemm_int8"] + 1)
    torch.cuda.synchronize()
    for k, got in zip((2, 4), outs[1:]):
        assert torch.equal(got, outs[0]), f"k={k} differs from k=1"
    _close_step(outs[0], ag.arrayflex_expert_gemm_plain(
        x, q, w_scale=s, out_dtype=out), out)


@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", [(128, 1, 2048, 768), (128, 1, 768, 2048),
                                  (7, 3, 131, 70), (9, 5, 77, 200)])
def test_int8_expert_narrow_bits_do_not_depend_on_E(cuda, dx, etkn):
    """An expert's output in an E-expert launch is the same bits as its
    own one-expert launch (where the width rule may pick another width),
    including experts whose x and codes are off their 16-byte boundary in
    the E-expert tensors (T * K odd: they stage through the scalar path),
    at fp32 and at bf16 output."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E * T + K + 5 * N)
    x, q, s = _int8_expert_operands(g, E, T, K, N, dx)
    for out in (torch.float32, torch.bfloat16):
        whole = ag.arrayflex_expert_gemm(x, q, w_scale=s, k_collapse=4,
                                         out_dtype=out)
        for e in sorted({0, 1, E // 2, E - 1}):
            one = ag.arrayflex_expert_gemm(
                x[e:e + 1].clone(), q[e:e + 1].clone(),
                w_scale=s[e:e + 1].clone(), k_collapse=4, out_dtype=out)
            torch.cuda.synchronize()
            assert torch.equal(whole[e:e + 1], one), (out, e)


@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", [(128, 17, 2048, 768), (4, 17, 300, 70),
                                  (128, 160, 768, 2048), (3, 40, 130, 64)])
def test_int8_expert_past_16_rows_matches_plain(cuda, dx, etkn):
    """T > 16: fp32 x on the FFMA wide tile, bf16 x on the tensor-core
    tile (``af_expert_gemm_q_tc``, also counted under
    ``arrayflex_expert_gemm_int8_tc``); one launch each, the same bits at
    k = 1, 2, 4, and the fp32 output within 1e-5 of max |plain| (bf16 x:
    the exact products summed in fp32 in another order)."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E + T + K + N)
    x, q, s = _int8_expert_operands(g, E, T, K, N, dx)
    tc = int(dx == torch.bfloat16)
    outs = []
    for k in (1, 2, 4):
        before = dict(ag.LAUNCHES)
        outs.append(ag.arrayflex_expert_gemm(x, q, w_scale=s, k_collapse=k,
                                             out_dtype=torch.float32))
        assert ag.LAUNCHES == dict(
            before, arrayflex_expert_gemm_int8=before[
                "arrayflex_expert_gemm_int8"] + 1,
            arrayflex_expert_gemm_int8_tc=before[
                "arrayflex_expert_gemm_int8_tc"] + tc)
    torch.cuda.synchronize()
    for k, got in zip((2, 4), outs[1:]):
        assert torch.equal(got, outs[0]), f"k={k} differs from k=1"
    _close(outs[0], ag.arrayflex_expert_gemm_plain(
        x, q, w_scale=s, out_dtype=torch.float32), torch.float32)


@pytest.mark.parametrize("etkn", [(128, 160, 2048, 768), (7, 33, 131, 70),
                                  (8, 40, 64, 200)])
def test_int8_expert_tc_bits_do_not_depend_on_E(cuda, etkn):
    """The int8 banks above 16 rows on bf16 x (the tensor-core tile): an
    expert's output in an E-expert launch is the same bits as its own
    one-expert launch, including experts whose x and codes are off their
    16-byte boundary in the E-expert tensors (T * K odd), at fp32 and bf16
    output, and holds the plain version within one bf16 step."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E * T + K + 3 * N)
    x, q, s = _int8_expert_operands(g, E, T, K, N, torch.bfloat16)
    for out in (torch.float32, torch.bfloat16):
        whole = ag.arrayflex_expert_gemm(x, q, w_scale=s, k_collapse=2,
                                         out_dtype=out)
        _close_step(whole, ag.arrayflex_expert_gemm_plain(
            x, q, w_scale=s, out_dtype=out), torch.bfloat16)
        for e in sorted({0, 1, E // 2, E - 1}):
            one = ag.arrayflex_expert_gemm(
                x[e:e + 1].clone(), q[e:e + 1].clone(),
                w_scale=s[e:e + 1].clone(), k_collapse=2, out_dtype=out)
            torch.cuda.synchronize()
            assert torch.equal(whole[e:e + 1], one), (out, e)


# The FFMA wide tile above 16 rows (fp32 x): K1 fp32 and W8 at the
# 2048-token prefill's sites of qwen2-0.5b, the dual swiglu, ragged M / N
# / K (a 17-row tile, N = 65, K = 37), N <= 64 (the 64-column tile)
WIDE_SHAPES = [(2048, 896, 896), (2048, 896, 128), (300, 896, 4864),
               (1024, 4864, 896), (17, 130, 200), (129, 37, 65),
               (40, 300, 64), (200, 64, 33)]


@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("mkn", WIDE_SHAPES)
@pytest.mark.parametrize("flags", ["none", "qkv", "swiglu",
                                   "residual_bf16_out"])
def test_ffma_wide_tile_bit_identical_across_k(cuda, form, mkn, flags):
    """K1 on fp32 x above 16 rows keeps each output one fmaf chain from 0
    in increasing K order: the same bits at k = 1, 2, 4, 8 (a step holds
    at most three fp32 sub-tiles of the 128-row tile, seven of the 64-row
    one: k = 8 is cut to them), one launch each on the FFMA kernel, and
    within 1e-5 of max |plain|."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + 5 * K + N)

    def r(*sh):
        return torch.randn(*sh, generator=g, device=cuda)

    def weight(name):
        w = r(K, N) * K ** -0.5
        if form == "float":
            return {name: w}
        q, sc = substrate._quantize(w)
        return {name: q, f"{name}_scale": sc}

    kw = weight("w")
    kw.update({"none": {},
               "qkv": dict(bias=r(N), norm_scale=1.0 + 0.1 * r(K)),
               "swiglu": dict(weight("w2"), activation="silu",
                              norm_scale=1.0 + 0.1 * r(K)),
               "residual_bf16_out": dict(residual=r(M, N),
                                         out_dtype=torch.bfloat16)}[flags])
    x, w = r(M, K), kw.pop("w")
    name = "arrayflex_gemm" if form == "float" else "arrayflex_gemm_int8"
    outs = []
    for k in (1, 2, 4, 8):
        before = dict(ag.LAUNCHES)
        outs.append(ag.arrayflex_gemm(x, w, k_collapse=k, **kw))
        assert ag.LAUNCHES == dict(before, **{name: before[name] + 1})
    torch.cuda.synchronize()
    for k, got in zip((2, 4, 8), outs[1:]):
        assert torch.equal(got, outs[0]), f"k={k} differs from k=1"
    _close_step(outs[0], ag.arrayflex_gemm_plain(x, w, **kw),
                kw.get("out_dtype", torch.float32))


@pytest.mark.parametrize("form", ["float", "int8"])
@pytest.mark.parametrize("mkn", [(300, 264, 136), (37, 130, 200)])
def test_ffma_wide_tile_scalar_staging(cuda, form, mkn):
    """x, w, w2 and the residual 4 bytes off a 16-byte boundary (int8
    codes 1 byte off) stage through the scalar paths of the same kernel:
    the same bits as the aligned copies."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(3 * M + K + N)

    def r(*sh):
        return torch.randn(*sh, generator=g, device=cuda)

    def shifted(t):                     # same values, base one element off
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    w, w2 = r(K, N) * K ** -0.5, r(K, N) * K ** -0.5
    kw = dict(activation="silu", norm_scale=1.0 + 0.1 * r(K),
              residual=r(M, N))
    if form == "int8":
        (w, s), (w2, s2) = substrate._quantize(w), substrate._quantize(w2)
        kw.update(w_scale=s, w2_scale=s2)
    x = r(M, K)
    want = ag.arrayflex_gemm(x, w, w2=w2, k_collapse=2, **kw)
    got = ag.arrayflex_gemm(shifted(x), shifted(w), w2=shifted(w2),
                            k_collapse=2,
                            **dict(kw, residual=shifted(kw["residual"])))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _close(got, ag.arrayflex_gemm_plain(x, w, w2=w2, **kw), torch.float32)


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", [(2, 14336, 64, 2048), (2, 1792, 256, 64),
                                  (3, 40, 130, 70), (5, 17, 100, 36)])
def test_ffma_wide_expert_bit_identical_across_k(cuda, wdt, etkn):
    """K2 on fp32 x above 16 rows (fp32 w, or a bf16 cache), the FFMA wide
    tile with the expert on z: the same bits at k = 1, 2, 4, one
    ``arrayflex_expert_gemm`` launch each and none on the tensor cores,
    each expert's bits its own one-expert launch's, within 1e-5 of max
    |plain|."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E + 7 * T + K + N)
    x = torch.randn(E, T, K, generator=g, device=cuda)
    w = (torch.randn(E, K, N, generator=g, device=cuda)
         * K ** -0.5).to(wdt)
    outs = []
    for k in (1, 2, 4):
        before = dict(ag.LAUNCHES)
        outs.append(ag.arrayflex_expert_gemm(x, w, k_collapse=k))
        assert ag.LAUNCHES == dict(
            before, arrayflex_expert_gemm=before["arrayflex_expert_gemm"] + 1)
    torch.cuda.synchronize()
    for k, got in zip((2, 4), outs[1:]):
        assert torch.equal(got, outs[0]), f"k={k} differs from k=1"
    one = ag.arrayflex_expert_gemm(x[-1:].clone(), w[-1:].clone(),
                                   k_collapse=2)
    torch.cuda.synchronize()
    assert torch.equal(outs[0][-1:], one)
    _close(outs[0], ag.arrayflex_expert_gemm_plain(x, w), torch.float32)


def test_int8_expert_narrow_width_rule(cuda):
    """K2's int8-only width is K1's int8 rule with the grid counted as
    blocks x experts: 128 columns at T <= 4 where that grid fills the card
    (every MoE bank at decode), else 64, 32, 16.  Its shared memory fits
    one SM at every k and either x type; K1's tile takes fp32 x only."""
    lib = ag._lib()
    i8, f32, bf16 = 2, 0, 1
    for (T, N, E), want in {
            (1, 768, 128): 128, (1, 2048, 128): 128, (4, 768, 128): 128,
            (5, 768, 128): 64, (16, 2048, 128): 64, (1, 768, 22): 128,
            (1, 768, 21): 64, (1, 768, 1): 16, (16, 70, 3): 16,
            (4, 70, 64): 64, (4, 70, 50): 32}.items():
        assert lib.af_narrow_cols(T, N, i8, E) == want, (T, N, E)
    assert lib.af_narrow_cols(17, 768, i8, 128) == -1
    for T, K, N in [(1, 2048, 768), (1, 768, 2048), (4, 2048, 768),
                    (16, 2048, 768), (5, 37, 200)]:
        for E in (1, 128):
            for k in (1, 2, 4, 8, 64):
                for dx in (f32, bf16):
                    smem = lib.af_narrow_smem(T, N, K, k, i8, 0, E, dx)
                    assert 0 < smem <= 232448, (T, K, N, E, k, dx)
    assert lib.af_narrow_smem(4, 896, 896, 1, i8, 0, 0, bf16) == -1


# W8A8 at decode (K1 at M <= 16, K2 at T <= 16) runs the W8A8 narrow tile:
# x quantized once a block, the codes through warp rings, per-step int32
# partials folded in step order.  Its codes, scales, partials and fold are
# the plain version's operations, so where the store is the dequant alone
# (fp32 out, no bias, activation, gate or residual) the output is the plain
# version's bits.  K1's (K, N) at every W8A8 decode site of qwen2-0.5b and
# qwen3-moe-30b-a3b (the dual swiglu as one contraction here; its store is
# not dequant alone) and K2's banks and attn.qk grids.
W8A8_K1_SITES = [(896, 896), (896, 128), (896, 4864), (4864, 896),
                 (896, 152064), (2048, 4096), (2048, 512), (4096, 2048),
                 (2048, 152064)]
W8A8_K2_SITES = [(128, 1, 2048, 768), (128, 1, 768, 2048), (128, 4, 2048, 768),
                 (128, 4, 768, 2048), (128, 16, 2048, 768),
                 (128, 16, 768, 2048), (8, 7, 64, 256), (16, 8, 128, 64)]


def _w8a8_call(fn, *args, launch, **kw):
    """One call of a W8A8 wrapper: exactly one launch, counted under
    ``launch`` and nothing else."""
    before = dict(ag.LAUNCHES)
    out = fn(*args, act_quant=True, **kw)
    assert ag.LAUNCHES == dict(before, **{launch: before[launch] + 1})
    return out


@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 4, 5, 16])
@pytest.mark.parametrize("kn", W8A8_K1_SITES)
def test_w8a8_narrow_k1_bits_equal_plain(cuda, kn, M, dx):
    K, N = kn
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x, kw = _quant_operands(g, M, K, N, dx, "none")
    w = kw.pop("w")
    got = _w8a8_call(ag.arrayflex_gemm, x, w, launch="arrayflex_gemm_w8a8",
                     k_collapse=4, out_dtype=torch.float32, **kw)
    want = ag.arrayflex_gemm_plain(x, w, act_quant=True, k_collapse=4,
                                   out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 4, 5, 16])
@pytest.mark.parametrize("kn,flags", [
    ((896, 896), "qkv"), ((896, 4864), "swiglu"), ((4864, 896), "residual"),
    ((896, 152064), "none"), ((2048, 4096), "qkv"),
    ((4096, 2048), "residual"), ((300, 200), "all")])
def test_w8a8_narrow_k1_epilogue_matches_plain(cuda, kn, flags, M, dx):
    """The full store (bias and norm scale, the dual swiglu with both
    scales, the residual) in x's type at the decode sites' (K, N): within
    one step of the plain version (activations and the output cast may
    round apart)."""
    K, N = kn
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x, kw = _quant_operands(g, M, K, N, dx, flags)
    w = kw.pop("w")
    got = _w8a8_call(ag.arrayflex_gemm, x, w, launch="arrayflex_gemm_w8a8",
                     k_collapse=4, **kw)
    _close_step(got, ag.arrayflex_gemm_plain(x, w, act_quant=True,
                                             k_collapse=4, **kw), dx)


def _w8a8_bank_operands(g, E, T, K, N, dx):
    x = torch.randn(E, T, K, generator=g, device="cuda").to(dx)
    q, s = substrate._quantize(torch.randn(E, K, N, generator=g,
                                           device="cuda") * K ** -0.5)
    return x, q, s


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", W8A8_K2_SITES)
def test_w8a8_narrow_k2_bits_equal_plain(cuda, etkn, dx, out):
    """K2's store is the dequant alone, so the bits equal the plain
    version's at either output type."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E + T + K + N)
    x, q, s = _w8a8_bank_operands(g, E, T, K, N, dx)
    got = _w8a8_call(ag.arrayflex_expert_gemm, x, q, w_scale=s,
                     launch="arrayflex_expert_gemm_w8a8", k_collapse=4,
                     out_dtype=out)
    want = ag.arrayflex_expert_gemm_plain(x, q, w_scale=s, act_quant=True,
                                          k_collapse=4, out_dtype=out)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", [(128, 1, 2048, 768), (128, 1, 768, 2048),
                                  (7, 3, 131, 70), (9, 5, 77, 200)])
def test_w8a8_narrow_k2_bits_do_not_depend_on_E(cuda, dx, etkn):
    """An expert's output in an E-expert launch is the same bits as its
    own one-expert launch (where the width rule may pick another width),
    including experts whose codes are off their 16-byte boundary in the
    E-expert tensor (K * N odd: they stage through the scalar path) and
    whose x rows are (T * K odd)."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E * T + K + 3 * N)
    x, q, s = _w8a8_bank_operands(g, E, T, K, N, dx)
    whole = ag.arrayflex_expert_gemm(x, q, w_scale=s, act_quant=True,
                                     k_collapse=4, out_dtype=torch.float32)
    for e in sorted({0, 1, E // 2, E - 1}):
        one = ag.arrayflex_expert_gemm(
            x[e:e + 1].clone(), q[e:e + 1].clone(), w_scale=s[e:e + 1].clone(),
            act_quant=True, k_collapse=4, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(whole[e:e + 1], one), e


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("mkn", [(4, 300, 200), (5, 130, 70), (1, 37, 36),
                                 (16, 4864, 20000)])
def test_w8a8_narrow_ragged_steps_and_misaligned_bases(cuda, mkn, k):
    """Quantization steps that are not whole 32-row sub-tiles (K = 300 at
    k = 1: 100 columns; K = 130: 65; K = 37: one step of 37 or 40), and
    16 rows at K = 4864 with 64-column blocks, whose steps take several
    rounds of the tile's shared memory at k = 1: the plain version's bits.
    x with a row stride off the 16-byte grid and w a column slice off it
    (scalar staging) give the contiguous operands' bits."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + K + N + k)
    x, kw = _quant_operands(g, M, K, N, torch.bfloat16, "none")
    w = kw.pop("w")
    got = _w8a8_call(ag.arrayflex_gemm, x, w, launch="arrayflex_gemm_w8a8",
                     k_collapse=k, out_dtype=torch.float32, **kw)
    want = ag.arrayflex_gemm_plain(x, w, act_quant=True, k_collapse=k,
                                   out_dtype=torch.float32, **kw)
    xs = torch.zeros(M, K + 3, device=cuda, dtype=x.dtype)[:, 3:]
    xs.copy_(x)
    ws = torch.zeros(K, N + 1, device=cuda, dtype=w.dtype)[:, 1:]
    ws.copy_(w)
    off = _w8a8_call(ag.arrayflex_gemm, xs, ws, launch="arrayflex_gemm_w8a8",
                     k_collapse=k, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()
    assert torch.equal(off, got)


def test_w8a8_narrow_width_rule(cuda):
    """The W8A8 narrow tile takes the int8 width rule (``nw_cols``, the
    grid counted as blocks x experts): 128 columns at M <= 4 where that
    grid fills the card, else 64, 32, 16; its shared memory fits one SM
    for every shape, however many rounds of steps K needs; it takes no
    more than 16 rows."""
    lib = ag._lib()
    for (M, N, E), want in {
            (4, 896, 1): 16, (4, 4864, 1): 32, (4, 152064, 1): 128,
            (5, 152064, 1): 64, (16, 4096, 1): 32, (1, 768, 128): 128,
            (16, 2048, 128): 64, (7, 256, 8): 16, (8, 64, 16): 16}.items():
        assert lib.af_w8a8_cols(M, N, E) == want, (M, N, E)
        assert lib.af_w8a8_cols(M, N, E) == lib.af_narrow_cols(M, N, 2, E)
    assert lib.af_w8a8_cols(17, 896, 1) == -1
    for M, K, N, E in [(4, 896, 4864, 1), (4, 4864, 896, 1),
                       (4, 896, 152064, 1), (16, 4864, 20000, 1),
                       (16, 14336, 8192, 1), (1, 2048, 768, 128),
                       (16, 768, 2048, 128), (7, 64, 256, 8)]:
        for k in (1, 2, 4, 8):
            qkk = ag.quant_tiles(M, K, k)[1]
            for dual in ((0, 1) if E == 1 else (0,)):
                smem = lib.af_w8a8_smem(M, N, K, qkk, dual, E)
                assert 0 < smem <= 232448, (M, K, N, E, k, dual)
    assert lib.af_w8a8_smem(17, 896, 896, 448, 0, 1) == -1


# ---------------------------------------------------------------- W8A8 > 16

# W8A8 above 16 rows (K1 at the prefill chunk, K2's attn.qk at g x chunk
# query rows) runs the quantize pass into scratch and then the int8
# tensor-core tile: the plain version's codes, scales, exact int32
# partials and fold, so where the store is the dequant alone the output is
# its bits, in either output type.  K1's (K, N) at every prefill-chunk site
# of qwen2-0.5b (the dual as one contraction here; its store is not the
# dequant alone).
W8A8_TC_K1_SITES = [(896, 896), (896, 128), (896, 4864), (4864, 896)]


def _norm_scale(g, K):
    return 1.0 + 0.1 * torch.randn(K, generator=g, device="cuda")


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kn", W8A8_TC_K1_SITES)
def test_w8a8_tc_k1_bits_equal_plain(cuda, kn, dx, out):
    """The prefill chunk's 1024 rows at each site's (K, N), with the
    rmsnorm scale in the prologue, at k = 1, 2, 4: the plain version's
    bits, one launch a call."""
    K, N = kn
    g = torch.Generator(device=cuda).manual_seed(K + N)
    x, kw = _quant_operands(g, 1024, K, N, dx, "none")
    w = kw.pop("w")
    kw["norm_scale"] = _norm_scale(g, K)
    for k in (1, 2, 4):
        got = _w8a8_call(ag.arrayflex_gemm, x, w,
                         launch="arrayflex_gemm_w8a8", k_collapse=k,
                         out_dtype=out, **kw)
        want = ag.arrayflex_gemm_plain(x, w, act_quant=True, k_collapse=k,
                                       out_dtype=out, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (k, (got.float() - want.float())
                                        .abs().max().item())


@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkn,flags", [
    ((1024, 896, 896), "qkv"), ((1024, 896, 128), "qkv"),
    ((1024, 896, 4864), "swiglu"), ((1024, 4864, 896), "residual"),
    ((130, 300, 70), "all"), ((1000, 300, 70), "all")])
def test_w8a8_tc_k1_epilogue_matches_plain(cuda, mkn, flags, dx):
    """The full store (bias and norm scale, the dual swiglu with both
    scales, the residual, all at once) in x's type: within one step of
    the plain version (activations and the output cast may round
    apart)."""
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x, kw = _quant_operands(g, M, K, N, dx, flags)
    w = kw.pop("w")
    for k in (1, 2, 4):
        got = _w8a8_call(ag.arrayflex_gemm, x, w,
                         launch="arrayflex_gemm_w8a8", k_collapse=k, **kw)
        _close_step(got, ag.arrayflex_gemm_plain(x, w, act_quant=True,
                                                 k_collapse=k, **kw), dx)


@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("M", [17, 130, 1000])
def test_w8a8_tc_ragged_and_misaligned(cuda, M, k, dx):
    """Ragged M (one short row tile, a last row tile of 2 or 104 rows), N
    = 70 and K = 300 (quantization steps of 100, 152, 300 or 304 columns:
    none a whole number of 32-column sub-tiles): the plain version's
    bits, fp32 and bf16 out.  x with a row stride off the 16-byte grid
    (the quantize pass's scalar loads) and w a column slice off it (the
    tile's scalar staging) give the contiguous operands' bits."""
    K, N = 300, 70
    g = torch.Generator(device=cuda).manual_seed(M + k)
    x, kw = _quant_operands(g, M, K, N, dx, "none")
    w = kw.pop("w")
    kw["norm_scale"] = _norm_scale(g, K)
    xs = torch.zeros(M, K + 3, device=cuda, dtype=x.dtype)[:, 3:]
    xs.copy_(x)
    ws = torch.zeros(K, N + 1, device=cuda, dtype=w.dtype)[:, 1:]
    ws.copy_(w)
    for out in (torch.float32, torch.bfloat16):
        got = _w8a8_call(ag.arrayflex_gemm, x, w,
                         launch="arrayflex_gemm_w8a8", k_collapse=k,
                         out_dtype=out, **kw)
        want = ag.arrayflex_gemm_plain(x, w, act_quant=True, k_collapse=k,
                                       out_dtype=out, **kw)
        off = _w8a8_call(ag.arrayflex_gemm, xs, ws,
                         launch="arrayflex_gemm_w8a8", k_collapse=k,
                         out_dtype=out, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (out, (got.float() - want.float())
                                        .abs().max().item())
        assert torch.equal(off, got), out


# K2's W8A8 above 16 query rows: attn.qk at the prefill chunk (E = B x KV
# = 8, T = g x chunk = 1792, K = head_dim 64, N = max_seq 256), a ragged T
# above 128 with a K that is not a whole sub-tile, and T = 17
W8A8_TC_K2_SITES = [(8, 1792, 64, 256), (3, 300, 130, 70), (2, 17, 64, 40)]


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", W8A8_TC_K2_SITES)
def test_w8a8_tc_k2_bits_equal_plain(cuda, etkn, dx, out):
    """K2's store is the dequant alone, so the bits equal the plain
    version's at either output type and k = 1, 2, 4."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E + T + K + N)
    x, q, s = _w8a8_bank_operands(g, E, T, K, N, dx)
    for k in (1, 2, 4):
        got = _w8a8_call(ag.arrayflex_expert_gemm, x, q, w_scale=s,
                         launch="arrayflex_expert_gemm_w8a8", k_collapse=k,
                         out_dtype=out)
        want = ag.arrayflex_expert_gemm_plain(x, q, w_scale=s,
                                              act_quant=True, k_collapse=k,
                                              out_dtype=out)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (k, (got.float() - want.float())
                                        .abs().max().item())


@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("etkn", [(8, 1792, 64, 256), (7, 37, 131, 70),
                                  (5, 300, 77, 201)])
def test_w8a8_tc_k2_bits_do_not_depend_on_E(cuda, dx, etkn):
    """An expert's output in an E-expert launch is the same bits as its
    own one-expert launch, including experts whose codes are off their
    16-byte boundary in the E-expert tensor (K * N odd: the tile's scalar
    staging) and whose x rows are (T * K odd: the quantize pass's scalar
    loads)."""
    E, T, K, N = etkn
    g = torch.Generator(device=cuda).manual_seed(E * T + K + 3 * N)
    x, q, s = _w8a8_bank_operands(g, E, T, K, N, dx)
    whole = ag.arrayflex_expert_gemm(x, q, w_scale=s, act_quant=True,
                                     k_collapse=2, out_dtype=torch.float32)
    for e in sorted({0, 1, E // 2, E - 1}):
        one = ag.arrayflex_expert_gemm(
            x[e:e + 1].clone(), q[e:e + 1].clone(), w_scale=s[e:e + 1].clone(),
            act_quant=True, k_collapse=2, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(whole[e:e + 1], one), e


@pytest.mark.parametrize("dx", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", [
    ((1024, 896), 2), ((1024, 4864), 2), ((1024, 896), 4), ((130, 300), 1),
    ((17, 300), 8), ((8, 1792, 64), 2), ((3, 37, 131), 4)])
def test_w8a8_quantize_pass_equals_plain(cuda, shape, k, dx):
    """The quantize pass alone: its codes (each step padded to whole
    32-column sub-tiles, each group in ``w8a8_code_cols``'s order) and its
    scales (one a row tile and step) are the plain model's bits, with the
    rmsnorm scale in the prologue for K1; it counts no launch."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + k)
    x = torch.randn(*shape, generator=g, device=cuda).to(dx)
    gs = _norm_scale(g, shape[-1]) if len(shape) == 2 else None
    before = dict(ag.LAUNCHES)
    codes, scales = ag.w8a8_quantize(x, norm_scale=gs, k_collapse=k)
    assert ag.LAUNCHES == before
    want_c, want_s = ag.w8a8_quantize_plain(ag.prologue_phase(x, gs), k)
    torch.cuda.synchronize()
    assert torch.equal(scales, want_s)
    assert torch.equal(codes, want_c)


def _af_gemm_q_w8a8(x, w, s, out, quant_bm, quant_kk, scratch, nbytes):
    """One direct call of the C entry af_gemm_q under W8A8 (no bias,
    residual or g); returns its code."""
    M, K = x.shape
    N = w.shape[1]
    return ag._lib().af_gemm_q(
        ag._DTYPE_CODE[x.dtype], ag._DTYPE_CODE[out.dtype], 1, x.data_ptr(),
        w.data_ptr(), None, s.data_ptr(), None, None, None, None, None,
        out.data_ptr(), M, N, K, K, N, 0, N, 1, 0, quant_bm, quant_kk,
        None if scratch is None else scratch.data_ptr(), nbytes,
        torch.cuda.current_stream().cuda_stream)


def test_w8a8_tc_scratch_width_and_refusals(cuda):
    """The C entry's scratch size is the wrapper's (``w8a8_scratch``); the
    width rule: 64 columns at the 1024-row chunk's 896- and 128-wide sites
    and the dual, 128 where the 128 x 128 grid fills the card (attn.qk at
    the chunk: 8 experts); shared memory fits one SM; a quant_bm that
    splits a 128-row block, too small a scratch and 16 rows or fewer are
    refused, and a refused call writes nothing."""
    lib = ag._lib()
    for M, K, k, E in [(1024, 896, 2, 1), (1024, 4864, 2, 1),
                       (1024, 896, 4, 1), (1792, 64, 2, 8), (130, 300, 1, 1),
                       (17, 300, 8, 3), (1000, 300, 4, 1)]:
        lay = ag.w8a8_scratch(M, K, k, E)
        assert lib.af_w8a8_scratch_bytes(M, K, lay["bm"], lay["kk"],
                                         E) == lay["nbytes"], (M, K, k, E)
    for (M, N, dual, E), want in {
            (1024, 896, 0, 1): 64, (1024, 128, 0, 1): 64,
            (1024, 4864, 1, 1): 64, (1024, 4864, 0, 1): 128,
            (1792, 256, 0, 8): 128, (17, 70, 0, 1): 64}.items():
        assert lib.af_w8a8_tc_cols(M, N, dual, E) == want, (M, N, dual, E)
    assert lib.af_w8a8_tc_cols(16, 896, 0, 1) == -1
    for M, N, K, dual, E in [(1024, 896, 896, 0, 1), (1024, 4864, 896, 1, 1),
                             (1024, 4864, 896, 0, 1), (1792, 256, 64, 0, 8)]:
        bm, kk = ag.quant_tiles(M, K, 2)
        assert 0 < lib.af_w8a8_tc_smem(M, N, K, bm, kk, dual, E) <= 232448
    assert lib.af_w8a8_tc_smem(1024, 896, 896, 64, 224, 0, 1) == -1
    assert lib.af_w8a8_tc_smem(1024, 896, 896, 256, 224, 0, 1) > 0
    g = torch.Generator(device=cuda).manual_seed(7)
    x, kw = _quant_operands(g, 1024, 896, 128, torch.bfloat16, "none")
    out = torch.full((1024, 128), 3.0, device=cuda)
    lay = ag.w8a8_scratch(1024, 896, 2)
    scratch = torch.empty(lay["nbytes"], dtype=torch.uint8, device=cuda)
    assert _af_gemm_q_w8a8(x, kw["w"], kw["w_scale"], out, 64, lay["kk"],
                           scratch, lay["nbytes"]) != 0
    assert _af_gemm_q_w8a8(x, kw["w"], kw["w_scale"], out, 128, lay["kk"],
                           scratch, lay["nbytes"] - 1) != 0
    assert _af_gemm_q_w8a8(x, kw["w"], kw["w_scale"], out, 128, lay["kk"],
                           None, 0) != 0
    torch.cuda.synchronize()
    assert bool((out == 3.0).all())
    assert _af_gemm_q_w8a8(x, kw["w"], kw["w_scale"], out, 128, lay["kk"],
                           scratch, lay["nbytes"]) == 0
    want = ag.arrayflex_gemm_plain(x, kw["w"], w_scale=kw["w_scale"],
                                   act_quant=True, k_collapse=2,
                                   out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


# ---------------------------------------------------------------- K3

# (BH, S, T, D, causal, window): chip_smoke.py's shapes cut in BH, the
# ragged two-chunk case (T = 4097: chunks of 4096 and 1), a window, and
# rows that see no column (non-causal window with S > T)
FLASH_CASES = [(8, 256, 256, 64, True, 0), (2, 4096, 4096, 64, True, 0),
               (2, 1024, 1024, 128, True, 0), (4, 128, 4097, 64, False, 0),
               (2, 4096, 4096, 64, True, 512), (2, 512, 256, 64, False, 64),
               (3, 96, 200, 32, False, 0)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_flash_attention_matches_plain(cuda, dt, case):
    """One launch of K3 per ops.attention call, at the planner's chunk,
    against the plain version; rows that see no column come out exactly
    0.  Tolerance: ``_close_step`` (fp32 1e-5; bf16 one step at max
    |value|: p is rounded to bf16 against the same chunk max in both)."""
    BH, S, T, D, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(S + T + D)
    q, k, v = (torch.randn(BH, n, D, generator=g, device=cuda).to(dt)
               for n in (S, T, T))
    before = dict(fa.LAUNCHES)
    got = ops.attention(q, k, v, causal=causal, window=window)
    tc = int(dt == torch.bfloat16)          # the tensor-core kernel ran
    assert fa.LAUNCHES == dict(
        flash_attention=before["flash_attention"] + 1,
        flash_attention_tc=before["flash_attention_tc"] + tc)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    kv_chunk=planner.attention_plan(S, T))
    _close_step(got, want, dt)
    dead = want.float().abs().amax(dim=-1) == 0
    assert torch.equal(got[dead], torch.zeros_like(got[dead]))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("case", [(14, 128, 4097, 64, False, 0),
                                  (4, 128, 4097, 64, False, 0),
                                  (4, 128, 4097, 128, True, 0),
                                  (2, 256, 3000, 32, False, 700)],
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_split_matches_unsplit(cuda, case):
    """Short S, long T: the split path (the ragged case's kv_splits count,
    and 2 and 7 splits) against the unsplit tensor-core kernel and the
    plain version, one bf16 step at max |value|; rows that see no column
    come out exactly 0."""
    BH, S, T, D, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(BH + S + T + D)
    q, k, v = (torch.randn(BH, n, D, generator=g, device=cuda).to(
        torch.bfloat16) for n in (S, T, T))
    kc = planner.attention_plan(S, T)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    auto = fa.kv_splits(BH, S, T, kc, n_sm)
    if (BH, S, T) == (14, 128, 4097):
        assert auto > 1
    whole = fa._launch(q, k, v, causal, window, kc, 1)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    kv_chunk=kc)
    _close_step(whole, want, torch.bfloat16)
    dead = want.float().abs().amax(dim=-1) == 0
    for n in sorted({auto, 2, 7}):
        before = dict(fa.LAUNCHES)
        got = fa._launch(q, k, v, causal, window, kc, n)
        assert fa.LAUNCHES == {key: val + 1 for key, val in before.items()}
        _close_step(got, whole, torch.bfloat16)
        _close_step(got, want, torch.bfloat16)
        assert torch.equal(got[dead], torch.zeros_like(got[dead]))
        assert bool(torch.isfinite(got).all())


def test_flash_attention_fp32_rescales_per_subtile(cuda):
    """fp32 K3 takes one pass with the running max rescaled per 64-column
    sub-tile.  Scores spanning about +-80 (s = 8 a_row b_col, a in [-1, 1],
    b rising or falling across the keys) move a row's max in sub-tile
    after sub-tile and across two planner chunks, so earlier sums rescale
    by factors down to exp(-160); held to 1e-5 of max |value| against the
    chunk-max plain version, finite, causal rows past the first key
    included."""
    BH, S, D = 4, 1024, 64
    g = torch.Generator(device=cuda).manual_seed(11)
    a = torch.rand(BH, S, 1, generator=g, device=cuda) * 2 - 1
    b = torch.linspace(-10, 10, S, device=cuda).view(1, S, 1).repeat(
        BH, 1, 1)
    b[1::2] = b[1::2].flip(1)               # falling keys on odd heads
    noise = 0.05 * torch.randn(BH, S, D, generator=g, device=cuda)
    q = (a + 0.01 * torch.randn(BH, S, D, generator=g, device=cuda)
         ).contiguous()
    k = (b + noise).contiguous()
    v = torch.randn(BH, S, D, generator=g, device=cuda)
    s = torch.einsum("bsd,btd->bst", q, k) / math.sqrt(D)
    assert s.max().item() > 70 and s.min().item() < -70
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=True, kv_chunk=512)
    assert fa.LAUNCHES == dict(
        before, flash_attention=before["flash_attention"] + 1)
    want = fa.flash_attention_plain(q, k, v, causal=True, kv_chunk=512)
    _close(got, want, torch.float32)
    assert bool(torch.isfinite(got).all())


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 64, 256, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 64, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, q.to(torch.bfloat16), q)


@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_prefill_matches_ref_backend(cuda, path):
    """Full-width qwen2-0.5b at 2 layers, fp32: ``lm.prefill`` on the
    kernels against the ``ref`` backend (1e-4 of max |logit|), K1 and K2
    launched per layer and never K3."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), n_layers=2,
                              compute_dtype="float32",
                              attn_dense_below=1024 if path == "dense"
                              else 256, attn_kv_chunk=256)
    params = lm.init_params(cfg, seed=0)
    toks = torch.randint(0, cfg.vocab_size, (1, 512), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(
                             0))
    out = {}
    for backend in ("arrayflex", "ref"):
        c = dataclasses.replace(cfg, gemm_backend=backend)
        ag.reset_launches()
        fa.reset_launches()
        out[backend], _ = lm.prefill(c, lm.prepare_params(c, params),
                                     {"tokens": toks})
        if backend == "arrayflex":
            assert ag.LAUNCHES["arrayflex_gemm"] == 6 * 2 + 1
            assert ag.LAUNCHES["arrayflex_gemm_tc"] == 0     # fp32: FFMA
            assert ag.LAUNCHES["arrayflex_expert_gemm"] == (
                2 * 2 if path == "dense" else 0)
            assert ag.LAUNCHES["arrayflex_expert_gemm_tc"] == 0  # fp32: FFMA
            assert fa.LAUNCHES["flash_attention"] == 0
    torch.cuda.synchronize()
    scale = out["ref"].abs().max().item()
    err = (out["arrayflex"] - out["ref"]).abs().max().item()
    assert err <= 1e-4 * scale, (err, scale)


RESILIENCE_PROMPTS = [[5, 6, 7], [11, 12, 13, 14, 15], [21]]


def _serve_restoring(cfg, params, sc, max_new=8):
    """Serve RESILIENCE_PROMPTS, restoring from the latest snapshot after
    an injected crash (the crashed engine released first); returns the
    final engine and the requests merged by rid."""
    eng = ServingEngine(cfg, params, sc)
    reqs = [Request(prompt=list(p), max_new_tokens=max_new, rid=i)
            for i, p in enumerate(RESILIENCE_PROMPTS)]
    for r in reqs:
        eng.submit(r)
    for _ in range(4):
        try:
            eng.run_to_completion()
            break
        except EngineCrash:
            snap = eng.latest_snapshot()
        eng = None
        eng = ServingEngine.restore(cfg, params, sc, snap)
    final = {r.rid: r for r in reqs}
    for r in eng.restored_requests:
        final[r.rid] = r
    return eng, [final[r.rid] for r in reqs]


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8"])
@pytest.mark.parametrize("case", ["gemm_prefill", "gemm_decode", "crash",
                                  "crash_paged", "preempt"])
def test_resilient_serving_matches_clean_run(cuda, backend, case):
    """Reduced qwen2-0.5b in bf16 on the kernels: a transient GEMM fault
    at layer 0's attn.pv of the first prefill or decode trace (retried
    once), a crash at tick 3 restored from a snapshot taken every tick
    (dense, and paged with the prefix cache), and preemption on a
    five-page pool: every stream equals the clean run's."""
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                              gemm_backend=backend,
                              compute_dtype="bfloat16")
    params = lm.init_params(cfg, seed=0)
    base = dict(max_batch=2, max_seq=64, prefill_chunk=4)
    paged = dict(kv_pages=40, page_size=8, prefix_cache=True)
    sc = {"gemm_prefill": dict(chaos=ChaosConfig(gemm_fault_at=4)),
          "gemm_decode": dict(chaos=ChaosConfig(gemm_fault_at=13)),
          "crash": dict(chaos=ChaosConfig(crash_at=3),
                        snapshot_every_ticks=1),
          "crash_paged": dict(paged, chaos=ChaosConfig(crash_at=3),
                              snapshot_every_ticks=1),
          "preempt": dict(kv_pages=5, page_size=8,
                          preempt_policy="youngest", prefix_cache=True),
          }[case]
    _, clean = _serve_restoring(cfg, params, ServeConfig(
        **base, **(paged if case == "crash_paged" else {})))
    eng, reqs = _serve_restoring(cfg, params, ServeConfig(**base, **sc))
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in clean]
    assert all(r.outcome == "ok" for r in clean)
    st = eng.stats
    assert st["kernel_fault_retries"] == case.startswith("gemm")
    assert st["sample_retries"] == 0 and st["watchdog_fired"] == 0
    if case == "preempt":
        assert st["preemptions"] >= 1
        assert {r.outcome for r in reqs} == {"ok", "preempted_retried"}
    else:
        assert all(r.outcome == "ok" for r in reqs)


FAMILY_CASES = [("mixtral-8x22b", {"sliding_window": 8}),
                ("llama-3.2-vision-90b", {}), ("whisper-base", {})]
FAMILY_PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15], [21, 22, 23],
                  [31, 32, 33, 34, 35]]


def _family_streams(cfg, params, device=None):
    eng = ServingEngine(cfg, params, ServeConfig(max_batch=2, max_seq=32),
                        device=device)
    reqs = [Request(prompt=list(p), max_new_tokens=5, rid=i)
            for i, p in enumerate(FAMILY_PROMPTS)]
    for r in reqs:
        eng.submit(r)
    substrate.DISPATCH_COUNTS.clear()
    ag.reset_launches()
    eng.run_to_completion()
    assert all(r.outcome == "ok" and len(r.out_tokens) == 5 for r in reqs)
    return [r.out_tokens for r in reqs], dict(ag.LAUNCHES), \
        dict(substrate.DISPATCH_COUNTS)


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8",
                                     "arrayflex_w8a8"])
@pytest.mark.parametrize("arch,kw", FAMILY_CASES,
                         ids=[a for a, _ in FAMILY_CASES])
def test_family_engine_on_the_kernels(cuda, arch, kw, backend):
    """Reduced mixtral (its ring of 8 wraps within the prompts), vlm and
    whisper in fp32, served in token mode on the card: every dispatch one
    launch of its form's kernel, the cross sites among them; every K1
    launch on FFMA, and of K2 only the self-attention's attn.pv on the
    tensor cores (its probabilities meet the bf16 K/V cache in bf16; a
    cross layer reads its context in fp32); greedy streams equal the CPU
    engine's on the plain versions (``arrayflex`` and W8), W8A8
    identical run to run."""
    cfg = dataclasses.replace(reduced(get_config(arch)), gemm_backend=backend,
                              compute_dtype="float32", **kw)
    params = lm.init_params(cfg, seed=0)
    streams, launches, dispatches = _family_streams(cfg, params)
    assert sum(v for k, v in launches.items() if not k.endswith("_tc")) == \
        sum(dispatches.values())
    cross = dispatches.get("xattn.wq", 0)
    assert launches["arrayflex_expert_gemm_tc"] == \
        dispatches["attn.pv"] - cross > 0
    assert not launches["arrayflex_gemm_tc"] and \
        not launches["arrayflex_gemm_int8_tc"]
    if cfg.family != "moe":
        assert cross == dispatches["xattn.wo"] > 0
    if backend == "arrayflex_w8a8":
        assert _family_streams(cfg, params)[0] == streams
    else:
        # the engine moves the card's tree to the CPU it serves on
        assert _family_streams(cfg, params, device="cpu")[0] == streams
