"""The port's ArrayFlex GEMM wrappers vs the reference Pallas kernels.

Inputs come from numpy with a fixed seed and go through the reference
kernel (interpret mode on the CPU, as ``tests/test_kernels.py`` runs it)
and the port's wrapper, which on a CPU tensor runs its plain PyTorch
version.  Tolerances, relative to the largest |value| of the reference
output:

* fp32: both sides accumulate in fp32 and differ only in summation order
  over K (<= 1024 terms here): 1e-5.
* bf16 outputs: both sides round an fp32 result once to bf16, and
  differently ordered fp32 sums may round to neighbouring bf16 values:
  one bf16 step, 2^-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.arrayflex_gemm import arrayflex_expert_gemm as ref_expert_gemm
from repro.kernels.arrayflex_gemm import arrayflex_gemm as ref_gemm
from repro.kernels import ops as ref_ops
from repro.kernels import substrate as ref_sub
from repro_torch.kernels import arrayflex_gemm as ag
from repro_torch.kernels import build, ops, substrate
from repro_torch.kernels.runtime import resolve_device

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, JNP[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH[dtype])


def _close(got, want, dtype: str):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


def _operands(M, K, N, dtype, seed, **flags):
    rng = np.random.RandomState(seed)
    x = _pair(rng.randn(M, K), dtype)
    w = _pair(rng.randn(K, N) / np.sqrt(K), dtype)
    kw_j, kw_t = {}, {}
    if flags.get("dual"):
        kw_j["w2"], kw_t["w2"] = _pair(rng.randn(K, N) / np.sqrt(K), dtype)
    for name, shape in (("bias", (N,)), ("bias2", (N,)),
                        ("norm_scale", (K,))):
        if flags.get(name):
            v = 1.0 + 0.1 * rng.randn(*shape)
            kw_j[name], kw_t[name] = _pair(v, "float32")
    if flags.get("residual"):
        kw_j["residual"], kw_t["residual"] = _pair(rng.randn(M, N), dtype)
    return x, w, kw_j, kw_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(256, 512, 256), (128, 1024, 384),
                                 (64, 256, 128)])
@pytest.mark.parametrize("k_collapse", [1, 2, 4])
def test_gemm_plain_vs_reference(mkn, dtype, k_collapse):
    M, K, N = mkn
    (xj, xt), (wj, wt), _, _ = _operands(M, K, N, dtype, M + K + N)
    want = ref_gemm(xj, wj, bk=64, k_collapse=k_collapse)
    got = ag.arrayflex_gemm(xt, wt, k_collapse=k_collapse)
    assert got.dtype == TORCH[dtype]
    _close(got, want, dtype)


EPILOGUES = {
    "bias": dict(bias=True),
    "silu": dict(activation="silu"),
    "gelu": dict(activation="gelu", bias=True),
    "swiglu": dict(dual=True, activation="silu", bias=True, bias2=True),
    "residual": dict(residual=True, activation="silu"),
    "norm_scale": dict(norm_scale=True, bias=True),
    "qkv": dict(norm_scale=True, bias=True),
    "swiglu_norm": dict(dual=True, activation="silu", norm_scale=True),
    "fp32_out": dict(out_f32=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(EPILOGUES))
def test_epilogue_plain_vs_reference(name, dtype):
    flags = dict(EPILOGUES[name])
    act = flags.pop("activation", "none")
    out_f32 = flags.pop("out_f32", False)
    (xj, xt), (wj, wt), kj, kt = _operands(8, 192, 256, dtype, len(name),
                                           **flags)
    want = ref_gemm(
        xj, wj, activation=act, bk=64, k_collapse=2,
        out_dtype=jnp.float32 if out_f32 else None, **kj)
    got = ag.arrayflex_gemm(xt, wt, activation=act, k_collapse=2,
                            out_dtype=torch.float32 if out_f32 else None,
                            **kt)
    _close(got, want, "float32" if out_f32 else dtype)


@pytest.mark.parametrize("K,k_collapse", [(130, 4), (130, 1), (100, 4),
                                          (257, 2), (70, 3)])
def test_gemm_ragged_k_exact(K, k_collapse):
    (xj, xt), (wj, wt), _, _ = _operands(64, K, 128, "float32", K)
    want = ref_gemm(xj, wj, k_collapse=k_collapse)
    _close(ag.arrayflex_gemm(xt, wt, k_collapse=k_collapse), want,
           "float32")


@pytest.mark.parametrize("M,K,N", [(300, 64, 128), (128, 64, 130),
                                   (200, 130, 200), (3, 130, 96)])
def test_matmul_ragged_mn_vs_reference(M, K, N):
    """The reference pads ragged M/N to its tile and slices; the port's
    kernel masks them: the results agree for every planned k."""
    (xj, xt), (wj, wt), kj, kt = _operands(M, K, N, "float32", M + N,
                                           bias=True, residual=True)
    for k_collapse in (0, 1, 4):    # 0 = planner-chosen
        want = ref_ops.arrayflex_matmul(xj, wj, k_collapse=k_collapse,
                                        activation="silu", **kj)
        got = ops.arrayflex_matmul(xt, wt, k_collapse=k_collapse,
                                   activation="silu", **kt)
        _close(got, want, "float32")


def test_matmul_leading_dims():
    (xj, xt), (wj, wt), _, _ = _operands(12, 64, 32, "float32", 5)
    want = ref_ops.arrayflex_matmul(xj.reshape(3, 4, 64), wj)
    got = ops.arrayflex_matmul(xt.reshape(3, 4, 64), wt)
    assert tuple(got.shape) == (3, 4, 32)
    _close(got, want, "float32")


@pytest.mark.parametrize("mkn", [(64, 0, 64), (0, 8, 8), (8, 8, 0)])
def test_empty_operands_return_epilogue_of_zeros(mkn):
    M, K, N = mkn
    rng = np.random.RandomState(0)
    b = rng.randn(N)
    xj, xt = _pair(np.zeros((M, K)), "float32")
    wj, wt = _pair(np.zeros((K, N)), "float32")
    bj, bt = _pair(b, "float32")
    want = ref_ops.arrayflex_matmul(xj, wj, bias=bj, activation="silu",
                                    w2=wj, bias2=bj)
    got = ops.arrayflex_matmul(xt, wt, bias=bt, activation="silu", w2=wt,
                               bias2=bt)
    assert tuple(got.shape) == (M, N)
    _close(got, want, "float32")
    assert ag.arrayflex_gemm(xt, wt, k_collapse=4).abs().sum() == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_collapse", [1, 2, 4])
@pytest.mark.parametrize("etkn", [(4, 64, 128, 128), (3, 8, 130, 64)])
def test_expert_gemm_plain_vs_reference(etkn, k_collapse, dtype):
    E, T, K, N = etkn
    rng = np.random.RandomState(E + T + K + N)
    xj, xt = _pair(rng.randn(E, T, K), dtype)
    wj, wt = _pair(rng.randn(E, K, N), dtype)
    want = ref_expert_gemm(xj, wj, bk=64, k_collapse=k_collapse)
    got = ag.arrayflex_expert_gemm(xt, wt, k_collapse=k_collapse)
    assert got.dtype == TORCH[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("etkn", [(2, 7, 64, 256), (2, 300, 64, 130),
                                  (0, 4, 8, 8), (2, 4, 0, 8)])
def test_expert_matmul_vs_reference(etkn):
    """Ragged T/N (the reference pads) and empty operands, fp32 queries
    against a bf16 operand with fp32 out, as attn.qk runs."""
    E, T, K, N = etkn
    rng = np.random.RandomState(T + N)
    xj, xt = _pair(rng.randn(E, T, K), "float32")
    wj, wt = _pair(rng.randn(E, K, N), "bfloat16")
    want = ref_ops.arrayflex_expert_matmul(xj, wj, out_dtype=jnp.float32)
    got = ops.arrayflex_expert_matmul(xt, wt, out_dtype=torch.float32)
    assert tuple(got.shape) == (E, T, N)
    _close(got, want, "float32")


def test_plain_versions_count_no_launches():
    before = dict(ag.LAUNCHES)
    ag.arrayflex_gemm(torch.ones(4, 8), torch.ones(8, 4), k_collapse=2)
    ag.arrayflex_expert_gemm(torch.ones(2, 4, 8), torch.ones(2, 8, 4))
    assert ag.LAUNCHES == before


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a card is refused, never computed
    on the side."""
    x = torch.empty(4, 8, device="meta")
    w = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ag.arrayflex_gemm(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        ag.arrayflex_expert_gemm(x[None], w[None])


def test_wrapper_validation():
    with pytest.raises(ValueError):
        ag.arrayflex_gemm(torch.zeros(4, 8), torch.zeros(7, 4))
    with pytest.raises(ValueError):
        ag.arrayflex_gemm(torch.zeros(4, 8), torch.zeros(8, 4), k_collapse=0)
    with pytest.raises(ValueError):
        ag.arrayflex_gemm(torch.zeros(4, 8), torch.zeros(8, 4),
                          bias2=torch.zeros(4))
    with pytest.raises(ValueError):
        ag.arrayflex_gemm(torch.zeros(4, 8), torch.zeros(8, 4),
                          activation="relu")
    with pytest.raises(ValueError):
        ag.arrayflex_gemm(torch.zeros(4, 8), torch.zeros(8, 4),
                          residual=torch.zeros(4, 5))


def test_gemm_kernel_rule():
    """The float form's written dtype -> kernel rule: bf16 operands launch
    the tensor-core kernel, fp32 the FFMA kernel, anything else raises."""
    assert ag.gemm_kernel(torch.bfloat16) == "af_gemm_tc"
    assert ag.gemm_kernel(torch.float32) == "af_gemm"
    for dt in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            ag.gemm_kernel(dt)


@pytest.mark.parametrize("x_dtype,act_quant,want", [
    (torch.bfloat16, False, "af_gemm_q_tc"),
    (torch.float32, False, "af_gemm_q"),
    (torch.bfloat16, True, "af_gemm_q"),
    (torch.float32, True, "af_gemm_q")])
def test_gemm_q_kernel_rule(x_dtype, act_quant, want):
    """K1's int8 forms: W8 on bf16 x launches the tensor-core kernel
    (codes widened to bf16, as the reference widens them to x's type), W8
    on fp32 x the FFMA kernel, W8A8 the __dp4a kernel on either x type."""
    assert ag.gemm_q_kernel(x_dtype, act_quant) == want


@pytest.mark.parametrize("x_dtype", [torch.float16, torch.float64,
                                     torch.int8])
def test_gemm_q_kernel_rule_refuses(x_dtype):
    for act_quant in (False, True):
        with pytest.raises(ValueError, match="float32 or bfloat16 x"):
            ag.gemm_q_kernel(x_dtype, act_quant)


def test_expert_gemm_kernel_rule():
    """K2's float form: bf16 x with bf16 w launches the tensor-core
    kernel; fp32 x with fp32 w, or with a bf16 K/V cache, the FFMA
    kernel; every other pairing raises."""
    bf, f32 = torch.bfloat16, torch.float32
    assert ag.expert_gemm_kernel(bf, bf) == "af_expert_gemm_tc"
    assert ag.expert_gemm_kernel(f32, f32) == "af_expert_gemm"
    assert ag.expert_gemm_kernel(f32, bf) == "af_expert_gemm"
    for xd, wd in ((bf, f32), (torch.float16, torch.float16),
                   (bf, torch.float16), (f32, torch.float64),
                   (torch.int8, torch.int8)):
        with pytest.raises(ValueError, match="unsupported dtypes"):
            ag.expert_gemm_kernel(xd, wd)


@pytest.mark.parametrize("counter,parent", [
    ("arrayflex_gemm_tc", "arrayflex_gemm"),
    ("arrayflex_gemm_int8_tc", "arrayflex_gemm_int8"),
    ("arrayflex_expert_gemm_tc", "arrayflex_expert_gemm")])
def test_tc_counter_resets_with_the_others(counter, parent):
    ag.LAUNCHES[counter] += 3
    ag.reset_launches()
    assert set(ag.LAUNCHES) >= {parent, counter}
    assert not any(ag.LAUNCHES.values())


def test_resolve_device():
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_build_sources_and_keys():
    srcs = build.sources()
    assert [s.name for s in srcs] == ["arrayflex_gemm.cu",
                                      "flash_attention.cu"]
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert build._digest(srcs[0]) == build._digest(srcs[0])
    assert build._digest(srcs[0]) != build._digest(srcs[1])


def test_build_key_covers_shared_headers(monkeypatch, tmp_path):
    """A source's build key changes with any ``csrc/*.cuh`` it may include,
    so an edited header rebuilds every library."""
    for f in list(build.sources()) + list(build.headers()):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [h.name for h in build.headers()] == ["tc.cuh"]
    src = build.sources()[0]
    before = build._digest(src)
    (tmp_path / "tc.cuh").write_text("// edited\n")
    assert build._digest(src) != before


def test_every_source_includes_and_keys_the_tensor_core_header(
        monkeypatch, tmp_path):
    """Both sources' tensor-core kernels (K1/K2's ``af_gemm_tc_kernel``, K3's
    ``flash_attention_tc``) include ``tc.cuh``, and each source's build key
    changes with it."""
    for f in list(build.sources()) + list(build.headers()):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {s.name: build._digest(s) for s in build.sources()}
    for src in build.sources():
        assert '#include "tc.cuh"' in src.read_text(), src.name
    (tmp_path / "tc.cuh").write_text("// edited\n")
    for src in build.sources():
        assert build._digest(src) != before[src.name], src.name


# ----------------------------------------------------------- planning

PLAN_GRID = [(896, 4864, 512), (4864, 896, 512), (896, 896, 4),
             (128, 896, 4), (152064, 896, 4), (256, 64, 7), (64, 256, 1792),
             (896, 4864, 1024), (128, 128, 128), (4096, 4096, 1)]


@pytest.mark.parametrize("precision", ["fp32", "int8", "w8a8"])
@pytest.mark.parametrize("mkt", PLAN_GRID)
def test_plan_collapse_matches_reference(mkt, precision):
    M, K, T = mkt
    for e_ops in (0, 1, 3):
        kw = dict(epilogue_ops=e_ops, precision=precision)
        assert ops.plan_collapse(M, K, T, **kw) == \
            ref_ops.plan_collapse(M, K, T, **kw), (mkt, kw)


def test_pinned_fp32_pick():
    """docs/substrate.md pins (896, 4864, 512): k=2 under fp32."""
    assert ops.plan_collapse(896, 4864, 512) == 2


SITE_EPILOGUES = {
    "attn.wq": dict(bias=True, norm_scale=True),
    "mlp.wi_gate+mlp.wi_up": dict(kind="swiglu", norm_scale=True),
    "mlp.wo": dict(residual=True),
    "attn.wo": dict(),
    "unembed": dict(),
}


@pytest.mark.parametrize("site", sorted(SITE_EPILOGUES))
@pytest.mark.parametrize("T", [4, 1024])
def test_substrate_site_plans_match_reference(site, T):
    """Full-width qwen2-0.5b site shapes plan the same k, cycles and
    predictions in both substrates, on every backend."""
    shapes = {"attn.wq": (896, 896), "mlp.wi_gate+mlp.wi_up": (4864, 896),
              "mlp.wo": (896, 4864), "attn.wo": (896, 896),
              "unembed": (152064, 896)}
    M, N = shapes[site]
    for backend in ("arrayflex", "xla", "ref"):
        got = substrate.plan_gemm(M, N, T, backend,
                                  substrate.Epilogue(**SITE_EPILOGUES[site]))
        want = ref_sub.plan_gemm(M, N, T, backend,
                                 ref_sub.Epilogue(**SITE_EPILOGUES[site]))
        assert (got.k, got.cycles, got.precision) == \
            (want.k, want.cycles, want.precision)
        assert got.t_pred_ps == pytest.approx(want.t_pred_ps)
        assert got.t_conventional_ps == pytest.approx(want.t_conventional_ps)


def test_substrate_backends_and_dispatch_counts():
    substrate.clear_plan_cache()
    x, w = torch.randn(5, 16), torch.randn(16, 8)
    out = substrate.gemm(x, w, w2=w, epilogue="swiglu",
                         site="mlp.wi_gate+mlp.wi_up", backend="arrayflex")
    ref = substrate.gemm(x, w, w2=w, epilogue="swiglu", backend="ref")
    torch.testing.assert_close(out, ref)
    assert substrate.DISPATCH_COUNTS == {"mlp.wi_gate+mlp.wi_up": 1}
    assert set(substrate.SITE_PLANS) == {"mlp.wi_gate", "mlp.wi_up"}
    b = substrate.batched_gemm(x[None], w[None], site="attn.qk",
                               backend="arrayflex", out_dtype=torch.float32)
    torch.testing.assert_close(b[0], x @ w)
    assert substrate.DISPATCH_COUNTS["attn.qk"] == 1
    info = substrate.plan_cache_info()
    assert info.per_backend["arrayflex"]["misses"] == 2
    with pytest.raises(ValueError, match="unknown gemm backend"):
        substrate.check_backend("arrayflex_fp8")
    substrate.clear_plan_cache()
    assert substrate.DISPATCH_COUNTS == {}
