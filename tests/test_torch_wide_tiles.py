"""The wide tiles above 16 rows, on the CPU: K2's int8-only MoE banks on
bf16 x name the tensor-core tile (``expert_gemm_q_kernel``), fp32 x the
FFMA tile; ``chip_smoke.py`` books each bank site under the kernel that
runs it, plans one tensor-core launch a bank dispatch of an int8 prefill,
and bounds both tiles at the datasheet's rates; its int8 MoE prefill and
fp32 prefill phases rehearsed at reduced width; and a reduced MoE
``lm.prefill`` on ``arrayflex_int8`` (banks of more than 16 capacity rows)
against the reference's, which runs its Pallas kernels in interpret mode.
The kernels themselves need the card (``tests/test_torch_gpu.py``).
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.kernels import substrate as ref_sub
from repro.models import lm as ref_lm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import arrayflex_gemm as ag
from repro_torch.kernels import substrate
from repro_torch.models import convert, lm

MOE = "qwen3-moe-30b-a3b"
MIXTRAL = "mixtral-8x22b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod     # its dataclasses look it up there
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 16, 17, 1440])
def test_expert_gemm_q_kernel_rule(T, x_dtype, act_quant):
    """The int8-only banks above 16 rows on bf16 x take the tensor-core
    tile; at 16 rows or fewer, on fp32 x, and under W8A8 the FFMA / W8A8
    entry ``af_expert_gemm_q``."""
    want = ("af_expert_gemm_q_tc" if x_dtype == torch.bfloat16
            and not act_quant and T > 16 else "af_expert_gemm_q")
    assert ag.expert_gemm_q_kernel(x_dtype, act_quant, T) == want


def test_expert_gemm_q_kernel_rule_refuses_other_types():
    for dt in (torch.float16, torch.int8):
        with pytest.raises(ValueError, match="float32 or bfloat16 x"):
            ag.expert_gemm_q_kernel(dt, False, 160)


def test_new_counter_in_step(smoke):
    """The bank tile's counter is a launch counter, a tensor-core subset of
    the int8-only form's, replacing the reference's ``_expert_kernel``."""
    name = "arrayflex_expert_gemm_int8_tc"
    assert name in ag.LAUNCHES and name in smoke.TC_COUNTERS
    assert set(smoke.REPLACES) == set(ag.LAUNCHES)
    assert smoke.REPLACES[name] == \
        smoke.REPLACES["arrayflex_expert_gemm_int8"] == \
        "src/repro/kernels/arrayflex_gemm.py:452"


def _full(arch, L, dtype="bfloat16", backend="arrayflex_int8"):
    return dataclasses.replace(get_config(arch), n_layers=L,
                               gemm_backend=backend, compute_dtype=dtype,
                               param_dtype="bfloat16")


@pytest.mark.parametrize("arch,T", [(MOE, 160), (MIXTRAL, 1440)])
def test_bank_sites_book_under_the_kernel_that_runs(smoke, arch, T):
    """At the int8 prefill's capacity rows a bank on bf16 x books under the
    tensor-core counter, on fp32 x under the FFMA form; a decode bank (one
    capacity row) keeps the FFMA form on either x."""
    L, S = smoke.WIDE_MOE[arch]
    sites = smoke.wide_bank_sites(_full(arch, L), S)
    assert [s.name for s in sites] == ["moe.wi_gate", "moe.wi_up", "moe.wo"]
    for s in sites:
        assert s.shape[1] == T and s.per_step == L
        assert s.kernel_key(torch.bfloat16) == \
            "arrayflex_expert_gemm_int8_tc"
        assert s.kernel_key(torch.float32) == "arrayflex_expert_gemm_int8"
        one = dataclasses.replace(s, shape=(s.shape[0], 1, *s.shape[2:]))
        for dt in (torch.bfloat16, torch.float32):
            assert one.kernel_key(dt) == "arrayflex_expert_gemm_int8"


@pytest.mark.parametrize("arch", [MOE, MIXTRAL])
def test_int8_prefill_plans_one_tc_launch_a_bank(smoke, arch):
    """``forward_launches`` of the int8 prefill: every bank dispatch one
    launch, each on the tensor-core tile in bf16, none in fp32 or where
    the capacity is 16 rows or fewer."""
    L, S = smoke.WIDE_MOE[arch]
    want = smoke.forward_launches(_full(arch, L), S)
    assert want["arrayflex_expert_gemm_int8"] == 3 * L
    assert want["arrayflex_expert_gemm_int8_tc"] == 3 * L
    assert want["arrayflex_gemm"] == L          # the fp32 router
    f32 = smoke.forward_launches(_full(arch, L, "float32"), S)
    assert f32["arrayflex_expert_gemm_int8"] == 3 * L
    assert not any(f32[name] for name in smoke.TC_COUNTERS)
    cfg = _full(arch, L)
    short = next(s for s in range(1, 4096)
                 if smoke.moe_capacity(cfg, s + 1) > 16)
    assert smoke.moe_capacity(cfg, short) <= 16
    few = smoke.forward_launches(cfg, short)
    assert few["arrayflex_expert_gemm_int8_tc"] == 0
    assert few["arrayflex_expert_gemm_int8"] == 3 * L


def _meta_bank(site, dt):
    E, T, K, N = site.shape
    x = torch.empty(E, T, K, dtype=dt, device="meta")
    kw = dict(w=torch.empty(E, K, N, dtype=torch.int8, device="meta"),
              w_scale=torch.empty(E, N, device="meta"))
    return x, kw


def test_bank_bounds(smoke):
    """The banks' bounds from their operands: bf16 x at 989 TFLOP/s
    (qwen3-moe's 201 MB of codes a bank: bytes; mixtral's: operations),
    fp32 x at 67 TFLOP/s (operations); bytes = x, codes, scales read
    once, the output written once."""
    for arch, by in ((MOE, "bytes"), (MIXTRAL, "operations")):
        L, S = smoke.WIDE_MOE[arch]
        for site in smoke.wide_bank_sites(_full(arch, L), S):
            E, T, K, N = site.shape
            ops = 2 * E * T * K * N
            for dt, peak in ((torch.bfloat16, 989e12),
                             (torch.float32, 67e12)):
                x, kw = _meta_bank(site, dt)
                esz = x.element_size()
                ms, got_by, byts, got_ops = smoke._bound(site, x, kw, dt, dt)
                assert got_ops == ops
                assert byts == E * T * K * esz + E * K * N + 4 * E * N \
                    + E * T * N * esz
                t_ops, t_bytes = ops / peak * 1e3, byts / 3.35e12 * 1e3
                assert ms == max(t_ops, t_bytes)
                if dt == torch.bfloat16:
                    assert got_by == by
                else:
                    assert got_by == "operations"


def test_fp32_prefill_bounds(smoke):
    """qwen2-0.5b's fp32 prefill sites at S = 2048: K1 fp32, W8 on fp32 x
    and K2 fp32 (T = g x S rows), each bound by operations at 67 TFLOP/s;
    their sum is the FFMA tile's bound for one prefill."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              compute_dtype="float32")
    sites = smoke.wide_fp32_sites(cfg)
    kinds = {(s.kernel_key(torch.float32), s.name) for s in sites}
    assert ("arrayflex_gemm", "unembed") in kinds
    assert ("arrayflex_gemm_int8", "mlp.wi_gate+mlp.wi_up") in kinds
    assert ("arrayflex_expert_gemm", "attn.pv") in kinds
    total = 0.0
    for s in sites:
        if s.kernel == "arrayflex_expert_gemm":
            E, T, K, N = s.shape
            assert T > 16
            ops = 2 * E * T * K * N
            continue
        M, K, N = s.shape
        assert M == smoke.WIDE_FP32_SEQ
        ops = 2 * M * K * N * (2 if s.flags.get("dual") else 1)
        x = torch.empty(M, K, device="meta")
        kw = dict(w=torch.empty(K, N, device="meta"))
        if s.flags.get("dual"):
            kw["w2"] = torch.empty(K, N, device="meta")
        ms, by, _, got = smoke._bound(s, x, kw, torch.float32, torch.float32)
        assert got == ops and by == "operations"
        assert ms == pytest.approx(ops / 67e12 * 1e3)
        if s.form == "float":
            total += ms * s.per_step
    assert total == pytest.approx(30.205, abs=0.001)   # ms a prefill, K1


def test_int8_moe_prefill_rehearsed_on_the_cpu(smoke):
    """Phase (a) on the CPU at reduced width, S = 32 (capacity 20 > 16):
    the recorded bank sites book under the tensor-core counter in bf16,
    every launch counter stays 0 (CPU tensors take the plain versions),
    the plain-version run with the routing pinned equals it."""
    cfg = dataclasses.replace(reduced(get_config(MOE)),
                              compute_dtype="bfloat16",
                              param_dtype="bfloat16")
    params = lm.init_params(cfg, seed=0, device="cpu")
    assert smoke.moe_capacity(cfg, 32) == 20
    out, sites = smoke.int8_moe_prefill(cfg, params, 32, device="cpu")
    assert out["capacity"] == 20 and out["parity"]["max_abs_err"] == 0
    assert not any(out["launches"].values())
    banks = [s for s in sites if s.name.startswith("moe.w")]
    assert {s.name for s in banks} == {"moe.wi_gate", "moe.wi_up", "moe.wo"}
    for s in banks:
        assert s.form == "int8" and s.shape[1] == 20
        assert s.time_dtype == torch.bfloat16
        assert s.kernel_key(s.time_dtype) == "arrayflex_expert_gemm_int8_tc"
        assert s.per_step == cfg.n_layers


def test_wide_fp32_phase_rehearsed_on_the_cpu(smoke):
    """Phase (b) on the CPU at reduced width: both fp32 prefills recorded,
    every K1 / K2 site on an FFMA form (fp32 x) and booked once (the int8
    run's attn.qk / pv are the float run's), the W8 run held to ref on the
    dequantized weights."""
    cfg = reduced(get_config("qwen2-0.5b"))
    params = lm.init_params(dataclasses.replace(cfg,
                                                compute_dtype="float32"),
                            seed=0, device="cpu")
    out, rows, errs = smoke.wide_fp32_phase(cfg, params, device="cpu")
    assert rows == [] and errs == {}
    keys = {key for _, _, _, key in out["sites"]}
    assert keys == {"arrayflex_gemm", "arrayflex_gemm_int8",
                    "arrayflex_expert_gemm"}
    assert len(set(out["sites"])) == len(out["sites"])
    assert all(shape[-3] > 16 or name == "unembed"
               for name, _, shape, _ in out["sites"])
    assert out["parity"]["rel_err"] <= smoke.W8_PARITY_TOL


def test_reduced_moe_int8_prefill_matches_reference():
    """A reduced MoE ``lm.prefill`` (S = 32: each of 4 experts holds 20
    capacity rows) on ``arrayflex_int8`` in fp32: the port's last-token
    logits against the reference's, whose banks run its Pallas kernel in
    interpret mode, within test_torch_moe's fp32 tolerance (1e-4 of max
    |logit|, at least 1e-4)."""
    rc = dataclasses.replace(ref_reduced(ARCHS[MOE]),
                             gemm_backend="arrayflex_int8",
                             compute_dtype="float32")
    tc = dataclasses.replace(reduced(get_config(MOE)),
                             gemm_backend="arrayflex_int8",
                             compute_dtype="float32")
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
    tp = convert.params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (1, 32))
    ref_sub.clear_plan_cache()
    want, _ = ref_lm.prefill(rc, ref_lm.prequantize_params(rc, rp),
                             {"tokens": jnp.asarray(toks, jnp.int32)})
    got, _ = lm.prefill(tc, lm.prequantize_params(
        tc, lm.prepare_params(tc, tp)), {"tokens": torch.as_tensor(toks)})
    ref_sub.clear_plan_cache()
    substrate.clear_plan_cache()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("arch", [MOE, MIXTRAL])
def test_tc_banks_held_to_kernel_tol_unless_named(smoke, arch):
    """The int8 banks on the tensor-core tile (bf16 x above 16 rows) take
    KERNEL_TOL like the float tensor-core sites, one bf16 step only where
    TC_FLIP_SITES names the site (mixtral's); on fp32 x (the FFMA tile)
    and at one capacity row they keep the int8 forms' step_tol."""
    L, S = smoke.WIDE_MOE[arch]
    scale = 6.5
    for s in smoke.wide_bank_sites(_full(arch, L), S):
        named = (s.cell, s.name, tuple(s.shape)) in smoke.TC_FLIP_SITES
        assert named == (arch == MIXTRAL)
        bf16, f32 = torch.bfloat16, torch.float32
        assert smoke.tc_bank(s, bf16) and not smoke.tc_bank(s, f32)
        assert smoke.kernel_tol(s, bf16, scale) == (
            smoke.step_tol(bf16, scale) if named
            else smoke.KERNEL_TOL[bf16] * scale)
        assert smoke.kernel_tol(s, f32, scale) == smoke.step_tol(f32, scale)
        one = dataclasses.replace(s, shape=(s.shape[0], 1, *s.shape[2:]))
        assert not smoke.tc_bank(one, bf16)
        assert smoke.kernel_tol(one, bf16, scale) == \
            smoke.step_tol(bf16, scale)
