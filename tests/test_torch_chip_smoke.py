"""``chip_smoke.py``'s bookkeeping, on the CPU: which kernel each serving
run's launches must land on, and which TPU kernel each counted form
replaces.  The script's checks and times need the card; its launch plan,
its kernel booking and its launch checks are plain Python, imported here
from the repository root without running anything.
"""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import arrayflex_gemm as ag

ARCHS = ["qwen2-0.5b", "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod     # its dataclasses look it up there
    spec.loader.exec_module(mod)
    return mod


def _cfg(arch, backend, dtype):
    return dataclasses.replace(get_config(arch), gemm_backend=backend,
                               compute_dtype=dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_w8_serving_launches_land_on_tensor_cores(smoke, arch):
    """bf16 ``arrayflex_int8`` serving: every W8 K1 launch on
    ``af_gemm_q_tc`` (the MoE router stays on the fp32 FFMA K1, the expert
    banks on K2's int8-only form)."""
    cfg = _cfg(arch, "arrayflex_int8", "bfloat16")
    want = smoke.expected_launches(cfg, steps=3)
    L = cfg.n_layers
    dense = 0 if cfg.moe is not None else 2 * L
    assert want["arrayflex_gemm_int8"] == (4 * L + 1 + dense) * 3
    assert want["arrayflex_gemm_int8_tc"] == want["arrayflex_gemm_int8"]
    assert want["arrayflex_gemm_tc"] == 0
    assert want["arrayflex_gemm"] == (L * 3 if cfg.moe is not None else 0)
    assert want["arrayflex_expert_gemm_int8"] == \
        (3 * L * 3 if cfg.moe is not None else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_w8_serving_launches_none_on_tensor_cores(smoke, arch):
    cfg = _cfg(arch, "arrayflex_int8", "float32")
    want = smoke.expected_launches(cfg, steps=2)
    assert want["arrayflex_gemm_int8"] > 0
    assert all(want[name] == 0 for name in smoke.TC_COUNTERS)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_w8a8"])
def test_other_backends_keep_their_tensor_core_launches(smoke, arch,
                                                        backend):
    """The float backend's bf16 K1 stays on ``af_gemm_tc``; W8A8 has no
    tensor-core K1; no backend but W8 counts ``arrayflex_gemm_int8_tc``."""
    want = smoke.expected_launches(_cfg(arch, backend, "bfloat16"), steps=2)
    assert want["arrayflex_gemm_int8_tc"] == 0
    if backend == "arrayflex":
        assert want["arrayflex_gemm_tc"] == want["arrayflex_gemm"] - (
            2 * get_config(arch).n_layers if get_config(arch).moe else 0)
    else:
        assert want["arrayflex_gemm_tc"] == 0


def test_replaces_names_every_launch_counter(smoke):
    assert set(smoke.REPLACES) == set(ag.LAUNCHES)
    assert set(smoke.TC_COUNTERS) <= set(ag.LAUNCHES)
    for tc in smoke.TC_COUNTERS:        # each a subset of its form's count
        assert tc.endswith("_tc") and tc[:-len("_tc")] in ag.LAUNCHES
        assert smoke.REPLACES[tc] == smoke.REPLACES[tc[:-len("_tc")]]


@pytest.mark.parametrize("dt,want", [(torch.bfloat16,
                                      "arrayflex_gemm_int8_tc"),
                                     (torch.float32, "arrayflex_gemm_int8")])
def test_w8_site_books_under_the_kernel_that_ran(smoke, dt, want):
    site = smoke.Site("attn.wq", "arrayflex_gemm", (4, 896, 896), 24,
                      form="int8")
    assert site.kernel_key(dt) == want
    bank = smoke.Site("moe.wi_gate", "arrayflex_expert_gemm",
                      (128, 1, 2048, 768), 48, form="int8")
    assert bank.kernel_key(dt) == "arrayflex_expert_gemm_int8"


def test_fp32_w8_launch_check(smoke):
    ok = dict.fromkeys(ag.LAUNCHES, 0)
    ok.update(arrayflex_gemm_int8=10, arrayflex_expert_gemm=4)
    smoke.check_fp32_w8_launches("fp32 W8", ok)
    for bad in (dict(ok, arrayflex_gemm_int8_tc=1),
                dict(ok, arrayflex_expert_gemm_tc=1),
                dict(ok, arrayflex_gemm_int8=0)):
        with pytest.raises(AssertionError, match="FFMA"):
            smoke.check_fp32_w8_launches("fp32 W8", bad)


def test_narrow_sites_cover_every_fp32_x_k1_decode_site(smoke):
    """The narrow-tile report lists, for both models at decode (M = 4),
    every K1 site in the float form (the dual swiglu, the unembed and the
    MoE router among them) and every W8 site, and nothing on K2."""
    cfg = _cfg("qwen2-0.5b", "arrayflex", "bfloat16")
    moe_cfg = _cfg("qwen3-moe-30b-a3b", "arrayflex", "bfloat16")
    sites = smoke.narrow_sites(cfg, moe_cfg)
    assert all(s.kernel == "arrayflex_gemm" and s.shape[0] == smoke.BATCH
               for s in sites)
    got = {(s.cell, s.form, s.name): s for s in sites}
    assert len(got) == len(sites)
    dense = ["attn.wq", "attn.wk", "attn.wv", "attn.wo",
             "mlp.wi_gate+mlp.wi_up", "mlp.wo", "unembed"]
    moe = ["attn.wq", "attn.wk", "attn.wv", "attn.wo", "unembed"]
    want = ({("qwen2-0.5b", f, n) for f in ("float", "int8") for n in dense}
            | {("qwen3-moe-30b-a3b", f, n) for f in ("float", "int8")
               for n in moe}
            | {("qwen3-moe-30b-a3b", "float", "moe.router")})
    assert set(got) == want
    for form in ("float", "int8"):
        dual = got[("qwen2-0.5b", form, "mlp.wi_gate+mlp.wi_up")]
        assert dual.flags["dual"] and dual.shape == (4, 896, 4864)
        assert got[("qwen2-0.5b", form, "unembed")].shape == (4, 896, 152064)
        assert got[("qwen3-moe-30b-a3b", form, "unembed")].shape == \
            (4, 2048, 152064)


@pytest.mark.parametrize("form", ["float", "int8", "w8a8"])
def test_planned_k_is_the_substrate_plan(smoke, form):
    from repro_torch.kernels import substrate
    backend = smoke.FORM_BACKEND[form]
    site = smoke.Site("mlp.wi_gate+mlp.wi_up", "arrayflex_gemm",
                      (4, 896, 4864), 24,
                      dict(dual=True, activation="silu", norm_scale=True),
                      form=form)
    ep = substrate.Epilogue(kind="swiglu", norm_scale=True)
    assert smoke.planned_k(site) == substrate.plan_gemm(4864, 896, 4,
                                                        backend, ep).k
    bank = smoke.Site("moe.wi_gate", "arrayflex_expert_gemm",
                      (128, 1, 2048, 768), 48, form=form)
    assert smoke.planned_k(bank) == substrate.plan_gemm(768, 2048, 1,
                                                        backend).k


def test_narrow_bank_sites_are_the_int8_moe_banks(smoke):
    """The narrow-tile report lists the three MoE expert banks in K2's
    int8-only form at decode (one capacity row of each of 128 experts),
    and the width rule gives each 128-byte code rows."""
    moe_cfg = _cfg("qwen3-moe-30b-a3b", "arrayflex", "bfloat16")
    sites = smoke.narrow_bank_sites(moe_cfg)
    assert {(s.name, s.shape) for s in sites} == {
        ("moe.wi_gate", (128, 1, 2048, 768)),
        ("moe.wi_up", (128, 1, 2048, 768)),
        ("moe.wo", (128, 1, 768, 2048))}
    for s in sites:
        assert s.kernel == "arrayflex_expert_gemm" and s.form == "int8"
        assert s.launch_name == "arrayflex_expert_gemm_int8"
        E, T, K, N = s.shape
        assert smoke.narrow_int8_cols(T, N, E) == 128


@pytest.mark.parametrize("mnb,want", [
    ((1, 768, 128), 128), ((4, 2048, 128), 128), ((5, 768, 128), 64),
    ((1, 768, 22), 128), ((1, 768, 21), 64), ((4, 70, 50), 32),
    ((16, 70, 3), 16), ((4, 152064, 1), 128), ((5, 152064, 1), 64),
    ((4, 4864, 1), 32), ((4, 896, 1), 16)])
def test_narrow_int8_width_rule(smoke, mnb, want):
    """The written width rule phase 3 holds the card's int8 tile to: the
    widest of 128 (M <= 4), 64 and 32 columns whose grid (blocks x
    experts) reaches 128 blocks, else 16; K1's int8 sites are its
    one-batch case."""
    assert smoke.narrow_int8_cols(*mnb) == want


@pytest.mark.parametrize("name", ["ragged non-causal", "window 512",
                                  "fully masked rows"])
def test_k3_cases_hold_fp32_forms(smoke, name):
    """K3's phase runs the ragged, window and fully masked cases in fp32
    too (the FFMA kernel), at the bf16 cases' shapes and masks."""
    cases = {c[0]: c for c in smoke.K3_CASES}
    bf16, fp32 = cases[name], cases[f"{name} fp32"]
    assert bf16[1:7] == fp32[1:7]
    assert bf16[7] == torch.bfloat16 and fp32[7] == torch.float32


def test_w8a8_sites_cover_every_w8a8_decode_site(smoke):
    """The W8A8 narrow-tile report and width checks list, for both models
    at decode, every K1 weight GEMM in the W8A8 form (the dual swiglu and
    the unembed among them), attn.qk on K2's W8A8 form and the three MoE
    expert banks on it; each at M (T) <= 16 rows, so on the new tile."""
    cfg = _cfg("qwen2-0.5b", "arrayflex", "bfloat16")
    moe_cfg = _cfg("qwen3-moe-30b-a3b", "arrayflex", "bfloat16")
    sites = smoke.w8a8_sites(cfg, moe_cfg)
    assert all(s.form == "w8a8" and smoke.site_rows(s)[0] <= 16
               for s in sites)
    got = {(s.cell, s.name): s for s in sites}
    assert len(got) == len(sites)
    dense = ["attn.wq", "attn.wk", "attn.wv", "attn.wo",
             "mlp.wi_gate+mlp.wi_up", "mlp.wo", "unembed", "attn.qk"]
    moe = ["attn.wq", "attn.wk", "attn.wv", "attn.wo", "unembed", "attn.qk",
           "moe.wi_gate", "moe.wi_up", "moe.wo"]
    assert set(got) == ({("qwen2-0.5b", n) for n in dense}
                        | {("qwen3-moe-30b-a3b", n) for n in moe})
    for (cell, name), s in got.items():
        assert s.launch_name == (
            "arrayflex_expert_gemm_w8a8" if name.startswith(("attn.qk",
                                                             "moe."))
            else "arrayflex_gemm_w8a8")
    assert got[("qwen2-0.5b", "mlp.wi_gate+mlp.wi_up")].flags["dual"]
    assert got[("qwen2-0.5b", "attn.qk")].shape == (8, 7, 64, smoke.MAX_SEQ)
    assert got[("qwen3-moe-30b-a3b", "moe.wo")].shape == (128, 1, 768, 2048)


# (cell, site) -> the W8A8 narrow tile's width at decode by the written
# rule: 16 columns at qwen2's 896- and 128-wide sites (a 16-byte code
# chunk a row), 32 at its dual and at the MoE attn.wq, 128 (a w row's 128
# bytes) at both unembeds and the MoE banks, 16 at both attn.qk grids
W8A8_WIDTHS = {
    ("qwen2-0.5b", "attn.wq"): 16, ("qwen2-0.5b", "attn.wk"): 16,
    ("qwen2-0.5b", "attn.wv"): 16, ("qwen2-0.5b", "attn.wo"): 16,
    ("qwen2-0.5b", "mlp.wi_gate+mlp.wi_up"): 32, ("qwen2-0.5b", "mlp.wo"): 16,
    ("qwen2-0.5b", "unembed"): 128, ("qwen2-0.5b", "attn.qk"): 16,
    ("qwen3-moe-30b-a3b", "attn.wq"): 32, ("qwen3-moe-30b-a3b", "attn.wk"): 16,
    ("qwen3-moe-30b-a3b", "attn.wv"): 16, ("qwen3-moe-30b-a3b", "attn.wo"): 16,
    ("qwen3-moe-30b-a3b", "unembed"): 128,
    ("qwen3-moe-30b-a3b", "attn.qk"): 16,
    ("qwen3-moe-30b-a3b", "moe.wi_gate"): 128,
    ("qwen3-moe-30b-a3b", "moe.wi_up"): 128,
    ("qwen3-moe-30b-a3b", "moe.wo"): 128}


def test_w8a8_width_rule_is_the_written_one(smoke):
    """Phase 3 holds each W8A8 decode site's width (the C entry
    ``af_w8a8_cols``) to :func:`narrow_int8_cols` at the site's rows, N
    and grid batch (experts for K2): the int8 rule of the narrow tile."""
    cfg = _cfg("qwen2-0.5b", "arrayflex", "bfloat16")
    moe_cfg = _cfg("qwen3-moe-30b-a3b", "arrayflex", "bfloat16")
    sites = smoke.w8a8_sites(cfg, moe_cfg)
    assert {(s.cell, s.name) for s in sites} == set(W8A8_WIDTHS)
    for s in sites:
        assert smoke.narrow_int8_cols(*smoke.site_rows(s)) == \
            W8A8_WIDTHS[(s.cell, s.name)], (s.cell, s.name, s.shape)
