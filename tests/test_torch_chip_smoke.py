"""``chip_smoke.py``'s bookkeeping, on the CPU: which kernel each serving
run's launches must land on, and which TPU kernel each counted form
replaces.  The script's checks and times need the card; its launch plan,
its kernel booking and its launch checks are plain Python, imported here
from the repository root without running anything.
"""
import contextlib
import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
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


def test_paged_pool_reserves_every_request_in_full(smoke):
    """Phase 5's requests at page 128 of max_seq 256: 48, 80, 112 and 144
    tokens reserved, 1 + 1 + 1 + 2 pages, and the scratch page; a pool
    never below the engine's minimum of max_seq / page + 1."""
    page = smoke.planner.page_plan(smoke.MAX_SEQ)
    assert page == 128
    assert smoke.paged_pool_pages(smoke.PROMPT_LENS, smoke.MAX_NEW,
                                  smoke.MAX_SEQ, page) == 6
    assert smoke.paged_pool_pages([4], 4, 256, 128) == 3
    assert smoke.paged_pool_pages([250], 16, 256, 128) == 3   # clipped
    assert smoke.paged_pool_pages(smoke.PAGED_SHORT_LENS,
                                  smoke.PAGED_SHORT_NEW, smoke.MAX_SEQ,
                                  page) == len(smoke.PAGED_SHORT_LENS) + 1


def test_shared_prefix_prompts(smoke):
    prompts = smoke.shared_prefix_prompts(1000, smoke.PREFIX_REQUESTS,
                                          smoke.PREFIX_SYSTEM,
                                          smoke.PREFIX_TAIL)
    S, T = smoke.PREFIX_SYSTEM, smoke.PREFIX_TAIL
    assert len(prompts) == smoke.PREFIX_REQUESTS == 8
    assert all(len(p) == S + T == 136 for p in prompts)
    assert all(p[:S] == prompts[0][:S] for p in prompts)
    assert len({tuple(p[S:]) for p in prompts}) == len(prompts)
    assert all(0 <= t < 1000 for p in prompts for t in p)
    assert prompts == smoke.shared_prefix_prompts(1000, 8, S, T)


def test_prefix_run_matches_one_full_page(smoke):
    """The prefix cache shares whole pages of prompt[:-1]: 135 tokens at
    page 128 share one page, so a warm follower prefills 7 tokens in one
    chunk where a cold one prefills 135 in two."""
    page = smoke.planner.page_plan(smoke.MAX_SEQ)
    n = smoke.PREFIX_SYSTEM + smoke.PREFIX_TAIL - 1
    assert n // page == 1 and n - page == 7
    assert -(-n // page) == 2


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8",
                                     "arrayflex_w8a8"])
def test_prefill_step_launches(smoke, backend):
    """Per prefill-chunk step of qwen2-0.5b: 6 K1 GEMMs a layer and the
    unembed, attn.qk and attn.pv on K2 (8 L + 1), on every backend."""
    cfg = _cfg("qwen2-0.5b", backend, "bfloat16")
    L = cfg.n_layers
    assert smoke.prefill_step_launches(cfg, 1) == 8 * L + 1
    assert smoke.prefill_step_launches(cfg, 3) == 3 * (8 * L + 1)


@pytest.mark.parametrize("write_idx", [0, 1])
def test_profile_block_tables_write_distinct_pages(smoke, write_idx):
    bt = smoke.profile_block_tables(smoke.BATCH, 2, write_idx)
    assert bt.shape == (smoke.BATCH, 2)
    writes = bt[:, write_idx]
    assert len(set(writes.tolist())) == smoke.BATCH and 0 not in writes
    assert (bt[:, 1 - write_idx] == 1).all()
    assert 1 not in writes
    # phase 5's pool (6 pages) holds every page the tables name
    assert bt.max() < smoke.paged_pool_pages(
        smoke.PROMPT_LENS, smoke.MAX_NEW, smoke.MAX_SEQ, 128)


# ------------------------------------------------ resilient serving's plan
def _reduced(arch, backend="arrayflex"):
    from repro_torch.configs import reduced
    return dataclasses.replace(reduced(get_config(arch)),
                               gemm_backend=backend, compute_dtype="float32")


def _dispatched(smoke, cfg):
    """The launch counters the substrate's dispatches of the run imply
    (on the CPU the wrappers run their plain versions and count nothing;
    one dispatch on an arrayflex backend is one launch)."""
    from repro_torch.kernels import substrate
    got = {name: 0 for name in ag.LAUNCHES}
    for site, n in substrate.DISPATCH_COUNTS.items():
        for name, k in smoke.site_launches(cfg, site).items():
            got[name] += k * n
    return got


@pytest.mark.parametrize("arch,step", [("qwen2-0.5b", "prefill"),
                                       ("qwen2-0.5b", "decode"),
                                       ("qwen3-moe-30b-a3b", "decode")])
def test_step_sites_are_the_dispatch_order(smoke, arch, step, monkeypatch):
    """``step_sites`` — what a faulted attempt launched before its site is
    read from it — is the order the port's step dispatches in."""
    from repro_torch.kernels import substrate
    from repro_torch.models import lm
    cfg = _reduced(arch)
    order = []
    real = substrate._record

    def record(site, plan, launches=1):
        order.append(site)
        real(site, plan, launches)

    monkeypatch.setattr(substrate, "_record", record)
    params = lm.init_params(cfg, seed=0, device="cpu")
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    zero = torch.zeros(2, dtype=torch.int64)
    if step == "prefill":
        lm.prefill_step(cfg, params, cache, torch.ones(2, 4, dtype=torch.int64),
                        zero, torch.tensor([4, 2]))
    else:
        lm.decode_step(cfg, params, cache, zero, zero)
    assert order == smoke.step_sites(cfg)


def test_expected_launches_are_per_site_launches(smoke):
    """Per step: every site of :func:`step_sites` on its form (8 L + 1 on
    qwen2's backends, the MoE router, banks and attention per layer)."""
    for arch in ARCHS:
        for backend in ("arrayflex", "arrayflex_int8", "arrayflex_w8a8"):
            cfg = _cfg(arch, backend, "bfloat16")
            one = smoke.expected_launches(cfg, 1)
            L = cfg.n_layers
            forms = sum(v for k, v in one.items()
                        if k not in smoke.TC_COUNTERS)
            assert forms == len(smoke.step_sites(cfg)) == (
                10 if cfg.moe else 8) * L + 1
            assert smoke.expected_launches(cfg, 3) == {
                k: 3 * v for k, v in one.items()}


@pytest.mark.parametrize("chaos_kw", [
    dict(gemm_fault_at=4), dict(gemm_fault_at=13), dict(gemm_fault_at=17),
    dict(nan_logits_at=0), dict(gemm_fault=1.0), dict(nan_logits=1.0),
    dict(seed=5, gemm_fault=0.1, nan_logits=0.3),
    dict(seed=7, gemm_fault=0.3, crash=0.2)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("mode", ["dense", "paged", "moe"])
def test_retried_launches_count_partial_attempts(smoke, chaos_kw, mode):
    """A run with retries launches the per-step counts times every
    dispatch that ran in full (sample retries included), plus what each
    faulted attempt launched before its faulted site — the site itself
    launching nothing; a crash restored from a snapshot taken every tick
    loses no launch."""
    from repro_torch.kernels import substrate
    from repro_torch.models import lm
    from repro_torch.runtime.chaos import ChaosConfig
    from repro_torch.serving import (EngineCrash, Request, ServeConfig,
                                     ServingEngine)
    cfg = _reduced("qwen3-moe-30b-a3b" if mode == "moe" else "qwen2-0.5b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    kw = dict(kv_pages=12, page_size=8) if mode == "paged" else {}
    sc = ServeConfig(max_batch=2, max_seq=32, prefill_chunk=4,
                     snapshot_every_ticks=1, chaos=ChaosConfig(**chaos_kw),
                     **kw)
    eng = ServingEngine(cfg, params, sc, device="cpu")
    for i, p in enumerate([[5, 6, 7], [11, 12, 13, 14, 15], [21]]):
        eng.submit(Request(prompt=p, max_new_tokens=4, rid=i))
    substrate.DISPATCH_COUNTS.clear()
    for _ in range(4):
        try:
            eng.run_to_completion()
            break
        except EngineCrash:
            eng = ServingEngine.restore(cfg, params, sc,
                                        eng.latest_snapshot(), device="cpu")
    log = eng._chaos.chaos_log
    assert _dispatched(smoke, cfg) == smoke.retried_launches(
        cfg, eng.stats, log)
    draws = 11 if mode == "moe" else 18     # the first traces' draws
    if chaos_kw.get("gemm_fault_at", draws) < draws:
        assert eng.stats["kernel_fault_retries"] == 1


# ------------------------------------------------ the SSM cell and the hybrid
@pytest.mark.parametrize("arch,kw", [("mamba2-370m", {}),
                                     ("mamba2-370m", {"d_ff": 0}),
                                     ("jamba-1.5-large-398b", {})],
                         ids=["mamba2", "mamba2-noffn", "jamba"])
def test_ssm_step_sites_are_the_dispatch_order(smoke, arch, kw, monkeypatch):
    """Each sub-layer's sites follow its ``lm.sublayer_kind``: a mamba
    layer's four GEMMs, an attention layer's six dispatches, a dense MLP's
    two, an MoE's four, none for ``mlp=None``; the unembed last."""
    from repro_torch.kernels import substrate
    from repro_torch.models import lm
    cfg = dataclasses.replace(_reduced(arch), **kw)
    order = []
    real = substrate._record

    def record(site, plan, launches=1):
        order.append(site)
        real(site, plan, launches)

    monkeypatch.setattr(substrate, "_record", record)
    params = lm.init_params(cfg, seed=0, device="cpu")
    zero = torch.zeros(2, dtype=torch.int64)
    lm.decode_step(cfg, params, lm.init_cache(cfg, 2, 16, device="cpu"),
                   zero, zero)
    assert order == smoke.step_sites(cfg)
    if kw.get("d_ff") == 0:
        assert order == list(smoke.MAMBA_SITES) * cfg.n_layers + ["unembed"]


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8",
                                     "arrayflex_w8a8"])
def test_ssm_launch_plan_at_full_width(smoke, backend):
    """Full-width mamba2-370m: 193 K1 launches a step (48 layers x 4 mamba
    sites, and the unembed), no K2; in bf16 all on the tensor-core K1 but
    under W8A8; its full-sequence prefill the same 193, never K2 or K3."""
    cfg = _cfg("mamba2-370m", backend, "bfloat16")
    want = smoke.expected_launches(cfg, 1)
    form = {"arrayflex": "arrayflex_gemm", "arrayflex_int8":
            "arrayflex_gemm_int8", "arrayflex_w8a8": "arrayflex_gemm_w8a8"}
    assert {k: v for k, v in want.items() if v} == (
        {form[backend]: 193} if backend == "arrayflex_w8a8"
        else {form[backend]: 193, form[backend] + "_tc": 193})
    fwd = smoke.forward_launches(_cfg("mamba2-370m", "arrayflex", "bfloat16"),
                                 smoke.SSM_FWD_SEQ)
    assert {k: v for k, v in fwd.items() if v} == {
        "arrayflex_gemm": 193, "arrayflex_gemm_tc": 193}
    fp32 = smoke.forward_launches(_cfg("mamba2-370m", "arrayflex", "float32"),
                                  smoke.SSM_FWD_SEQ)
    assert {k: v for k, v in fp32.items() if v} == {"arrayflex_gemm": 193}


def test_ssm_sites_are_the_mixer_and_unembed_shapes(smoke):
    """Phase 3's mamba2 sites at decode (M = 4) and at the full prefill
    (M = 2048, the unembed of every row): N = 2048, 2304, 32 and 1024 and
    the padded vocab; the SSM cell has no cell-wide exemption: its float
    checks take KERNEL_TOL (a flip must be named in TC_FLIP_SITES), its
    int8 forms ``step_tol``."""
    cfg = _cfg("mamba2-370m", "arrayflex", "bfloat16")
    for rows, form in ((smoke.BATCH, "float"), (smoke.SSM_FWD_SEQ, "w8a8")):
        sites = {s.name: s for s in smoke.ssm_sites(cfg, rows, form)}
        assert {n: s.shape for n, s in sites.items()} == {
            "mamba.z": (rows, 1024, 2048), "mamba.xbc": (rows, 1024, 2304),
            "mamba.dt": (rows, 1024, 32), "mamba.out": (rows, 2048, 1024),
            "unembed": (rows, 1024, 50432)}
        assert all(s.form == form and s.cell == "mamba2-370m"
                   for s in sites.values())
        assert [s.per_step for s in sites.values()] == [48] * 4 + [1]
        assert sites["unembed"].flags == {"out_f32": True}
        assert all(not s.flags for n, s in sites.items() if n != "unembed")
        for dt in (torch.bfloat16, torch.float32):
            assert smoke.kernel_tol(sites["mamba.dt"], dt, 3.0) == (
                smoke.step_tol(dt, 3.0) if form != "float"
                else smoke.KERNEL_TOL[dt] * 3.0)
    # mamba.dt at decode: 32 columns, 16 a block on the narrow int8 tile
    assert smoke.narrow_int8_cols(smoke.BATCH, 32) == 16


@pytest.mark.parametrize("case", ["mamba2", "jamba"])
def test_retried_launches_count_partial_attempts_ssm(smoke, case):
    """An SSM run whose first step faults at the last layer's mamba.out
    (every dispatch drawing: ``per_dispatch``) and whose first sampling is
    NaN; a hybrid run whose first trace faults at its first mlp.wo (each
    label drawing once): the launches are the full steps' plus what each
    faulted attempt launched before its site."""
    from repro_torch.kernels import substrate
    from repro_torch.models import lm
    from repro_torch.runtime.chaos import ChaosConfig
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    arch = "mamba2-370m" if case == "mamba2" else "jamba-1.5-large-398b"
    cfg = _reduced(arch)
    params = lm.init_params(cfg, seed=0, device="cpu")
    seq = smoke.step_sites(cfg)
    if case == "mamba2":
        n = len(seq) - 1 - seq[::-1].index("mamba.out")
        chaos_cfg = ChaosConfig(gemm_fault_at=n, nan_logits_at=0)
        scope = smoke.every_dispatch_draws()
    else:
        n = 5
        chaos_cfg = ChaosConfig(gemm_fault_at=n)
        scope = contextlib.nullcontext()
    eng = ServingEngine(cfg, params, ServeConfig(max_batch=2, max_seq=32,
                                                 chaos=chaos_cfg),
                        device="cpu")
    for i, p in enumerate([[5, 6, 7], [11, 12, 13, 14, 15], [21]]):
        eng.submit(Request(prompt=p, max_new_tokens=4, rid=i))
    substrate.DISPATCH_COUNTS.clear()
    with scope:
        eng.run_to_completion()
    log = eng._chaos.chaos_log
    fault = [e for e in log if e[0] == "substrate.dispatch"]
    assert fault == [("substrate.dispatch", n,
                      "mamba.out" if case == "mamba2" else "mlp.wo")]
    assert _dispatched(smoke, cfg) == smoke.retried_launches(
        cfg, eng.stats, log, per_dispatch=case == "mamba2")
    assert eng.stats["kernel_fault_retries"] == 1
    assert eng.stats["sample_retries"] == (case == "mamba2")


# ------------------------------------- the last families, the dense archs
FAMILIES = [("mixtral-8x22b", {"sliding_window": 4}),
            ("llama-3.2-vision-90b", {}), ("whisper-base", {})]


def _family_batch(cfg, S, n_ctx):
    batch = {"tokens": torch.ones(1, S, dtype=torch.int64)}
    if cfg.family in ("vlm", "audio"):
        batch["image_embeds" if cfg.family == "vlm" else "frames"] = \
            torch.randn(1, n_ctx, cfg.d_frontend)
    return batch


@pytest.mark.parametrize("arch,kw", FAMILIES, ids=[a for a, _ in FAMILIES])
def test_family_step_sites_are_the_dispatch_order(smoke, arch, kw,
                                                  monkeypatch):
    """A cross-attending sub-layer adds xattn.wq, attn.qk, attn.pv and
    xattn.wo at decode, and over a full sequence xattn.wq, xattn.kv
    twice, attn.qk, attn.pv, xattn.wo; ``forward_seq`` puts the vlm's
    frontend.img, or whisper's frontend.audio and encoder layers, first."""
    from repro_torch.kernels import substrate
    from repro_torch.models import lm
    cfg = dataclasses.replace(_reduced(arch), **kw)
    order = []
    real = substrate._record

    def record(site, plan, launches=1):
        order.append(site)
        real(site, plan, launches)

    monkeypatch.setattr(substrate, "_record", record)
    params = lm.init_params(cfg, seed=0, device="cpu")
    zero = torch.zeros(2, dtype=torch.int64)
    lm.decode_step(cfg, params, lm.init_cache(cfg, 2, 16, device="cpu"),
                   zero, zero)
    assert order == smoke.step_sites(cfg)
    order.clear()
    lm.prefill(cfg, params, _family_batch(cfg, 6, 10))
    assert order == [s for s, _ in smoke.forward_seq(cfg, 6, 10)]
    if cfg.family != "moe":
        assert "xattn.kv" in order and "xattn.kv" not in smoke.step_sites(cfg)


@pytest.mark.parametrize("arch,kw", FAMILIES, ids=[a for a, _ in FAMILIES])
def test_family_forward_launches_are_the_dispatched_ones(smoke, arch, kw):
    """``forward_launches`` of a prefill with a context equals the
    launches its dispatches imply (every site on ``arrayflex``; attn.qk /
    attn.pv only on the dense attention path)."""
    from repro_torch.kernels import substrate
    from repro_torch.models import lm
    cfg = dataclasses.replace(_reduced(arch), **kw)
    params = lm.init_params(cfg, seed=0, device="cpu")
    for S, dense_below in ((6, cfg.attn_dense_below), (6, 4)):
        c = dataclasses.replace(cfg, attn_dense_below=dense_below)
        substrate.DISPATCH_COUNTS.clear()
        lm.prefill(c, params, _family_batch(c, S, 10))
        want = smoke.forward_launches(c, S, 10)
        assert _dispatched(smoke, c) == {k: v for k, v in want.items()
                                         if k in ag.LAUNCHES}
        assert sum(want.values()) > 0


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8",
                                     "arrayflex_w8a8"])
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "mixtral-8x22b",
                                  "stablelm-12b"])
def test_recorded_sites_are_the_step_launches(smoke, arch, backend,
                                              monkeypatch):
    """The sites recorded over one decode step (and a batched prefill
    chunk) launch what the step's plan says, form by form: their
    ``per_step`` counts sum to :func:`expected_launches` of one step, each
    carries the k the substrate planned, and the recording leaves the
    wrappers as they were."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServingEngine
    cfg = dataclasses.replace(_reduced(arch), gemm_backend=backend,
                              compute_dtype="bfloat16")
    mm, emm = ops.arrayflex_matmul, ops.arrayflex_expert_matmul
    params = lm.init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(cfg, params, ServeConfig(max_batch=smoke.BATCH,
                                                 max_seq=32), device="cpu")
    for name in ("zeros", "full"):       # the script's tensors on the CPU
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, fn=fn, **k: fn(
            *a, **dict(k, device="cpu")))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    by_phase = smoke.record_step_sites(cfg, eng, 32)
    assert (ops.arrayflex_matmul, ops.arrayflex_expert_matmul) == (mm, emm)
    assert set(by_phase) == ({"decode"} if lm.supports_batched_prefill(cfg)
                             is False else
                             {"decode", f"prefill chunk {eng.prefill_chunk}"})
    want = {k: v for k, v in smoke.expected_launches(cfg, 1).items()
            if v and k not in smoke.TC_COUNTERS}
    for phase, sites in by_phase.items():
        got = {}
        for site in sites:
            got[site.launch_name] = got.get(site.launch_name, 0) + \
                site.per_step
            assert site.k == smoke.planned_k(site), (site.name, site.shape)
            assert 2 <= site.copies <= 24
        assert got == want, phase


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-0.5b", (1, 2)), ("qwen2-0.5b", (2, 2)),
    ("qwen3-moe-30b-a3b", (1, 2)), ("mamba2-370m", (1, 2))])
def test_mesh_launches_are_the_sharded_step_launches(smoke, arch, shape):
    """:func:`mesh_launches` — the launches the mesh phase holds its runs
    to, derived from the shard contexts — is what a decode step (and a
    batched prefill chunk) under the mesh launches, form by form: each
    dispatch once per distinct shard."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm
    from repro_torch.parallel import sharding
    cfg = dataclasses.replace(_reduced(arch), compute_dtype="bfloat16",
                              mesh_shape=shape)
    B, C = smoke.BATCH, 8
    params = lm.prepare_params(cfg, lm.init_params(cfg, seed=0,
                                                   device="cpu"))
    zero = torch.zeros(B, dtype=torch.int64)
    steps = {B: lambda c: lm.decode_step(cfg, params, c, zero, zero)}
    if lm.supports_batched_prefill(cfg):
        steps[B * C] = lambda c: lm.prefill_step(
            cfg, params, c, torch.ones(B, C, dtype=torch.int64), zero,
            torch.full((B,), C))
    with mesh_lib.host_devices(4, "cpu"):
        mesh = sharding.mesh_from_config(cfg)
        for rows, step in steps.items():
            with smoke.recorded_sites("mesh") as sites:
                step(lm.init_cache(cfg, B, 32, device="cpu"))
            got = {}
            for site in sites:
                got[site.launch_name] = got.get(site.launch_name, 0) + \
                    site.per_step
            want = {k: v for k, v in smoke.mesh_launches(
                cfg, {rows: 1}, mesh).items()
                if v and k not in smoke.TC_COUNTERS}
            assert got == want, rows
            unsharded = smoke.expected_launches(cfg, 1)
            assert sum(want.values()) > sum(
                v for k, v in unsharded.items()
                if k not in smoke.TC_COUNTERS)


def test_train_cells_are_the_trainers_defaults_at_full_width(smoke):
    """The training phase's cells: published widths on the xla backend,
    fp32 parameters and bf16 compute, at the trainer's default batch and
    sequence (``launch/train.py``), the depth cut only where stated."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import train
    ap = train.build_argparser()
    assert (smoke.TRAIN_BATCH, smoke.TRAIN_SEQ) == (
        ap.get_default("batch"), ap.get_default("seq"))
    for arch, layers, steps, lr in smoke.TRAIN_CELLS:
        cfg = smoke.train_cfg(arch, layers)
        full = get_config(arch)
        assert cfg.gemm_backend == "xla"
        assert (cfg.param_dtype, cfg.compute_dtype) == ("float32",
                                                        "bfloat16")
        assert (cfg.d_model, cfg.d_ff, cfg.vocab_size) == (
            full.d_model, full.d_ff, full.vocab_size)
        assert cfg.n_layers == (layers or full.n_layers) and steps >= 3
        assert 0 < lr <= 3e-4
        b = SyntheticLM(DataConfig(seq_len=smoke.TRAIN_SEQ,
                                   global_batch=smoke.TRAIN_BATCH,
                                   vocab_size=cfg.vocab_size)).batch_at(0)
        assert b["tokens"].shape == b["labels"].shape == (8, 256)
    assert [c[0] for c in smoke.TRAIN_CELLS] == [
        "qwen2-0.5b", "mamba2-370m", "qwen3-moe-30b-a3b"]
    parity = smoke.train_cfg("qwen2-0.5b", smoke.PARITY_TRAIN_LAYERS,
                             compute_dtype="float32")
    assert parity.n_layers == 2 and parity.compute_dtype == "float32"


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_sharded_train_meshes_are_built_exactly(smoke, shape):
    """Phase 7 (e)'s meshes fit the four logical devices it opens, so
    ``train.host_mesh`` builds each exactly (a clamped mesh would train
    another sharding than the one reported), and every GEMM's rows (B x S
    at the trainer's defaults) divide the data axis; the card run's
    tolerances are no looser than stated."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    assert shape in smoke.SHARDED_TRAIN_MESHES
    with mesh_lib.host_devices(4, "cpu"):
        got = train.host_mesh(*shape, torch.device("cpu"))
    assert got.shape == {"data": shape[0], "model": shape[1]}
    assert (smoke.TRAIN_BATCH * smoke.TRAIN_SEQ) % shape[0] == 0
    assert smoke.SHARDED_TRAIN_LOSS_TOL <= 5e-3
    assert smoke.MICRO_LOSS_TOL <= 1e-3 and smoke.MICRO_PARAM_LR <= 0.5
    assert smoke.MICRO_GRAD_RTOL <= 2**-6


def test_timed_train_steps_time_each_step(smoke, monkeypatch):
    """The wrapper phase 7 (e) puts around ``api.make_train_step`` returns
    the step's own result and appends one time per step."""
    from repro_torch.models import api
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(api, "make_train_step",
                        lambda *a, **k: (lambda *s: ("out", s)))
    times = []
    step = smoke._timed_train_steps(times)("cfg", "oc")
    assert step(1, 2) == ("out", (1, 2)) and step(3) == ("out", (3,))
    assert len(times) == 2 and all(t >= 0 for t in times)


@pytest.mark.parametrize("n,every,fail", [(8, 3, 5), (8, 3, 6), (8, 3, 2),
                                          (10, 4, 9), (6, 2, 0)])
def test_restart_schedule_follows_the_fault_manager(smoke, tmp_path, n,
                                                    every, fail):
    """``restart_schedule`` predicts the steps ``FaultToleranceManager``
    runs (a failure with no checkpoint yet replays from 0: a cold
    restart) and the checkpoints it writes."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import FaultToleranceManager, HeartbeatMonitor
    ran, fired = [], []

    class Steps:
        def batch_at(self, step):
            return step

    def step_fn(state, batch):
        ran.append(batch)
        return {"n": state["n"] + 1}

    def inject(step):
        if step == fail and not fired:
            fired.append(step)
            raise RuntimeError("injected")

    mgr = CheckpointManager(str(tmp_path), keep=100)
    ft = FaultToleranceManager(mgr, HeartbeatMonitor(1), ckpt_every=every)
    state, steps, restarts = ft.run({"n": np.int64(0)}, step_fn, Steps(), n,
                                    inject_failure=inject,
                                    cold_restart="restart")
    want_ran, want_saved = smoke.restart_schedule(n, every, fail)
    assert ran == want_ran and mgr.all_steps() == want_saved
    assert steps == n and restarts == 1 and int(state["n"]) == n
    assert smoke.restart_schedule(smoke.RESTART_STEPS,
                                  smoke.RESTART_CKPT_EVERY,
                                  smoke.RESTART_FAIL_AT) == (
        [0, 1, 2, 3, 4, 3, 4, 5, 6, 7], [3, 6])


def test_audit_phase_rehearsed_on_the_cpu(smoke):
    """Phase 9 end to end at reduced size on the CPU (the wrappers' plain
    versions): every cell as phase 9 wants it, the strict serve equal to
    the plain one, the refused dispatch, the static checks."""
    from repro_torch.configs import reduced
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = smoke.audit_phase("cpu", reduced(get_config("qwen2-0.5b")),
                                device="cpu")
    finally:
        torch.set_num_threads(n)
    codes = {c["cell"]: c["codes"] for c in out["cells"]}
    assert codes == {
        **{f"qwen2-0.5b/{b}/raw": (["AF008"] if b in ("arrayflex_int8",
                                                       "arrayflex_w8a8")
                                    else [])
           for b in smoke.AUDIT_BACKENDS},
        "qwen2-0.5b/arrayflex_int8/served": [],
        "qwen2-0.5b/arrayflex_w8a8/served": [],
        "qwen2-0.5b/arrayflex_int8/tp2": [],
        **{f"qwen2-0.5b/{b}/{r}-pp2": [] for b in smoke.BACKENDS
           for r in ("prefill", "decode")}}
    assert out["serve"]["strict"]["streams"] == out["serve"]["plain"]["streams"]
    assert len(out["runs"]) == len(out["cells"]) + 2
    assert set(out["decode_step_ms"]) == {"plain", "audited"}


def test_examples_phase_rehearsed_on_the_cpu(smoke):
    """Phase 10 end to end on the CPU at a small size (train_lm --small
    for 3 steps, fault_tolerant_training 12 steps with the failure at 5,
    serve_lm reduced only): the quickstart equal to its own CPU run, the
    plain versions taken (a CPU tensor's path), the restart bit-equal,
    the quickstart script's lines the in-process run's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = smoke.examples_phase(
            "cpu", device="cpu", train=dict(steps=3, small=True),
            ft=dict(steps=12, fail_at=5, ckpt_every=4), full_serve=False)
    finally:
        torch.set_num_threads(n)
    assert len(out["runs"]) == 5
    assert all(not any(r["launches"].values()) for r in out["runs"])
    assert out["quickstart"]["plain_calls"]["arrayflex_gemm_plain"] > 0
    assert out["fault_tolerant"]["bit_equal"]
    assert out["fault_tolerant"]["restarts"] == 1
    assert out["subprocess"]["rc"] == 0
    assert out["serve_lm"]["reduced"]["outcomes"] == ["ok"] * 6
    assert len(out["train_lm"]["losses"]) == 3
    assert set(smoke.EXAMPLE_FORMS) <= set(smoke.REPLACES)
