"""The port's substrate-contract auditor (``repro_torch.analysis``) against
the reference's (``repro.analysis``).

Modelled on the reference's ``tests/test_analysis.py``: every finding code
has a seeded test that plants exactly one violation and gets exactly that
code.  Then parity, all exact: ``CODES``, the plan-key tables, AF005's
boundary-op counts on all 80 (Epilogue spec x quantization) cases, the
finding-code set and the recorded site set of every entry of the
reference's clean cells and of its int8 / W8A8 raw and pre-quantized
cells, and the (code, line) pairs of the reference's seeded lint sources
written in torch.  Then strict audit, at the substrate, in the serving
engine and through ``serve.py --strict-audit``.  The reference's results
are computed once per module.
"""
import dataclasses
import textwrap

import pytest
import torch

from repro.analysis import ast_lint as ref_lint
from repro.analysis import contract as ref_contract
from repro.analysis import jaxpr_audit as ref_audit
from repro.analysis import kernel_check as ref_kc
from repro.analysis.findings import CODES as REF_CODES
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels import substrate as ref_substrate
from repro.kernels.arrayflex_gemm import store_phase as ref_store_phase
from repro.models import lm as ref_lm
from repro_torch.analysis import (ast_lint, contract, dispatch_audit as da,
                                  kernel_check)
from repro_torch.analysis.findings import CODES, Finding, Report
from repro_torch.configs import get_config, reduced
from repro_torch.core import planner
from repro_torch.kernels import substrate
from repro_torch.kernels.arrayflex_gemm import store_phase
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.roofline import trace
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving.engine import Request


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def codes(findings):
    return sorted({f.code for f in findings})


def _cfg(arch="qwen2-0.5b", backend="arrayflex", **kw):
    return dataclasses.replace(reduced(get_config(arch)),
                               gemm_backend=backend, **kw)


# ---------------------------------------------------------------------------
# findings / report plumbing

def test_codes_and_severities_equal_the_reference():
    assert set(CODES) == set(REF_CODES)
    assert {c: s for c, (s, _) in CODES.items()} == \
        {c: s for c, (s, _) in REF_CODES.items()}
    for code, (sev, desc) in CODES.items():
        assert sev in ("error", "warning") and desc, code


def test_finding_severity_defaults_from_codes():
    assert Finding("AF001", "x", "m").severity == "error"
    assert Finding("AF008", "x", "m").severity == "warning"
    assert Finding("ZZ999", "x", "m").severity == "error"   # unknown: strict


def test_report_exit_code_and_json():
    r = Report()
    r.extend([Finding("AF008", "a", "warn-only")])
    assert r.ok and r.exit_code == 0 and len(r.warnings) == 1
    r.extend([Finding("AF001", "b", "boom")])
    assert not r.ok and r.exit_code == 1
    d = r.to_dict()
    assert d["n_errors"] == 1 and d["n_warnings"] == 1
    assert d["findings"][1]["code"] == "AF001"
    assert set(d) == {"ok", "n_errors", "n_warnings", "meta", "findings"}


# ---------------------------------------------------------------------------
# the contract

def test_allowlist_is_the_references_plus_one_named_entry():
    """The port's allowlist is the reference's five entries, reasons
    included, plus exactly one named entry of its own."""
    ref = {(k[0].replace("\\", "/"), k[1]): v
           for k, v in ref_contract.ALLOWLIST.items()}
    port = {(k[0].replace("\\", "/"), k[1]): v
            for k, v in contract.ALLOWLIST.items()}
    assert {k: port[k] for k in ref} == ref
    assert set(port) - set(ref) == {("nn/moe.py", "_einsum")}
    assert [s.replace("\\", "/") for s in contract.SUBSTRATE_FILES] == \
        [s.replace("\\", "/") for s in ref_contract.SUBSTRATE_FILES]


def test_port_only_allowlist_entry_is_load_bearing(monkeypatch):
    """Without its entry the port's tree lints with exactly one AFL01, at
    the raw einsum of moe._einsum."""
    key = ("nn/moe.py".replace("/", contract.os.sep), "_einsum")
    trimmed = {k: v for k, v in contract.ALLOWLIST.items() if k != key}
    monkeypatch.setattr(contract, "ALLOWLIST", trimmed)
    found = ast_lint.run()
    assert codes(found) == ["AFL01"] and len(found) == 1
    assert found[0].where.startswith("src/repro_torch/nn/moe.py:")


def test_repro_rel_keys_on_the_port():
    assert contract.repro_rel("/x/src/repro_torch/nn/moe.py") == "nn/moe.py"
    assert contract.repro_rel("/x/src/repro/nn/moe.py") is None
    assert contract.classify_frames(
        [("/x/tests/t.py", "f"), ("/x/src/repro_torch/kernels/substrate.py",
                                  "gemm")]) == ("substrate",
                                                "kernels/substrate.py")


# ---------------------------------------------------------------------------
# dispatch audit: parity with the reference's jaxpr audit

PARITY_CELLS = [
    ("qwen2-0.5b", "xla", False),
    ("qwen2-0.5b", "arrayflex", False),
    ("qwen3-moe-30b-a3b", "arrayflex", False),
    ("mamba2-370m", "arrayflex", False),
    ("qwen2-0.5b", "arrayflex_int8", False),
    ("qwen2-0.5b", "arrayflex_int8", True),
    ("qwen2-0.5b", "arrayflex_w8a8", False),
    ("qwen2-0.5b", "arrayflex_w8a8", True),
]
CELL_IDS = [f"{a}-{b}{'-prequantized' if p else ''}"
            for a, b, p in PARITY_CELLS]


@pytest.fixture(scope="module")
def ref_cells():
    """Per cell: the reference's ``jaxpr_audit.audit_model`` findings and
    each entry's recorded site set (the ``DISPATCH_COUNTS`` keys each
    entry's trace left, read where ``audit_model`` clears them before the
    next entry)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        seen = []
        clear = ref_substrate.clear_plan_cache

        def spy():
            seen.append(set(ref_substrate.DISPATCH_COUNTS))
            clear()

        mp.setattr(ref_substrate, "clear_plan_cache", spy)
        for arch, backend, pq in PARITY_CELLS:
            cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                      gemm_backend=backend)
            entries = ["forward", "decode_step"] + (
                ["prefill_step"] if ref_lm.supports_batched_prefill(cfg)
                else [])
            del seen[:]
            found = ref_audit.audit_model(cfg, prequantize=pq)
            out[(arch, backend, pq)] = (found,
                                        dict(zip(entries, seen[1:])))
    return out


@pytest.fixture(scope="module")
def port_cells():
    out = {}
    for arch, backend, pq in PARITY_CELLS:
        meta = {}
        found = da.audit_model(_cfg(arch, backend), prequantize=pq,
                               device="cpu", meta=meta)
        out[(arch, backend, pq)] = (found, meta)
    return out


@pytest.mark.parametrize("cell", PARITY_CELLS, ids=CELL_IDS)
def test_dispatch_audit_codes_match_reference(cell, ref_cells, port_cells):
    ref_found, _ = ref_cells[cell]
    found, _ = port_cells[cell]
    assert codes(found) == codes(ref_found), "\n".join(map(str, found))
    # the reference's clean / AF008-only expectations hold in the port
    _, backend, pq = cell
    if backend in ("arrayflex_int8", "arrayflex_w8a8") and not pq:
        assert codes(found) == ["AF008"]
    else:
        assert found == [], "\n".join(map(str, found))


@pytest.mark.parametrize("cell", PARITY_CELLS, ids=CELL_IDS)
def test_dispatch_audit_site_sets_match_reference(cell, ref_cells,
                                                  port_cells):
    _, ref_sites = ref_cells[cell]
    _, meta = port_cells[cell]
    assert list(meta) == list(ref_sites)
    for entry, sites in ref_sites.items():
        assert set(meta[entry]["sites"]) == sites, entry


@pytest.mark.parametrize("cell", PARITY_CELLS, ids=CELL_IDS)
def test_kernel_calls_equal_dispatches(cell, port_cells):
    """One K1 / K2 wrapper call per dispatch on the arrayflex backends
    (unsharded), none on xla, no K3; no fallback on the CPU."""
    _, backend, _ = cell
    _, meta = port_cells[cell]
    for entry, m in meta.items():
        calls = sum(m["launches"].values())
        if backend == "xla":
            assert calls == 0, entry
        else:
            assert calls == m["dispatches"] > 0, entry
            assert set(m["launches"]) <= {"arrayflex_gemm",
                                          "arrayflex_expert_gemm"}
        assert m["fallbacks"] == []


def test_dispatch_audit_tp2_int8_warns_af008_only():
    meta = {}
    with mesh_lib.host_devices(2, "cpu"):
        found = da.audit_model(_cfg(backend="arrayflex_int8",
                                    mesh_shape=(1, 2)),
                               device="cpu", meta=meta)
    assert codes(found) == ["AF008"]
    # every sharded dispatch is two shard launches at tp 2
    for m in meta.values():
        assert sum(m["launches"].values()) == 2 * m["dispatches"]


def test_w8a8_actq_declaration_is_load_bearing():
    """The W8A8 forward audited WITHOUT the act_quantize declaration flags
    the plain version's per-tile activation casts as rogue AF003."""
    cfg = _cfg(backend="arrayflex_w8a8")
    params = lm_prequantized(cfg)
    tokens = torch.zeros((da.B, da.S), dtype=torch.int64)
    da.reset_memos()
    with torch.no_grad():
        rec = da.record(da.lm.forward, cfg, params, {"tokens": tokens})
    da.reset_memos()
    assert "AF003" in codes(da.audit_record(rec, quantized=True,
                                            act_quantized=False))
    assert da.audit_record(rec, quantized=True, act_quantized=True) == []


def lm_prequantized(cfg):
    return da.lm.prequantize_params(
        cfg, da.lm.init_params(cfg, seed=0, device="cpu"))


def test_audit_raises_without_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        da.audit_model(_cfg())


# ---------------------------------------------------------------------------
# dispatch audit: seeded violations (one per code)

def test_seeded_af001_bypass_gemm():
    def bypass(x, w):
        return x @ w                    # test-file frames: unattributed

    rec = da.record(bypass, torch.ones(4, 8), torch.ones(8, 4))
    assert codes(da.audit_record(rec)) == ["AF001"]


def test_seeded_af002_bf16_psum_on_quantized_path():
    def psum(x):
        trace.collective("all-reduce", x, 2)
        return x

    rec = da.record(psum, torch.ones(4, 4, dtype=torch.bfloat16))
    assert codes(da.audit_record(rec, quantized=True)) == ["AF002"]
    # same run on a non-quantized path, no substrate frames: tolerated
    assert da.audit_record(rec, quantized=False) == []


def test_seeded_af002_unpriced_psum_boundary():
    """A ShardCtx with forced ``reduce_axes`` over a 1-device mesh makes
    ``_sharded_gemm`` take the psum path while ``signature()`` prices
    ceil(log2(1)) == 0 reduce ops (the reference's seeded case)."""
    with mesh_lib.host_devices(1, "cpu"):
        mesh = mesh_lib.make_host_mesh(1, 1)
    ctx = substrate.ShardCtx(mesh, (None, "model"), ("model", None),
                             (None, None), reduce_axes=("model",))
    x = torch.ones(4, 8)
    w = torch.ones(8, 4)
    substrate.clear_plan_cache()
    try:
        rec = da.record(lambda a, b: substrate.gemm(a, b, site="mlp.wo",
                                                    shard=ctx), x, w)
        plan = rec.site_plans["mlp.wo"]
        assert plan.shard.reduce_ops == 0          # the seeded mispricing
        found = da.check_psum_boundaries(rec, quantized=True)
        assert found and codes(found) == ["AF002"]
        assert "reduce_ops" in found[0].message
        priced = dataclasses.replace(
            plan, shard=dataclasses.replace(plan.shard, reduce_ops=1))
        assert da.check_psum_boundaries(
            rec, quantized=True, site_plans={"mlp.wo": priced}) == []
        assert da.check_psum_boundaries(rec, quantized=False) == []
        assert da.audit_record(rec, quantized=True) == []   # fp32 psum
    finally:
        substrate.clear_plan_cache()


def _role_cfg(role, off):
    return _cfg(pp_role=role, pp_stages=2, mesh_shape=(2, 1, 1),
                pod_offset=off)


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8"])
def test_audit_pipeline_roles_clean(backend):
    with mesh_lib.host_devices(4, "cpu"):
        for role, off in (("prefill", 0), ("decode", 2)):
            rcfg = dataclasses.replace(_role_cfg(role, off),
                                       gemm_backend=backend)
            meta = {}
            assert da.audit_pipeline(rcfg, device="cpu", meta=meta) == []
            assert list(meta) == ["decode_step_pp", "prefill_step_pp"]


def test_seeded_af002_unscoped_pipeline():
    """A pipelined step run WITHOUT a role pricing scope hands off with no
    site plan pricing the transfer."""
    with mesh_lib.host_devices(4, "cpu"):
        found = da.audit_pipeline(_role_cfg("", 0), device="cpu")
    assert codes(found) == ["AF002"]
    assert all("collective_permute" in f.message
               and "use_pp_pricing" in f.message for f in found)


def test_seeded_af003_rogue_int8_cast():
    rec = da.record(lambda w: w.to(torch.int8).float() @ w,
                    torch.ones(8, 8))
    assert "AF003" in codes(da.audit_record(rec))
    rec = da.record(lambda w: w.to(torch.int8), torch.ones(8, 8))
    assert codes(da.audit_record(rec)) == ["AF003"]


def test_seeded_af008_in_step_weight_quantization():
    """A raw weight quantized inside the run warns AF008 (the memo
    misses once, then hits: one cast, one warning); on a W8A8 backend
    the same cast is still weight quantization, not an activation's."""
    w = torch.randn(8, 8)
    da.reset_memos()
    rec = da.record(lambda t: [substrate.quantize_weight(t)
                               for _ in range(2)], w)
    da.reset_memos()
    found = da.audit_record(rec, quantized=True)
    assert codes(found) == ["AF008"] and len(found) == 1
    assert codes(da.audit_record(rec, quantized=True,
                                 act_quantized=True)) == ["AF008"]


def test_seeded_af007_unknown_site_label():
    found = da.check_recorded_sites(counts={"attn.wq": 1, "bogus.site": 2})
    assert codes(found) == ["AF007"]
    assert "bogus.site" in found[0].message or "bogus.site" in found[0].where


def test_seeded_af007_config_foreign_site():
    found = da.check_recorded_sites(_cfg(), counts={"moe.router": 1})
    assert codes(found) == ["AF007"]
    assert da.check_recorded_sites(_cfg("qwen3-moe-30b-a3b"),
                                   counts={"moe.router": 1}) == []


def test_fallback_is_a_contraction_on_a_cuda_tensor_under_a_plain_frame():
    frames = (("/x/src/repro_torch/kernels/arrayflex_gemm.py",
               "arrayflex_gemm_plain"),
              ("/x/src/repro_torch/kernels/arrayflex_gemm.py",
               "arrayflex_gemm"))
    rec = da.Record(events=[
        da.Event("contraction", "mm", frames, cuda=True),
        da.Event("contraction", "mm", frames, cuda=False),
        da.Event("contraction", "mm", frames[1:], cuda=True)])
    assert da.fallbacks(rec) == [
        "kernels/arrayflex_gemm.py:arrayflex_gemm_plain aten.mm"]


def test_kernel_calls_are_counted_through_the_trace_hooks():
    from repro_torch.kernels import ops
    rec = da.record(ops.arrayflex_matmul, torch.ones(4, 8),
                    torch.ones(8, 4), k_collapse=1)
    assert rec.launches == {"arrayflex_gemm": 1}
    with trace.listening(trace.Listener()):
        with pytest.raises(RuntimeError, match="already active"):
            with trace.listening(trace.Listener()):
                pass


# ---------------------------------------------------------------------------
# kernel <-> timing consistency

def test_kernel_check_clean():
    assert kernel_check.run() == []


def _epilogues():
    return [(ep, q) for ep in kernel_check._valid_epilogues()
            for q in (False, True)]


@pytest.mark.parametrize(
    "ep,quant", _epilogues(),
    ids=[f"{e.kind}-b{e.bias:d}{e.bias2:d}-r{e.residual:d}"
         f"-n{e.norm_scale:d}-q{q:d}" for e, q in _epilogues()])
def test_af005_counts_match_reference(ep, quant):
    got = kernel_check._count_store_ops(store_phase, ep, quant)
    ref_ep = ref_substrate.Epilogue(**dataclasses.asdict(ep))
    want = ref_kc._count_store_ops(ref_store_phase, ref_ep, quant)
    assert vars(got) == vars(want)
    assert got.total + got.dequant_muls == ep.ops + (
        ep.contractions if quant else 0)


def test_plan_key_tables_match_reference():
    ref_call = {k: v for k, v in ref_substrate.CALL_FIELD_KEYING.items()
                if k != "interpret"}
    assert substrate.CALL_FIELD_KEYING == ref_call
    assert substrate.BACKEND_FIELD_KEYING == ref_substrate.BACKEND_FIELD_KEYING
    assert substrate.PLAN_KEY_PARAMS == ref_substrate.PLAN_KEY_PARAMS


def test_seeded_af005_store_drops_bias():
    def broken_store(y, y2=None, w_scale=None, w2_scale=None, bias=None,
                     bias2=None, activation="none", residual=None):
        return store_phase(y, y2, w_scale, w2_scale, None, bias2,
                           activation, residual)  # silently ignores bias

    found = kernel_check.check_epilogue_pricing(store_fn=broken_store)
    assert found and codes(found) == ["AF005"]
    assert all("bias=True" in f.where for f in found)


def test_seeded_af005_extra_unpriced_op():
    def gilded_store(y, y2=None, w_scale=None, w2_scale=None, bias=None,
                     bias2=None, activation="none", residual=None):
        out = store_phase(y, y2, w_scale, w2_scale, bias, bias2,
                          activation, residual)
        return out * torch.tanh(out)            # fused but never priced

    found = kernel_check.check_epilogue_pricing(store_fn=gilded_store)
    assert found and codes(found) == ["AF005"]


def test_seeded_af006_undeclared_gemmcall_field():
    keying = dict(substrate.CALL_FIELD_KEYING)
    del keying["bias"]                        # field with no keying story
    found = kernel_check.check_plan_key(call_keying=keying)
    assert codes(found) == ["AF006"]
    assert any("GemmCall.bias" in f.where for f in found)


def test_seeded_af006_stale_declaration_and_bad_attr():
    keying = dict(substrate.CALL_FIELD_KEYING)
    keying["ghost"] = "operand: field that no longer exists"
    keying["bias"] = "epilogue:no_such_attr"
    found = kernel_check.check_plan_key(call_keying=keying)
    assert codes(found) == ["AF006"] and len(found) == 2


def test_seeded_af006_noncompare_key_field():
    @dataclasses.dataclass(frozen=True)
    class LeakySig:
        rows: int = 1
        note: str = dataclasses.field(default="", compare=False)

    found = kernel_check.check_plan_key(shard_cls=LeakySig)
    assert codes(found) == ["AF006"]
    assert any("LeakySig.note" in f.where for f in found)


def test_seeded_af006_key_signature_drift():
    found = kernel_check.check_plan_key(
        key_params=("M", "N", "T", "backend", "epilogue"))
    assert codes(found) == ["AF006"]


@pytest.mark.parametrize("instr,bad", [
    ("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16", True),
    ("mma.sync.aligned.m16n8k16.row.col.bf16.bf16.bf16.bf16", True),
    ("wgmma.mma_async.sync.aligned.m64n128k16.f16.bf16.bf16", True),
    ("mma.sync.aligned.m16n8k32.row.col.f32.s8.s8.f32", True),
    ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32", False),
    ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16", False),
    ("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32", False),
])
def test_seeded_af004_mma_accumulator(tmp_path, instr, bad):
    src = tmp_path / "k.cu"
    src.write_text(textwrap.dedent(f"""\
        // {instr} in a comment is not an instruction
        __device__ void mma(float* d) {{
          asm volatile(
              "{instr} "
              "{{%0,%1}}, {{%2}}, {{%3}}, {{%4,%5}};\\n" : : );
        }}
    """))
    found = kernel_check.check_mma_accumulators([src], root=tmp_path)
    assert codes(found) == (["AF004"] if bad else [])
    if bad:
        assert len(found) == 1 and found[0].where.endswith("k.cu:4")


def test_af004_reads_the_port_sources():
    """The two MMA strings the kernels use today are found and clean."""
    n = sum(len(kernel_check._MMA.findall(p.read_text()))
            for p in list(kernel_check.CSRC.glob("*.cu"))
            + list(kernel_check.CSRC.glob("*.cuh")))
    assert n >= 2
    assert kernel_check.check_mma_accumulators() == []


# ---------------------------------------------------------------------------
# AST lint

def test_lint_repo_clean():
    found = ast_lint.run()
    assert found == [], "\n".join(str(f) for f in found)


# the reference's seeded lint sources (tests/test_analysis.py), as
# (zone file, reference source, the same source written in torch)
_SNEAKY = """\
    import {imp}
    from {pkg}.kernels import substrate

    def sneaky(x, w):
        y = x @ w
        z = {mod}.einsum("ij,jk->ik", x, w)
        h = substrate.gemm(x, w)
        g = substrate.gemm(x, w, site="totally.bogus")
        substrate.DISPATCH_COUNTS.clear()
        substrate.SITE_PLANS["x"] = None
        return y + z + h + g
"""
_PAGED = """\
    def hijack(pool, seq, node):
        pool.free_pages.append(3)
        pool.refcounts[4] += 1
        seq.block_table[0] = 7
        node.children.pop(("a",))
        return seq
"""
_CHAOS = """\
    def hijack(chaos_engine, engine):
        chaos_engine.chaos_draws["engine.tick"] = 0
        chaos_engine.chaos_draws.update({"pool.alloc": 9})
        chaos_engine.chaos_log.append(("engine.tick", 0, "forged"))
        engine._snapshots.pop()
        engine._snapshots[0] = {}
        return engine
"""
_ALLOWED = """\
    from {pkg}.kernels import substrate

    def moe_apply_reference(x, w):
        return x @ w

    def linear(x, w, site):
        return substrate.gemm(x, w, site=site)
"""
SEEDED_LINT = [
    ("nn/bad.py", _SNEAKY.format(imp="jax.numpy as jnp", pkg="repro",
                                 mod="jnp"),
     _SNEAKY.format(imp="torch", pkg="repro_torch", mod="torch")),
    ("serving/rogue.py", _PAGED, _PAGED),
    ("serving/rogue.py", _CHAOS, _CHAOS),
    ("nn/moe.py", _ALLOWED.format(pkg="repro"),
     _ALLOWED.format(pkg="repro_torch")),
    ("kernels/somekernel.py", "def f(x, w):\n    return x @ w\n",
     "def f(x, w):\n    return x @ w\n"),
]


def _write(root, rel, text):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(text))
    return path


@pytest.mark.parametrize("rel,ref_src,src", SEEDED_LINT,
                         ids=["sneaky", "paged", "chaos-snapshot",
                              "allowlisted", "kernels-zone"])
def test_lint_seeded_pairs_match_reference(tmp_path, rel, ref_src, src):
    _write(tmp_path / "ref", rel, ref_src)
    _write(tmp_path / "port", rel, src)
    want = ref_lint.lint_paths([tmp_path / "ref"], root=tmp_path / "ref")
    got = ast_lint.lint_paths([tmp_path / "port"], root=tmp_path / "port")
    pairs = sorted((f.code, int(f.where.rsplit(":", 1)[1])) for f in got)
    assert pairs == sorted((f.code, int(f.where.rsplit(":", 1)[1]))
                           for f in want)
    assert all(f.where.startswith(f"src/repro_torch/{rel}:") for f in got)


def test_lint_seeded_violations(tmp_path):
    _write(tmp_path, "nn/bad.py", SEEDED_LINT[0][2])
    found = ast_lint.lint_paths([tmp_path], root=tmp_path)
    by_code = {c: [f for f in found if f.code == c] for c in codes(found)}
    assert codes(found) == ["AFL01", "AFL02", "AFL03"]
    assert len(by_code["AFL01"]) == 2       # `@` and einsum
    assert len(by_code["AFL02"]) == 2       # missing site=, bogus label
    assert len(by_code["AFL03"]) == 2       # .clear() and subscript write


@pytest.mark.parametrize("call,raw", [
    ("torch.mm(x, w)", True), ("x.bmm(w)", True), ("torch.matmul(x, w)", True),
    ("F.linear(x, w)", True), ("torch.nn.functional.linear(x, w)", True),
    ("F.conv1d(x, w)", True), ("torch.addmm(b, x, w)", True),
    ("torch._int_mm(x, w)", True), ("x.matmul(w)", True),
    ("layers.linear(p, x, site='mlp.wo')", False), ("x.sum(-1)", False),
])
def test_lint_torch_raw_gemm_syntax(tmp_path, call, raw):
    _write(tmp_path, "models/m.py", f"def f(x, w, b, p):\n    return {call}\n")
    found = ast_lint.lint_paths([tmp_path], root=tmp_path)
    assert codes(found) == (["AFL01"] if raw else [])


def test_lint_seeded_weight_block_memo_mutation(tmp_path):
    """The substrate group holds the port's weight-block memo too."""
    _write(tmp_path, "nn/rogue.py", """\
        def hijack(substrate):
            substrate._SHARD_CACHE.clear()
            substrate.SHARD_CACHE_STATS["hits"] = 0
    """)
    found = ast_lint.lint_paths([tmp_path], root=tmp_path)
    assert codes(found) == ["AFL03"] and len(found) == 2
    _write(tmp_path / "own", "kernels/substrate.py", """\
        def clear_shard_cache():
            _SHARD_CACHE.clear()
            SHARD_CACHE_STATS["hits"] = 0
    """)
    assert ast_lint.lint_paths([tmp_path / "own"],
                               root=tmp_path / "own") == []


# ---------------------------------------------------------------------------
# strict-audit runtime enforcement

def test_strict_audit_scope_raises_af007():
    x = torch.ones(4, 8)
    w = torch.ones(8, 4)
    substrate.clear_plan_cache()
    try:
        with substrate.strict_audit_scope():
            substrate.gemm(x, w, site="mlp.wo")          # known label: fine
            with pytest.raises(RuntimeError, match="AF007"):
                substrate.gemm(x, w, site="bogus.site")
            with pytest.raises(RuntimeError, match="AF007.*unlabeled"):
                substrate.gemm(x, w)
        assert "bogus.site" not in substrate.DISPATCH_COUNTS
    finally:
        substrate.clear_plan_cache()


class _Launches(trace.Listener):
    def __init__(self):
        self.calls = 0

    def kernel(self, name, cost, fn, args, kwargs):
        self.calls += 1
        return fn(*args, **kwargs)


@pytest.mark.parametrize("entry", ["gemm", "batched_gemm", "expert_gemm"])
def test_strict_audit_raises_before_any_launch(entry):
    shapes = {"gemm": ((4, 8), (8, 4)), "batched_gemm": ((2, 4, 8), (2, 8, 4)),
              "expert_gemm": ((1, 2, 4, 8), (2, 8, 4))}
    x, w = (torch.ones(s) for s in shapes[entry])
    fn = getattr(substrate, entry)
    counter = _Launches()
    substrate.clear_plan_cache()
    try:
        with trace.listening(counter):
            fn(x, w, site="attn.qk", backend="arrayflex")   # launches
            assert counter.calls == 1
            with substrate.strict_audit_scope(), \
                    pytest.raises(RuntimeError, match="AF007"):
                fn(x, w, site="bogus.site", backend="arrayflex")
        assert counter.calls == 1
    finally:
        substrate.clear_plan_cache()


def test_strict_audit_env_and_contextvar(monkeypatch):
    monkeypatch.delenv("REPRO_STRICT_AUDIT", raising=False)
    assert not substrate.strict_audit_enabled()
    monkeypatch.setenv("REPRO_STRICT_AUDIT", "1")
    assert substrate.strict_audit_enabled()
    with substrate.strict_audit_scope(False):
        assert not substrate.strict_audit_enabled()     # contextvar wins
    monkeypatch.setenv("REPRO_STRICT_AUDIT", "0")
    assert not substrate.strict_audit_enabled()
    with substrate.strict_audit_scope():
        assert substrate.strict_audit_enabled()


def test_strict_audit_off_records_unknown_site():
    substrate.clear_plan_cache()
    try:
        substrate.gemm(torch.ones(4, 8), torch.ones(8, 4), site="bogus.site")
        assert substrate.DISPATCH_COUNTS.get("bogus.site") == 1
        with pytest.raises(RuntimeError, match="AF007"):
            substrate.check_dispatch_sites()
    finally:
        substrate.clear_plan_cache()


def test_check_dispatch_sites_clean():
    substrate.clear_plan_cache()
    try:
        substrate.gemm(torch.ones(4, 8), torch.ones(8, 4), site="mlp.wo")
        substrate.check_dispatch_sites()             # no raise
    finally:
        substrate.clear_plan_cache()


def test_site_registry_covers_model_gemms():
    reg = planner.site_registry()
    assert {"attn.wq", "mlp.wo", "moe.router", "mamba.out",
            "unembed"} <= reg
    assert "bogus.site" not in reg


# ---------------------------------------------------------------------------
# strict serving

def _streams(reqs):
    return [(r.rid, list(r.out_tokens), r.outcome) for r in reqs]


def test_serve_strict_audit_streams_equal_plain(capsys):
    argv = ["--device", "cpu", "--gemm-backend", "arrayflex", "--requests",
            "3", "--max-new", "8"]
    plain = serve.main(argv)
    strict = serve.main(argv + ["--strict-audit"])
    capsys.readouterr()
    assert _streams(strict) == _streams(plain)
    assert all(r.outcome == "ok" for r in strict)
    assert not substrate.strict_audit_enabled()      # the scope ended


def _engine():
    cfg = _cfg()
    params = da.lm.init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(cfg, params, ServeConfig(max_batch=2, max_seq=32),
                        device="cpu")
    req = Request(prompt=[3, 5, 7], max_new_tokens=3, rid=0)
    eng.submit(req)
    return eng, req


def test_engine_propagates_unknown_site_under_strict_audit(monkeypatch):
    """A dispatch under an unknown label inside an engine step raises out
    of run_to_completion: never retried, never a typed outcome."""
    gemm = substrate.gemm

    def mislabelled(*args, site="", **kwargs):
        return gemm(*args, site="bogus.site" if site == "mlp.wo" else site,
                    **kwargs)

    eng, _ = _engine()
    monkeypatch.setattr(substrate, "gemm", mislabelled)
    with substrate.strict_audit_scope(), \
            pytest.raises(RuntimeError, match="AF007"):
        eng.run_to_completion()
    assert eng.stats["kernel_fault_retries"] == 0


def test_engine_post_run_check_under_strict_audit():
    eng, req = _engine()
    substrate.clear_plan_cache()
    try:
        substrate.DISPATCH_COUNTS["bogus.site"] = 1    # recorded unchecked
        with substrate.strict_audit_scope(), \
                pytest.raises(RuntimeError, match="AF007"):
            eng.run_to_completion()
        assert req.outcome == "ok" and len(req.out_tokens) == 3
    finally:
        substrate.clear_plan_cache()
