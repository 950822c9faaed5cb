"""The port's quickstart (``examples/torch/quickstart.py``) against the
reference's (``examples/quickstart.py``), on the CPU.

The reference's ``main`` runs once a module, its stdout captured and its
serving engines recorded (``repro.serving``'s two engine classes are
swapped for subclasses that keep the requests they were given, so the
reference's streams are read without running them twice).  The port's
``run(device="cpu")`` runs once on the reference's parameter tree,
converted with ``models.convert.params_from_reference``.  Then: every
printed line equals the reference's character for character except the
lines :data:`BY_DESIGN` lists, each held to its own check below; the
logit differences lie within the reference's documented tolerances; the
dense, paged, colocated and disaggregated streams equal the reference's
token for token (fp32 on ``xla``, as the reference's ``cfg``); the
audit is clean and the seeded violations give their codes.
"""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.serving as ref_serving
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.kernels import substrate as ref_substrate
from repro.models import lm as ref_lm
from repro_torch.configs import get_config, reduced
from repro_torch.models import convert

ROOT = Path(__file__).resolve().parents[1]

# reference line prefix -> why the port's line differs from it by design
# (each is held to its own check in this file)
BY_DESIGN = {
    "=== Pallas kernel": "the kernel is CUDA (its plain version on the "
                         "CPU), not Pallas",
    "  planned k=": "the kernel's error differs; the planned k is compared "
                    "and the error held to 2^-8 x max|oracle|",
    "  xla vs arrayflex logits": "a float difference: held to its "
                                 "tolerance",
    "  fp32-arrayflex vs int8": "a float difference: held to its tolerance",
    "  fp32-arrayflex vs w8a8": "a float difference: held to its tolerance",
    "  weight-quantize memo": "the `traced` memo counter: the port runs "
                              "eagerly, so no weight is traced and each "
                              "quantized weight is a miss",
    "  (full matrix:": "the package's name",
    "  seeded bypass": "the recorded op's name (aten.mm, not dot_general); "
                       "the finding's code, severity and label are compared",
    "=== Paged K/V serving": "the package's name",
    "  prefix reuse": "the launch count: the reference counts one jit "
                      "trace of a prefill chunk, in which the layer scan "
                      "dispatches each site once (9 a chunk); the port "
                      "counts every layer's dispatches (17 a chunk).  The "
                      "hit tokens and the chunks are compared",
    "  int8 x int8 dot_generals": "the staged-int8 count: the Pallas kernel "
                                  "stages one int8 dot_general per K step; "
                                  "the port counts the dispatch audit's "
                                  "integer products of the plain version "
                                  "on the CPU (one per weight) and W8A8 "
                                  "launches of K1 on the card (one)",
    "  mean virtual TTFT": "a clock",
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(cls, engines):
    class Recording(cls):
        """The reference's engine, keeping the requests it was given."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.given = {}
            engines.append(self)

        def submit(self, req):
            self.given[req.rid] = req
            return super().submit(req)

    return Recording


@pytest.fixture(scope="module")
def reference():
    """The reference quickstart's printed lines, and per serving engine
    (dense, paged, colocated, disaggregated, in the order it builds them)
    its streams and stats."""
    mod = load(ROOT / "examples" / "quickstart.py", "reference_quickstart")
    engines = []
    real = ref_serving.ServingEngine, ref_serving.DisaggServingEngine
    ref_serving.ServingEngine = _recording(real[0], engines)
    ref_serving.DisaggServingEngine = _recording(real[1], engines)
    ref_substrate.clear_plan_cache()
    ref_substrate.clear_quant_cache()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        ref_serving.ServingEngine, ref_serving.DisaggServingEngine = real
    return dict(lines=buf.getvalue().splitlines(),
                streams=[[list(e.given[i].out_tokens)
                          for i in sorted(e.given)] for e in engines],
                stats=[dict(e.stats) for e in engines])


@pytest.fixture(scope="module")
def port():
    """The port quickstart's ``run`` on the CPU, on the reference's
    parameter tree."""
    kw = dict(compute_dtype="float32", param_dtype="float32")
    rp = ref_lm.init_params(ref_reduced(ref_get_config("qwen2-0.5b"), **kw),
                            jax.random.PRNGKey(0))
    params = convert.params_from_reference(
        reduced(get_config("qwen2-0.5b"), **kw),
        jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    mod = load(ROOT / "examples" / "torch" / "quickstart.py",
               "port_quickstart")
    out = mod.run("cpu", params=params, log=lambda line: None)
    out["printed"] = "\n".join(out["lines"]).splitlines()
    return out


def _pairs(reference, port):
    assert len(port["printed"]) == len(reference["lines"]), (
        port["printed"], reference["lines"])
    return list(zip(reference["lines"], port["printed"]))


def _line(lines, prefix):
    (line,) = [l for l in lines if l.startswith(prefix)]
    return line


def test_deterministic_lines_equal_the_reference(reference, port):
    """Steps 1-2 (6 lines), the 10 per-site plans of step 4, the mlp.wo
    lines of steps 5 and 8, step 6's audit and [AF007] lines, step 7's
    page plan, residency, peak and identity, step 8's precision_table,
    step 9's handoff KiB, identity and both boundary lines — every line
    but :data:`BY_DESIGN`'s — character for character."""
    compared = 0
    for want, got in _pairs(reference, port):
        if any(want.startswith(p) for p in BY_DESIGN):
            continue
        assert got == want
        compared += 1
    seen = {p for p in BY_DESIGN for l in reference["lines"]
            if l.startswith(p)}
    assert seen == set(BY_DESIGN)
    assert compared == len(reference["lines"]) - len(BY_DESIGN)
    assert sum(1 for l in port["printed"]
               if re.match(r"    \S+ +M= *\d+ N= *\d+ T= *\d+ -> k=", l)) == 10
    for prefix in ("  mlp.wo (M=896", "  strict-audit dispatch -> [AF007]",
                   "  precision_table[", "  attn.wq boundary"):
        assert any(l.startswith(prefix) for l in port["printed"]), prefix


def test_by_design_lines_hold_their_own_checks(reference, port):
    """The lines that differ by design: the same planned k, memo keys but
    `traced`, the finding's code and label, the prefix-reuse tokens and
    chunks, one integer product per W8A8 weight."""
    ref_k = re.search(r"planned k=(\d+);",
                      _line(reference["lines"], "  planned k=")).group(1)
    assert port["gemm"]["k"] == int(ref_k)
    assert _line(port["printed"], "=== CUDA kernel")
    ref_memo = _line(reference["lines"], "  weight-quantize memo")
    assert set(port["quant_memo"]) == set(
        re.findall(r"'(\w+)'", ref_memo)) - {"traced"}
    assert _line(port["printed"], "  seeded bypass -> ").startswith(
        "  seeded bypass -> [AF001][error] bypass-demo @ ")
    paged, ref_paged = port["paged"], reference["stats"][1]
    assert paged["prefix_hit_tokens"] == ref_paged["prefix_hit_tokens"] == 64
    assert paged["prefill_dispatches"] == ref_paged["prefill_dispatches"]
    n_layers = reduced(get_config("qwen2-0.5b")).n_layers
    per_layer = 8           # wq, wk, wv, qk, pv, wo, wi_gate+wi_up, mlp.wo
    assert paged["prefill_gemm_dispatches"] == \
        paged["prefill_dispatches"] * (n_layers * per_layer + 1)
    assert ref_paged["prefill_gemm_dispatches"] == \
        ref_paged["prefill_dispatches"] * (per_layer + 1)
    assert port["int8_contractions"] == 1
    assert _line(port["printed"], "  mean virtual TTFT").endswith(
        _line(reference["lines"], "  mean virtual TTFT").split(" ms ", 1)[1])


def test_errors_within_the_documented_tolerances(port):
    """xla vs arrayflex within 1e-5 of the logit scale, int8 within 0.06,
    W8A8 within 0.12 (the reference's documented tolerances); the bf16
    GEMM within 2^-8 of the oracle's largest magnitude."""
    d = port["logits_diff"]
    assert d["arrayflex"] <= 1e-5 * d["scale"]
    assert 0 < d["arrayflex_int8"] <= 0.06
    assert 0 < d["arrayflex_w8a8"] <= 0.12
    assert port["gemm"]["err"] <= 2 ** -8 * port["gemm"]["scale"]


def test_streams_equal_the_reference(reference, port):
    """fp32 on xla: the dense, paged, colocated and disaggregated streams
    equal the reference's engines' token for token, and the three
    identities hold."""
    dense, paged, colo, dis = reference["streams"]
    assert port["paged"]["dense"] == dense
    assert port["paged"]["paged"] == paged
    assert port["disagg"]["colocated"] == colo
    assert port["disagg"]["disagg"] == dis
    assert port["paged"]["identical"] and port["disagg"]["identical"]
    assert all(len(s) == 3 for s in dense)
    assert all(l.endswith("True") for l in port["printed"]
               if "identical to" in l or "exact=" in l)


def test_audit_clean_and_seeded_violations(port):
    """Step 6: no error on the traced forward / decode / prefill, no
    fallback; the raw `@` gives [AF001]; an unknown site under strict
    audit gives [AF007]."""
    assert port["audit"] == dict(errors=0, warnings=0, fallbacks=0)
    assert port["bypass"] == ["AF001"]
    assert port["strict"].startswith("[AF007] dispatch site 'not.a.site'")


def test_cpu_steps_dispatch_without_launching(port):
    """On the CPU every kernel step runs the plain versions: a reduced
    forward dispatches 13 K1 + 4 K2 sites on each backend, the audit's
    forward, decode and prefill entries three times that, and no launch
    is counted (on the card the same run launches one kernel a
    dispatch)."""
    for step in ("arrayflex", "arrayflex_int8", "arrayflex_w8a8"):
        assert port["steps"][step]["dispatches"] == 17, step
        assert port["steps"][step]["kernel_launches"] == 0, step
    assert port["steps"]["audit"]["dispatches"] == 3 * 17
    assert port["steps"]["audit"]["kernel_launches"] == 0
    assert port["steps"]["gemm"]["launches"] == {}
