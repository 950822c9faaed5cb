"""Disaggregated prefill/decode serving: the port's engine against the
reference's, at ``pp_stages = 1``.

Modelled on the reference's ``tests/test_disagg.py``: reduced llama3-8b
(and reduced qwen3-moe-30b-a3b and mamba2-370m in token mode) serves the
reference's four requests at ``max_batch=4, max_seq=64`` through both
packages' ``DisaggServingEngine`` on the same converted parameters (one
reference tree an arch, fp32 compute: the parity harness's rule), and
both must give equal token streams, outcomes, error-type prefixes, the
scheduling and disaggregation counters of ``stats`` (:data:`STATS`), the
prefill role's chunk, the virtual-TTFT keys and the chaos draw counters
and fired-event log entry for entry — the ``substrate.dispatch`` draws of
the token-mode prefill step (``decode_p``) included.  The streams must
also equal the port's colocated engine's (fp32 and W8 exactly; W8A8 run
to run, its chunk kept; not the SSM family's: a token-prefill step
advances the co-resident rows' recurrent state in the prefill role's
cache, so the reference's disaggregated SSM streams differ from its
colocated ones too, and the port holds to them).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.kernels import substrate as ref_sub
from repro.models import lm as ref_lm
from repro.runtime.chaos import ChaosConfig as RefChaosConfig
from repro.serving import DisaggServeConfig as RefDisaggServeConfig
from repro.serving import DisaggServingEngine as RefDisaggEngine
from repro.serving import EngineCrash as RefEngineCrash
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.configs import get_config, reduced
from repro_torch.core import planner
from repro_torch.kernels import arrayflex_gemm as ag
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import substrate
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convert, lm
from repro_torch.runtime.chaos import ChaosConfig
from repro_torch.serving import (DisaggServeConfig, DisaggServingEngine,
                                 EngineCrash, ServeConfig, ServingEngine)
from repro_torch.serving.disagg import PREFILL_STEP_OVERHEAD
from repro_torch.serving.engine import PREFILL_CHUNK_CHOICES, Request


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's _reqs(): several tokens, two, one (no prefill and no
# handoff), twenty (the longest prefill)
REQS = [([5, 7, 11, 13, 17, 19, 23], 6, 1), ([2, 3], 5, 2), ([31], 4, 3),
        (list(range(40, 60)), 6, 4)]
# the GEMM-fault cases' requests: a step whose first trace faulted is
# traced anew at every later call in the reference, so these runs are kept
# to a few prefill tokens and two decode steps
SHORT = [([5, 7, 11], 2, 1), ([2, 3], 2, 2), ([31], 2, 3)]
KW = dict(max_batch=4, max_seq=64, seed=0)
STATS = ("prefill_dispatches", "decode_dispatches", "prefill_tokens",
         "decode_tokens", "kv_transfer_bytes", "kv_transfer_pages",
         "transfer_retries", "pod_losses", "preemptions",
         "kernel_fault_retries", "sample_retries", "snapshots_taken",
         "outcome_ok", "outcome_preempted_retried", "outcome_failed")
MOE = "qwen3-moe-30b-a3b"
SSM = "mamba2-370m"


@pytest.fixture(autouse=True)
def _process_state():
    """Put back every process-wide log and counter a test touches (both
    packages' site and dispatch logs and plan tallies, the launch
    counters) and empty the port's plan memos."""
    dicts = (substrate.DISPATCH_COUNTS, substrate.SITE_PLANS,
             ref_sub.DISPATCH_COUNTS, ref_sub.SITE_PLANS, ag.LAUNCHES,
             fa.LAUNCHES)
    tallies = (substrate.PLAN_CACHE_STATS, ref_sub.PLAN_CACHE_STATS)
    saved = [dict(d) for d in dicts]
    saved_tallies = [{k: dict(v) for k, v in t.items()} for t in tallies]
    yield
    substrate.clear_plan_cache()
    for d, v in zip(dicts + tallies, saved + saved_tallies):
        d.clear()
        d.update(v)


_MODELS = {}


def models(arch="llama3-8b"):
    """((reference cfg, params), (port cfg, params)) at fp32 compute: one
    reference tree an arch, converted leaf by leaf (the parameters do not
    depend on the backend; quantizing engines quantize their own copy)."""
    if arch not in _MODELS:
        rc = dataclasses.replace(ref_reduced(ARCHS[arch]),
                                 compute_dtype="float32")
        tc = dataclasses.replace(reduced(get_config(arch)),
                                 compute_dtype="float32")
        rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
        tp = convert.params_from_reference(
            tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
        _MODELS[arch] = ((rc, rp), (tc, tp))
    return _MODELS[arch]


PACKAGES = {
    "ref": dict(colo=RefEngine, disagg=RefDisaggEngine, sc=RefServeConfig,
                dsc=RefDisaggServeConfig, req=RefRequest,
                chaos=RefChaosConfig, crash=RefEngineCrash, kw={}),
    "port": dict(colo=ServingEngine, disagg=DisaggServingEngine,
                 sc=ServeConfig, dsc=DisaggServeConfig, req=Request,
                 chaos=ChaosConfig, crash=EngineCrash,
                 kw={"device": "cpu"}),
}


def run(pkg, arch="llama3-8b", backend="arrayflex", disagg=True,
        chaos=None, reqs=REQS, **sc_kw):
    """Serve ``reqs`` on package ``pkg``'s engine (disaggregated, 1 + 1
    pods, or colocated), restoring from the latest snapshot after an
    injected crash, and return what the packages must agree on."""
    P = PACKAGES[pkg]
    cfg, params = models(arch)[0 if pkg == "ref" else 1]
    cfg = dataclasses.replace(cfg, gemm_backend=backend)
    sc_kw = dict(KW, **sc_kw)
    if chaos is not None:
        sc_kw["chaos"] = P["chaos"](**chaos)
    if disagg:
        cls, sc = P["disagg"], P["dsc"](**{"prefill_pods": 1,
                                           "decode_pods": 1, **sc_kw})
    else:
        cls, sc = P["colo"], P["sc"](**sc_kw)
    eng = cls(cfg, params, sc, **P["kw"])
    rs = [P["req"](prompt=list(p), max_new_tokens=n, rid=rid)
          for p, n, rid in reqs]
    for r in rs:
        eng.submit(r)
    restarts, snaps = 0, []
    while True:
        try:
            eng.run_to_completion()
            break
        except P["crash"]:
            restarts += 1
            assert restarts <= 3, "crash recovery livelocked"
            snaps.append(eng.latest_snapshot())
            eng = cls.restore(cfg, params, eng.sc, snaps[-1], **P["kw"])
    final = {r.rid: r for r in rs}
    for r in eng.restored_requests:
        final[r.rid] = r
    rs = [final[r.rid] for r in rs]
    ch = eng._chaos
    return dict(
        tokens=[list(r.out_tokens) for r in rs],
        outcomes=[r.outcome for r in rs],
        errors=[r.error.split(":")[0] for r in rs],
        preemptions=[r.preemptions for r in rs],
        restarts=restarts,
        prefill_chunk=eng.prefill_chunk,
        stats={k: eng.stats.get(k) for k in STATS},
        ttft_keys=sorted(getattr(eng, "ttft_virtual", {})),
        chaos_draws=None if ch is None else dict(ch.chaos_draws),
        chaos_log=None if ch is None else [tuple(e) for e in ch.chaos_log],
    ), eng, snaps


def assert_parity(**scenario):
    want, _, _ = run("ref", **scenario)
    got, eng, snaps = run("port", **scenario)
    for key in want:
        assert got[key] == want[key], (key, got[key], want[key])
    assert all(t > 0 for t in eng.ttft_virtual.values())
    return got, eng, snaps


# ------------------------------------------------------ stream parity
CLEAN = {
    "dense_arrayflex": dict(),
    "dense_int8": dict(backend="arrayflex_int8"),
    "paged": dict(kv_pages=40, page_size=16),
    "moe_token": dict(arch=MOE, prefill_mode="token"),
    "moe_token_int8": dict(arch=MOE, backend="arrayflex_int8",
                           prefill_mode="token"),
    "dense_token": dict(prefill_mode="token"),
}


@pytest.mark.parametrize("name", list(CLEAN))
def test_clean_run_matches_reference_and_colocated(name):
    """Streams, outcomes, stats, chunk and virtual-TTFT keys equal the
    reference's disaggregated engine's; streams equal the port's colocated
    engine's; every request ok, every prefilled request handed off."""
    got, eng, _ = assert_parity(**CLEAN[name])
    colo, _, _ = run("port", disagg=False, **CLEAN[name])
    assert got["tokens"] == colo["tokens"]
    assert got["outcomes"] == ["ok"] * len(REQS)
    assert got["ttft_keys"] == sorted(rid for _, _, rid in REQS)
    assert got["stats"]["kv_transfer_bytes"] > 0
    assert eng.prefill_chunk == colo["prefill_chunk"]
    if eng.paged:
        assert got["stats"]["kv_transfer_pages"] > 0


def test_ssm_token_mode_matches_reference():
    """The reference's disaggregated engine serves mamba2-370m in token
    mode; the port gives its streams (the recurrent ``state`` / ``conv``
    rows handed off from a cache whose steps advance them out of place),
    and its handoff bytes count those leaves."""
    got, eng, _ = assert_parity(arch=SSM, prefill_mode="token")
    assert got["outcomes"] == ["ok"] * len(REQS)
    row = sum(t[:, 0].numel() * t.element_size()
              for layer in eng.pcache for t in layer.values())
    assert got["stats"]["kv_transfer_bytes"] == 3 * row


def test_w8a8_keeps_the_colocated_chunk_and_streams():
    """W8A8 (the parity harness's rule: run-to-run identity): the
    disaggregated engine keeps the colocated chunk, gives the colocated
    engine's streams and the same streams run to run, and the reference's
    counters."""
    want, _, _ = run("ref", backend="arrayflex_w8a8")
    got, eng, _ = run("port", backend="arrayflex_w8a8")
    again, _, _ = run("port", backend="arrayflex_w8a8")
    colo, _, _ = run("port", backend="arrayflex_w8a8", disagg=False)
    assert got["tokens"] == again["tokens"] == colo["tokens"]
    assert got["prefill_chunk"] == colo["prefill_chunk"] == \
        want["prefill_chunk"]
    for key in ("stats", "outcomes", "ttft_keys"):
        assert got[key] == want[key], key


def test_handoff_bytes_and_pages():
    """kv_transfer_bytes is the handoffs times a row's bytes (dense), and
    the live pages' bytes (paged)."""
    got, eng, _ = run("port")
    row = sum(t[:, 0].numel() * t.element_size()
              for layer in eng.pcache for t in layer.values())
    handoffs = sum(len(p) > 1 for p, _, _ in REQS)
    assert got["stats"]["kv_transfer_bytes"] == handoffs * row
    got, eng, _ = run("port", kv_pages=40, page_size=16)
    live = sum(-(-(len(p) - 1) // 16) for p, _, _ in REQS)
    page = sum(t[:, 0].numel() * t.element_size()
               for layer in eng.pcache for t in layer.values())
    assert got["stats"]["kv_transfer_pages"] == live
    assert got["stats"]["kv_transfer_bytes"] == live * page


def test_prefill_chunk_repick():
    """The prefill role re-picks its chunk under PREFILL_STEP_OVERHEAD;
    an explicit prefill_chunk wins."""
    assert PREFILL_STEP_OVERHEAD == 4.0
    S = KW["max_seq"]
    want = min(S, max(1, planner.attention_plan(
        S, S, choices=PREFILL_CHUNK_CHOICES,
        step_overhead=PREFILL_STEP_OVERHEAD)))
    got, _, _ = run("port")
    assert got["prefill_chunk"] == want
    pinned, _, _ = run("port", backend="xla", prefill_chunk=8)
    ref_pinned, _, _ = run("ref", backend="xla", prefill_chunk=8)
    assert pinned["prefill_chunk"] == 8
    for key in ("tokens", "stats"):
        assert pinned[key] == ref_pinned[key], key


# --------------------------------------------------------------- chaos
# The chaos cases run on the xla backend (plain matmuls in both packages:
# the reference's Pallas kernels in interpret mode cost most of its run,
# and a step whose first trace faulted is traced anew at every call) but
# for one dense pod loss on arrayflex; the draws do not depend on the
# backend, and the clean cases above hold the kernel backends.
CHAOS = {
    "transfer_retry": dict(backend="xla", max_retries=2,
                           chaos=dict(kv_transfer_at=0)),
    "transfer_persistent": dict(backend="xla", max_retries=0,
                                chaos=dict(kv_transfer=1.0)),
    "pod_loss_dense": dict(chaos=dict(pod_lost_at=4)),
    "pod_loss_paged": dict(backend="xla", kv_pages=40, page_size=16,
                           chaos=dict(pod_lost_at=4)),
    "quiet": dict(backend="xla", chaos=dict(seed=7)),
    # the first prefill trace's first draw, and the first decode trace's
    # fifth (nine sites a trace: eight of the one traced layer, unembed)
    "prefill_fault": dict(backend="xla", chaos=dict(gemm_fault_at=0)),
    "decode_fault": dict(backend="xla", reqs=SHORT,
                         chaos=dict(gemm_fault_at=9 + 4)),
    # token-mode prefill: the decode_p step's trace draws first
    "decode_p_fault": dict(backend="xla", prefill_mode="token", reqs=SHORT,
                           chaos=dict(gemm_fault_at=3)),
    "crash_restore": dict(backend="xla", snapshot_every_ticks=1,
                          chaos=dict(crash_at=5)),
    "crash_restore_paged": dict(backend="xla", kv_pages=40, page_size=16,
                                snapshot_every_ticks=1,
                                chaos=dict(crash_at=3)),
}
# qwen3-moe-30b-a3b in token mode: eleven sites a trace (attention's six,
# the router, three expert banks, the unembed): decode_p's trace draws 0-10,
# the decode step's 11-21
MOE_DRAWS = (0, 6, 10, 11, 16)


@pytest.mark.parametrize("name", list(CHAOS))
def test_chaos_matches_reference(name):
    got, eng, snaps = assert_parity(**CHAOS[name])
    st = got["stats"]
    clean, _, _ = run("port", **{k: v for k, v in CHAOS[name].items()
                                 if k not in ("chaos", "max_retries",
                                              "snapshot_every_ticks")})
    if name == "transfer_retry":
        assert st["transfer_retries"] == 1
        assert got["tokens"] == clean["tokens"]
        assert got["outcomes"] == ["ok"] * len(REQS)
        assert got["chaos_log"][0][:2] == ("transfer.kv", 0)
    elif name == "transfer_persistent":
        bad = [e for o, e in zip(got["outcomes"], got["errors"])
               if o == "failed"]
        assert bad and all(e == "TransferFault" for e in bad)
    elif name.startswith("pod_loss"):
        assert st["pod_losses"] == 1
        assert got["tokens"] == clean["tokens"]
        assert "preempted_retried" in got["outcomes"]
    elif name.startswith("crash"):
        assert got["restarts"] == 1 and "pcache" in snaps[0]
        assert got["tokens"] == clean["tokens"]
    elif name != "quiet":
        assert st["kernel_fault_retries"] == 1
        assert got["tokens"] == clean["tokens"]


@pytest.mark.parametrize("n", MOE_DRAWS)
def test_moe_decode_p_draws_match_reference(n):
    """A GEMM fault at draw n of the MoE engine's token-mode run: the
    decode_p step draws its own trace first, then the decode step its
    own; the step whose first trace faulted draws at every later
    dispatch, in both packages."""
    got, _, _ = assert_parity(arch=MOE, backend="xla", prefill_mode="token",
                              reqs=SHORT, chaos=dict(gemm_fault_at=n))
    clean, _, _ = run("port", arch=MOE, backend="xla", prefill_mode="token",
                      reqs=SHORT)
    assert got["stats"]["kernel_fault_retries"] == 1
    assert got["tokens"] == clean["tokens"]
    assert got["chaos_log"] == [("substrate.dispatch", n,
                                 got["chaos_log"][0][2])]
    assert got["chaos_draws"]["substrate.dispatch"] > 2 * 11


def test_prefill_retry_leaves_the_decode_cache():
    """A KernelFault in a disaggregated prefill chunk is retried on
    ``pcache`` and committed there: the decode cache is untouched until
    the handoff."""
    cfg, params = models()[1]
    cfg = dataclasses.replace(cfg, gemm_backend="arrayflex")
    eng = DisaggServingEngine(
        cfg, params, DisaggServeConfig(prefill_pods=1, decode_pods=1,
                                       prefill_chunk=8,
                                       chaos=ChaosConfig(gemm_fault_at=0),
                                       **KW), device="cpu")
    before = [{k: t.clone() for k, t in layer.items()} for layer in eng.cache]
    req = Request(prompt=list(range(40, 60)), max_new_tokens=3, rid=1)
    eng.submit(req)
    eng.step()                          # admit, one faulted chunk, retried
    assert eng.stats["kernel_fault_retries"] == 1
    assert eng.stats["prefill_dispatches"] == 1
    for layer, saved in zip(eng.cache, before):
        for k, t in layer.items():
            assert torch.equal(t, saved[k]), k
    assert any(bool(t.any()) for layer in eng.pcache for t in layer.values())
    eng.run_to_completion()
    want, _, _ = run("port", prefill_chunk=8,
                     reqs=[(list(range(40, 60)), 3, 1)])
    assert [req.out_tokens] == want["tokens"]
    assert req.outcome == "ok"


# --------------------------------------------------------- validations
def test_construction_validations_match_reference():
    """The reference's checks, in its order, with its types and messages;
    a pp_stages > 1 engine then needs its role windows' devices."""
    cases = [
        ("colocated config", None),
        ("zero pods", dict(prefill_pods=0)),
        ("prefix cache", dict(kv_pages=40, page_size=16, prefix_cache=True)),
        ("pp paged", dict(pp_stages=2, prefill_pods=2, decode_pods=2,
                          kv_pages=40, page_size=16)),
        ("pp pods", dict(pp_stages=2, prefill_pods=1, decode_pods=2)),
        ("pp token", dict(pp_stages=2, prefill_pods=2, decode_pods=2,
                          prefill_mode="token")),
    ]
    for what, kw in cases:
        errs = []
        for pkg in ("ref", "port"):
            P = PACKAGES[pkg]
            cfg, params = models()[0 if pkg == "ref" else 1]
            sc = P["sc"](**KW) if kw is None else P["dsc"](**KW, **kw)
            with pytest.raises((TypeError, ValueError)) as exc:
                P["disagg"](cfg, params, sc, **P["kw"])
            errs.append((type(exc.value).__name__, str(exc.value)))
        assert errs[0] == errs[1], what
    # pp = 2 needs 2 + 2 devices: both packages refuse it with one device,
    # and the port serves it over four logical ones (the reference's own
    # pp = 2 acceptance, streams equal to its colocated engine's)
    errs = []
    for pkg in ("ref", "port"):
        P = PACKAGES[pkg]
        cfg, params = models()[0 if pkg == "ref" else 1]
        with pytest.raises(ValueError, match="devices") as exc:
            P["disagg"](cfg, params, P["dsc"](
                **KW, pp_stages=2, prefill_pods=2, decode_pods=2),
                **P["kw"])
        errs.append(str(exc.value).split(";")[0])
    assert errs[0] == errs[1]
    with mesh_lib.host_devices(4, "cpu"):
        got, eng, _ = run("port", reqs=SHORT, pp_stages=2, prefill_pods=2,
                          decode_pods=2)
    want, _, _ = run("ref", disagg=False, reqs=SHORT)
    assert eng.pp == 2 and got["tokens"] == want["tokens"]


def test_role_configs():
    """Role configs carry pp_role; decode steps run under the decode
    role's config, and at pp_stages = 1 every role plan is the colocated
    one (the boundary site takes no shard signature)."""
    got, eng, _ = run("port")
    assert (eng.pcfg.pp_role, eng.dcfg.pp_role) == ("prefill", "decode")
    assert eng.pp == 1 and eng.cfg.pp_role == ""
    assert substrate.SITE_PLANS["attn.wq"].shard == substrate.SHARD_NONE


# ------------------------------------------------------------ serve CLI
def test_serve_cli_disagg():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--reduced", "--requests", "3", "--max-new", "4",
         "--prefill-pods", "1", "--decode-pods", "1"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    assert "disagg: 1 prefill + 1 decode pod(s), pp=1, prefill_chunk=" \
        in out.stdout
    assert "virtual TTFT" in out.stdout
    assert out.stdout.count("[ok]") == 3
