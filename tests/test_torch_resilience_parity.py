"""Resilient serving, the port against the reference, scenario by scenario.

Each chaos, deadline, queue, preemption and crash scenario of
``tests/test_resilience.py`` runs through both packages on the same
reduced qwen2-0.5b (fp32, ``arrayflex``: the reference's Pallas kernels in
interpret mode, the port's kernels' plain versions), the same converted
weights and, where the scenario has one, the same fake clock.  Both must
give equal token streams, outcomes and error-type prefixes (the text
before the first colon), the resilience and scheduling counters of
``stats`` (:data:`STATS`), and the chaos draw counters and fired-event log
entry for entry; an engine crash is restored from its latest snapshot in
both, at most three times.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.models import lm as ref_lm
from repro.runtime.chaos import ChaosConfig as RefChaosConfig
from repro.serving import AdmissionError as RefAdmissionError
from repro.serving import EngineCrash as RefEngineCrash
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.configs import get_config, reduced
from repro_torch.models import convert
from repro_torch.runtime.chaos import ChaosConfig
from repro_torch.serving import (AdmissionError, EngineCrash, ServeConfig,
                                 ServingEngine)
from repro_torch.serving.engine import Request


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STATS = ("outcome_ok", "outcome_rejected_overload",
         "outcome_deadline_expired", "outcome_preempted_retried",
         "outcome_failed", "sample_retries", "kernel_fault_retries",
         "preemptions", "watchdog_fired", "snapshots_taken",
         "prefix_hit_tokens", "pages_used_peak", "concurrency_peak",
         "prefill_dispatches", "decode_dispatches", "prefill_tokens",
         "decode_tokens")

PROMPTS = [[5, 6, 7], [11, 12, 13, 14, 15], [21]]
SHARED = [7, 8, 9, 10, 11, 12, 13, 14]


def cfgs(arch="qwen2-0.5b", backend="arrayflex"):
    rc = dataclasses.replace(ref_reduced(ARCHS[arch]), gemm_backend=backend,
                             compute_dtype="float32")
    tc = dataclasses.replace(reduced(get_config(arch)), gemm_backend=backend,
                             compute_dtype="float32")
    return rc, tc


def models(arch="qwen2-0.5b", backend="arrayflex"):
    """((reference cfg, params), (port cfg, params)): one reference tree,
    converted leaf by leaf."""
    rc, tc = cfgs(arch, backend)
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
    tp = convert.params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return (rc, rp), (tc, tp)


PACKAGES = {
    "ref": dict(engine=RefEngine, sc=RefServeConfig, req=RefRequest,
                chaos=RefChaosConfig, admission=RefAdmissionError,
                crash=RefEngineCrash, kw={}),
    "port": dict(engine=ServingEngine, sc=ServeConfig, req=Request,
                 chaos=ChaosConfig, admission=AdmissionError,
                 crash=EngineCrash, kw={"device": "cpu"}),
}


def run(pkg: str, model, prompts=PROMPTS, max_new=4, chaos=None,
        clock=None, ticks=None, **sc_kw):
    """Serve ``prompts`` on package ``pkg``'s engine and return what the
    two packages must agree on.  ``chaos``: ChaosConfig keyword
    arguments; ``clock``: the start of a fake engine clock; ``ticks``:
    clock values to step the engine at one by one (instead of
    ``run_to_completion`` with crash recovery)."""
    P = PACKAGES[pkg]
    cfg, params = model
    sc_kw = dict(dict(max_batch=2, max_seq=64, prefill_mode="batched",
                      prefill_chunk=4), **sc_kw)
    if chaos is not None:
        sc_kw["chaos"] = P["chaos"](**chaos)
    kw = dict(P["kw"])
    if clock is not None:
        clock = [clock]
        kw["clock"] = lambda: clock[0]
    eng = P["engine"](cfg, params, P["sc"](**sc_kw), **kw)
    reqs = [P["req"](prompt=list(p), max_new_tokens=max_new, rid=i)
            for i, p in enumerate(prompts)]
    rejected = []
    for r in reqs:
        try:
            eng.submit(r)
        except P["admission"] as exc:
            rejected.append((r.rid, exc.outcome.value))
    restarts = 0
    if ticks is not None:
        for t in ticks:
            clock[0] = t
            eng.step()
    else:
        while True:
            try:
                eng.run_to_completion()
                break
            except P["crash"]:
                restarts += 1
                assert restarts <= 3, "crash recovery livelocked"
                eng = P["engine"].restore(cfg, params, eng.sc,
                                          eng.latest_snapshot(), **kw)
    final = {r.rid: r for r in reqs}
    for r in eng.restored_requests:
        final[r.rid] = r
    reqs = [final[r.rid] for r in reqs]
    ch = eng._chaos
    return dict(
        tokens=[list(r.out_tokens) for r in reqs],
        outcomes=[r.outcome for r in reqs],
        errors=[r.error.split(":")[0] for r in reqs],
        preemptions=[r.preemptions for r in reqs],
        rejected=rejected, restarts=restarts,
        stats={k: eng.stats[k] for k in STATS},
        chaos_draws=None if ch is None else dict(ch.chaos_draws),
        chaos_log=None if ch is None else [tuple(e) for e in ch.chaos_log])


def assert_parity(ref_model, port_model, **scenario):
    want = run("ref", ref_model, **scenario)
    got = run("port", port_model, **scenario)
    for key in want:
        assert got[key] == want[key], (key, got[key], want[key])
    return got


@pytest.fixture(scope="module")
def both():
    return models()


SCENARIOS = {
    # chaos (tests/test_resilience.py's NaN, GEMM, page and zero-chaos cases)
    "zero_chaos": dict(chaos=dict(seed=123)),
    "transient_nan": dict(chaos=dict(nan_logits_at=0)),
    "persistent_nan": dict(chaos=dict(nan_logits=1.0), max_retries=1),
    "transient_gemm": dict(chaos=dict(gemm_fault_at=0)),
    "persistent_gemm": dict(chaos=dict(gemm_fault=1.0)),
    "page_exhaustion": dict(kv_pages=24, page_size=8,
                            chaos=dict(page_exhaust=1.0), watchdog_ticks=4),
    "counted_once": dict(chaos=dict(seed=5, nan_logits=0.3, gemm_fault=0.1),
                         max_retries=1),
    "counted_once_paged": dict(chaos=dict(seed=5, nan_logits=0.3,
                                          gemm_fault=0.1, page_exhaust=0.2),
                               kv_pages=5, page_size=8,
                               preempt_policy="youngest", prefix_cache=True,
                               max_new=8),
    # queue
    "bounded_queue": dict(prompts=[[1, 2], [3, 4], [5, 6]], max_queue=2,
                          max_new=2),
    "invalid_prompts": dict(prompts=[[], [1] * 65, [3, 4]], max_new=2),
    # preemption
    "preempt_ample": dict(max_new=8, kv_pages=40, page_size=8,
                          preempt_policy="youngest", prefix_cache=True),
    "preempt_tight": dict(max_new=8, kv_pages=5, page_size=8,
                          preempt_policy="youngest", prefix_cache=True),
    "preempt_dense_streams": dict(kv_pages=5, page_size=8,
                                  preempt_policy="youngest",
                                  prefix_cache=True),
    # crash recovery
    "crash_0": dict(chaos=dict(crash_at=0), snapshot_every_ticks=1),
    "crash_2": dict(chaos=dict(crash_at=2), snapshot_every_ticks=1),
    "crash_4": dict(chaos=dict(crash_at=4), snapshot_every_ticks=1),
    "crash_paged_prefix": dict(
        prompts=[SHARED + [20 + i] for i in range(3)], max_new=6,
        kv_pages=40, page_size=8, prefix_cache=True,
        chaos=dict(crash_at=3), snapshot_every_ticks=1),
    "crash_gemm_nan": dict(chaos=dict(seed=9, crash=0.3, gemm_fault=0.1,
                                      nan_logits=0.2),
                           snapshot_every_ticks=2),
    "snapshot_inert": dict(snapshot_every_ticks=2),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(both, name):
    got = assert_parity(*both, **SCENARIOS[name])
    assert all(o is not None for o in got["outcomes"])
    assert sum(v for k, v in got["stats"].items()
               if k.startswith("outcome_")) == len(got["outcomes"])


def test_total_deadline_matches_reference(both):
    """The reference case's fake clock: a step at 0, one at 1 ms (< 5 ms),
    one at 10 s: every request expires typed at the third."""
    got = assert_parity(*both, deadline_ms=5.0, max_new=50, clock=0.0,
                        ticks=[0.0, 0.001, 10.0])
    assert got["outcomes"] == ["deadline_expired"] * 3
    assert got["errors"] == ["DeadlineExceeded"] * 3


def test_ttft_deadline_matches_reference(both):
    """A TTFT deadline the fake clock never passes, and one it passes
    while the third request still waits for a slot."""
    got = assert_parity(*both, ttft_deadline_ms=1000.0, max_new=3,
                        clock=0.0)
    assert got["outcomes"] == ["ok"] * 3
    got = assert_parity(*both, ttft_deadline_ms=1000.0, max_new=3,
                        clock=0.0, ticks=[0.0, 0.5, 2.0, 2.0, 2.0, 2.0])
    assert "deadline_expired" in got["outcomes"]
