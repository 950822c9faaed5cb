"""The port's resilient serving, case for case with the reference's
``tests/test_resilience.py``.

Each of the reference file's 28 cases has a counterpart here on the port
(reduced qwen2-0.5b, fp32, ``arrayflex`` — the kernels' plain versions on
the CPU —, the reference's converted parameters), named after it with
``_port`` appended; ``tests/test_torch_resilience_parity.py`` runs
the same scenarios through both packages and compares them.  Also here:
the port's copies of ``runtime/chaos.py``, ``runtime/fault.py`` and
``serving/errors.py`` against the reference's (code equal, docstrings
aside), the three ``HeartbeatMonitor`` cases of ``tests/test_runtime.py``
against the port's copy, the idempotency of a retried step (logits and the
whole K/V cache or pool bit for bit a clean step's, for a fault at the
first, a middle and the last dispatch), and the snapshot round trip
(``snapshot()`` of ``restore(snapshot(e))`` equals ``snapshot(e)``, the
tensors bit for bit; a temperature-sampled run crashed and restored
continues with the uncrashed run's tokens).
"""
import ast
import copy
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.models import lm as ref_lm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import substrate
from repro_torch.models import convert, lm
from repro_torch.runtime import HeartbeatMonitor, chaos
from repro_torch.runtime.chaos import ChaosConfig, ChaosEngine
from repro_torch.serving import (AdmissionError, EngineCrash, KernelFault,
                                 Outcome, ServeConfig, ServingEngine)
from repro_torch.serving.engine import Request
from repro_torch.serving.paged import PagePool, RadixCache


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]


def _cfg(arch="qwen2-0.5b", backend="arrayflex"):
    return dataclasses.replace(reduced(get_config(arch)),
                               gemm_backend=backend,
                               compute_dtype="float32")


@pytest.fixture(scope="module")
def model():
    rc = dataclasses.replace(ref_reduced(ARCHS["qwen2-0.5b"]),
                             compute_dtype="float32")
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
    tc = _cfg()
    tp = convert.params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return tc, tp


PROMPTS = [
    [5, 6, 7],
    [11, 12, 13, 14, 15],
    [21],
]


def _mk(model, pr=PROMPTS, max_new=4, **sc_kw):
    cfg, params = model
    sc_kw.setdefault("max_batch", 2)
    sc_kw.setdefault("max_seq", 64)
    sc_kw.setdefault("prefill_mode", "batched")
    sc_kw.setdefault("prefill_chunk", 4)
    clock = sc_kw.pop("clock", None)
    temperature = sc_kw.pop("temperature", 0.0)
    kw = {"clock": clock} if clock is not None else {}
    eng = ServingEngine(cfg, params, ServeConfig(**sc_kw), device="cpu",
                        **kw)
    reqs = [Request(prompt=list(p), max_new_tokens=max_new, rid=i,
                    temperature=temperature)
            for i, p in enumerate(pr)]
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def _run(model, **sc_kw):
    eng, reqs = _mk(model, **sc_kw)
    eng.run_to_completion()
    return eng, reqs


@pytest.fixture(scope="module")
def baseline(model):
    _, reqs = _run(model)
    return [r.out_tokens for r in reqs]


# ------------------------------------------------- the port's own copies
def _code(path: Path) -> str:
    """The module's code with every docstring dropped."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", ["runtime/chaos.py", "runtime/fault.py",
                                 "serving/errors.py"])
def test_framework_free_modules_are_copies(rel):
    """The port's chaos, fault and errors modules are the reference's,
    code for code (their docstrings speak of the port)."""
    assert (_code(ROOT / "src" / "repro_torch" / rel)
            == _code(ROOT / "src" / "repro" / rel))


# ---------------------------------------------------------- chaos engine
def test_chaos_decision_is_pure_function_of_seed_point_draw_port():
    a = ChaosEngine(ChaosConfig(seed=7, gemm_fault=0.5))
    seq_a = [a.fire("substrate.dispatch") for _ in range(64)]
    # interleave other points between draws: decisions must not move
    b = ChaosEngine(ChaosConfig(seed=7, gemm_fault=0.5))
    seq_b = []
    for _ in range(64):
        b.fire("engine.sample")
        b.fire("pool.alloc")
        seq_b.append(b.fire("substrate.dispatch"))
    assert seq_a == seq_b
    assert any(seq_a) and not all(seq_a)
    c = ChaosEngine(ChaosConfig(seed=8, gemm_fault=0.5))
    assert [c.fire("substrate.dispatch") for _ in range(64)] != seq_a


def test_chaos_at_trigger_fires_exactly_once_port():
    e = ChaosEngine(ChaosConfig(nan_logits_at=2))
    hits = [e.fire("engine.sample") for _ in range(6)]
    assert hits == [False, False, True, False, False, False]
    assert e.chaos_log == [("engine.sample", 2, "")]


def test_chaos_state_snapshot_roundtrip_port():
    e = ChaosEngine(ChaosConfig(seed=3, gemm_fault=0.5))
    pre = [e.fire("substrate.dispatch") for _ in range(10)]
    snap = e.state_snapshot()
    tail = [e.fire("substrate.dispatch") for _ in range(10)]
    e2 = ChaosEngine(ChaosEngine.config_from_snapshot(snap))
    e2.load_state(snap)
    assert [e2.fire("substrate.dispatch") for _ in range(10)] == tail
    assert e2.chaos_draws["substrate.dispatch"] == 20 and len(pre) == 10


def test_parse_spec_roundtrip_and_errors_port():
    c = chaos.parse_spec("seed=3, gemm=0.05, nan_at=2, crash=0.01")
    assert c == ChaosConfig(seed=3, gemm_fault=0.05, nan_logits_at=2,
                            crash=0.01)
    assert c.without_crash().crash == 0.0
    with pytest.raises(ValueError, match="unknown chaos spec key"):
        chaos.parse_spec("bogus=1")
    with pytest.raises(ValueError, match="key=value"):
        chaos.parse_spec("seed")


def test_ambient_fire_is_noop_outside_scope_port():
    assert chaos.active() is None
    assert chaos.fire("engine.tick") is False
    eng = ChaosEngine(ChaosConfig(crash_at=0))
    with chaos.scope(eng):
        assert chaos.active() is eng
        assert chaos.fire("engine.tick") is True
    assert chaos.active() is None


# ----------------------------------------------------- admission control
def test_bounded_queue_rejects_overload_typed_port(model):
    eng, _ = _mk(model, pr=[], max_queue=2)
    eng.submit(Request(prompt=[1, 2], max_new_tokens=2, rid=0))
    eng.submit(Request(prompt=[3, 4], max_new_tokens=2, rid=1))
    r = Request(prompt=[5, 6], max_new_tokens=2, rid=2)
    with pytest.raises(AdmissionError) as ei:
        eng.submit(r)
    assert ei.value.outcome == Outcome.REJECTED_OVERLOAD
    assert r.done and r.outcome == Outcome.REJECTED_OVERLOAD.value
    assert eng.stats["outcome_rejected_overload"] == 1
    assert isinstance(ei.value, ValueError)


def test_invalid_prompt_fails_typed_port(model):
    eng, _ = _mk(model, pr=[])
    r = Request(prompt=[], max_new_tokens=2, rid=0)
    with pytest.raises(ValueError):
        eng.submit(r)
    assert r.done and r.outcome == Outcome.FAILED.value
    long = Request(prompt=[1] * 65, max_new_tokens=2, rid=1)
    with pytest.raises(AdmissionError, match="max_seq"):
        eng.submit(long)
    assert long.outcome == Outcome.FAILED.value
    assert eng.stats["outcome_failed"] == 2


# ---------------------------------------------------------- deadlines
def test_total_deadline_expires_typed_port(model):
    t = [0.0]
    eng, reqs = _mk(model, deadline_ms=5.0, max_new=50,
                    clock=lambda: t[0])
    eng.step()
    t[0] = 0.001                     # 1ms < 5ms: still running
    eng.step()
    assert not all(r.done for r in reqs)
    t[0] = 10.0                      # 10s >> 5ms
    eng.step()
    assert all(r.done and r.outcome == Outcome.DEADLINE_EXPIRED.value
               for r in reqs)
    assert all(r.error.startswith("DeadlineExceeded: total deadline")
               for r in reqs)
    assert eng.stats["outcome_deadline_expired"] == len(reqs)


def test_ttft_deadline_only_pre_first_token_port(model):
    t = [0.0]
    eng, reqs = _mk(model, ttft_deadline_ms=1000.0, max_new=3,
                    clock=lambda: t[0])
    eng.run_to_completion()
    assert all(r.outcome == Outcome.OK.value for r in reqs)


# ------------------------------------------------ NaN/Inf logit handling
def test_transient_nan_retried_stream_identical_port(model, baseline):
    eng, reqs = _run(model, chaos=ChaosConfig(nan_logits_at=0))
    assert [r.out_tokens for r in reqs] == baseline
    assert eng.stats["sample_retries"] == 1
    assert all(r.outcome == Outcome.OK.value for r in reqs)


def test_persistent_nan_fails_typed_no_hang_port(model):
    eng, reqs = _run(model, chaos=ChaosConfig(nan_logits=1.0),
                     max_retries=1)
    assert all(r.done and r.outcome == Outcome.FAILED.value for r in reqs)
    assert all("non-finite" in r.error for r in reqs)
    assert eng.stats["outcome_failed"] == len(reqs)


def test_real_nonfinite_logits_fail_typed(model, monkeypatch):
    """A NaN the model itself emits (no chaos) is caught by the same
    check: retried once, then the rows fail typed — never a raise, never
    a sampled token."""
    real = lm.decode_step

    def poisoned(cfg, params, cache, token, pos):
        logits, cache = real(cfg, params, cache, token, pos)
        return torch.full_like(logits, float("nan")), cache

    monkeypatch.setattr(lm, "decode_step", poisoned)
    eng, reqs = _run(model, max_new=3)
    assert all(r.outcome == Outcome.FAILED.value and not r.out_tokens
               for r in reqs)
    assert eng.stats["sample_retries"] == eng.stats["decode_dispatches"] > 0


# --------------------------------------------------- GEMM launch faults
def test_transient_gemm_fault_retried_stream_identical_port(model, baseline):
    eng, reqs = _run(model, chaos=ChaosConfig(gemm_fault_at=0))
    assert [r.out_tokens for r in reqs] == baseline
    assert eng.stats["kernel_fault_retries"] >= 1
    assert all(r.outcome == Outcome.OK.value for r in reqs)


def test_persistent_gemm_fault_fails_typed_no_hang_port(model):
    eng, reqs = _run(model, chaos=ChaosConfig(gemm_fault=1.0))
    assert all(r.done and r.outcome == Outcome.FAILED.value for r in reqs)
    assert all(r.error.startswith("KernelFault") for r in reqs)
    assert eng.stats["outcome_failed"] == len(reqs)


def test_faulted_site_launches_nothing(model):
    """The chaos point fires before the backend: the faulted site is not
    counted, the sites before it are, and a retried step dispatches in
    full (the faulted attempt's partial dispatches on top)."""
    substrate.DISPATCH_COUNTS.clear()
    eng, _ = _run(model)
    clean = sum(substrate.DISPATCH_COUNTS.values())
    substrate.DISPATCH_COUNTS.clear()
    eng, _ = _run(model, chaos=ChaosConfig(gemm_fault_at=4))   # attn.pv
    assert eng.stats["kernel_fault_retries"] == 1
    assert sum(substrate.DISPATCH_COUNTS.values()) == clean + 4
    assert eng.stats["prefill_gemm_dispatches"] == 2 * 8 + 1 + 4


# --------------------------------------------- page exhaustion + watchdog
def test_page_exhaustion_chaos_terminates_all_typed_port(model):
    eng, reqs = _run(model, kv_pages=24, page_size=8,
                     chaos=ChaosConfig(page_exhaust=1.0),
                     watchdog_ticks=4)
    assert all(r.done and r.outcome is not None for r in reqs)
    assert eng.stats["watchdog_fired"] >= 1


def test_zero_chaos_probabilities_fire_nothing_port(model, baseline):
    eng, reqs = _run(model, chaos=ChaosConfig(seed=123))
    assert [r.out_tokens for r in reqs] == baseline
    assert eng._chaos.chaos_log == []


def test_heartbeat_beats_once_per_tick(model):
    eng, _ = _run(model)
    assert eng.monitor.beats[0].step == eng._tick
    assert eng.monitor.dead_hosts() == []


# ----------------------------------------------------------- preemption
def test_preemption_streams_bit_identical_port(model):
    _, ample = _run(model, max_new=8, kv_pages=40, page_size=8,
                    preempt_policy="youngest", prefix_cache=True)
    eng, tight = _run(model, max_new=8, kv_pages=5, page_size=8,
                      preempt_policy="youngest", prefix_cache=True)
    assert eng.stats["preemptions"] >= 1
    assert ([r.out_tokens for r in tight]
            == [r.out_tokens for r in ample])
    preempted = [r for r in tight if r.preemptions]
    assert preempted
    assert all(r.outcome == Outcome.PREEMPTED_RETRIED.value
               for r in preempted)
    assert all(r.outcome == Outcome.OK.value
               for r in tight if not r.preemptions)


def test_preemption_matches_dense_streams_port(model, baseline):
    eng, reqs = _run(model, kv_pages=5, page_size=8,
                     preempt_policy="youngest", prefix_cache=True)
    assert [r.out_tokens for r in reqs] == baseline


def test_policy_none_small_pool_rejected_at_construction_port(model):
    cfg, params = model
    with pytest.raises(ValueError, match="preempt_policy"):
        ServingEngine(cfg, params,
                      ServeConfig(max_batch=2, max_seq=64, kv_pages=5,
                                  page_size=8), device="cpu")


def test_unknown_preempt_policy_rejected_port(model):
    cfg, params = model
    with pytest.raises(ValueError, match="preempt_policy"):
        ServingEngine(cfg, params,
                      ServeConfig(max_batch=2, max_seq=64,
                                  preempt_policy="oldest"), device="cpu")


# ------------------------------------------------------- crash recovery
def _finish_after_restore(model, eng, reqs, max_restarts=3):
    cfg, params = model
    restarts = 0
    while True:
        try:
            eng.run_to_completion()
            break
        except EngineCrash:
            restarts += 1
            assert restarts <= max_restarts, "crash recovery livelocked"
            snap = eng.latest_snapshot()
            assert snap is not None
            eng = ServingEngine.restore(cfg, params, eng.sc, snap,
                                        device="cpu")
    final = {r.rid: r for r in reqs}
    for r in eng.restored_requests:
        final[r.rid] = r
    return eng, [final[r.rid] for r in reqs], restarts


@pytest.mark.parametrize("crash_at", [0, 2, 4])
def test_crash_restore_bit_identical_port(model, baseline, crash_at):
    eng, reqs = _mk(model, chaos=ChaosConfig(crash_at=crash_at),
                    snapshot_every_ticks=1)
    eng, reqs, restarts = _finish_after_restore(model, eng, reqs)
    assert restarts == 1
    assert [r.out_tokens for r in reqs] == baseline
    assert all(r.outcome == Outcome.OK.value for r in reqs)


def test_crash_restore_paged_with_prefix_cache_port(model):
    shared = [7, 8, 9, 10, 11, 12, 13, 14]
    pr = [shared + [20 + i] for i in range(3)]
    _, clean = _run(model, pr=pr, max_new=6, kv_pages=40, page_size=8,
                    prefix_cache=True)
    eng, reqs = _mk(model, pr=pr, max_new=6, kv_pages=40, page_size=8,
                    prefix_cache=True, chaos=ChaosConfig(crash_at=3),
                    snapshot_every_ticks=1)
    eng, reqs, restarts = _finish_after_restore(model, eng, reqs)
    assert restarts == 1
    assert ([r.out_tokens for r in reqs]
            == [r.out_tokens for r in clean])


def test_restore_strips_crash_trigger_by_default_port(model):
    eng, reqs = _mk(model, chaos=ChaosConfig(crash_at=1),
                    snapshot_every_ticks=1)
    with pytest.raises(EngineCrash):
        eng.run_to_completion()
    cfg, params = model
    e2 = ServingEngine.restore(cfg, params, eng.sc, eng.latest_snapshot(),
                               device="cpu")
    assert e2.sc.chaos.crash_at == -1
    assert e2._chaos.chaos_draws["engine.tick"] >= 1
    e3 = ServingEngine.restore(cfg, params, eng.sc, eng.latest_snapshot(),
                               device="cpu", reinject_crash=True)
    assert e3.sc.chaos.crash_at == 1


def test_snapshot_without_crash_chaos_is_inert_port(model, baseline):
    eng, reqs = _run(model, snapshot_every_ticks=2)
    assert [r.out_tokens for r in reqs] == baseline
    assert eng.stats["snapshots_taken"] >= 1


# --------------------------------------------- pool/radix snapshot bits
def test_radix_snapshot_roundtrip_preserves_matches_port():
    pool = PagePool(16, 4)
    rad = RadixCache(4)
    toks = list(range(12))
    pages = pool.alloc(3)
    rad.insert(toks, pages, pool)
    rad2 = RadixCache.from_snapshot(rad.to_snapshot())
    assert rad2.match(toks) == rad.match(toks)
    assert (rad2.hit_tokens, rad2.lookup_tokens) == (12, 12)
    assert rad2.n_pages() == rad.n_pages()
    assert rad2.n_nodes() == rad.n_nodes()
    pool2 = PagePool(16, 4)
    pool2.free_pages[:] = list(pool.free_pages)
    pool2.refcounts[:] = list(pool.refcounts)
    for pg in pages:
        pool.decref(pg)
        pool2.decref(pg)          # drop producer refs; tree ref remains
    assert rad.evict(3, pool) == rad2.evict(3, pool2) == 3
    assert pool.free_pages == pool2.free_pages


# ------------------------------------------------- outcome bookkeeping
def test_every_request_counted_exactly_once_port(model):
    eng, reqs = _run(model, chaos=ChaosConfig(seed=5, nan_logits=0.3,
                                              gemm_fault=0.1),
                     max_retries=1)
    assert all(r.done and r.outcome is not None for r in reqs)
    counted = sum(v for k, v in eng.stats.items()
                  if k.startswith("outcome_"))
    assert counted == len(reqs)


def test_hardened_defaults_keep_unhardened_config_shape_port(model, baseline):
    """Default ServeConfig enables no resilience feature, and its streams
    are the unhardened path's (the baseline fixture runs defaults)."""
    sc = ServeConfig(max_batch=2, max_seq=64)
    assert sc.max_queue == 0 and sc.deadline_ms == 0.0
    assert sc.preempt_policy == "none" and sc.chaos is None
    assert sc.snapshot_every_ticks == 0
    assert dataclasses.fields(sc)
    eng, reqs = _run(model)
    assert [r.out_tokens for r in reqs] == baseline
    assert eng._chaos is None and eng.stats["outcome_ok"] == len(reqs)


# ------------------------------------------ HeartbeatMonitor (the port's)
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_monitor_dead_hosts_by_timeout_port():
    clk = FakeClock()
    mon = HeartbeatMonitor(3, dead_after_s=10.0, clock=clk)
    assert mon.dead_hosts() == [0, 1, 2]
    for h in range(3):
        mon.beat(h, step=5, step_time_s=1.0)
    assert mon.dead_hosts() == []
    clk.t = 11.0
    assert mon.dead_hosts() == [0, 1, 2]
    mon.beat(1, step=6, step_time_s=1.0)
    assert mon.dead_hosts() == [0, 2]


def test_monitor_stragglers_need_quorum_port():
    clk = FakeClock()
    mon = HeartbeatMonitor(8, straggler_factor=2.0, clock=clk)
    mon.beat(0, 1, 10.0)
    mon.beat(1, 1, 1.0)
    assert mon.stragglers() == []
    mon.beat(2, 1, 1.0)
    mon.beat(3, 1, 1.1)
    assert mon.stragglers() == [0]


def test_monitor_single_host_never_straggles_port():
    mon = HeartbeatMonitor(1, clock=FakeClock())
    mon.beat(0, 1, 100.0)
    assert mon.stragglers() == []


# ------------------------------------------------- retry idempotency
def _state(cache):
    return [t.clone() for layer in cache for t in layer.values()]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _steps(cfg, params):
    """Each step kind at a mid-stream state: (name, cache, run) with run
    the step on a cache.  The dense and paged caches hold two rows'
    prefilled K/V first (positions 0-5, a ragged second row)."""
    B, S, page = 2, 32, 8
    toks = torch.tensor([[3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 0, 0]])
    lens, zero = torch.tensor([6, 4]), torch.zeros(2, dtype=torch.int64)
    dense = lm.init_cache(cfg, B, S, device="cpu")
    lm.prefill_step(cfg, params, dense, toks, zero, lens)
    pool = lm.init_paged_cache(cfg, 12, page, device="cpu")
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0]])
    lm.prefill_step_paged(cfg, params, pool, toks, zero, lens, bt)
    tok2 = torch.tensor([[13, 14, 15], [16, 17, 0]])
    pos, lens2 = torch.tensor([6, 4]), torch.tensor([3, 2])
    last = torch.tensor([21, 22])
    return [
        ("prefill", dense, lambda c: lm.prefill_step(
            cfg, params, c, tok2, pos, lens2)[0]),
        ("decode", dense, lambda c: lm.decode_step(
            cfg, params, c, last, pos)[0]),
        ("prefill_paged", pool, lambda c: lm.prefill_step_paged(
            cfg, params, c, tok2, pos, lens2, bt)[0]),
        ("decode_paged", pool, lambda c: lm.decode_step_paged(
            cfg, params, c, last, pos, bt)[0]),
    ]


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "prefill_paged",
                                  "decode_paged"])
def test_retried_step_rewrites_the_same_bytes(model, kind, where):
    """Every dispatch of the step draws (no trace scope), so the fault
    lands at dispatch ``n``: the first (nothing written), the last
    layer's attn.pv (its K/V already written in place — in the paged
    prefill, into the gathered view not yet scattered back) or the
    unembed (every layer written).  The retry then leaves logits and the
    whole cache or pool bit for bit a clean step's from the same state."""
    cfg, params = model
    params = ServingEngine(cfg, params, ServeConfig(max_seq=32),
                           device="cpu").params
    L = cfg.n_layers
    n = {"first": 0, "middle": 8 * (L - 1) + 4, "last": 8 * L}[where]
    name, cache, run = dict((s[0], s) for s in _steps(cfg, params))[kind]
    clean = copy.deepcopy(cache)
    want = run(clean)
    faulted = copy.deepcopy(cache)
    eng = ChaosEngine(ChaosConfig(gemm_fault_at=n))
    with chaos.scope(eng), pytest.raises(KernelFault):
        run(faulted)
    site = {"first": "attn.wq", "middle": "attn.pv", "last": "unembed"}
    assert eng.chaos_log == [("substrate.dispatch", n, site[where])]
    if where != "first":
        assert not all(torch.equal(a, b) for a, b in
                       zip(_state(faulted), _state(cache)))
    got = run(faulted)
    assert torch.equal(got, want)
    _assert_same(_state(faulted), _state(clean))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("n", [0, 4, 8, 9, 13, 17])
def test_engine_retry_leaves_the_clean_cache(model, paged, n):
    """The engine's own retry (a fault at draw n of its first prefill and
    decode traces: 9 sites each) leaves the whole cache or pool after
    every tick bit for bit a clean engine's."""
    kw = dict(kv_pages=12, page_size=8) if paged else {}
    clean, creqs = _mk(model, max_new=3, **kw)
    eng, reqs = _mk(model, max_new=3, chaos=ChaosConfig(gemm_fault_at=n),
                    **kw)
    while clean.queue or clean._resident():
        clean.step()
        eng.step()
        _assert_same(_state(eng.cache), _state(clean.cache))
    assert not (eng.queue or eng._resident())
    assert eng.stats["kernel_fault_retries"] == 1
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in creqs]


# ------------------------------------------------- snapshot round trip
def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kv_pages=12, page_size=8, prefix_cache=True),
    dict(kv_pages=5, page_size=8, preempt_policy="youngest",
         prefix_cache=True, chaos=ChaosConfig(seed=2, gemm_fault=0.2)),
], ids=["dense", "paged", "paged-preempt-chaos"])
def test_snapshot_restore_snapshot_is_identity(model, kw):
    shared = [7, 8, 9, 10, 11, 12, 13, 14]
    eng, _ = _mk(model, pr=[shared + [20 + i] for i in range(3)],
                 max_new=6, temperature=0.7, **kw)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    cfg, params = model
    again = ServingEngine.restore(cfg, params, eng.sc, snap,
                                  device="cpu").snapshot()
    assert _equal(again, snap)
    assert _equal(eng.snapshot(), snap)   # taking it changed nothing


@pytest.mark.parametrize("paged", [False, True])
def test_sampled_stream_survives_crash(model, baseline, paged):
    kw = dict(kv_pages=40, page_size=8) if paged else {}
    _, clean = _run(model, max_new=6, temperature=0.8, seed=3, **kw)
    eng, reqs = _mk(model, max_new=6, temperature=0.8, seed=3,
                    chaos=ChaosConfig(crash_at=3), snapshot_every_ticks=1,
                    **kw)
    eng, reqs, restarts = _finish_after_restore(model, eng, reqs)
    assert restarts == 1
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in clean]
    assert [r.out_tokens for r in clean] != baseline      # it sampled
