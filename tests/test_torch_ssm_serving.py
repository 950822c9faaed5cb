"""Serving the SSM family and the hybrid through the port's engine, against
the reference's engine.

* Greedy streams: both engines serve the same requests on the same
  converted weights (fp32) under the same schedule, in token mode (the
  only mode these families have): identical on ``arrayflex`` (fp32) and
  ``arrayflex_int8`` (W8), at ``max_batch`` 1 and 2 (the hybrid at 2),
  with the same dispatch counts.
* Co-resident pollution, a fact about the reference that the port keeps
  for parity: a token-prefill step is a full-batch decode step, so the
  other resident rows advance their recurrent state on token 0, and a
  freed slot's state is not reset.  Request A served alone and served
  with B resident give different streams, in both packages alike.
* The anchor the pollution cannot touch: one request alone
  (``max_batch=1``).  Its stream is the greedy argmax of ``lm.forward``
  over its own tokens, and ``decode_step``'s logits token by token equal
  ``lm.forward``'s at every position within 4e-3 absolute in both
  packages: the conv window is cached in bf16, which the full-sequence
  forward never rounds (the reference's own gap on these inputs is
  2.0e-3 with an MLP and 1.8e-3 without, at logits below 0.62).
* Retries: a step that faults part way (at the last layer's
  ``mamba.out``, or at the unembed after every layer ran) or whose logits
  a NaN retry rejects is run again on the cache as it was, so the whole
  cache after every tick and the streams equal a clean engine's bit for
  bit; ``snapshot()`` / ``restore()`` round-trip the recurrent leaves.
"""
import contextlib

import jax.numpy as jnp
import pytest
import torch

from repro.kernels import substrate as ref_sub
from repro.models import lm as ref_lm
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.kernels import substrate
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.runtime import chaos
from repro_torch.runtime.chaos import ChaosConfig, ChaosEngine
from repro_torch.serving import (EngineCrash, KernelFault, ServeConfig,
                                 ServingEngine)
from repro_torch.serving.engine import Request
from test_torch_ssm_model import _ref_decode, build, cfgs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROMPTS = [[5, 6, 7], [11, 12, 13, 14], [21, 22]]
ANCHOR_TOL = 4e-3


@pytest.fixture(scope="module")
def trees():
    return {case: build(case) for case in ("mamba2", "mamba2-noffn",
                                           "jamba")}


def _serve_ref(rc, rp, prompts, max_batch, max_new=5):
    eng = RefEngine(rc, rp, RefServeConfig(max_batch=max_batch, max_seq=32))
    reqs = [RefRequest(prompt=list(p), max_new_tokens=max_new, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.out_tokens for r in reqs], eng


def _serve(tc, tp, prompts, max_batch, max_new=5, **kw):
    eng = ServingEngine(tc, tp, ServeConfig(max_batch=max_batch, max_seq=32,
                                            **kw), device="cpu")
    reqs = [Request(prompt=list(p), max_new_tokens=max_new, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.out_tokens for r in reqs], eng


@pytest.mark.parametrize("case,max_batch", [("mamba2", 1), ("mamba2", 2),
                                            ("jamba", 2)])
@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8"])
def test_greedy_streams_match_reference_engine(trees, case, backend,
                                               max_batch):
    rc, tc = cfgs(case, backend)
    rp, tp = trees[case]
    ref_sub.clear_plan_cache()
    want, ref = _serve_ref(rc, rp, PROMPTS, max_batch)
    ref_counts = dict(ref_sub.DISPATCH_COUNTS)
    substrate.clear_plan_cache()
    got, eng = _serve(tc, tp, PROMPTS, max_batch)
    assert got == want
    assert all(len(s) == 5 for s in got)
    assert eng.prefill_mode == "token"
    for key in ("prefill_dispatches", "decode_dispatches", "prefill_tokens",
                "decode_tokens"):
        assert eng.stats[key] == ref.stats[key], key
    steps = eng.stats["prefill_dispatches"] + eng.stats["decode_dispatches"]
    assert set(substrate.DISPATCH_COUNTS) == set(ref_counts)
    for site, n in substrate.DISPATCH_COUNTS.items():
        per_step = 1 if site == "unembed" else \
            ref_counts[site] // ref_counts["unembed"] * lm.n_super(tc)
        assert n == steps * per_step, site
    substrate.clear_plan_cache()
    ref_sub.clear_plan_cache()


def test_co_resident_pollution_is_the_references(trees):
    """A's stream alone differs from A's with B resident (B's token
    prefill advances A's state on token 0), in both packages alike."""
    rc, tc = cfgs("mamba2-noffn", "arrayflex")
    rp, tp = trees["mamba2-noffn"]
    a, b = [3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8]
    alone_ref, _ = _serve_ref(rc, rp, [a], 2, max_new=6)
    alone, _ = _serve(tc, tp, [a], 2, max_new=6)
    shared_ref, _ = _serve_ref(rc, rp, [b, a], 2, max_new=6)
    shared, _ = _serve(tc, tp, [b, a], 2, max_new=6)
    assert alone == alone_ref and shared == shared_ref
    assert alone[0] != shared[1]


@pytest.mark.parametrize("case", ["mamba2", "mamba2-noffn"])
def test_one_request_alone_is_the_forward(trees, case):
    rc, tc = cfgs(case, "arrayflex")
    rp, tp = trees[case]
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    (stream,), _ = _serve(tc, tp, [prompt], 1, max_new=8)
    (want,), _ = _serve_ref(rc, rp, [prompt], 1, max_new=8)
    assert stream == want
    toks = prompt + stream[:-1]
    p = lm.prepare_params(tc, tp)
    full, _, _ = lm.forward(tc, p, {"tokens": torch.tensor([toks])})
    assert [int(t) for t in full[0, len(prompt) - 1:].argmax(-1)] == stream
    ref_full, _, _ = ref_lm.forward(rc, rp, {"tokens": jnp.asarray([toks])})
    cache = lm.init_cache(tc, 1, 32, device="cpu")
    rcache = ref_lm.init_cache(rc, 1, 32)
    gap = ref_gap = 0.0
    for t, tok in enumerate(toks):
        logits, cache = lm.decode_step(tc, p, cache, torch.tensor([tok]),
                                       torch.tensor([t]))
        rlogits, rcache = _ref_decode(rc)(rp, rcache, jnp.asarray([tok]),
                                          jnp.asarray([t]))
        gap = max(gap, float((logits[0] - full[0, t]).abs().max()))
        ref_gap = max(ref_gap, float(jnp.abs(rlogits[0]
                                             - ref_full[0, t]).max()))
    assert gap <= ANCHOR_TOL and ref_gap <= ANCHOR_TOL, (gap, ref_gap)


# ------------------------------------------------------------- retries
def _leaves(cache):
    return [t.clone() for layer in cache for t in layer.values()]


def _same(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def every_dispatch_draws(monkeypatch):
    """Every GEMM dispatch of an attempt draws (not only each site label's
    first), so a fault can land at any layer."""
    monkeypatch.setattr(substrate, "chaos_trace_scope", contextlib.nullcontext)


def _fault_index(tc, tp, where, monkeypatch):
    """The draw index of the last layer's mamba.out, or of the unembed,
    in one decode step that draws at every dispatch: the step's dispatch
    order, recorded."""
    order = []
    real = substrate._record

    def record(site, plan, launches=1):
        order.append(site)
        real(site, plan, launches)

    with monkeypatch.context() as m:
        m.setattr(substrate, "_record", record)
        lm.decode_step(tc, lm.prepare_params(tc, tp),
                       lm.init_cache(tc, 2, 8, device="cpu"),
                       torch.tensor([1, 2]), torch.tensor([0, 0]))
    assert order[-1] == "unembed"
    if where == "unembed":
        return len(order) - 1
    return len(order) - 1 - order[::-1].index("mamba.out")


@pytest.mark.parametrize("where", ["last mamba.out", "unembed"])
@pytest.mark.parametrize("case", ["mamba2", "mamba2-noffn"])
def test_retried_decode_step_equals_a_clean_one(trees, case, where,
                                                monkeypatch):
    """``lm.decode_step`` faulted part way leaves its input cache as it
    was; run again, its logits and the cache it returns equal a clean
    step's bit for bit."""
    _, tc = cfgs(case, "arrayflex")
    p = lm.prepare_params(tc, trees[case][1])
    cache = lm.init_cache(tc, 2, 16, device="cpu")
    toks = torch.tensor([[3, 4], [5, 6], [7, 8]])
    for t in range(3):                         # a mid-stream state
        _, cache = lm.decode_step(tc, p, cache, toks[t], torch.tensor([t, t]))
    before = _leaves(cache)
    step = (lambda: lm.decode_step(tc, p, cache, torch.tensor([9, 10]),
                                   torch.tensor([3, 3])))
    want, clean = step()
    n = _fault_index(tc, trees[case][1], where, monkeypatch)
    eng = ChaosEngine(ChaosConfig(gemm_fault_at=n))
    with chaos.scope(eng), pytest.raises(KernelFault):
        step()
    assert eng.chaos_log == [("substrate.dispatch", n, where.split()[-1])]
    assert _same(_leaves(cache), before)
    got, again = step()
    assert torch.equal(got, want)
    assert _same(_leaves(again), _leaves(clean))


def _lockstep(model, prompts, chaos_cfg, **kw):
    """A clean engine and a chaos one, stepped tick by tick: the whole
    cache equal after every tick, then the streams."""
    tc, tp = model
    clean = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_seq=32, **kw),
                          device="cpu")
    eng = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_seq=32,
                                            chaos=chaos_cfg, **kw),
                        device="cpu")
    creqs = [Request(prompt=list(p), max_new_tokens=4, rid=i)
             for i, p in enumerate(prompts)]
    reqs = [Request(prompt=list(p), max_new_tokens=4, rid=i)
            for i, p in enumerate(prompts)]
    for a, b in zip(creqs, reqs):
        clean.submit(a)
        eng.submit(b)
    while clean.queue or clean._resident():
        clean.step()
        eng.step()
        assert _same(_leaves(eng.cache), _leaves(clean.cache))
    assert not (eng.queue or eng._resident())
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in creqs]
    assert all(r.outcome == "ok" for r in reqs)
    return eng


@pytest.mark.parametrize("where", ["last mamba.out", "unembed"])
@pytest.mark.parametrize("step", ["token prefill", "decode"])
@pytest.mark.parametrize("case", ["mamba2-noffn", "jamba"])
def test_engine_retry_leaves_the_clean_cache(trees, every_dispatch_draws,
                                             monkeypatch, case, step, where):
    """The engine's retry of a faulted first step — a token-prefill step
    (a 4-token prompt resident beside a decoding one-token request) or a
    decode step (one-token prompts: no prefill) — leaves the whole cache
    bit for bit a clean engine's after every tick."""
    _, tc = cfgs(case, "arrayflex")
    prompts = ([[21], [5, 6, 7, 8]] if step == "token prefill"
               else [[21], [22]])
    n = _fault_index(tc, trees[case][1], where, monkeypatch)
    eng = _lockstep((tc, trees[case][1]), prompts,
                    ChaosConfig(gemm_fault_at=n))
    assert eng.stats["kernel_fault_retries"] == 1
    assert eng._chaos.chaos_log[0][1:] == (n, where.split()[-1])
    if step == "decode":
        assert eng.stats["prefill_dispatches"] == 0


def test_engine_nan_retry_leaves_the_clean_cache(trees):
    """A transient NaN at the first sampling re-runs the decode step from
    the cache as it was (the rejected attempt's state is dropped)."""
    _, tc = cfgs("mamba2", "arrayflex")
    eng = _lockstep((tc, trees["mamba2"][1]), [[21], [5, 6, 7]],
                    ChaosConfig(nan_logits_at=0))
    assert eng.stats["sample_retries"] == 1


def test_snapshot_restore_round_trips_the_state(trees):
    """``snapshot()`` of ``restore(snapshot(e))`` equals ``snapshot(e)``,
    the recurrent leaves bit for bit; a crash restored from its latest
    snapshot continues with the uncrashed streams."""
    _, tc = cfgs("mamba2", "arrayflex")
    tp = trees["mamba2"][1]
    want, _ = _serve(tc, tp, PROMPTS, 2)
    eng = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_seq=32),
                        device="cpu")
    reqs = [Request(prompt=list(p), max_new_tokens=5, rid=i)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    assert {"state", "conv"} <= set(snap["cache"][0])
    again = ServingEngine.restore(tc, tp, eng.sc, snap, device="cpu")
    assert _same(_leaves(again.cache), _leaves(eng.cache))
    assert _same(_leaves(again.snapshot()["cache"]), _leaves(snap["cache"]))
    again.run_to_completion()
    final = {r.rid: r.out_tokens for r in reqs}
    final.update({r.rid: r.out_tokens for r in again.restored_requests})
    assert [final[i] for i in range(len(PROMPTS))] == want
    crashed = ServingEngine(tc, tp, ServeConfig(
        max_batch=2, max_seq=32, snapshot_every_ticks=1,
        chaos=ChaosConfig(crash_at=4)), device="cpu")
    reqs = [Request(prompt=list(p), max_new_tokens=5, rid=i)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        crashed.submit(r)
    with pytest.raises(EngineCrash):
        crashed.run_to_completion()
    restored = ServingEngine.restore(tc, tp, crashed.sc,
                                     crashed.latest_snapshot(), device="cpu")
    restored.run_to_completion()
    final = {r.rid: r.out_tokens for r in reqs}
    final.update({r.rid: r.out_tokens for r in restored.restored_requests})
    assert [final[i] for i in range(len(PROMPTS))] == want


def test_engine_gates_and_cache_bytes(trees):
    _, tc = cfgs("mamba2", "arrayflex")
    tp = trees["mamba2"][1]
    with pytest.raises(ValueError, match="batched prefill"):
        ServingEngine(tc, tp, ServeConfig(prefill_mode="batched"),
                      device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(tc, tp, ServeConfig(kv_pages=12, page_size=8),
                      device="cpu")
    eng = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_seq=32),
                        device="cpu")
    entry = eng.cache[0]
    assert eng.kv_cache_bytes() == sum(
        t.numel() * t.element_size() for t in entry.values()) > 0
    assert entry["state"].dtype == torch.float32
    assert entry["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_serve_cli_on_cpu(arch, capsys):
    reqs = serve.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                       "--max-new", "3", "--gemm-backend", "arrayflex_int8"])
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)
    assert "prefill[token]" in capsys.readouterr().out


def test_serve_cli_refuses_unported_archs_at_once(capsys):
    """The three families that were refused now serve, reduced, in token
    mode: every request ``ok`` with its tokens."""
    for arch in ("mixtral-8x22b", "whisper-base", "llama-3.2-vision-90b"):
        reqs = serve.main(["--device", "cpu", "--arch", arch, "--requests",
                           "2", "--max-new", "3"])
        assert [r.outcome for r in reqs] == ["ok", "ok"], arch
        assert all(len(r.out_tokens) == 3 for r in reqs), arch
        assert "prefill[token]" in capsys.readouterr().out
