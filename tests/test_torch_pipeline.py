"""The pipeline: ``parallel/pipeline.py``'s single-controller schedules and
cost model, ``lm.decode_step_pp`` / ``prefill_step_pp`` and the
disaggregated engine at ``pp_stages = 2``, against the reference.

The reference runs its stages inside ``shard_map`` over a (pod, data,
model) role mesh; the port runs each stage once, in order, on the stage's
logical device (four CPU devices here: two prefill pods, two decode
pods).  The reference asserts that its pp = 2 streams are its colocated
engine's, bit for bit (``tests/test_disagg.py``); the port's pp = 2
streams are held to the reference's colocated streams on ``xla``,
``arrayflex`` and ``arrayflex_w8a8``.  The pp = 2 chaos draw book is held
to the reference's own pp = 2 run in ``tests/test_torch_sharded_dispatch``
(the one multi-device subprocess).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.kernels import substrate as ref_sub
from repro.models import lm as ref_lm
from repro.parallel import pipeline as ref_pipe
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, substrate
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve
from repro_torch.models import convert, lm
from repro_torch.parallel import pipeline
from repro_torch.serving import DisaggServeConfig, DisaggServingEngine
from repro_torch.serving.engine import Request


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "llama3-8b"
REQS = [([5, 7, 11, 13, 17, 19, 23], 4, 1), ([2, 3], 3, 2), ([31], 3, 3),
        (list(range(40, 52)), 3, 4)]
KW = dict(max_batch=4, max_seq=64, seed=0)


@pytest.fixture(autouse=True)
def _process_state():
    """Put back the site and dispatch logs and plan tallies, and empty the
    port's plan memos."""
    dicts = (substrate.DISPATCH_COUNTS, substrate.SITE_PLANS,
             ref_sub.DISPATCH_COUNTS, ref_sub.SITE_PLANS)
    tallies = (substrate.PLAN_CACHE_STATS, ref_sub.PLAN_CACHE_STATS)
    saved = [dict(d) for d in dicts]
    saved_tallies = [{k: dict(v) for k, v in t.items()} for t in tallies]
    yield
    substrate.clear_plan_cache()
    for d, v in zip(dicts + tallies, saved + saved_tallies):
        d.clear()
        d.update(v)


_MODELS = {}


def models(arch=ARCH):
    """(reference cfg, params, port cfg, params) at fp32 compute, the
    port's tree converted leaf by leaf."""
    if arch not in _MODELS:
        rc = dataclasses.replace(ref_reduced(ARCHS[arch]),
                                 compute_dtype="float32")
        tc = dataclasses.replace(reduced(get_config(arch)),
                                 compute_dtype="float32")
        rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
        tp = convert.params_from_reference(
            tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
        _MODELS[arch] = (rc, rp, tc, tp)
    return _MODELS[arch]


def _role(cfg, role="decode", offset=0):
    return dataclasses.replace(cfg, pp_role=role, pp_stages=2,
                               mesh_shape=(2, 1, 1), pod_offset=offset)


# ------------------------------------------------------------ schedules
def test_staged_step_runs_each_stage_once_in_order():
    """Stage s runs once, on stage s-1's output moved to its device, and
    commits its own state; the last stage's output comes back."""
    calls = []

    def fn(s, x, state):
        calls.append((s, x.device))
        return x * (s + 2), state + [s]

    devs = [torch.device("cpu")] * 3
    y, states = pipeline.staged_step(fn, torch.ones(2), [[], [], []], devs)
    assert torch.equal(y, torch.full((2,), 24.0))
    assert states == [[0], [1], [2]]
    assert [s for s, _ in calls] == [0, 1, 2]


@pytest.mark.parametrize("P,M", [(1, 3), (2, 1), (2, 4), (4, 3)])
def test_gpipe_equals_the_stages_applied_in_turn(P, M):
    """The fill/drain schedule over M microbatches gives each microbatch
    the composition of the P stage functions, in microbatch order; the
    pipelined wrapper takes one params tree a stage."""
    g = torch.Generator().manual_seed(P * 10 + M)
    ws = [torch.randn(4, 4, generator=g) for _ in range(P)]
    x = torch.randn(M, 3, 4, generator=g)

    def fn(p, h):
        return torch.tanh(h @ p["w"])

    want = x
    for w in ws:
        want = torch.tanh(want @ w)
    with mesh_lib.host_devices(P, "cpu"):
        mesh = mesh_lib.pod_mesh(P, 1, 1, 0)
    got = pipeline.make_pipelined(fn, mesh)([{"w": w} for w in ws], x)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="stage params"):
        pipeline.make_pipelined(fn, mesh)([{"w": ws[0]}] * (P + 1), x)


def test_cost_model_matches_reference():
    for n_pods, micro, layer, over in itertools.product(
            (1, 2, 4, 8, 12), (1, 2, 8, 32), (0.5, 3.0), (0.1, 2.0, 9.0)):
        c = pipeline.PipelineCost(n_pods, micro, layer, over)
        rc = ref_pipe.PipelineCost(n_pods, micro, layer, over)
        for k in range(1, n_pods + 1):
            assert pipeline.stage_time_ms(c, k) == \
                ref_pipe.stage_time_ms(rc, k)
            assert pipeline.pipeline_latency_ms(c, k) == \
                ref_pipe.pipeline_latency_ms(rc, k)
        assert pipeline.k_hat(c) == ref_pipe.k_hat(rc)
        assert pipeline.best_collapse(c) == ref_pipe.best_collapse(rc)
        assert pipeline.plan(c) == ref_pipe.plan(rc)


# ------------------------------------------------------------ pp steps
def test_supports_pipeline_and_check_pp_match_reference():
    for arch, kw in itertools.product(
            ("llama3-8b", "qwen2-0.5b", "qwen3-moe-30b-a3b", "mamba2-370m"),
            (dict(), dict(pp_stages=2), dict(pp_stages=2,
                                             mesh_shape=(2, 1, 1)),
             dict(pp_stages=2, mesh_shape=(3, 1, 1)),
             dict(pp_stages=3, mesh_shape=(3, 1, 1)))):
        tc = dataclasses.replace(reduced(get_config(arch)), **kw)
        rc = dataclasses.replace(ref_reduced(ARCHS[arch]), **kw)
        assert lm.supports_pipeline(tc) == ref_lm.supports_pipeline(rc)
        if not lm.supports_pipeline(tc):
            with pytest.raises(ValueError) as want:
                ref_lm._check_pp(rc)
            with pytest.raises(ValueError) as got:
                lm._check_pp(tc)
            assert str(got.value) == str(want.value)
            with pytest.raises(ValueError, match="pipeline step needs"):
                lm.decode_step_pp(tc, None, None, torch.zeros(1), 0)


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8"])
def test_pp_steps_equal_colocated_and_reference(backend):
    """decode_step_pp and prefill_step_pp under each role give the
    colocated steps' logits and cache bit for bit, and the reference's
    colocated logits (1e-5); they launch exactly the colocated steps'
    kernels; attn.wq plans under the role's transfer terms."""
    rc, rp, tc, tp = models()
    rc = dataclasses.replace(rc, gemm_backend=backend)
    tc = dataclasses.replace(tc, gemm_backend=backend)
    tp = lm.prequantize_params(tc, tp)
    B, C = 2, 8
    rng = np.random.default_rng(3)
    toks = rng.integers(2, 500, (B, C))
    lens = np.asarray([C, 5])
    ref_cache = ref_lm.init_cache(rc, B, 32)
    want_p, ref_cache = ref_lm.prefill_step(
        rc, rp, ref_cache, jnp.asarray(toks, jnp.int32),
        jnp.zeros(B, jnp.int32), jnp.asarray(lens, jnp.int32))
    tok = np.asarray([7, 9])
    want_d, _ = ref_lm.decode_step(rc, rp, ref_cache,
                                   jnp.asarray(tok, jnp.int32),
                                   jnp.asarray(lens, jnp.int32))
    out, launches = {}, {}
    with mesh_lib.host_devices(4, "cpu"):
        for name, pcfg, dcfg, pre, dec in (
                ("colocated", tc, tc, lm.prefill_step, lm.decode_step),
                ("pp", _role(tc, "prefill"), _role(tc, "decode", 2),
                 lm.prefill_step_pp, lm.decode_step_pp)):
            cache = lm.init_cache(tc, B, 32, device="cpu")
            n = [0]
            mm = ops.arrayflex_matmul

            def counted(*a, **kw):
                n[0] += 1
                return mm(*a, **kw)

            ops.arrayflex_matmul = counted
            try:
                lp, cache = pre(pcfg, tp, cache, torch.as_tensor(toks),
                                torch.zeros(B, dtype=torch.int64),
                                torch.as_tensor(lens))
                wq_pre = substrate.SITE_PLANS["attn.wq"].shard
                ld, cache = dec(dcfg, tp, cache, torch.as_tensor(tok),
                                torch.as_tensor(lens))
                wq_dec = substrate.SITE_PLANS["attn.wq"].shard
            finally:
                ops.arrayflex_matmul = mm
            out[name] = (lp, ld, cache, wq_pre, wq_dec)
            launches[name] = n[0]
    lp, ld, cache, wq_pre, wq_dec = out["pp"]
    assert torch.equal(lp, out["colocated"][0])
    assert torch.equal(ld, out["colocated"][1])
    for a, b in zip(cache, out["colocated"][2]):
        for key in a:
            assert torch.equal(a[key], b[key])
    assert launches["pp"] == launches["colocated"] > 0
    assert wq_pre.transfer_ops == 1 and wq_dec.transfer_cycles > 0
    assert out["colocated"][3] == substrate.SHARD_NONE
    for got, want in ((lp, want_p), (ld, want_d)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# --------------------------------------------------- disaggregated pp=2
_REF_STREAMS = {}


def _serve(eng, req_cls):
    rs = [req_cls(prompt=list(p), max_new_tokens=n, rid=rid)
          for p, n, rid in REQS]
    for r in rs:
        eng.submit(r)
    eng.run_to_completion()
    return [list(r.out_tokens) for r in rs], [r.outcome for r in rs]


@pytest.mark.parametrize("backend", ["xla", "arrayflex", "arrayflex_w8a8"])
def test_pp2_streams_equal_reference_colocated(backend):
    """DisaggServingEngine with 2 + 2 pods and pp_stages = 2 over four
    logical devices: the reference's colocated streams, every request ok,
    every prefilled request's K/V rows handed across the role windows;
    the role meshes are the reference's windows."""
    rc, rp, tc, tp = models()
    if backend not in _REF_STREAMS:
        _REF_STREAMS[backend] = _serve(RefEngine(
            dataclasses.replace(rc, gemm_backend=backend), rp,
            RefServeConfig(**KW)), RefRequest)
    want = _REF_STREAMS[backend]
    with mesh_lib.host_devices(4, "cpu"):
        eng = DisaggServingEngine(
            dataclasses.replace(tc, gemm_backend=backend), tp,
            DisaggServeConfig(**KW, pp_stages=2, prefill_pods=2,
                              decode_pods=2), device="cpu")
        got = _serve(eng, Request)
    assert got == want and got[1] == ["ok"] * len(REQS)
    assert (eng.pcfg.mesh_shape, eng.pcfg.pod_offset) == ((2, 1, 1), 0)
    assert (eng.dcfg.mesh_shape, eng.dcfg.pod_offset) == ((2, 1, 1), 2)
    assert eng._pmesh.shape == eng._dmesh.shape == {"pod": 2, "data": 1,
                                                    "model": 1}
    row = sum(t[:, 0].numel() * t.element_size()
              for layer in eng.pcache for t in layer.values())
    handoffs = sum(len(p) > 1 for p, _, _ in REQS)
    assert eng.stats["kv_transfer_bytes"] == handoffs * row


def test_pp2_construction_checks_match_reference():
    """The reference's pp checks, in its order: dense K/V, pods equal to
    the stages, batched prefill, and a stage-divisible dense family."""
    rc, rp, tc, tp = models()
    from repro.serving import DisaggServeConfig as RefDSC
    from repro.serving import DisaggServingEngine as RefDisagg
    cases = [dict(kv_pages=40, page_size=16), dict(prefill_pods=1),
             dict(decode_pods=3), dict(prefill_mode="token")]
    with mesh_lib.host_devices(8, "cpu"):
        for kw in cases:
            kw = {"prefill_pods": 2, "decode_pods": 2, **kw}
            errs = []
            for cls, sc, cfg, params, extra in (
                    (RefDisagg, RefDSC, rc, rp, {}),
                    (DisaggServingEngine, DisaggServeConfig, tc, tp,
                     {"device": "cpu"})):
                with pytest.raises(ValueError) as exc:
                    cls(cfg, params, sc(**KW, pp_stages=2, **kw), **extra)
                errs.append(str(exc.value))
            assert errs[0] == errs[1], kw
        # an MoE model has no batched prefill: the reference's error
        moe = dataclasses.replace(reduced(get_config("qwen3-moe-30b-a3b")),
                                  compute_dtype="float32")
        with pytest.raises(ValueError, match="batched prefill"):
            DisaggServingEngine(moe, lm.init_params(moe, seed=0,
                                                    device="cpu"),
                                DisaggServeConfig(**KW, pp_stages=2,
                                                  prefill_pods=2,
                                                  decode_pods=2),
                                device="cpu")


# ------------------------------------------------------------ serve CLI
def test_serve_cli_pp2_in_process(capsys):
    """``--pp 2 --prefill-pods 2 --decode-pods 2 --host-devices 4``
    serves in process, every request ok; without the fan-out it raises."""
    args = ["--device", "cpu", "--gemm-backend", "arrayflex", "--requests",
            "2", "--max-new", "3", "--pp", "2", "--prefill-pods", "2",
            "--decode-pods", "2"]
    reqs = serve.main(args + ["--host-devices", "4"])
    out = capsys.readouterr().out
    assert "disagg: 2 prefill + 2 decode pod(s), pp=2" in out
    assert [r.outcome for r in reqs] == ["ok", "ok"]
    colo = serve.main(["--device", "cpu", "--gemm-backend", "arrayflex",
                       "--requests", "2", "--max-new", "3"])
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in colo]
    with pytest.raises(ValueError, match="devices"):
        serve.main(args)
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--pp", "2"])
