"""The port's ServingEngine vs the reference engine.

Greedy streams on the reduced qwen2-0.5b with the reference's converted
parameters must be identical to the reference ``ServingEngine``'s (fp32,
the xla and arrayflex backends), with the same prefill/decode dispatch
structure.  The reference traces each jit'd step once, so its
``DISPATCH_COUNTS`` hold one count per site and trace; the port runs
eagerly and counts every dispatch: per site, once per layer (``unembed``
once) for every prefill or decode dispatch.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.kernels import substrate as ref_sub
from repro.models import lm as ref_lm
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import substrate
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.serving import Request, ServeConfig, ServingEngine

PROMPTS = [[5, 6, 7], [11, 12, 13, 14], [21, 22]]


def _cfgs(backend):
    rc = dataclasses.replace(ref_reduced(ARCHS["qwen2-0.5b"]),
                             gemm_backend=backend, compute_dtype="float32")
    tc = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                             gemm_backend=backend, compute_dtype="float32")
    return rc, tc


@pytest.fixture(scope="module")
def params():
    rc, tc = _cfgs("xla")
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
    tp = convert.params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return rp, tp


def _run_port(tc, tp, prompts=PROMPTS, **sc):
    eng = ServingEngine(tc, tp, ServeConfig(**dict(dict(
        max_batch=2, max_seq=32), **sc)), device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=4, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
def test_greedy_streams_match_reference_engine(backend, params):
    rc, tc = _cfgs(backend)
    rp, tp = params
    ref_sub.clear_plan_cache()
    ref = RefEngine(rc, rp, RefServeConfig(max_batch=2, max_seq=32))
    rreqs = [RefRequest(prompt=p, max_new_tokens=4, rid=i)
             for i, p in enumerate(PROMPTS)]
    for r in rreqs:
        ref.submit(r)
    ref.run_to_completion()
    ref_counts = dict(ref_sub.DISPATCH_COUNTS)
    substrate.clear_plan_cache()
    streams, eng = _run_port(tc, tp)
    assert streams == [r.out_tokens for r in rreqs]
    for key in ("prefill_dispatches", "decode_dispatches", "prefill_tokens",
                "decode_tokens"):
        assert eng.stats[key] == ref.stats[key], key
    steps = eng.stats["prefill_dispatches"] + eng.stats["decode_dispatches"]
    assert set(substrate.DISPATCH_COUNTS) == set(ref_counts)
    traces = set(ref_counts.values())
    assert len(traces) == 1           # every site traced equally often
    for site, n in substrate.DISPATCH_COUNTS.items():
        per_step = 1 if site == "unembed" else tc.n_layers
        assert n == per_step * steps, site
    assert eng.stats["prefill_gemm_dispatches"] == \
        eng.stats["prefill_dispatches"] * (6 * tc.n_layers + 1 + 2 * tc.n_layers)
    substrate.clear_plan_cache()
    ref_sub.clear_plan_cache()


LONG_PROMPTS = [[5, 6, 7], [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
                [21], [31, 32, 33, 34, 35], [41, 42, 43, 44, 45, 46, 47, 48]]


@pytest.mark.parametrize("chunk", [4, 16, 0])
def test_batched_prefill_matches_token_prefill(chunk, params):
    """The contract of tests/test_serving_prefill.py: chunked batched
    prefill emits the same greedy streams as token-by-token prefill, in
    ceil(P / chunk) prefill dispatches."""
    _, tc = _cfgs("arrayflex")
    token, _ = _run_port(tc, params[1], LONG_PROMPTS, prefill_mode="token")
    batched, eng = _run_port(tc, params[1], LONG_PROMPTS,
                             prefill_mode="batched", prefill_chunk=chunk)
    assert batched == token
    if chunk == 4:
        assert eng.stats["prefill_dispatches"] < sum(
            len(p) - 1 for p in LONG_PROMPTS)


def test_eos_frees_slot(params):
    _, tc = _cfgs("xla")
    first, _ = _run_port(tc, params[1])
    eos = first[0][1]
    cut, _ = _run_port(tc, params[1], eos_id=eos)
    assert cut[0] == first[0][:2]


def test_temperature_sampling_is_seeded(params):
    _, tc = _cfgs("xla")

    def run(seed):
        eng = ServingEngine(tc, params[1], ServeConfig(max_batch=2,
                                                       max_seq=32, seed=seed),
                            device="cpu")
        reqs = [Request(prompt=p, max_new_tokens=6, temperature=1.0, rid=i)
                for i, p in enumerate(PROMPTS)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        return [r.out_tokens for r in reqs]

    a = run(0)
    assert a == run(0)
    assert all(0 <= t < tc.padded_vocab for s in a for t in s)


def test_engine_rejects_bad_requests_and_devices(params):
    _, tc = _cfgs("xla")
    eng = ServingEngine(tc, params[1], ServeConfig(max_batch=1, max_seq=8),
                        device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(prompt=[]))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.submit(Request(prompt=list(range(9))))
    with pytest.raises(ValueError, match="unknown gemm backend"):
        ServingEngine(dataclasses.replace(tc, gemm_backend="nope"),
                      params[1], ServeConfig(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(tc, params[1], ServeConfig())


def test_serve_cli_on_cpu(capsys):
    reqs = serve.main(["--device", "cpu", "--requests", "2", "--max-new",
                       "3", "--gemm-backend", "arrayflex"])
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)
    assert "decode:" in capsys.readouterr().out


@pytest.mark.parametrize("argv,want", [(["--no-reduced"], False), ([], True),
                                       (["--reduced"], True)])
def test_serve_cli_reduced_flag_switches_off(argv, want):
    """The reference's --reduced is store_true with default True and can
    never be turned off; the port's takes --no-reduced."""
    assert serve.build_parser().parse_args(argv).reduced is want
