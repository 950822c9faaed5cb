"""The sliding window in the port against the reference ``repro.models.lm``.

* ``nn.attention.decode_attention`` with and without ``window``, rows
  before and after the ring fills, on ``xla`` and ``arrayflex``.
* Reduced ``qwen2-0.5b`` with ``sliding_window=8`` (the reference's tree,
  converted leaf by leaf), fp32 K/V cache of 8 rows: 24 decode steps at
  ragged positions, through two wraps of the ring; the logits every step
  and the ring's contents after the last, within 1e-4.
* ``forward`` / ``prefill`` at S in {5, 8, 21}: the logits, and the cache
  (the last ``cache_len`` rows, rolled by S % cache_len), equal to the
  reference's within 1e-4 (bf16 rows: one bf16 step).
* Reduced ``mixtral-8x22b`` with its window cut to 8: decode steps and
  the serving engine's greedy streams (token-by-token prefill, ring
  wraps within the prompt) equal to the reference's on ``arrayflex`` (fp32)
  and ``arrayflex_int8`` (W8); W8A8 streams identical run to run.
  Decode against ``forward`` is no check on an MoE model: capacity
  routing depends on how many tokens share a dispatch.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.nn import attention as ref_attn
from repro.models import lm as ref_lm
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.configs import get_config, reduced
from repro_torch.models import convert, lm
from repro_torch.nn import attention
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving.engine import Request
from test_torch_ssm_model import assert_cache, assert_logits


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FP32_ATOL = 1e-4
WINDOW = 8


def cfgs(arch, backend="xla", **kw):
    kw = dict(kw, gemm_backend=backend, compute_dtype="float32")
    return (dataclasses.replace(ref_reduced(ARCHS[arch]), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def build(arch, **kw):
    rc, tc = cfgs(arch, **kw)
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
    tp = convert.params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return rp, tp


def served(arch, backend, trees, **kw):
    rc, tc = cfgs(arch, backend, **kw)
    rp, tp = trees
    return (rc, ref_lm.prequantize_params(rc, rp), tc,
            lm.prequantize_params(tc, lm.prepare_params(tc, tp)))


@functools.lru_cache(maxsize=None)
def ref_decode(rc):
    return jax.jit(functools.partial(ref_lm.decode_step, rc))


@pytest.fixture(scope="module")
def qwen():
    return build("qwen2-0.5b", sliding_window=WINDOW)


@pytest.fixture(scope="module")
def mixtral():
    return build("mixtral-8x22b", sliding_window=WINDOW)


@pytest.mark.parametrize("window", [0, WINDOW])
@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
def test_decode_attention_matches_reference(window, backend):
    """Rows at pos 2 and 6 (the ring filling), 7 (just full) and 13 (full
    and wrapped)."""
    rng = np.random.default_rng(0)
    B, T, H, KV, D = 4, WINDOW, 4, 2, 16
    q = rng.standard_normal((B, 1, H, D), np.float32)
    k = rng.standard_normal((B, T, KV, D), np.float32)
    v = rng.standard_normal((B, T, KV, D), np.float32)
    pos = np.array([2, 6, 7, 13])
    want = ref_attn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pos, jnp.int32), window=window, backend=backend)
    got = attention.decode_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(pos), window=window, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
def test_ring_decode_through_two_wraps(qwen, backend):
    rc, rq, tc, tq = served("qwen2-0.5b", backend, qwen,
                            sliding_window=WINDOW)
    B, S = 2, 64
    rcache = ref_lm.init_cache(rc, B, S, dtype=jnp.float32)
    tcache = lm.init_cache(tc, B, S, dtype=torch.float32, device="cpu")
    assert tcache[0]["k"].shape[2] == lm.cache_len(tc, S) == WINDOW
    toks = [3, 5]
    for step in range(3 * WINDOW):
        pos = [step, step + 3]
        rl, rcache = ref_decode(rc)(rq, rcache, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(pos, jnp.int32))
        tl, tcache = lm.decode_step(tc, tq, tcache, torch.tensor(toks),
                                    torch.tensor(pos))
        assert_logits(tl, rl, FP32_ATOL)
        toks = [int(t) for t in np.argmax(np.asarray(rl), -1)]
    assert_cache(tcache, rcache, FP32_ATOL)


@pytest.mark.parametrize("S", [5, 8, 21])
def test_forward_and_prefill_roll_the_cache(qwen, S):
    rc, rq, tc, tq = served("qwen2-0.5b", "arrayflex", qwen,
                            sliding_window=WINDOW)
    toks = np.random.RandomState(S).randint(0, tc.vocab_size, (2, S))
    rl, _, rcache = ref_lm.forward(rc, rq, {"tokens": jnp.asarray(toks)},
                                   return_cache=True)
    tl, _, tcache = lm.forward(tc, tq, {"tokens": torch.tensor(toks)},
                               return_cache=True)
    assert_logits(tl, rl, FP32_ATOL)
    assert_cache(tcache, rcache, FP32_ATOL)
    assert tcache[0]["k"].shape[2] == min(S, WINDOW)
    tlast, tcache = lm.prefill(tc, tq, {"tokens": torch.tensor(toks)})
    assert_logits(tlast, rl[:, -1], FP32_ATOL)
    assert_cache(tcache, rcache, FP32_ATOL)


def test_prefill_cache_continues_into_decode(qwen):
    """The ring ``prefill`` returns (S = 21: rolled by 5) feeds decode in
    both packages alike: three steps from position 21 on."""
    rc, rq, tc, tq = served("qwen2-0.5b", "xla", qwen, sliding_window=WINDOW)
    toks = np.random.RandomState(1).randint(0, tc.vocab_size, (2, 21))
    rl, rcache = ref_lm.prefill(rc, rq, {"tokens": jnp.asarray(toks)})
    tl, tcache = lm.prefill(tc, tq, {"tokens": torch.tensor(toks)})
    nxt = [int(t) for t in np.argmax(np.asarray(rl), -1)]
    for pos in range(21, 24):
        rl, rcache = ref_decode(rc)(rq, rcache, jnp.asarray(nxt, jnp.int32),
                                    jnp.asarray(pos, jnp.int32))
        tl, tcache = lm.decode_step(tc, tq, tcache, torch.tensor(nxt),
                                    torch.tensor([pos, pos]))
        assert_logits(tl, rl, FP32_ATOL)
        nxt = [int(t) for t in np.argmax(np.asarray(rl), -1)]
    assert_cache(tcache, rcache, FP32_ATOL)


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8"])
def test_mixtral_ring_decode_matches_reference(mixtral, backend):
    rc, rq, tc, tq = served("mixtral-8x22b", backend, mixtral,
                            sliding_window=WINDOW)
    B, S = 2, 32
    rcache = ref_lm.init_cache(rc, B, S, dtype=jnp.float32)
    tcache = lm.init_cache(tc, B, S, dtype=torch.float32, device="cpu")
    toks = [7, 9]
    for step in range(2 * WINDOW + 2):
        pos = [step, step + 1]
        rl, rcache = ref_decode(rc)(rq, rcache, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(pos, jnp.int32))
        tl, tcache = lm.decode_step(tc, tq, tcache, torch.tensor(toks),
                                    torch.tensor(pos))
        assert_logits(tl, rl, FP32_ATOL)
        toks = [int(t) for t in np.argmax(np.asarray(rl), -1)]
    assert_cache(tcache, rcache, FP32_ATOL)


# prompts past the window: each ring wraps within its own prompt
MIXTRAL_PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15], [21, 22, 23],
                   [31, 32, 33, 34, 35, 36, 37, 38, 39]]


def serve_streams(pkg, cfg, params, prompts, max_new=6):
    engine, sc, req = ((RefEngine, RefServeConfig, RefRequest) if pkg == "ref"
                       else (ServingEngine, ServeConfig, Request))
    kw = {} if pkg == "ref" else {"device": "cpu"}
    eng = engine(cfg, params, sc(max_batch=2, max_seq=32), **kw)
    reqs = [req(prompt=list(p), max_new_tokens=max_new, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.outcome == "ok" for r in reqs)
    return [list(r.out_tokens) for r in reqs], eng


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8"])
def test_mixtral_engine_streams_match_reference(mixtral, backend):
    rc, tc = cfgs("mixtral-8x22b", backend, sliding_window=WINDOW)
    rp, tp = mixtral
    want, ref = serve_streams("ref", rc, rp, MIXTRAL_PROMPTS)
    got, eng = serve_streams("port", tc, tp, MIXTRAL_PROMPTS)
    assert got == want
    assert eng.prefill_mode == "token"
    assert eng.cache[0]["k"].shape[2] == WINDOW
    for key in ("prefill_dispatches", "decode_dispatches", "prefill_tokens",
                "decode_tokens"):
        assert eng.stats[key] == ref.stats[key], key


def test_mixtral_w8a8_streams_identical_run_to_run(mixtral):
    _, tc = cfgs("mixtral-8x22b", "arrayflex_w8a8", sliding_window=WINDOW)
    a, _ = serve_streams("port", tc, mixtral[1], MIXTRAL_PROMPTS)
    b, _ = serve_streams("port", tc, mixtral[1], MIXTRAL_PROMPTS)
    assert a == b and all(len(s) == 6 for s in a)
