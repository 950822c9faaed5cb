"""Serving the last three families through the port's engine, against the
reference's engine, on the reference's converted weights (fp32, token-by-
token prefill: the only mode these families have).

* Greedy streams of reduced ``llama-3.2-vision-90b`` and ``whisper-base``
  equal the reference engine's on ``arrayflex`` and ``arrayflex_int8``
  (W8), with the same dispatch counts; both engines cross-attend to the
  zero context their ``init_cache`` made (the reference's engine has no
  request field for image embeddings or audio frames).  W8A8 streams are
  identical run to run.
* Resilience (``tests/test_torch_resilience_parity.py``'s
  ``assert_parity``: streams, outcomes, counters, draw counters and the
  chaos log equal the reference's): a cross-attending sub-layer draws at
  each of its call sites (its self- and cross-attention both dispatch
  attn.qk and attn.pv), so a vlm trace draws 21 times and a whisper trace
  13; a GEMM fault at the vlm's ``xattn.wq`` and ``xattn.wo`` and at
  whisper's ``xattn.wo``; and on
  mixtral with its window cut to 8, a seeded fault at attn.pv after the
  ring wrapped, once the first attempt's fault has made every later
  attempt draw (the reference's jit retraces after a failed first trace).
"""
import pytest
import torch

from test_torch_resilience_parity import assert_parity
from test_torch_window import build, cfgs, serve_streams


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VLM, AUDIO = "llama-3.2-vision-90b", "whisper-base"
PROMPTS = [[5, 6, 7, 8], [11, 12, 13, 14, 15, 16], [21, 22]]
# decode draws a trace, sub-layer by sub-layer: reduced vlm (period 2)
# 8 + (6 + 4 + 2) + the unembed; whisper (every layer cross) 6 + 4 + 2 + 1
VLM_DRAWS, AUDIO_DRAWS = 21, 13


@pytest.fixture(scope="module")
def trees():
    return {arch: build(arch) for arch in (VLM, AUDIO)}


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_engine_streams_match_reference(trees, arch, backend):
    rc, tc = cfgs(arch, backend)
    rp, tp = trees[arch]
    want, ref = serve_streams("ref", rc, rp, PROMPTS)
    got, eng = serve_streams("port", tc, tp, PROMPTS)
    assert got == want
    assert eng.prefill_mode == "token"
    for key in ("prefill_dispatches", "decode_dispatches", "prefill_tokens",
                "decode_tokens"):
        assert eng.stats[key] == ref.stats[key], key
    # the cache counts the zero cross leaves
    assert eng.kv_cache_bytes() == sum(
        t.numel() * t.element_size() for c in eng.cache for t in c.values())
    assert any("xk" in c for c in eng.cache)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_w8a8_streams_identical_run_to_run(trees, arch):
    _, tc = cfgs(arch, "arrayflex_w8a8")
    a, _ = serve_streams("port", tc, trees[arch][1], PROMPTS)
    b, _ = serve_streams("port", tc, trees[arch][1], PROMPTS)
    assert a == b and all(len(s) == 6 for s in a)


def _models(arch, trees=None, **kw):
    rc, tc = cfgs(arch, "xla", **kw)
    rp, tp = trees[arch] if trees else build(arch, **kw)
    return (rc, rp), (tc, tp)


@pytest.mark.parametrize("arch,draws", [(VLM, VLM_DRAWS),
                                        (AUDIO, AUDIO_DRAWS)])
def test_cross_sublayers_draw_at_each_call_site(trees, arch, draws):
    got = assert_parity(*_models(arch, trees), prompts=PROMPTS[:2],
                        max_new=3, chaos=dict(seed=1), prefill_mode="token")
    assert got["chaos_draws"]["substrate.dispatch"] == draws


@pytest.mark.parametrize("arch,n,site", [(VLM, 14, "xattn.wq"),
                                         (VLM, 17, "xattn.wo"),
                                         (AUDIO, 9, "xattn.wo")])
def test_vlm_gemm_fault_at_cross_site_matches_reference(trees, arch, n,
                                                        site):
    got = assert_parity(*_models(arch, trees), prompts=PROMPTS[:2],
                        max_new=3, chaos=dict(gemm_fault_at=n),
                        prefill_mode="token")
    assert got["chaos_log"][0] == ("substrate.dispatch", n, site)
    assert got["stats"]["kernel_fault_retries"] == 1
    assert got["outcomes"] == ["ok"] * 2


def test_mixtral_fault_after_the_ring_wraps_matches_reference():
    """Seed 52: the first attempt faults at its first draw, so every later
    attempt draws, 11 a trace; draw 137 is attn.pv in step 12 (one step a
    prompt token), where the 11-token prompt's row is at position 9 or
    later, past its ring of 8."""
    got = assert_parity(*_models("mixtral-8x22b", sliding_window=8),
                        prompts=[[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
                                 [21, 22, 23]],
                        max_new=4, max_seq=32, prefill_mode="token",
                        chaos=dict(seed=52, gemm_fault_at=0,
                                   gemm_fault=0.02))
    assert got["chaos_log"] == [("substrate.dispatch", 0, "attn.wq"),
                                ("substrate.dispatch", 137, "attn.pv")]
    assert got["outcomes"] == ["ok"] * 2
    assert got["stats"]["kernel_fault_retries"] == 2
