"""Cross-attention in the port against the reference ``repro.models.lm``:
reduced ``llama-3.2-vision-90b`` (vlm: ``frontend.img`` over image
embeddings, every second layer cross-attends) and ``whisper-base``
(audio: the encoder over frame embeddings, every decoder layer
cross-attends), the reference's tree converted leaf by leaf, fp32.

* ``forward`` logits within 1e-4, its cache (the self K/V, and the
  context's ``xk`` / ``xv``) within 1e-4 or one bf16 step of each value.
* Decode: both packages start from the same cache (zeros, ``xk`` / ``xv``
  taken from ``prefill``'s) and are fed the same tokens (teacher forced);
  their logits agree within 1e-4 every step, and decode never writes the
  cross leaves.
* ``encode_audio`` against the reference's ``_encode_audio``.
* ``nn.layers.layernorm`` and ``gelu_mlp`` (on no model path in either
  package) against the reference's, on ``xla`` and ``arrayflex``.
* The quantized trees of the three new families (mixtral's MoE banks,
  the vlm's ``img_proj`` and ``xattn.*``, whisper's ``audio_proj`` and
  encoder): every leaf the reference quantizes, and only those, with its
  codes and scales bit for bit.
* ``init_params`` / ``init_cache`` lay out the reference's trees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import substrate as ref_sub
from repro.models import lm as ref_lm
from repro.nn import layers as ref_layers
from repro_torch.kernels import substrate
from repro_torch.models import lm
from repro_torch.nn import layers
from test_torch_quant import _leaves
from test_torch_ssm_model import assert_cache, assert_logits, tree_shapes
from test_torch_window import build, cfgs, ref_decode, served


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FP32_ATOL = 1e-4
VLM, AUDIO = "llama-3.2-vision-90b", "whisper-base"
N_FRAMES = 24           # encoder frames in the forward checks


@pytest.fixture(scope="module")
def trees():
    return {arch: build(arch) for arch in (VLM, AUDIO)}


def batch(cfg, B, S, seed=0):
    """Seeded tokens and the family's context input, as numpy."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size, (B, S))}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
    else:
        out["frames"] = rng.standard_normal(
            (B, N_FRAMES, cfg.d_frontend)).astype(np.float32)
    return out


def both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.tensor(v) for k, v in b.items()})


@pytest.mark.parametrize("backend", ["xla", "arrayflex", "arrayflex_int8"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_forward_and_cross_cache_match_reference(trees, arch, backend):
    rc, rq, tc, tq = served(arch, backend, trees[arch])
    rb, tb = both(batch(tc, 2, 7))
    rl, _, rcache = ref_lm.forward(rc, rq, rb, return_cache=True)
    tl, _, tcache = lm.forward(tc, tq, tb, return_cache=True)
    assert_logits(tl, rl, FP32_ATOL)
    assert_cache(tcache, rcache, FP32_ATOL)
    assert any("xk" in c for c in tcache)
    tlast, tcache = lm.prefill(tc, tq, tb)
    assert_logits(tlast, rl[:, -1], FP32_ATOL)
    assert_cache(tcache, rcache, FP32_ATOL)


@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_decode_from_the_prefill_context(trees, arch, backend):
    """Teacher-forced decode from a zero cache holding ``prefill``'s
    ``xk`` / ``xv`` (the reference's, in both packages)."""
    rc, rq, tc, tq = served(arch, backend, trees[arch])
    B, S = 2, 16
    b = batch(tc, B, 6, seed=1)
    _, pcache = ref_lm.prefill(rc, rq, both(b)[0])
    rcache = ref_lm.init_cache(rc, B, S, dtype=jnp.float32)
    tcache = lm.init_cache(tc, B, S, dtype=torch.float32, device="cpu",
                           n_cross=pcache[-1]["xk"].shape[2])
    rcache = tuple(dict(c, xk=p["xk"].astype(jnp.float32),
                        xv=p["xv"].astype(jnp.float32)) if "xk" in p else c
                   for c, p in zip(rcache, pcache))
    for c, p in zip(tcache, pcache):
        if "xk" in p:
            c["xk"].copy_(torch.tensor(np.asarray(p["xk"], np.float32)))
            c["xv"].copy_(torch.tensor(np.asarray(p["xv"], np.float32)))
    cross = [(c["xk"].clone(), c["xv"].clone()) for c in tcache if "xk" in c]
    for step in range(6):
        toks = b["tokens"][:, step]
        pos = [step, step]
        rl, rcache = ref_decode(rc)(rq, rcache, jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(pos, jnp.int32))
        tl, tcache = lm.decode_step(tc, tq, tcache, torch.tensor(toks),
                                    torch.tensor(pos))
        assert_logits(tl, rl, FP32_ATOL)
    assert_cache(tcache, rcache, FP32_ATOL)
    for (xk, xv), c in zip(cross, [c for c in tcache if "xk" in c]):
        assert torch.equal(xk, c["xk"]) and torch.equal(xv, c["xv"])


@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
def test_encode_audio_matches_reference(trees, backend):
    rc, rq, tc, tq = served(AUDIO, backend, trees[AUDIO])
    frames = batch(tc, 2, 1, seed=2)["frames"]
    want = ref_lm._encode_audio(rc, rq, jnp.asarray(frames))
    got = lm.encode_audio(tc, tq, torch.tensor(frames))
    assert got.shape == (2, N_FRAMES, tc.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
def test_layernorm_and_gelu_mlp_match_reference(backend):
    rng = np.random.RandomState(3)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = ref_layers.layernorm({"scale": jnp.asarray(scale),
                                 "bias": jnp.asarray(bias)}, jnp.asarray(x))
    got = layers.layernorm({"scale": torch.tensor(scale),
                            "bias": torch.tensor(bias)}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    init = layers.layernorm_init(64, device="cpu")
    assert torch.equal(init["scale"], torch.ones(64))
    assert torch.equal(init["bias"], torch.zeros(64))

    rp = ref_layers.gelu_mlp_init(jax.random.PRNGKey(1), 64, 96)
    rp = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(2),
                                               a.shape), rp)   # bias != 0
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), rp)
    gen = torch.Generator().manual_seed(0)
    shapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        layers.gelu_mlp_init(gen, 64, 96, device="cpu"))
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), rp)
    res = rng.standard_normal((3, 5, 64)).astype(np.float32)
    want = ref_layers.gelu_mlp(rp, jnp.asarray(x), jnp.float32,
                               backend=backend, residual=jnp.asarray(res))
    got = layers.gelu_mlp(tp, torch.tensor(x), torch.float32,
                          backend=backend, residual=torch.tensor(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    plan, ref_plan = substrate.SITE_PLANS["mlp.wi"], \
        ref_sub.SITE_PLANS["mlp.wi"]
    assert (plan.k, plan.epilogue.kind) == (ref_plan.k, "gelu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", VLM, AUDIO])
def test_quantized_trees_equal_the_reference(trees, arch, dtype):
    rp, tp = trees[arch] if arch in trees else build(arch)
    rc, tc = cfgs(arch, "arrayflex_int8", compute_dtype=dtype)
    want = dict(_leaves(ref_lm.prequantize_params(rc, rp)))
    got = dict(_leaves(lm.prequantize_params(tc, tp)))
    assert set(got) == set(want)
    quantized = {p for p, leaf in got.items()
                 if isinstance(leaf, substrate.QuantizedTensor)}
    assert quantized == {p for p, leaf in want.items()
                         if hasattr(leaf, "codes")}
    for path in quantized:
        np.testing.assert_array_equal(got[path].codes.numpy(),
                                      np.asarray(want[path].codes))
        np.testing.assert_array_equal(got[path].scale.numpy(),
                                      np.asarray(want[path].scale))
    expect = {"mixtral-8x22b": "/blocks/0/moe/wi_gate",
              VLM: "/img_proj/w", AUDIO: "/enc_blocks/0/mlp/wo/w"}[arch]
    assert expect in quantized
    if arch == VLM:
        assert "/blocks/1/xattn/wk/w" in quantized


@pytest.mark.parametrize("arch", ["mixtral-8x22b", VLM, AUDIO])
def test_layout_equals_the_reference(arch):
    rc, tc = cfgs(arch)
    rp = jax.eval_shape(lambda: ref_lm.init_params(rc, jax.random.PRNGKey(0)))
    tp = lm.init_params(tc, seed=0, device="cpu")
    assert tree_shapes(tp) == tree_shapes(rp)
    for S in (4, 64):
        want = ref_lm.init_cache(rc, 2, S)
        got = lm.init_cache(tc, 2, S, device="cpu")
        assert tree_shapes(got) == tree_shapes(want)
