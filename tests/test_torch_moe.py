"""The port's MoE family vs the reference: ``nn.moe`` routing and dispatch,
``substrate.expert_gemm`` with K2's int8-only form, the reduced
``qwen3-moe-30b-a3b`` model and its serving streams.

Inputs come from numpy with a fixed seed (model parameters: the
reference's ``init_params`` tree, converted leaf by leaf).  The
reference's Pallas kernels run in interpret mode on the CPU; the port's
wrappers run their plain versions on CPU tensors.  Tolerances:

* routing (top-k ids, capacity keeps and drops): equal — both packages
  take the same discrete decisions from router logits that agree to fp32
  rounding (no near-tie within it on these inputs).
* ``moe_apply`` outputs, fp32: 1e-5 relative to max |ref| — the same
  gathers and drops, fp32 sums in another order; aux to 1e-6.
* int8-only K2 plain version vs the reference's interpret run: 1e-5
  relative — exact products of int8 codes and fp32/bf16 x, fp32 sums in
  another order.
* expert codes and scales: bit for bit (elementwise IEEE ops and an
  exact max over the contraction axis).
* model logits (reduced model, fp32): 1e-4 absolute on xla, arrayflex and
  W8 (``tests/test_torch_model.py``'s fp32 contract); 2.5 absolute on
  W8A8, the reference's MoE W8A8 tolerance
  (``tests/test_w8a8_substrate.py``: router top-k flips amplify the
  quantization noise).
* greedy streams: identical to the reference engine's on ``arrayflex``
  and ``arrayflex_int8``; on W8A8, identical run to run (per-tile scales
  follow the tiling).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.kernels import ops as ref_ops
from repro.kernels import substrate as ref_sub
from repro.models import lm as ref_lm
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import arrayflex_gemm as ag
from repro_torch.kernels import ops, substrate
from repro_torch.launch import serve
from repro_torch.models import convert, lm
from repro_torch.nn import layers, moe
from repro_torch.serving import Request, ServeConfig, ServingEngine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ref_moe = importlib.import_module("repro.nn.moe")

ARCH = "qwen3-moe-30b-a3b"
RTOL = 1e-5
FP32_ATOL = 1e-4
W8A8_ATOL = 2.5
BACKENDS = ["xla", "arrayflex", "arrayflex_int8", "arrayflex_w8a8"]
ARRAYFLEX = ["arrayflex", "arrayflex_int8", "arrayflex_w8a8"]
PROMPTS = [[5, 6, 7], [11, 12, 13, 14], [21, 22]]


def _close_rel(got, want, rtol=RTOL):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _to_torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


# ------------------------------------------------------------ nn.moe

def _moe_params(d=64, ff=128, E=4, num_shared=0, seed=0):
    p = ref_moe.moe_init(jax.random.PRNGKey(seed), d, ff, E,
                         num_shared=num_shared, dtype=jnp.float32)
    return p, _to_torch(p)


def _x(B, S, d, seed=1):
    a = np.random.RandomState(seed).randn(B, S, d).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _routing_np(top_idx, E, cap):
    """An independent statement of the capacity rule: an assignment is
    kept when fewer than ``cap`` earlier assignments of its group (in
    (token, k) order) went to the same expert."""
    G, Tg, k = top_idx.shape
    flat = top_idx.reshape(G, Tg * k)
    keep = np.zeros_like(flat, dtype=bool)
    for g in range(G):
        seen = np.zeros(E, np.int64)
        for i, e in enumerate(flat[g]):
            keep[g, i] = seen[e] < cap
            seen[e] += 1
    return keep.reshape(G, Tg, k)


# (B, S, groups, top_k, capacity_factor, cap, must drop): decode's global
# group at cf 2.0; 2.5 -> 2 and 0.5 -> 0 -> 1 (Python's round half to
# even), fewer slots than assignments; per-sequence groups; ample capacity
ROUTING_CASES = [(4, 1, 1, 2, 2.0, 4, False), (1, 5, 1, 2, 1.0, 2, True),
                 (4, 1, 1, 2, 0.25, 1, True), (2, 8, 0, 2, 1.25, 5, False),
                 (3, 4, 1, 2, 8.0, 48, False)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ROUTING_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}g{c[2]}cf{c[4]}")
def test_moe_apply_matches_reference(case, backend):
    """The same top-k ids, keeps and drops (checked against the
    capacity rule), the same outputs and the same aux loss as the
    reference's ``moe_apply`` on the same backend."""
    B, S, groups, k, cf, cap, drops = case
    pj, pt = _moe_params()
    xj, xt = _x(B, S, 64, seed=B + S)
    want, want_aux = ref_moe.moe_apply(pj, xj, top_k=k, capacity_factor=cf,
                                       groups=groups,
                                       compute_dtype=jnp.float32,
                                       backend=backend)
    with moe.record_routing() as routing:
        got, aux = moe.moe_apply(pt, xt, top_k=k, capacity_factor=cf,
                                 groups=groups, compute_dtype=torch.float32,
                                 backend=backend)
    (top_idx, keep), = routing
    G = groups or B
    logits = np.asarray(xj, np.float32).reshape(G, -1, 64) @ \
        np.asarray(pj["router"])
    _, want_idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), k)
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(want_idx))
    want_keep = _routing_np(np.asarray(want_idx), 4, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert drops == (not want_keep.all())
    _close_rel(got, want)
    assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("backend", ["xla", "arrayflex", "arrayflex_int8"])
def test_moe_apply_ample_capacity_matches_oracle(backend):
    """With capacity for every assignment the dispatch path equals the
    every-expert-on-every-token oracle, in both packages (W8 on the
    dequantized banks)."""
    pj, pt = _moe_params()
    xj, xt = _x(2, 8, 64)
    if backend == "arrayflex_int8":
        for name in ("wi_gate", "wi_up", "wo"):
            q, s = substrate._quantize(pt[name])
            pt[name] = q.float() * s.unsqueeze(-2)
    got, _ = moe.moe_apply(pt, xt, top_k=2, capacity_factor=8.0,
                           compute_dtype=torch.float32, backend=backend)
    oracle = moe.moe_apply_reference(pt, xt, top_k=2)
    torch.testing.assert_close(got, oracle, rtol=0, atol=1e-5)
    _close_rel(moe.moe_apply_reference(_to_torch(pj), xt, top_k=2),
               ref_moe.moe_apply_reference(pj, xj, top_k=2))


def test_moe_shared_experts_match_reference():
    pj, pt = _moe_params(num_shared=1, seed=2)
    assert set(pt) == {"router", "wi_gate", "wi_up", "wo", "shared"}
    xj, xt = _x(1, 8, 64, seed=3)
    want, _ = ref_moe.moe_apply(pj, xj, top_k=2, compute_dtype=jnp.float32,
                                backend="arrayflex")
    got, _ = moe.moe_apply(pt, xt, top_k=2, compute_dtype=torch.float32,
                           backend="arrayflex")
    _close_rel(got, want)
    _close_rel(moe.moe_apply_reference(pt, xt, top_k=2),
               ref_moe.moe_apply_reference(pj, xj, top_k=2))


def test_top_k_breaks_ties_as_jax():
    """Equal probabilities go to the lower expert id first, as
    ``jax.lax.top_k`` orders them."""
    p = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]], np.float32)
    vals, idx = moe._top_k(torch.from_numpy(p), 4)
    wv, wi = jax.lax.top_k(jnp.asarray(p), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))


def test_moe_init_layout():
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, 16, 32, 4, num_shared=1, dtype=torch.bfloat16)
    ref = ref_moe.moe_init(jax.random.PRNGKey(0), 16, 32, 4, num_shared=1,
                           dtype=jnp.bfloat16)
    shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype.name),
                                    ref)
    got = {k: (jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), v)
        if isinstance(v, dict) else (tuple(v.shape),
                                     str(v.dtype).split(".")[1]))
        for k, v in p.items()}
    assert got == shapes
    assert p["router"].dtype == torch.float32


# ------------------------------------------------------------ K2 int8-only

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("etkn", [(3, 5, 300, 70), (2, 1, 640, 96),
                                  (4, 9, 130, 200), (5, 1, 100, 36),
                                  (3, 4, 70, 130)])
def test_expert_int8_plain_vs_reference_multistep(etkn, k, dtype):
    """K2's int8-only form (the MoE banks under W8): ragged K over several
    main-loop steps (K = 300, 640 at bk = 128), T = 1 as at decode, and
    ragged N, against the reference's interpret run; then the decode
    shapes the card's narrow tile takes (T = 1 and 4, K not a multiple of
    its 32-row sub-tiles, narrow N)."""
    E, T, K, N = etkn
    rng = np.random.RandomState(E * T + K + k)
    xj = jnp.asarray(rng.randn(E, T, K), getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    qj, sj = ref_sub._quantize(jnp.asarray(rng.randn(E, K, N) / np.sqrt(K),
                                           jnp.float32))
    want = ref_ops.arrayflex_expert_matmul(xj, qj, w_scale=sj, k_collapse=k,
                                           out_dtype=jnp.float32)
    got = ops.arrayflex_expert_matmul(
        xt, torch.from_numpy(np.array(qj)), w_scale=torch.from_numpy(
            np.array(sj)), k_collapse=k, out_dtype=torch.float32)
    _close_rel(got, want)


def test_expert_gemm_dispatch_and_custom_backend_unroll():
    """The builtin arrayflex backends run a site in one dispatch; a
    custom backend unrolls the expert axis (E dispatches against the
    shared plan) and computes the same product; a pre-quantized bank on a
    float backend raises."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 3, 4, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 16, 8).astype(np.float32))
    substrate.clear_plan_cache()
    want = substrate.expert_gemm(x, w, site="moe.wi_gate",
                                 backend="arrayflex_int8")
    assert substrate.DISPATCH_COUNTS == {"moe.wi_gate": 1}
    q, s = substrate._quantize(w)
    torch.testing.assert_close(
        want, torch.einsum("gecd,edf->gecf", x, q.float() * s[:, None]),
        rtol=0, atol=1e-5)
    substrate.register_backend("_q8", substrate._arrayflex_backend,
                               collapse=True, precision="int8",
                               quantize=True)
    try:
        got = substrate.expert_gemm(x, w, site="moe.wo", backend="_q8")
        assert substrate.DISPATCH_COUNTS["moe.wo"] == 3
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    finally:
        substrate._BACKENDS.pop("_q8")
        substrate._BACKEND_INFO.pop("_q8")
    with pytest.raises(ValueError, match="non-quantizing"):
        substrate.expert_gemm(x, substrate.prequantize(w), backend="xla")
    substrate.clear_plan_cache()
    substrate.clear_quant_cache()


# ------------------------------------------------------------ planning

SITE_SHAPES = {  # (M, N, T): output columns, contraction, rows
    "full.router": (128, 2048, 4),
    "full.wi_gate": (768, 2048, 1),
    "full.wo": (2048, 768, 1),
    "reduced.router": (4, 64, 2),
    "reduced.wi_gate": (128, 64, 4),
    "reduced.wo": (64, 128, 4),
}


@pytest.mark.parametrize("backend", ARRAYFLEX)
@pytest.mark.parametrize("site", sorted(SITE_SHAPES))
def test_moe_site_plans_match_reference(site, backend):
    """The moe.* sites plan the same k, precision, cycles and predictions
    in both packages, at the full-width decode shapes (cap = 1 row per
    expert) and the reduced ones; the router plans on the fp32 base
    under a quantizing backend, as the dispatch executes it."""
    M, N, T = SITE_SHAPES[site]
    be = "arrayflex" if site.endswith("router") else backend
    got = substrate.plan_gemm(M, N, T, be)
    want = ref_sub.plan_gemm(M, N, T, be)
    assert (got.k, got.precision, got.cycles) == \
        (want.k, want.precision, want.cycles)
    assert got.t_pred_ps == pytest.approx(want.t_pred_ps)


# ------------------------------------------------------------ model

def _cfgs(backend):
    rc = dataclasses.replace(ref_reduced(ARCHS[ARCH]),
                             gemm_backend=backend, compute_dtype="float32")
    tc = dataclasses.replace(reduced(get_config(ARCH)),
                             gemm_backend=backend, compute_dtype="float32")
    return rc, tc


@pytest.fixture(scope="module")
def params():
    rc, tc = _cfgs("xla")
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
    tp = convert.params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    return rp, tp


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_converted_tree_and_init_layout(params):
    """The converted reference tree holds every leaf; the port's own init
    builds the same layout, router fp32 under bf16 parameters."""
    rp, tp = params
    want = {p: tuple(v.shape) for p, v in _leaves(rp)}
    got = {p: tuple(v.shape) for p, v in _leaves(tp)}
    assert got == want
    np.testing.assert_array_equal(
        tp["blocks"][0]["moe"]["wo"].numpy(),
        np.asarray(rp["blocks"][0]["moe"]["wo"]))
    _, tc = _cfgs("xla")
    own = lm.init_params(dataclasses.replace(tc, param_dtype="bfloat16"),
                         seed=0, device="cpu")
    assert {p: tuple(v.shape) for p, v in _leaves(own)} == want
    blk = own["blocks"][0]
    assert blk["moe"]["router"].dtype == torch.float32
    assert blk["moe"]["wi_gate"].dtype == torch.bfloat16


def test_init_params_fills_stacked_leaves_layer_by_layer():
    """Allocating each stacked leaf once and filling it layer by layer
    draws the same numbers as stacking per-layer trees."""
    _, tc = _cfgs("xla")
    tc = dataclasses.replace(tc, n_layers=3, param_dtype="bfloat16")
    got = lm.init_params(tc, seed=7, device="cpu")
    gen = torch.Generator().manual_seed(7)
    gen_tree = layers.embedding_init(gen, tc.padded_vocab, tc.d_model,
                                        torch.bfloat16, "cpu")
    layers_ = [lm.sublayer_init(gen, tc, 0, "cpu") for _ in range(3)]
    torch.testing.assert_close(got["embed"]["table"], gen_tree["table"],
                               rtol=0, atol=0)
    for path, leaf in _leaves(got["blocks"][0]):
        keys = path.strip("/").split("/")
        for l, tree in enumerate(layers_):
            for k in keys:
                tree = tree[k]
            assert torch.equal(leaf[l], tree), (path, l)


def test_prepare_params_casts_banks_once(params):
    _, tc = _cfgs("arrayflex")
    tc = dataclasses.replace(tc, compute_dtype="bfloat16")
    served = lm.prepare_params(tc, params[1])
    m = served["blocks"][0]["moe"]
    assert m["wi_gate"].dtype == m["wo"].dtype == torch.bfloat16
    assert m["router"].dtype == torch.float32
    assert served["blocks"][0]["attn"]["wq"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_bank_codes_bit_equal_to_reference(dtype, params):
    """Every quantized leaf of the reduced MoE tree — the expert banks
    among them, the router left float — holds the reference's codes and
    scales; a stacked 4-D bank quantized one layer at a time equals the
    whole bank quantized at once."""
    rc, tc = _cfgs("arrayflex_int8")
    rc = dataclasses.replace(rc, compute_dtype=dtype)
    tc = dataclasses.replace(tc, compute_dtype=dtype)
    rp, tp = params
    want = dict(_leaves(ref_lm.prequantize_params(rc, rp)))
    got = lm.prequantize_params(tc, tp)
    n_banks = 0
    for path, leaf in _leaves(got):
        if path.endswith("router"):
            assert torch.is_tensor(leaf) and leaf.dtype == torch.float32
        if not isinstance(leaf, substrate.QuantizedTensor):
            continue
        np.testing.assert_array_equal(leaf.codes.numpy(),
                                      np.asarray(want[path].codes))
        np.testing.assert_array_equal(leaf.scale.numpy(),
                                      np.asarray(want[path].scale))
        if "/moe/" in path:
            n_banks += 1
            assert leaf.codes.ndim == 4 and leaf.scale.ndim == 3
    assert n_banks == 3
    bank = tp["blocks"][0]["moe"]["wi_up"].to(getattr(torch, dtype))
    whole = substrate._quantize(bank)
    sliced = substrate.prequantize(bank)
    assert torch.equal(sliced.codes, whole[0])
    assert torch.equal(sliced.scale, whole[1])


def _decode_both(backend, params, steps=3):
    """``steps`` decode steps in both packages from the same tokens (the
    reference's argmax feeds the next step), on the backend's served
    trees; yields (port logits, reference logits), then the plans."""
    rc, tc = _cfgs(backend)
    rp, tp = params
    rq = ref_lm.prequantize_params(rc, rp)
    tq = lm.prequantize_params(tc, lm.prepare_params(tc, tp))
    B, S = 2, 16
    rcache = ref_lm.init_cache(rc, B, S)
    tcache = lm.init_cache(tc, B, S, device="cpu")
    ref_sub.clear_plan_cache()
    substrate.clear_plan_cache()
    toks = [3, 5]
    out = []
    for step in range(steps):
        pos = [step, step + 2]           # ragged per-row positions
        rl, rcache = ref_lm.decode_step(rc, rq, rcache,
                                        jnp.asarray(toks, jnp.int32),
                                        jnp.asarray(pos, jnp.int32))
        tl, tcache = lm.decode_step(tc, tq, tcache, torch.tensor(toks),
                                    torch.tensor(pos))
        out.append((tl.float().numpy(), np.asarray(rl)))
        toks = [int(t) for t in np.argmax(np.asarray(rl), -1)]
    plans = dict(substrate.SITE_PLANS), dict(ref_sub.SITE_PLANS)
    substrate.clear_plan_cache()
    ref_sub.clear_plan_cache()
    return out, plans


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_logits_and_plans_match_reference(backend, params):
    out, (plans, ref_plans) = _decode_both(backend, params)
    atol = W8A8_ATOL if backend == "arrayflex_w8a8" else FP32_ATOL
    for got, want in out:
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert set(plans) == set(ref_plans) >= {
        "moe.router", "moe.wi_gate", "moe.wi_up", "moe.wo"}
    for site, plan in plans.items():
        ref = ref_plans[site]
        assert (plan.M, plan.N, plan.T, plan.k, plan.precision) == \
            (ref.M, ref.N, ref.T, ref.k, ref.precision), site
    if backend in ARRAYFLEX:
        assert plans["moe.router"].precision == "fp32"
        assert plans["moe.wi_gate"].precision == \
            {"arrayflex": "fp32", "arrayflex_int8": "int8",
             "arrayflex_w8a8": "w8a8"}[backend]


def test_moe_prefill_is_token_by_token(params):
    _, tc = _cfgs("arrayflex")
    assert not lm.supports_batched_prefill(tc)
    with pytest.raises(ValueError, match="batched prefill"):
        ServingEngine(tc, params[1], ServeConfig(prefill_mode="batched"),
                      device="cpu")


def _run_port(tc, tp):
    eng = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_seq=32),
                        device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=4, rid=i)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done and len(r.out_tokens) == 4 for r in reqs)
    return [r.out_tokens for r in reqs], eng


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8"])
def test_greedy_streams_match_reference_engine(backend, params):
    """Token-mode prefill in both engines (the other slots' placeholder
    rows compete for capacity in the one global decode group on both
    sides): identical greedy streams, the same dispatch structure."""
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
    assert eng.prefill_mode == "token"
    for key in ("prefill_dispatches", "decode_dispatches", "prefill_tokens",
                "decode_tokens"):
        assert eng.stats[key] == ref.stats[key], key
    steps = eng.stats["prefill_dispatches"] + eng.stats["decode_dispatches"]
    assert set(substrate.DISPATCH_COUNTS) == set(ref_counts)
    for site, n in substrate.DISPATCH_COUNTS.items():
        assert n == steps * (1 if site == "unembed" else tc.n_layers), site
    substrate.clear_plan_cache()
    ref_sub.clear_plan_cache()


def test_w8a8_streams_identical_run_to_run(params):
    _, tc = _cfgs("arrayflex_w8a8")
    a, eng = _run_port(tc, params[1])
    b, _ = _run_port(tc, params[1])
    assert a == b
    bank = eng.params["blocks"][0]["moe"]["wi_gate"]
    assert isinstance(bank, substrate.QuantizedTensor)
    substrate.clear_plan_cache()


@pytest.mark.parametrize("backend", ["arrayflex", "arrayflex_int8"])
def test_serve_cli_moe_on_cpu(backend, capsys):
    reqs = serve.main(["--device", "cpu", "--arch", ARCH, "--requests", "2",
                       "--max-new", "3", "--gemm-backend", backend])
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)
    assert "prefill[token]" in capsys.readouterr().out


def test_expert_int8_form_counts_its_own_launches():
    """The plain version launches nothing; the int8-only form has its own
    counter beside the other five."""
    before = dict(ag.LAUNCHES)
    q = torch.ones(2, 8, 4, dtype=torch.int8)
    ag.arrayflex_expert_gemm(torch.ones(2, 3, 8), q, w_scale=torch.ones(2, 4))
    assert ag.LAUNCHES == before
    assert "arrayflex_expert_gemm_int8" in ag.LAUNCHES
