"""The port's paged K/V serving path vs the reference's.

The page pool and the radix prefix cache are held to the reference's on
the same seeded operation sequences; ``gather_pages`` / ``scatter_pages``
to the reference's on the same numpy inputs; ``decode_step_paged`` and
``prefill_step_paged`` to the reference's on the same tokens, pools and
block tables (reduced qwen2-0.5b, fp32 compute, the reference's converted
parameters): logits within the fp32 step tolerance of
``tests/test_torch_model.py`` (1e-4 absolute), the pools equal to the
reference's within the same tolerance in fp32 and within one rounding
step in bf16 (2^-7 relative: the two packages' fp32 K/V differ in their
last bits, so a value may round to the neighbouring bf16 one), and the
paged logits and pools equal the port's own dense step's bit for bit.  The
paged engine's greedy streams must equal the port's dense streams and the
reference's paged engine streams, and the prefix cache's counters the
reference's.  The reference traces each jit'd step once, so its
``prefill_gemm_dispatches`` is a per-trace count and is not compared
(``tests/test_torch_serving.py``); the port counts every dispatch.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced as ref_reduced
from repro.models import lm as ref_lm
from repro.nn import attention as ref_attn
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving import paged as ref_paged
from repro.serving.engine import Request as RefRequest
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import convert, lm
from repro_torch.nn import attention as attn
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving import paged


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FP32_ATOL = 1e-4
# the reference's tests/test_serving_prefill.py prompts: several chunks,
# a one-token prompt (no prefill at all), ragged lengths
PROMPTS = [[5, 6, 7], [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21], [21],
           [31, 32, 33, 34, 35], [41, 42, 43, 44, 45, 46, 47, 48]]
GEOMETRIES = [(16, False), (16, True), (8, True), (0, False)]


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


# ------------------------------------------------------------ pool, radix

@pytest.mark.parametrize("seed", range(4))
def test_page_pool_matches_reference(seed):
    """Seeded alloc / incref / decref traffic: the same pages handed out,
    the same refcounts and free lists after every operation."""
    rng = random.Random(seed)
    n = rng.randrange(2, 16)
    pools = paged.PagePool(n, 4), ref_paged.PagePool(n, 4)
    held = []
    for _ in range(200):
        op = rng.randrange(3)
        if op == 0:
            k = rng.randrange(0, n)
            got, want = (p.alloc(k) for p in pools)
            assert got == want
            held += got or []
        elif held:
            pg = rng.choice(held)
            for p in pools:
                (p.incref if op == 1 else p.decref)(pg)
            if op == 1:
                held.append(pg)
            else:
                held.remove(pg)
        a, b = pools
        assert (a.free_pages, a.refcounts, a.n_free, a.n_used) == \
            (b.free_pages, b.refcounts, b.n_free, b.n_used)
    for p in pools:
        with pytest.raises(ValueError, match="scratch"):
            p.incref(paged.PagePool.SCRATCH)
    with pytest.raises(ValueError):
        paged.PagePool(1, 4)


def _tree(node):
    """A radix node's structure, pages and LRU clocks, recursively."""
    return (tuple(node.keys), tuple(node.pages), node.last_used,
            {k: _tree(c) for k, c in node.children.items()})


@pytest.mark.parametrize("seed,page", [(0, 1), (1, 2), (2, 3), (3, 2)])
def test_radix_cache_matches_reference(seed, page):
    """Seeded match / publish / release / evict traffic over a 3-token
    vocabulary (so prefixes collide, nodes split and leaves age): the same
    pages matched, published and evicted, the same trie (keys, pages, LRU
    clocks) and pool state after every operation."""
    rng = random.Random(seed)
    pools = paged.PagePool(64, page), ref_paged.PagePool(64, page)
    trees = paged.RadixCache(page), ref_paged.RadixCache(page)
    owned = []                               # page lists "sequences" hold
    for _ in range(150):
        op = rng.randrange(4)
        toks = [rng.randrange(3) for _ in range(rng.randrange(4 * page + 1))]
        if op == 0:
            got, want = (t.match(toks) for t in trees)
            assert got == want
        elif op == 1:                        # a sequence publishes
            shared, want = (t.match(toks) for t in trees)
            assert shared == want
            fresh = [p.alloc(len(toks) // page - len(shared))
                     for p in pools]
            assert fresh[0] == fresh[1]
            if fresh[0] is None:
                continue
            pages = shared + fresh[0]
            for p in pools:
                for pg in shared:
                    p.incref(pg)
            got, want = (t.insert(toks, pages, p)
                         for t, p in zip(trees, pools))
            assert got == want
            owned.append(pages)
        elif op == 2 and owned:              # a sequence releases
            for pg in owned.pop(rng.randrange(len(owned))):
                for p in pools:
                    p.decref(pg)
        elif op == 3:
            n = rng.randrange(1, 4)
            got, want = (t.evict(n, p) for t, p in zip(trees, pools))
            assert got == want
        a, b = trees
        assert _tree(a.root) == _tree(b.root)
        assert (a.n_nodes(), a.n_pages(), a._clock) == \
            (b.n_nodes(), b.n_pages(), b._clock)
        assert pools[0].refcounts == pools[1].refcounts
        assert pools[0].free_pages == pools[1].free_pages


def test_gather_scatter_pages_match_reference():
    """Rows aliasing pages (a shared prefix page, the scratch page); the
    scattered views change only uniquely owned pages, as the engine's do."""
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    bt = np.array([[1, 2, 0], [1, 3, 4], [0, 0, 0]])
    want = np.asarray(ref_attn.gather_pages(jnp.asarray(pool),
                                            jnp.asarray(bt, jnp.int32)))
    got = attn.gather_pages(torch.from_numpy(pool), torch.from_numpy(bt))
    assert got.shape == (3, 12, 2, 8)
    assert np.array_equal(got.numpy(), want)
    view = want.copy()
    view[0, 4:8] += 1.0                      # page 2, row 0's own
    view[1, 4:12] -= 2.0                     # pages 3 and 4, row 1's own
    ref_pool = np.asarray(ref_attn.scatter_pages(
        jnp.asarray(pool), jnp.asarray(bt, jnp.int32), jnp.asarray(view)))
    port_pool = torch.from_numpy(pool.copy())
    out = attn.scatter_pages(port_pool, torch.from_numpy(bt),
                             torch.from_numpy(view))
    assert out is port_pool                  # in place
    assert np.array_equal(port_pool.numpy(), ref_pool)


# ------------------------------------------------------------------ steps

N_PAGES, PAGE, N_PG = 10, 4, 4                # views of L = 16 positions
# rows 0 and 1 share the prefix pages 1 and 2 (positions 0-7)
BT = [[1, 2, 3, 0], [1, 2, 4, 5], [6, 7, 0, 0]]
IDLE_BT = [[1, 2, 3, 0], [1, 2, 4, 5], [0, 0, 0, 0]]


POOL_DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16, 0.0, 2.0 ** -7),
               "float32": (jnp.float32, torch.float32, FP32_ATOL, 0.0)}


def _pools(tc, dtype, seed=1):
    rng = np.random.default_rng(seed)
    shape = (lm.n_super(tc), N_PAGES, PAGE, tc.n_kv_heads,
             tc.resolved_head_dim)
    k, v = (0.5 * rng.standard_normal(shape).astype(np.float32)
            for _ in range(2))
    k[:, 0] = v[:, 0] = 0.0                  # the scratch page
    jdt, tdt = POOL_DTYPES[dtype][:2]
    ref = ({"kp": jnp.asarray(k, jdt), "vp": jnp.asarray(v, jdt)},)
    port = ({"kp": torch.from_numpy(k).to(tdt),
             "vp": torch.from_numpy(v).to(tdt)},)
    return ref, port


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _dense_from(port_cache, bt):
    """The dense cache (n_super, B, L, KV, hd) of each row's view."""
    return tuple({"k": torch.stack([attn.gather_pages(kp, bt)
                                    for kp in c["kp"]]),
                  "v": torch.stack([attn.gather_pages(vp, bt)
                                    for vp in c["vp"]])}
                 for c in port_cache)


def _check_step(rl, tl, r_cache, t_cache, dense_logits, dense_cache, bt,
                rows, dtype, scratch_written):
    """Logits (live rows) within FP32_ATOL of the reference's, pools
    within the pool dtype's tolerance of the reference's, logits and
    views equal to the dense step's bit for bit."""
    atol, rtol = POOL_DTYPES[dtype][2:]
    np.testing.assert_allclose(tl[rows].numpy(), _f32(rl)[rows], rtol=0,
                               atol=FP32_ATOL)
    assert torch.equal(tl[rows], dense_logits[rows])
    for key, dkey in (("kp", "k"), ("vp", "v")):
        got, want = t_cache[0][key].float().numpy(), _f32(r_cache[0][key])
        if scratch_written:
            # the reference leaves an idle row's K/V on the scratch page;
            # the port writes back the bytes already there
            assert not got[:, 0].any()
            got, want = got[:, 1:], want[:, 1:]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=key)
        views = _dense_from(t_cache, bt)[0][dkey]
        assert torch.equal(views[:, rows], dense_cache[0][dkey][:, rows])


@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
@pytest.mark.parametrize("tables", ["live", "idle_row"])
@pytest.mark.parametrize("dtype", sorted(POOL_DTYPES))
def test_decode_step_paged_matches_reference(backend, tables, dtype,
                                             params):
    rc, tc = _cfgs(backend)
    rp, tp = params
    r_cache, t_cache = _pools(tc, dtype)
    bt = np.asarray(BT if tables == "live" else IDLE_BT)
    toks = np.asarray([3, 5, 7])
    pos = np.asarray([9, 13, 5] if tables == "live" else [9, 13, 0])
    rows = [0, 1, 2] if tables == "live" else [0, 1]
    tbt = torch.from_numpy(bt)
    dense = _dense_from(t_cache, tbt)
    dl, dense = lm.decode_step(tc, tp, dense, torch.from_numpy(toks),
                               torch.from_numpy(pos))
    rl, r_cache = ref_lm.decode_step_paged(
        rc, rp, r_cache, jnp.asarray(toks, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(bt, jnp.int32))
    tl, t_cache = lm.decode_step_paged(tc, tp, t_cache,
                                       torch.from_numpy(toks),
                                       torch.from_numpy(pos), tbt)
    _check_step(rl, tl, r_cache, t_cache, dl, dense, tbt, rows, dtype,
                scratch_written=tables == "idle_row")


@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
@pytest.mark.parametrize("dtype", sorted(POOL_DTYPES))
def test_prefill_step_paged_matches_reference(backend, dtype, params):
    """Rows 0 and 1 prefill from the page-aligned end of their shared
    prefix; row 2's chunk spans two pages."""
    rc, tc = _cfgs(backend)
    rp, tp = params
    r_cache, t_cache = _pools(tc, dtype, seed=2)
    bt = np.asarray(BT)
    toks = np.asarray([[3, 4, 5, 6], [7, 8, 9, 0], [10, 11, 12, 13]])
    pos, lens = np.asarray([8, 8, 2]), np.asarray([4, 3, 4])
    tbt = torch.from_numpy(bt)
    args = [torch.from_numpy(a) for a in (toks, pos, lens)]
    dense = _dense_from(t_cache, tbt)
    dl, dense = lm.prefill_step(tc, tp, dense, *args)
    rl, r_cache = ref_lm.prefill_step_paged(
        rc, rp, r_cache, *(jnp.asarray(a, jnp.int32)
                           for a in (toks, pos, lens, bt)))
    tl, t_cache = lm.prefill_step_paged(tc, tp, t_cache, *args, tbt)
    _check_step(rl, tl, r_cache, t_cache, dl, dense, tbt, [0, 1, 2],
                dtype, scratch_written=False)


def test_init_paged_cache_matches_reference():
    rc, tc = _cfgs("xla")
    want = ref_lm.init_paged_cache(rc, 7, 4)
    got = lm.init_paged_cache(tc, 7, 4, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"kp", "vp"}
        for key in g:
            assert tuple(g[key].shape) == w[key].shape
            assert g[key].dtype == torch.bfloat16 and not g[key].any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm.init_paged_cache(tc, 7, 4)


# ---------------------------------------------------------------- engine

def _run(tc, tp, prompts=PROMPTS, max_new=5, **sc):
    eng = ServingEngine(tc, tp, ServeConfig(**dict(dict(
        max_batch=2, max_seq=64), **sc)), device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=max_new, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


def _run_ref(rc, rp, prompts=PROMPTS, max_new=5, **sc):
    eng = RefEngine(rc, rp, RefServeConfig(**dict(dict(
        max_batch=2, max_seq=64), **sc)))
    reqs = [RefRequest(prompt=p, max_new_tokens=max_new, rid=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


@pytest.fixture(scope="module")
def dense_streams(params):
    return {be: _run(_cfgs(be)[1], params[1])[0]
            for be in ("xla", "arrayflex")}


@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
@pytest.mark.parametrize("page,prefix", GEOMETRIES)
def test_paged_streams_match_dense_and_reference(backend, page, prefix,
                                                 params, dense_streams):
    rc, tc = _cfgs(backend)
    rp, tp = params
    geo = dict(kv_pages=40, page_size=page, prefix_cache=prefix)
    streams, eng = _run(tc, tp, **geo)
    assert streams == dense_streams[backend]
    ref_streams, ref = _run_ref(rc, rp, **geo)
    assert streams == ref_streams
    assert eng.page_size == ref.page_size
    for key in ("prefill_dispatches", "decode_dispatches", "prefill_tokens",
                "decode_tokens", "pages_used_peak", "concurrency_peak",
                "prefix_hit_tokens"):
        assert eng.stats[key] == ref.stats[key], key
    # every sequence released its reservations; only the tree's published
    # prefix pages may remain
    assert eng.pool.n_used == (eng.radix.n_pages() if prefix else 0)
    assert eng.kv_cache_bytes() == ref.kv_cache_bytes()


def test_paged_eos_matches_dense(params):
    _, tc = _cfgs("xla")
    first = _run(tc, params[1])[0]
    eos = first[0][1]
    dense = _run(tc, params[1], eos_id=eos)[0]
    streams, _ = _run(tc, params[1], eos_id=eos, kv_pages=40, page_size=8,
                      prefix_cache=True)
    assert streams == dense
    assert any(len(s) < 5 for s in streams), "EOS never fired"


def test_concurrency_exceeds_max_batch(params):
    """Short requests: more sequences resident than dispatch rows, the
    decode ticks round-robin, every reservation is released."""
    _, tc = _cfgs("xla")
    prompts = [[3 + i, 4 + i, 5 + i] for i in range(8)]
    streams, eng = _run(tc, params[1], prompts, max_new=4, max_seq=32,
                        kv_pages=40, page_size=8)
    assert all(len(s) == 4 for s in streams)
    assert eng.stats["concurrency_peak"] == 8 > eng.sc.max_batch
    assert eng.pool.n_used == 0
    assert streams == _run(tc, params[1], prompts, max_new=4,
                           max_seq=32)[0]


def test_admission_blocks_on_page_budget(params):
    """4 data pages, one a request: at most 4 resident, the rest wait at
    the head of the queue, and everyone completes."""
    _, tc = _cfgs("xla")
    prompts = [[3 + i, 4 + i, 5 + i] for i in range(8)]
    streams, eng = _run(tc, params[1], prompts, max_new=4, max_seq=32,
                        kv_pages=5, page_size=8)
    assert all(len(s) == 4 for s in streams)
    assert eng.stats["concurrency_peak"] == 4
    assert eng.stats["pages_used_peak"] == 4
    assert eng.pool.n_used == 0


@pytest.mark.parametrize("kw,match", [
    (dict(kv_pages=10, page_size=7), "divide max_seq"),
    (dict(kv_pages=2, page_size=8), "need at least"),
    (dict(kv_pages=10, page_size=8, prefill_mode="token"), "batched")])
def test_engine_validates_page_geometry(kw, match, params):
    _, tc = _cfgs("xla")
    with pytest.raises(ValueError, match=match):
        ServingEngine(tc, params[1], ServeConfig(max_batch=2, max_seq=32,
                                                 **kw), device="cpu")


def test_moe_is_refused():
    cfg = dataclasses.replace(reduced(get_config("qwen3-moe-30b-a3b")),
                              compute_dtype="float32")
    assert not lm.supports_paged_kv(cfg)
    with pytest.raises(ValueError, match="paged"):
        lm.init_paged_cache(cfg, 4, 8, device="cpu")
    params = lm.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(cfg, params, ServeConfig(max_seq=32, kv_pages=8),
                      device="cpu")


def test_write_page_grows_then_raises(params):
    """A missing write page is allocated (radix eviction first when the
    pool is dry), and a dry pool with nothing to evict (and, under the
    default ``preempt_policy="none"``, no one to preempt) fails the
    request typed: ``PagePoolExhausted``, the sequence released."""
    _, tc = _cfgs("xla")
    eng = ServingEngine(tc, params[1], ServeConfig(
        max_batch=2, max_seq=32, kv_pages=6, page_size=8,
        prefix_cache=True), device="cpu")
    eng.submit(Request(prompt=list(range(3, 13)), max_new_tokens=2))
    eng.step()                               # admit + prefill + decode
    (seq,) = eng.active
    assert eng.radix.n_pages() == 1          # prompt[:8] published
    eng.pool.decref(seq.block_table[0])      # the tree's page alone
    seq.block_table[0] = paged.PagePool.SCRATCH
    idx = seq.pos // eng.page_size
    eng.pool.decref(seq.block_table[idx])
    seq.block_table[idx] = paged.PagePool.SCRATCH
    eng.pool.alloc(eng.pool.n_free)          # dry the pool
    eng._ensure_write_page(seq)              # evicts the tree's page
    assert seq.block_table[idx] != paged.PagePool.SCRATCH
    assert eng.radix.n_pages() == 0
    eng.pool.decref(seq.block_table[idx])
    seq.block_table[idx] = paged.PagePool.SCRATCH
    eng.pool.alloc(eng.pool.n_free)
    assert eng._ensure_write_page(seq) is False
    assert seq.req.done and seq.req.outcome == "failed"
    assert seq.req.error.startswith("PagePoolExhausted: ")
    assert "no page" in seq.req.error and seq not in eng.active


def _staggered(run, cfg, params, *, prefix_cache):
    """The reference's reuse-sensitive schedule
    (tests/test_serving_prefill.py): one request completes prefill first,
    publishing its prompt pages when the cache is on, then followers
    sharing its 32-token system prompt arrive."""
    system = list(range(3, 35))                       # 32 = 4 pages of 8
    prompts = [system + [40 + i, 41 + i] for i in range(4)]
    eng = run(cfg, params, [], max_seq=64, prefill_mode="batched",
              prefill_chunk=8, kv_pages=60, page_size=8,
              prefix_cache=prefix_cache)[1]
    req_cls = Request if isinstance(eng, ServingEngine) else RefRequest
    reqs = [req_cls(prompt=p, max_new_tokens=4, rid=i)
            for i, p in enumerate(prompts)]
    eng.submit(reqs[0])
    while not reqs[0].out_tokens:                     # prefix now published
        eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


def test_prefix_reuse_cuts_prefill_like_the_reference(params):
    rc, tc = _cfgs("xla")
    rp, tp = params
    out = {}
    for prefix in (False, True):
        streams, eng = _staggered(_run, tc, tp, prefix_cache=prefix)
        ref_streams, ref = _staggered(_run_ref, rc, rp, prefix_cache=prefix)
        assert streams == ref_streams
        for key in ("prefix_hit_tokens", "prefill_tokens",
                    "prefill_dispatches"):
            assert eng.stats[key] == ref.stats[key], key
        assert eng.stats["prefill_gemm_dispatches"] == \
            eng.stats["prefill_dispatches"] * (8 * tc.n_layers + 1)
        out[prefix] = streams, eng.stats
    (cold, cs), (warm, ws) = out[False], out[True]
    assert warm == cold
    assert ws["prefix_hit_tokens"] > 0 == cs["prefix_hit_tokens"]
    assert ws["prefill_tokens"] < cs["prefill_tokens"]
    assert ws["prefill_gemm_dispatches"] < cs["prefill_gemm_dispatches"]


def test_int8_paged_streams_match_reference(params):
    rc, tc = _cfgs("arrayflex_int8")
    rp, tp = params
    geo = dict(kv_pages=40, page_size=16, prefix_cache=True)
    streams, _ = _run(tc, tp, **geo)
    assert streams == _run_ref(rc, rp, **geo)[0]
    assert streams == _run(tc, tp)[0]


def test_w8a8_paged_streams_repeat(params):
    """W8A8's per-tile activation scales follow the batch's composition:
    paged streams are identical run to run (not across modes)."""
    _, tc = _cfgs("arrayflex_w8a8")
    geo = dict(kv_pages=40, page_size=8, prefix_cache=True)
    first, eng = _run(tc, params[1], **geo)
    assert first == _run(tc, params[1], **geo)[0]
    assert all(len(s) == 5 for s in first)
    assert eng.stats["prefix_hit_tokens"] == 0    # no shared prompt here


# ------------------------------------------------------------------- CLI

def test_serve_cli_paged_on_cpu(capsys):
    argv = ["--device", "cpu", "--requests", "3", "--max-new", "3",
            "--gemm-backend", "arrayflex"]
    dense = [r.out_tokens for r in serve.main(argv)]
    capsys.readouterr()
    reqs = serve.main(argv + ["--kv-pages", "40", "--page-size", "16",
                              "--prefix-cache"])
    out = capsys.readouterr().out
    assert [r.out_tokens for r in reqs] == dense
    assert "paged KV: 40 pages x 16 tok" in out
    assert "prefix_cache=on" in out and "concurrency peak 3" in out


def test_serve_cli_prefix_cache_needs_pages():
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--prefix-cache"])
