"""The port's attention vs the reference: K3's plain version
(``kernels.flash_attention``), ``ops.attention``, the dense oracles of
``kernels.ref``, and ``nn.attention``'s dense / chunked / switching paths.

Inputs come from numpy with a fixed seed and go to both packages.  The
reference's Pallas kernels run in interpret mode on the CPU, as
``tests/test_kernels.py`` runs them; the port's wrappers run their plain
versions on CPU tensors.  Tolerances (``assert_allclose`` rtol = atol):

* fp32: 1e-5 — both sides compute the same chunks in fp32 and differ only
  in summation order and the last bit of exp.
* bf16: 1e-2, half the reference test's own 2e-2 — bf16 inputs, fp32
  scores and sums on both sides; p is rounded to bf16 before the PV
  product, where an fp32 rounding difference can flip one bf16 step of a
  p value, and the output is rounded once to bf16 (one step is 2^-8
  relative).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels import substrate as ref_sub
from repro.nn import attention as ref_att
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref, substrate
from repro_torch.nn import attention as att


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers on the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ref_fa = importlib.import_module("repro.kernels.flash_attention")

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _pair(shape, seed, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(a, JNP[dtype]), torch.from_numpy(a).to(TORCH[dtype])


def _qkv(q_shape, kv_shape, seed, dtype):
    return [_pair(s, seed + i, dtype)
            for i, s in enumerate((q_shape, kv_shape, kv_shape))]


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


# ------------------------------------------------------------ K3

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,kv_chunk", [(97, 64), (320, 128), (130, 64)])
def test_flash_ragged_kv_matches_reference(T, kv_chunk, causal, dtype):
    """A ragged last chunk is masked past T, as the reference's padded
    chunk grid is (tests/test_kernels.py's ragged shapes)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv((2, 64, 32), (2, T, 32), T, dtype)
    want = ref_fa.flash_attention(jq, jk, jv, causal=causal, bq=32,
                                  kv_chunk=kv_chunk)
    got = fa.flash_attention(tq, tk, tv, causal=causal, bq=32,
                             kv_chunk=kv_chunk)
    assert got.dtype == TORCH[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", [
    dict(BH=4, S=256, T=256, D=64, causal=True, window=0),
    dict(BH=2, S=128, T=256, D=64, causal=False, window=0),
    dict(BH=3, S=256, T=256, D=64, causal=True, window=96),
    dict(BH=2, S=256, T=256, D=128, causal=True, window=0),
], ids=["causal", "noncausal", "window96", "d128"])
def test_flash_matches_reference_kernel(cfg, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(
        (cfg["BH"], cfg["S"], cfg["D"]), (cfg["BH"], cfg["T"], cfg["D"]),
        cfg["S"] + cfg["D"], dtype)
    kw = dict(causal=cfg["causal"], window=cfg["window"], bq=64,
              kv_chunk=64)
    _close(fa.flash_attention(tq, tk, tv, **kw),
           ref_fa.flash_attention(jq, jk, jv, **kw), dtype)
    # the plain version is the same function as the dense oracle
    _close(fa.flash_attention(tq, tk, tv, **kw),
           ref_ref.attention_ref(jq, jk, jv, causal=cfg["causal"],
                                 window=cfg["window"]), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_rows_are_exactly_zero(dtype):
    """Non-causal, window 16, S > T: rows 79.. see no column, so l = 0
    and the output is o / 1e-30 = 0 (not NaN), in both packages."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv((2, 128, 32), (2, 64, 32), 7, dtype)
    got = fa.flash_attention(tq, tk, tv, causal=False, window=16,
                             kv_chunk=32)
    want = ref_fa.flash_attention(jq, jk, jv, causal=False, window=16,
                                  kv_chunk=32)
    assert torch.equal(got[:, 79:], torch.zeros_like(got[:, 79:]))
    assert bool(torch.isfinite(got).all())
    assert np.all(np.asarray(want[:, 79:], np.float32) == 0)
    assert got[:, :79].abs().amax(dim=-1).min() > 0
    _close(got, want, dtype)


@pytest.mark.parametrize("S,bq", [(96, 64), (200, 128), (48, 32)])
def test_query_block_contract_raises(S, bq):
    """The reference asserts S % min(bq, S) == 0; the port raises."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv((1, S, 16), (1, 64, 16), 3,
                                        "float32")
    with pytest.raises(AssertionError):
        ref_fa.flash_attention(jq, jk, jv, bq=bq)
    with pytest.raises(ValueError, match="multiple of the query block"):
        fa.flash_attention(tq, tk, tv, bq=bq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 320, 64, False),
                                   (1, 128, 4097, 64, False),
                                   (2, 256, 256, 128, True)])
def test_ops_attention_matches_reference(shape, dtype):
    """The planner picks the same KV chunk in both packages (T = 4097:
    chunks of 4096 and 1 columns)."""
    BH, S, T, D, causal = shape
    (jq, tq), (jk, tk), (jv, tv) = _qkv((BH, S, D), (BH, T, D), T, dtype)
    _close(ops.attention(tq, tk, tv, causal=causal),
           ref_ops.attention(jq, jk, jv, causal=causal), dtype)


def test_plain_version_launches_nothing():
    before = dict(fa.LAUNCHES)
    q = torch.zeros(1, 8, 16)
    ops.attention(q, q, q)
    fa.flash_attention(q, q, q, kv_chunk=4)
    assert fa.LAUNCHES == before


def test_attention_kernel_rule():
    """The written dtype -> kernel rule: bf16 launches the tensor-core
    kernel, fp32 the FFMA kernel, anything else raises."""
    assert fa.attention_kernel(torch.bfloat16) == "flash_attention_tc"
    assert fa.attention_kernel(torch.float32) == "flash_attention_fwd"
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fa.attention_kernel(dt)


@pytest.mark.parametrize("args,want", [
    ((14, 4096, 4096, 4096, 132), 1),     # qwen2 long prefill: 896 blocks
    ((32, 4096, 4096, 4096, 132), 1),     # qwen3-moe long prefill
    ((56, 256, 256, 256, 132), 1),        # the prefill-chunk yardstick
    ((14, 512, 256, 256, 132), 1),        # 4 sub-tiles: too few to split
    ((14, 128, 4097, 4096, 132), 5),      # ragged: 28 blocks -> 140
    ((4, 128, 4097, 4096, 132), 16),      # capped at 64 / 4 sub-tiles
    ((1, 64, 512, 512, 132), 2)])
def test_kv_splits(args, want):
    assert fa.kv_splits(*args) == want


@pytest.mark.parametrize("BH", [1, 3, 14, 40])
@pytest.mark.parametrize("S", [1, 64, 128, 500, 4096])
@pytest.mark.parametrize("T,kv_chunk", [(64, 64), (300, 256), (4097, 4096),
                                        (2048, 1024), (700, 256)])
def test_kv_splits_bounds(BH, S, T, kv_chunk):
    """Never a split below MIN_SPLIT_SUBTILES sub-tiles of the chunk (so
    never below one), and a split only while the query tiles alone leave
    SMs idle."""
    n = fa.kv_splits(BH, S, T, kv_chunk, 132)
    assert n >= 1
    if n > 1:
        assert -(-S // fa.TC_QUERY_ROWS) * BH < 132
        width = -(-min(kv_chunk, T) // n)
        assert width >= fa.MIN_SPLIT_SUBTILES * fa.TC_KV_COLS - fa.TC_KV_COLS
        assert -(-min(kv_chunk, T) // fa.TC_KV_COLS) >= n * \
            fa.MIN_SPLIT_SUBTILES


def test_kv_splits_refuses_empty_sizes():
    for args in ((0, 1, 1, 1, 1), (1, 1, 1, 0, 1), (1, 1, 1, 1, 0)):
        with pytest.raises(ValueError, match="positive"):
            fa.kv_splits(*args)


def test_launch_refuses_bad_splits():
    """The launcher refuses a split count below 1, and any split of the
    fp32 (FFMA) kernel, before it allocates or builds anything."""
    q = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="n_split"):
        fa._launch(q, q, q, True, 0, 8, 2)
    with pytest.raises(ValueError, match="n_split"):
        fa._launch(q.bfloat16(), q.bfloat16(), q.bfloat16(), True, 0, 8, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa._launch(q.half(), q.half(), q.half(), True, 0, 8, 1)


def test_wrapper_never_runs_the_plain_version_off_the_cpu():
    """A tensor on any device but the CPU launches the kernel or raises:
    on a device the kernel does not take it raises, and without a card a
    CUDA tensor cannot even be made (no silent CPU run)."""
    q = torch.zeros(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.attention(q, q, q)
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA tensors launch the kernel")
    with pytest.raises((RuntimeError, AssertionError)):
        ops.attention(*(torch.zeros(1, 8, 16, device="cuda")
                        for _ in range(3)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracles_match_reference(dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv((3, 64, 32), (3, 80, 32), 11, dtype)
    for causal, window in ((True, 0), (False, 24), (True, 24)):
        _close(ref.attention_ref(tq, tk, tv, causal=causal, window=window),
               ref_ref.attention_ref(jq, jk, jv, causal=causal,
                                     window=window), dtype)
    (jx, tx), (jw, tw) = _pair((16, 48), 1, dtype), _pair((48, 24), 2, dtype)
    _close(ref.gemm_ref(tx, tw), ref_ref.gemm_ref(jx, jw), dtype)
    _close(ref.gemm_ref(tx, tw, torch.float32),
           ref_ref.gemm_ref(jx, jw, jnp.float32), "float32")


# ------------------------------------------------------------ nn.attention

def _bshd(B, S, T, H, KV, D, seed, dtype):
    return _qkv((B, S, H, D), (B, T, KV, D), seed, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("gqa", [(8, 8), (8, 2), (4, 1)])
def test_dense_and_chunked_match_reference(gqa, window, dtype):
    H, KV = gqa
    (jq, tq), (jk, tk), (jv, tv) = _bshd(2, 128, 128, H, KV, 32, 1, dtype)
    kw = dict(causal=True, window=window)
    _close(att.dense_attention(tq, tk, tv, **kw),
           ref_att.dense_attention(jq, jk, jv, **kw), dtype)
    _close(att.chunked_attention(tq, tk, tv, kv_chunk=32, **kw),
           ref_att.chunked_attention(jq, jk, jv, kv_chunk=32, **kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,kv_chunk,q_offset", [
    (97, 32, 0), (130, 64, 66), (96, 128, 32), (101, 101, 37)])
def test_ragged_kv_and_q_offset_match_reference(T, kv_chunk, q_offset,
                                                causal, dtype):
    """Queries at global rows q_offset.., ragged KV lengths: the chunked
    scan's shorter last chunk equals the reference's zero-pad-and-mask,
    and dense attention masks keys past kv_len."""
    (jq, tq), (jk, tk), (jv, tv) = _bshd(1, 64, T, 4, 2, 16, T, dtype)
    kw = dict(causal=causal, q_offset=q_offset)
    _close(att.chunked_attention(tq, tk, tv, kv_chunk=kv_chunk, **kw),
           ref_att.chunked_attention(jq, jk, jv, kv_chunk=kv_chunk, **kw),
           dtype)
    _close(att.dense_attention(tq, tk, tv, kv_len=T - 5, **kw),
           ref_att.dense_attention(jq, jk, jv, kv_len=T - 5, **kw), dtype)


@pytest.mark.parametrize("backend", ["xla", "ref", "arrayflex"])
@pytest.mark.parametrize("dense_below", [64, 16])
def test_attention_switch_matches_reference(dense_below, backend):
    """``dense_below`` picks the path in both packages: the dense path
    dispatches attn.qk and attn.pv through the substrate backend, the
    chunked scan dispatches nothing."""
    (jq, tq), (jk, tk), (jv, tv) = _bshd(2, 32, 32, 4, 2, 16, 5, "float32")
    kw = dict(causal=True, window=0, kv_chunk=8, dense_below=dense_below,
              backend=backend)
    ref_sub.DISPATCH_COUNTS.clear()
    want = ref_att.attention(jq, jk, jv, **kw)
    ref_counts = dict(ref_sub.DISPATCH_COUNTS)
    substrate.DISPATCH_COUNTS.clear()
    got = att.attention(tq, tk, tv, **kw)
    assert dict(substrate.DISPATCH_COUNTS) == ref_counts == (
        {"attn.qk": 1, "attn.pv": 1} if 32 <= dense_below else {})
    _close(got, want, "float32")
    substrate.DISPATCH_COUNTS.clear()
    ref_sub.DISPATCH_COUNTS.clear()


@pytest.mark.parametrize("B", [1, 3])
def test_attention_products_get_contiguous_operands(B, monkeypatch):
    """The CUDA kernels take contiguous operands only: with B = 1 the
    (B * KV) reshape of the permuted K^T and V would be a strided view,
    so qk_scores and pv_mix hand the substrate contiguous copies."""
    real = substrate.batched_gemm
    seen = []

    def checked(x, w, **kw):
        seen.append(kw["site"])
        assert x.is_contiguous() and w.is_contiguous(), kw["site"]
        return real(x, w, **kw)

    monkeypatch.setattr(substrate, "batched_gemm", checked)
    _, tq = _pair((B, 16, 4, 16), 1, "float32")
    _, tk = _pair((B, 24, 2, 16), 2, "float32")
    _, tv = _pair((B, 24, 2, 16), 3, "float32")
    att.dense_attention(tq, tk, tv, causal=False)
    att.decode_attention(tq[:, :1], tk, tv, torch.full((B,), 5))
    assert seen == ["attn.qk", "attn.pv"] * 2
