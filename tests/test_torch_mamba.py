"""The port's Mamba-2 mixer (``repro_torch.nn.mamba``) vs the reference's
``repro.nn.mamba``.

Inputs come from numpy with a fixed seed; the mixer's parameters are the
reference's ``mamba_init`` leaves carried across.  Tolerances, fp32:

* ``ssd_chunked``, ``_causal_conv``, ``_segsum``, ``mamba_forward`` and
  ``mamba_decode_step``: rtol = atol = 1e-5 — both packages run the same
  chunk-major scan with the same contractions in fp32 and differ only in
  summation order and in the last bits of exp/log1p.
* ``mamba_init``: ``dt_bias`` bit for bit (float64 numpy in both, cast
  once to fp32); ``a_log`` to 1e-6 relative (each package's fp32 log may
  round the last bit differently); layout and dtypes equal.

The arrayflex backend runs the kernels' plain versions on CPU tensors,
the reference's Pallas kernels in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as RefSSM
from repro.nn import mamba as ref_mamba
from repro_torch.configs.base import SSMConfig
from repro_torch.nn import mamba

TOL = dict(rtol=1e-5, atol=1e-5)
D_MODEL = 32
SSM = dict(d_state=16, head_dim=8, expand=2, chunk_size=8)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _ssd_inputs():
    """The inputs of the reference's ``test_ssd_chunked_vs_naive``."""
    rng = np.random.RandomState(0)
    B, S, H, P, G, N = 2, 64, 4, 8, 2, 16
    return (rng.randn(B, S, H, P), rng.rand(B, S, H) * 0.5,
            -rng.rand(H) - 0.2, rng.randn(B, S, G, N), rng.randn(B, S, G, N))


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_chunked_matches_reference(chunk):
    ins = _ssd_inputs()
    want_y, want_st = ref_mamba.ssd_chunked(
        *(jnp.asarray(a, jnp.float32) for a in ins), chunk)
    got_y, got_st = mamba.ssd_chunked(*(_t(a) for a in ins), chunk)
    assert got_y.dtype == torch.float32 and got_st.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), _np(want_y), **TOL)
    np.testing.assert_allclose(got_st.numpy(), _np(want_st), **TOL)


def test_ssd_chunked_asserts_whole_chunks():
    """S must be a multiple of the chunk in both packages: neither pads."""
    x, dt, A, B_, C_ = (a[:, :48] if a.ndim > 1 else a
                        for a in _ssd_inputs())
    with pytest.raises(AssertionError):
        ref_mamba.ssd_chunked(*(jnp.asarray(a, jnp.float32)
                                for a in (x, dt, A, B_, C_)), 32)
    with pytest.raises(AssertionError):
        mamba.ssd_chunked(*(_t(a) for a in (x, dt, A, B_, C_)), 32)


def test_segsum_matches_reference():
    dA = -np.random.RandomState(1).rand(3, 2, 8)
    want = _np(ref_mamba._segsum(jnp.asarray(dA, jnp.float32)))
    got = mamba._segsum(_t(dA)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("S", [1, 2, 7])
def test_causal_conv_matches_reference(S):
    rng = np.random.RandomState(2)
    x, w, b = rng.randn(2, S, 12), rng.randn(4, 12), rng.randn(12)
    want = ref_mamba._causal_conv(*(jnp.asarray(a, jnp.float32)
                                    for a in (x, w, b)))
    got = mamba._causal_conv(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.fixture(scope="module")
def params():
    ref = ref_mamba.mamba_init(jax.random.PRNGKey(0), D_MODEL,
                               RefSSM(**SSM), jnp.float32)
    port = jax.tree_util.tree_map(lambda a: _t(a), ref)
    return ref, port


def test_mamba_init_mirrors_reference(params):
    ref, _ = params
    gen = torch.Generator().manual_seed(0)
    got = mamba.mamba_init(gen, D_MODEL, SSMConfig(**SSM))
    shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                    ref)

    def ours(node):
        if isinstance(node, dict):
            return {k: ours(v) for k, v in node.items()}
        return tuple(node.shape), str(node.dtype).split(".")[-1]

    assert ours(got) == shapes
    assert list(got) == list(ref)
    assert torch.equal(got["dt_bias"], _t(ref["dt_bias"]))
    np.testing.assert_allclose(got["a_log"].numpy(), _np(ref["a_log"]),
                               rtol=1e-6, atol=0)
    assert torch.equal(got["D"], torch.ones_like(got["D"]))
    bf16 = mamba.mamba_init(torch.Generator().manual_seed(0), D_MODEL,
                            SSMConfig(**SSM), torch.bfloat16)
    assert bf16["z_proj"]["w"].dtype == torch.bfloat16
    assert bf16["dt_bias"].dtype == bf16["a_log"].dtype == torch.float32


@pytest.mark.parametrize("S", [24, 5])
@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
def test_mamba_forward_matches_reference(params, backend, S):
    """S = 24 runs three chunks of 8; S = 5 one chunk of 5, its conv
    window left-padded (S < d_conv - 1 is covered by the conv test)."""
    ref, port = params
    x = np.random.RandomState(3).randn(2, S, D_MODEL)
    want = ref_mamba.mamba_forward(ref, jnp.asarray(x, jnp.float32),
                                   RefSSM(**SSM), jnp.float32,
                                   backend=backend)
    got = mamba.mamba_forward(port, _t(x), SSMConfig(**SSM), torch.float32,
                              backend=backend)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
    assert got[1].dtype == torch.float32


@pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["xla", "arrayflex"])
def test_mamba_decode_step_matches_reference(params, backend, conv_dtype):
    """Eight steps from a zero state; the conv window cached in
    ``conv_dtype`` between steps (the served cache is bf16: the window is
    then the promoted fp32 concatenation, cast back after each step)."""
    ref, port = params
    ssm = SSMConfig(**SSM)
    rng = np.random.RandomState(4)
    d_in = ssm.expand * D_MODEL
    hg = d_in // ssm.head_dim
    ch = d_in + 2 * ssm.d_state
    r_st = jnp.zeros((2, 1, hg, ssm.head_dim, ssm.d_state), jnp.float32)
    r_cv = jnp.zeros((2, ssm.d_conv - 1, ch), getattr(jnp, conv_dtype))
    t_st = torch.zeros(tuple(r_st.shape))
    t_cv = torch.zeros(tuple(r_cv.shape), dtype=getattr(torch, conv_dtype))
    for _ in range(8):
        x = rng.randn(2, D_MODEL)
        ry, r_st, r_cv = ref_mamba.mamba_decode_step(
            ref, jnp.asarray(x, jnp.float32), r_st, r_cv, RefSSM(**SSM),
            jnp.float32, backend=backend)
        r_cv = r_cv.astype(getattr(jnp, conv_dtype))
        prev, before, prev_cv = t_st, t_st.clone(), t_cv
        ty, t_st, t_cv = mamba.mamba_decode_step(port, _t(x), t_st, t_cv,
                                                 ssm, torch.float32,
                                                 backend=backend)
        assert torch.equal(prev, before)           # the input not written
        dst = (torch.empty_like(t_st), torch.empty_like(prev_cv))
        y2, st2, cv2 = mamba.mamba_decode_step(port, _t(x), prev, prev_cv,
                                               ssm, torch.float32,
                                               backend=backend, out=dst)
        assert st2 is dst[0] and cv2 is dst[1]     # written in place there
        assert torch.equal(y2, ty) and torch.equal(st2, t_st)
        assert torch.equal(cv2, t_cv.to(cv2.dtype))
        t_cv = t_cv.to(getattr(torch, conv_dtype))
        np.testing.assert_allclose(ty.numpy(), _np(ry), **TOL)
        np.testing.assert_allclose(t_st.numpy(), _np(r_st), **TOL)
        np.testing.assert_allclose(t_cv.float().numpy(), _np(r_cv), **TOL)
        assert t_st.dtype == torch.float32
