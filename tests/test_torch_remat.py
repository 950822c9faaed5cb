"""Remat in the port: ``cfg.remat`` over every super-block of
``lm.forward`` and every encoder layer of ``lm.encode_audio``, and the
unconditional checkpoints of each chunked-attention KV step and each SSD
chunk.

* "none", "dots" and "full" give the same loss and gradients, bit for bit
  on the CPU (the recomputation runs the forward's own ops), also under a
  mesh (the recomputation runs in the forward's mesh scope);
* the port at "full" against the reference at "full" (reduced qwen2-0.5b,
  mamba2-370m, and whisper-base with its encoder), fp32: the loss within
  1e-5, each gradient leaf within 1e-4 of its largest |g|;
* "full" and "dots" leave far fewer saved-tensor bytes outside their
  checkpoints (counted with ``torch.autograd.graph.saved_tensors_hooks``),
  and "full" recomputes the dots that "dots" keeps;
* outside autograd nothing is checkpointed: ``lm.prefill`` and greedy
  decode give the same logits and streams with remat on as off.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as REF_ARCHS, reduced as ref_reduced
from repro.models import lm as ref_lm
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config, reduced
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import api, convert, lm
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving.engine import Request

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models run fastest on one intra-op thread: the suite
    runs several workers on the machine's cores, and torch's default (a
    thread per core in each worker) oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(arch, remat, **kw):
    return reduced(get_config(arch), compute_dtype="float32",
                   gemm_backend="xla", remat=remat, **kw)


def batch(c, B=2, S=32, seed=0):
    rng = np.random.RandomState(seed)
    T = max(S // 8, 16) if c.family == "audio" else S
    out = {"tokens": rng.randint(2, c.vocab_size, (B, T)),
           "labels": rng.randint(2, c.vocab_size, (B, T))}
    if c.family == "audio":
        out["frames"] = rng.standard_normal((B, S, c.d_frontend)).astype(
            np.float32)
    return out


def port_batch(b):
    return {k: torch.tensor(v) if v.dtype != np.float32
            else torch.tensor(v).to(torch.bfloat16) for k, v in b.items()}


def grads_of(c, params, b):
    (loss, _), g = api.value_and_grad(c, params, port_batch(b))
    return loss, tree_lib.leaves(g)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-30b-a3b",
                                  "mamba2-370m", "whisper-base"])
def test_remat_modes_give_the_same_loss_and_grads(arch):
    """Bit for bit: the checkpointed super-blocks (and encoder layers)
    recompute exactly the ops they dropped."""
    base = cfg(arch, "none")
    params = lm.init_params(base, seed=0, device="cpu")
    b = batch(base)
    want_loss, want = grads_of(base, params, b)
    for remat in ("dots", "full"):
        loss, got = grads_of(cfg(arch, remat), params, b)
        assert torch.equal(loss, want_loss), remat
        assert all(torch.equal(a, w) for a, w in zip(got, want)), remat


@pytest.mark.parametrize("remat", ("dots", "full"))
def test_remat_under_a_mesh_recomputes_in_the_mesh_scope(remat):
    """Sharded training with remat: the backward pass runs after
    ``lm.loss_fn`` has left its mesh scope, so each recomputation runs in
    a copy of the forward's context; the gradients equal remat "none"
    under the same (2, 2) mesh bit for bit."""
    base = cfg("qwen2-0.5b", "none", mesh_shape=(2, 2))
    params = lm.init_params(base, seed=0, device="cpu")
    b = batch(base, B=4)
    with mesh_lib.host_devices(4, "cpu"):
        want_loss, want = grads_of(base, params, b)
        loss, got = grads_of(dataclasses.replace(base, remat=remat),
                             params, b)
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_chunked_scan_and_ssd_checkpoints_keep_the_gradients():
    """The KV-step checkpoints of the chunked scan (``attn_dense_below``
    8, KV chunks of 8) and the SSD chunk checkpoints (chunks of 8): the
    gradients equal an uncheckpointed run's (``layers.checkpointed``
    made a plain call) bit for bit."""
    from repro_torch.nn import layers
    for arch, kw in (("qwen2-0.5b", dict(attn_dense_below=8,
                                          attn_kv_chunk=8)),
                     ("mamba2-370m", {})):
        c = cfg(arch, "none", **kw)
        if c.ssm is not None:
            c = dataclasses.replace(c, ssm=dataclasses.replace(
                c.ssm, chunk_size=8))
        params = lm.init_params(c, seed=0, device="cpu")
        b = batch(c)
        loss, got = grads_of(c, params, b)
        plain = layers.checkpointed
        try:
            layers.checkpointed = lambda fn, *a, context_fn=None: fn(*a)
            want_loss, want = grads_of(c, params, b)
        finally:
            layers.checkpointed = plain
        assert torch.equal(loss, want_loss), arch
        assert all(torch.equal(a, w) for a, w in zip(got, want)), arch


def _ref_grads(arch):
    rc = ref_reduced(REF_ARCHS[arch], compute_dtype="float32",
                     gemm_backend="xla", remat="full")
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(0))
    b = batch(rc)
    rb = {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32
                         else jnp.int32) for k, v in b.items()}
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(rc, p, rb), has_aux=True))(rp)
    return rp, b, float(loss), [np.asarray(x, np.float32)
                                for x in jax.tree.leaves(g)]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m",
                                  "whisper-base"])
def test_full_remat_matches_reference(arch):
    """The port at remat "full" against the reference at remat "full" on
    the reference's tree (whisper-base: the decoder's super-blocks and
    the encoder's layers both checkpointed)."""
    rp, b, want_loss, want = _ref_grads(arch)
    c = cfg(arch, "full")
    params = convert.params_from_reference(
        c, jax.tree_util.tree_map(np.asarray, rp), device="cpu")
    loss, got = grads_of(c, params, b)
    assert abs(float(loss) - want_loss) <= LOSS_ATOL
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * scale)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _saved_bytes(c, params, b):
    """(bytes of the distinct storages autograd saves for the backward pass
    of ``lm.loss_fn`` — a checkpointed region's tensors are held by the
    checkpoint, not saved — and the 2-D matmuls the backward pass runs,
    its recomputation's included)."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    leaves = tree_lib.tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = lm.loss_fn(c, leaves, port_batch(b))
    with _CountMM() as count:
        loss.backward()
    return sum(seen.values()), count.mm


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_full_remat_saves_fewer_tensor_bytes(arch):
    """"full" and "dots" keep only each super-block's inputs outside the
    checkpoints; "full" recomputes the block's 2-D matmuls in the
    backward pass, "dots" keeps their outputs and recomputes none."""
    base = cfg(arch, "none", n_layers=4)
    params = lm.init_params(base, seed=0, device="cpu")
    b = batch(base, B=4, S=64)
    none, mm_none = _saved_bytes(base, params, b)
    full, mm_full = _saved_bytes(dataclasses.replace(base, remat="full"),
                                 params, b)
    dots, mm_dots = _saved_bytes(dataclasses.replace(base, remat="dots"),
                                 params, b)
    assert full * 4 < none and dots * 4 < none, (full, dots, none)
    assert mm_dots == mm_none < mm_full, (mm_none, mm_dots, mm_full)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_remat_is_inactive_outside_autograd(arch):
    """Prefill and greedy decode with remat "full" (grad mode on, no
    parameter requiring a gradient) give the logits and streams of remat
    "none" bit for bit."""
    off, on = cfg(arch, "none"), cfg(arch, "full")
    params = lm.init_params(off, seed=0, device="cpu")
    toks = torch.tensor(batch(off)["tokens"])
    want, wcache = lm.prefill(off, params, {"tokens": toks})
    got, gcache = lm.prefill(on, params, {"tokens": toks})
    assert torch.equal(got, want)
    for a, w in zip(tree_lib.leaves(gcache), tree_lib.leaves(wcache)):
        assert torch.equal(a, w)
    streams = []
    for c in (off, on):
        eng = ServingEngine(c, params, ServeConfig(max_batch=2, max_seq=64,
                                                   seed=0), device="cpu")
        reqs = [Request(prompt=[5, 7, 11, 13], max_new_tokens=6, rid=1),
                Request(prompt=[3, 2], max_new_tokens=6, rid=2)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        streams.append([r.out_tokens for r in reqs])
    assert streams[0] == streams[1]
