"""Training in the port against the reference: ``lm.loss_fn`` and its
gradients on every registered arch, the AdamW train step (single and
microbatched), the collapse-backend guard and the training CLI.

Reduced configs in fp32 compute on the ``xla`` backend (the reference's
training backend, ``configs/base.py``), the reference's tree
(``lm.init_params(cfg, PRNGKey(0))``) converted leaf by leaf, the same
seeded numpy batch in both packages at the shapes of the reference's
``tests/test_models_smoke.py::_batch`` (B = 2, S = 32; audio 32 frames
and 16 decoder tokens).  Tolerances:

* the loss: 1e-5 absolute (fp32 summation order through two layers);
* each gradient leaf: 1e-4 of that leaf's largest |g| in the reference
  (the forward's 1e-4 fp32 contract, ``test_torch_forward.py``, carried
  through the backward pass);
* a train step's new parameters: within 2 x the step's learning rate,
  since AdamW's first update is ``lr * g / (|g| + eps)`` and a gradient
  element within rounding of 0 may take either sign; its new first
  moment (0.1 g) within 1e-4 of each leaf's largest |m|, which holds the
  gradient itself.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS, reduced as ref_reduced
from repro.launch import train as ref_train
from repro.models import api as ref_api
from repro.models import lm as ref_lm
from repro.optim import OptConfig as RefOptConfig, adamw_init as ref_init
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import arrayflex_gemm as ag
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.models import api, convert, lm
from repro_torch.optim import OptConfig, adamw_init

ARCH_LIST = sorted(REF_ARCHS)
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
COLLAPSE = ("arrayflex", "arrayflex_int8", "arrayflex_w8a8")


def cfgs(arch, backend="xla", **kw):
    kw = dict(gemm_backend=backend, compute_dtype="float32", **kw)
    return (dataclasses.replace(ref_reduced(REF_ARCHS[arch]), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def batch_np(cfg, B=2, S=32, seed=0):
    """A seeded batch at ``_batch``'s shapes: tokens and labels, and the
    vlm's image embeddings or the audio family's frames (fp32 here, bf16
    in both packages)."""
    rng = np.random.RandomState(seed)
    T = max(S // 8, 16) if cfg.family == "audio" else S
    out = {"tokens": rng.randint(2, cfg.vocab_size, (B, T)),
           "labels": rng.randint(2, cfg.vocab_size, (B, T))}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, S, cfg.d_frontend)).astype(np.float32)
    return out


def ref_batch(b):
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32
                           else jnp.int32) for k, v in b.items()}


def port_batch(b, device="cpu"):
    return {k: torch.tensor(v).to(device, torch.bfloat16
                                  if v.dtype == np.float32 else torch.int64)
            for k, v in b.items()}


def trees(rc, tc, seed=0):
    """The reference's tree and its conversion into the port."""
    rp = ref_lm.init_params(rc, jax.random.PRNGKey(seed))
    return rp, convert.params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu")


def refvalue_and_grad(rc, rp, rb):
    fn = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(rc, p, rb), has_aux=True))
    return fn(rp)


def ref_leaves(tree):
    """(path key, numpy leaf) of a reference tree in flatten order."""
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), np.asarray(leaf, np.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def port_leaves(tree):
    return [(tree_lib.path_key(path), leaf.detach().float().numpy())
            for path, leaf in tree_lib.leaves_with_path(tree)]


def assert_tree_close(got, want, rtol, what=""):
    """Leaf by leaf (same path keys in the same order): within ``rtol`` of
    each reference leaf's largest |value|."""
    got, want = port_leaves(got), ref_leaves(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, (what, key)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale,
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_loss_and_grads_match_reference(arch):
    """``jax.value_and_grad(lm.loss_fn)`` against the port's autograd on
    the converted tree: the loss, xent, aux and every gradient leaf."""
    rc, tc = cfgs(arch)
    rp, tp = trees(rc, tc)
    b = batch_np(rc)
    (rloss, rmet), rgrads = refvalue_and_grad(rc, rp, ref_batch(b))
    (loss, met), grads = api.value_and_grad(tc, tp, port_batch(b))
    assert abs(float(loss) - float(rloss)) <= LOSS_ATOL
    assert abs(float(met["xent"]) - float(rmet["xent"])) <= LOSS_ATOL
    assert abs(float(met["aux"]) - float(rmet["aux"])) <= LOSS_ATOL
    if tc.moe is None:
        assert float(met["aux"]) == 0.0
    assert_tree_close(grads, rgrads, GRAD_RTOL, arch)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x22b"])
def test_chunked_attention_grads_match_reference(arch):
    """The same through the chunked scan (``attn_dense_below`` 8, KV
    chunks of 8): plain qwen2, and mixtral's MoE with its sliding window
    cut to 8 so that it masks."""
    win = dict(sliding_window=8) if arch == "mixtral-8x22b" else {}
    rc, tc = cfgs(arch, attn_dense_below=8, attn_kv_chunk=8, **win)
    rp, tp = trees(rc, tc)
    b = batch_np(rc, seed=2)
    (rloss, _), rgrads = refvalue_and_grad(rc, rp, ref_batch(b))
    (loss, _), grads = api.value_and_grad(tc, tp, port_batch(b))
    assert abs(float(loss) - float(rloss)) <= LOSS_ATOL
    assert_tree_close(grads, rgrads, GRAD_RTOL, arch)


def test_ref_backend_grads_match_reference():
    rc, tc = cfgs("qwen2-0.5b", "ref")
    rp, tp = trees(rc, tc)
    b = batch_np(rc, seed=1)
    (rloss, _), rgrads = refvalue_and_grad(rc, rp, ref_batch(b))
    (loss, _), grads = api.value_and_grad(tc, tp, port_batch(b))
    assert abs(float(loss) - float(rloss)) <= LOSS_ATOL
    assert_tree_close(grads, rgrads, GRAD_RTOL, "ref")


def _mask(B, S):
    """A loss mask whose rows keep 8, 16, 24, ... tokens: per-microbatch
    normalisation then depends on which rows share a microbatch."""
    return (np.arange(S)[None, :] < 8 * (1 + np.arange(B))[:, None]) \
        .astype(np.float32)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    """One train step of each package from one state: the loss, the
    gradient norm, the learning rate, the new parameters and first
    moments.  B = 4 with a ragged loss mask: the microbatched loss is
    the mean of per-microbatch masked means, so it equals the
    reference's only under the same stride split (rows m, m + n, ...)."""
    rc, tc = cfgs("qwen2-0.5b")
    rp, tp = trees(rc, tc)
    b = batch_np(rc, B=4)
    b["loss_mask"] = _mask(4, 32)
    rb = {k: (jnp.asarray(v) if k == "loss_mask" else ref_batch({k: v})[k])
          for k, v in b.items()}
    pb = {k: (torch.tensor(v) if k == "loss_mask" else
              port_batch({k: v})[k]) for k, v in b.items()}
    roc = RefOptConfig(total_steps=10)
    rnp, ropt, rmet = jax.jit(ref_api.make_train_step(rc, roc, n_micro))(
        rp, ref_init(rp, roc), rb)
    oc = OptConfig(total_steps=10)
    nparams, nopt, met = api.make_train_step(tc, oc, n_micro)(
        tp, adamw_init(tp, oc), pb)
    assert abs(float(met["loss"]) - float(rmet["loss"])) <= LOSS_ATOL
    assert abs(float(met["grad_norm"]) / float(rmet["grad_norm"]) - 1) \
        <= GRAD_RTOL
    assert abs(float(met["lr"]) - float(rmet["lr"])) <= 1e-12
    assert int(nopt["step"]) == int(ropt["step"]) == 1
    assert_tree_close(nopt["m"], ropt["m"], GRAD_RTOL, "m")
    lr = float(rmet["lr"])
    for (key, g), (_, w) in zip(port_leaves(nparams), ref_leaves(rnp)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr + 1e-7,
                                   err_msg=key)
    # the step writes neither input and changes the parameters
    assert all(torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(tp), tree_lib.leaves(convert.params_from_reference(
            tc, jax.tree_util.tree_map(np.asarray, rp), device="cpu"))))
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_lib.leaves(tp), tree_lib.leaves(nparams)))


def test_microbatch_split_takes_strided_rows():
    b = {"tokens": torch.arange(12).reshape(6, 2)}
    assert api._micro(b, 3, 1)["tokens"].tolist() == [[2, 3], [8, 9]]


@pytest.mark.parametrize("backend", COLLAPSE)
def test_collapse_backends_refused_in_both_packages(backend):
    """The reference's Pallas kernels fail under differentiation; the
    port refuses the backend up front (a CUDA kernel would return a
    result without a ``grad_fn``)."""
    rc, tc = cfgs("qwen2-0.5b", backend)
    rp, tp = trees(rc, tc)
    b = batch_np(rc)
    with pytest.raises(AssertionError):
        jax.value_and_grad(lambda p: ref_lm.loss_fn(rc, p, ref_batch(b)),
                           has_aux=True)(rp)
    with pytest.raises(NotImplementedError, match="'xla' or 'ref'"):
        api.make_train_step(tc, OptConfig())
    req = tree_lib.tree_map(lambda t: t.requires_grad_(True), tp)
    with pytest.raises(NotImplementedError, match=backend):
        lm.loss_fn(tc, req, port_batch(b))
    with torch.no_grad():          # evaluation needs no backward pass
        loss, _ = lm.loss_fn(tc, req, port_batch(b))
    assert torch.isfinite(loss)


def test_kernel_wrappers_refuse_tensors_requiring_grad():
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 16)
    with pytest.raises(RuntimeError, match="no backward pass"):
        ag.arrayflex_gemm(x, w)
    with pytest.raises(RuntimeError, match="no backward pass"):
        ag.arrayflex_expert_gemm(x[None], w[None])
    with torch.no_grad():
        assert ag.arrayflex_gemm(x, w).shape == (4, 16)


def test_flash_attention_refuses_tensors_requiring_grad():
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn(2, 16, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        fa.flash_attention(q, q, q, kv_chunk=8)


def test_prefill_and_serve_steps_are_the_lm_entries():
    _, tc = cfgs("qwen2-0.5b")
    params = lm.init_params(tc, seed=0, device="cpu")
    toks = torch.tensor(batch_np(tc)["tokens"])
    last, cache = api.make_prefill_step(tc)(params, {"tokens": toks})
    want, _ = lm.prefill(tc, params, {"tokens": toks})
    assert torch.equal(last, want)
    nxt = torch.tensor([3, 4])
    got, _ = api.make_serve_step(tc)(params, tuple(
        {k: v.clone() for k, v in c.items()} for c in cache), nxt,
        torch.tensor(32))
    want, _ = lm.decode_step(tc, params, cache, nxt, torch.tensor(32))
    assert torch.equal(got, want)


def test_train_cli_runs_and_resumes_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--reduced", "--batch", "4", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    losses = train.main(argv + ["--steps", "3"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    resumed = train.main(argv + ["--steps", "4"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(resumed) == 2 and np.isfinite(resumed).all()


def test_train_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])


def test_arrayflex_report_equals_reference(capsys):
    argv = ["--reduced", "--steps", "1", "--batch", "2", "--seq", "16",
            "--arrayflex-report"]
    ref_train.main(argv)
    want = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith(("ArrayFlex", "  "))]
    train.main(argv + ["--device", "cpu"])
    got = [l for l in capsys.readouterr().out.splitlines()
           if l.startswith(("ArrayFlex", "  "))]
    assert len(want) == 9 and got == want


def test_a_mesh_of_several_devices_is_refused(monkeypatch, capsys):
    """Once refused, now trained (sharded training, ROADMAP Queue 1 item
    7b): the mesh clamps over ``launch.mesh.devices()`` of the device's
    type — one CPU alone, an outer ``host_devices`` scope's logical
    devices when one is active, several physical devices when they exist
    — and a (2, 1) mesh over two logical CPU devices trains through
    ``train.main``, equal to the unsharded run (fp32 compute)."""
    dev = torch.device("cpu")
    assert train.host_mesh(4, 2, dev).size == 1      # clamps to one CPU
    with mesh_lib.host_devices(4, "cpu"):             # the outer scope
        assert train.host_mesh(4, 2, dev).shape == {"data": 4, "model": 1}
        assert train.host_mesh(2, 2, dev).shape == {"data": 2, "model": 2}
    build = train.build_config
    monkeypatch.setattr(train, "build_config", lambda a: dataclasses.replace(
        build(a), compute_dtype="float32"))
    argv = ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "4",
            "--seq", "16", "--log-every", "1"]
    want = train.main(argv)
    assert "mesh:" not in capsys.readouterr().out
    with mesh_lib.host_devices(2, "cpu"):
        got = train.main(argv + ["--mesh-data", "2"])
    assert "mesh: data=2 x model=1 over 2 devices" in capsys.readouterr().out
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    monkeypatch.setattr(mesh_lib, "physical_devices",
                        lambda kind=None: [dev, dev])
    assert train.host_mesh(2, 1, dev).shape == {"data": 2, "model": 1}
