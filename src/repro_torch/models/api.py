"""Public model API: the step functions, abstract input specs and their
mesh specs.

Port of the reference's ``models/api.py``: a fused forward + backward +
AdamW training step (optionally accumulating gradients over
microbatches), the prefill and serving steps, and the dry run's tables.
``batch_specs`` / ``decode_specs`` / ``abstract_params`` /
``abstract_opt_state`` give every model input and state as tensors on
the ``meta`` device — shapes and dtypes (the reference's), no storage —
and ``*_pspecs`` the matching spec trees for a mesh
(``parallel.sharding``'s tuple specs).

A training step differentiates ``lm.loss_fn`` with ``torch.autograd`` on
detached, gradient-requiring views of the parameters (no copy), then
runs ``optim.adamw_update``; it returns new parameter and optimizer trees
and writes neither input.  It trains on the ``xla`` and ``ref`` backends:
building one on a collapse backend raises ``NotImplementedError``
(``lm.check_trainable``).
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig, SSMConfig
from repro_torch.models import lm
from repro_torch.optim import OptConfig, adamw_init, adamw_update
from repro_torch.parallel import sharding


def dec_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Decoder-token length for enc-dec (audio) models."""
    return max(shape.seq_len // 8, 16)


# ---------------------------------------------------------------------------
# abstract specs (meta tensors: a shape and a dtype, no storage)

def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, with_labels=True):
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        DL = dec_len(cfg, shape)
        out = {"frames": _sds((B, S, cfg.d_frontend), torch.bfloat16),
               "tokens": _sds((B, DL), torch.int32)}
        if with_labels:
            out["labels"] = _sds((B, DL), torch.int32)
        return out
    out = {"tokens": _sds((B, S), torch.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = _sds((B, cfg.n_image_tokens, cfg.d_frontend),
                                   torch.bfloat16)
    if with_labels:
        out["labels"] = _sds((B, S), torch.int32)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(cache, token, pos) meta tensors for ``make_serve_step``."""
    B = shape.global_batch
    cache = lm.init_cache(cfg, B, shape.seq_len, device="meta")
    return cache, _sds((B,), torch.int32), _sds((), torch.int32)


def abstract_params(cfg: ModelConfig):
    """``lm.init_params``' tree on the ``meta`` device: every leaf's shape
    and dtype, no storage allocated."""
    return lm.init_params(cfg, seed=0, device="meta")


def abstract_opt_state(cfg: ModelConfig, opt_cfg: OptConfig):
    return adamw_init(abstract_params(cfg), opt_cfg)


# ---------------------------------------------------------------------------
# mesh specs

def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                 with_labels=True):
    B = shape.global_batch
    tok = sharding.token_pspec(mesh, B)
    act = sharding.activation_pspec(mesh, B)
    if cfg.family == "audio":
        out = {"frames": act, "tokens": tok}
        if with_labels:
            out["labels"] = tok
        return out
    out = {"tokens": tok}
    if cfg.family == "vlm":
        out["image_embeds"] = act
    if with_labels:
        out["labels"] = tok
    return out


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    B = shape.global_batch
    ssm = cfg.ssm or SSMConfig()
    hg = (cfg.d_inner // ssm.head_dim) // ssm.n_groups
    conv_ch = cfg.d_inner + 2 * ssm.n_groups * ssm.d_state
    cache = lm.init_cache(cfg, B, shape.seq_len, device="meta")

    def spec(path, leaf):
        name = str(path[-1])
        if name in ("k", "v", "xk", "xv"):
            return sharding.kv_cache_pspec(mesh, B, leaf.shape[2])
        if name == "state":
            return sharding.ssm_state_pspec(mesh, B, hg)
        if name == "conv":
            return sharding.conv_state_pspec(mesh, B, conv_ch)
        return ()

    return tree_lib.map_with_path(spec, cache)


def decode_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    B = shape.global_batch
    tok = sharding._P(sharding._maybe(B, mesh, sharding.batch_axes(mesh)))
    return cache_pspecs(cfg, shape, mesh), tok, ()


def param_pspecs(cfg: ModelConfig, mesh):
    return sharding.param_pspec_tree(
        abstract_params(cfg), mesh,
        moe_experts=cfg.moe.num_experts if cfg.moe else 0)


def opt_pspecs(cfg: ModelConfig, opt_cfg: OptConfig, mesh):
    pp = param_pspecs(cfg, mesh)
    out = {"m": pp, "v": pp, "step": ()}
    if opt_cfg.master_weights:
        out["master"] = pp
    return out


# ---------------------------------------------------------------------------
# step functions


def value_and_grad(cfg: ModelConfig, params, batch):
    """((loss, metrics), grads) of ``lm.loss_fn`` at ``params``: the
    gradient tree holds each leaf's gradient in the leaf's dtype (zeros
    where the loss does not reach the leaf)."""
    leaves = tree_lib.tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
    with torch.enable_grad():
        loss, metrics = lm.loss_fn(cfg, leaves, batch)
        flat = tree_lib.leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_leaf = {id(p): (g if g is not None else torch.zeros_like(p))
               for p, g in zip(flat, grads)}
    grads = tree_lib.tree_map(lambda p: by_leaf[id(p)], leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def _micro(batch, n: int, m: int):
    """Microbatch ``m`` of ``n``: rows m, m + n, m + 2n, ... of every batch
    leaf (the reference's stride split, so each microbatch spans every
    data shard evenly), from the (n, B/n, ...) view the "micro_batch"
    activation rule constrains."""
    def split(x):
        b = x.shape[0] // n
        xr = x.reshape((b, n) + tuple(x.shape[1:])).movedim(1, 0)
        return sharding.constrain(xr, "micro_batch")[m]
    return {k: split(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    n_microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``n_microbatches > 1`` accumulates fp32 gradients (each
    divided by n) over the stride-split microbatches, and the loss as the
    mean of theirs (activation memory scales 1/n)."""
    lm.check_trainable(cfg)
    if n_microbatches <= 1:
        def train_step(params, opt_state, batch):
            (loss, metrics), grads = value_and_grad(cfg, params, batch)
            new_params, new_opt, stats = adamw_update(params, grads,
                                                      opt_state, opt_cfg)
            return new_params, new_opt, dict(metrics, loss=loss, **stats)
        return train_step

    n = n_microbatches

    def train_step(params, opt_state, batch):
        gacc = tree_lib.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=tree_lib.leaves(params)[0].device)
        for m in range(n):
            (loss, _), grads = value_and_grad(cfg, params,
                                               _micro(batch, n, m))
            gacc = tree_lib.tree_map(lambda a, g: a + g.float() / n, gacc,
                                     grads)
            loss_acc = loss_acc + loss / n
            del grads
        new_params, new_opt, stats = adamw_update(params, gacc, opt_state,
                                                  opt_cfg)
        return new_params, new_opt, dict(loss=loss_acc, **stats)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return lm.prefill(cfg, params, batch)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, token, pos):
        return lm.decode_step(cfg, params, cache, token, pos)
    return serve_step
