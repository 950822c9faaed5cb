"""Public model API: the ``make_*_step`` functions.

Port of the ``make_*_step`` functions of the reference's
``models/api.py``: a fused forward + backward + AdamW training step
(optionally accumulating gradients over microbatches), and the prefill
and serving steps.  The
reference's abstract input specs and PartitionSpec trees serve its
sharded dry run and are not ported here.

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
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import OptConfig, adamw_update


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
    data shard evenly)."""
    def split(x):
        b = x.shape[0] // n
        return x.reshape((b, n) + tuple(x.shape[1:]))[:, m]
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
