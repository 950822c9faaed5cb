"""AdamW with global-norm clipping and a warmup-cosine schedule.

Port of the reference's ``optim/adamw.py``.  Functional, as the
reference's: ``adamw_update`` returns new parameter, moment and master
trees and writes none of its inputs.  Every update runs in fp32 in the
reference's operation order (the clip scale from the global norm, bias
correction from the fp32 step count, weight decay on leaves of two or
more dims only), then casts back to each leaf's dtype.

Moments can be stored in bfloat16 (``moment_dtype``), and
``master_weights`` keeps an fp32 master copy while the live parameters
stay in their (bf16) dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import tree as tree_lib


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    moment_dtype: str = "float32"   # "bfloat16" for the giant configs
    # an fp32 master copy beside bf16 live parameters
    master_weights: bool = False


def _f32(step, device=None):
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32, device=device)


def lr_schedule(cfg: OptConfig, step):
    """The learning rate at ``step`` (an int or a 0-d tensor), in fp32:
    linear warmup to ``lr`` over ``warmup_steps``, then a half cosine to 0
    at ``total_steps``."""
    step = _f32(step)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def adamw_init(params, cfg: OptConfig):
    """{'m', 'v': zeros like ``params`` in the moment dtype, 'step': int32
    0 on the parameters' device}, and 'master' (fp32 copies) with
    ``master_weights``."""
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = tree_lib.leaves(params)[0].device
    state = {"m": tree_lib.tree_map(zeros, params),
             "v": tree_lib.tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.master_weights:
        state["master"] = tree_lib.tree_map(
            lambda p: p.to(torch.float32, copy=True), params)
    return state


def _global_norm(tree):
    total = 0
    for x in tree_lib.leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    """Returns (new_params, new_state, stats): stats holds the global
    gradient norm (before clipping) and the step's learning rate, 0-d
    fp32 tensors."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** _f32(step)
    bc2 = 1.0 - b2 ** _f32(step)
    masters = state.get("master", params)

    def upd(p, w, g, m, v):
        g = g.float() * scale
        w32 = w.float()
        m32, v32 = m.float(), v.float()
        m_new = b1 * m32 + (1 - b1) * g
        v_new = b2 * v32 + (1 - b2) * torch.square(g)
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        w_new = w32 - lr * (update + wd * w32)
        return (w_new.to(p.dtype), w_new.to(w.dtype), m_new.to(m.dtype),
                v_new.to(v.dtype))

    out = tree_lib.tree_map(upd, params, masters, grads, state["m"],
                            state["v"])
    new_params, new_master, new_m, new_v = (
        tree_lib.tree_map(lambda _, o: o[i], params, out) for i in range(4))
    new_state = {"m": new_m, "v": new_v, "step": step}
    if "master" in state:
        new_state["master"] = new_master
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}

