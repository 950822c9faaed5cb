"""Int8 error-feedback gradient compression for the data-parallel
all-reduce.

Port of the reference's ``parallel/compression.py``.  Data-parallel
gradient traffic dominates the inter-pod links, and int8 codes cut it 4x
against fp32 (2x against bf16).  Per-tensor symmetric scales; the
quantization residual is carried to the next step in bf16 (error
feedback).

The numbers are the reference's bit for bit:

* :func:`compress` is its eager ``compress``: ``scale = max(amax, 1e-12)
  / 127`` and ``codes = clip(round(g / scale), -127, 127)``, round half to
  even, both IEEE divisions by tensors (PyTorch's CUDA division by a
  Python scalar multiplies by the reciprocal);
* ``compiled=True`` is what XLA makes of the same lines inside a compiled
  step (the reference's ``compressed_allreduce`` runs under
  ``shard_map``): the scale ``max(amax, 1e-12) * fp32(1/127)``, and the
  residual ``g - codes * scale`` contracted into one fused multiply-add
  (computed here in fp64, where the product and the difference are
  exact, then rounded once to fp32).

:func:`compressed_allreduce` is the single controller's counterpart of
the reference's collective: it takes one gradient tree per shard of the
mesh axis, in shard order, and sums the shards' int8 codes as int32 (the
``psum``).  As in the reference, each shard scales the summed codes by
its **own** scale, so shards whose scales differ get different "means"
(ROADMAP Queue 3 records it as a fact about the reference).

Usage in a train step over ``n`` data shards:
    means, errors = compressed_allreduce(shard_grads, shard_errors)
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels.arrayflex_gemm import INV_127
from repro_torch.roofline import trace as _trace


def init_error(params):
    """bf16 zeros shaped like each leaf of ``params``."""
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                              device=p.device), params)


def _compress_leaf(g, e, compiled: bool):
    g = g.float() + e.float()
    amax = torch.clamp(g.abs().max(), min=1e-12)
    if compiled:
        scale = amax * torch.full_like(amax, INV_127)
    else:
        scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    if compiled:
        err = (g.double() - q.double() * scale.double()).float()
    else:
        err = g - q.float() * scale
    return q, scale, err.to(torch.bfloat16)


def compress(grads, error, *, compiled: bool = False):
    """-> (int8 tree, fp32 scale tree, new bf16 error tree)."""
    errs = dict(tree_lib.leaves_with_path(error))
    out = {path: _compress_leaf(g, errs[path], compiled)
           for path, g in tree_lib.leaves_with_path(grads)}
    return tuple(tree_lib.map_with_path(lambda path, _: out[path][i], grads)
                 for i in range(3))


def decompress(q, scales, dtype=torch.float32):
    return tree_lib.tree_map(
        lambda qq, ss: (qq.float() * ss).to(dtype), q, scales)


def compressed_allreduce(grads, errors):
    """Error-feedback int8 all-reduce over one mesh axis.

    ``grads`` / ``errors``: one tree per shard of the axis, in shard
    order.  Each shard compresses its own tree (the compiled form, as
    under the reference's ``shard_map``); the codes are summed as int32
    over the shards in order; shard ``i``'s mean is ``sum * scale_i / n``
    with its own scale.  Returns (one mean tree per shard, one new error
    tree per shard)."""
    n = len(grads)
    if n != len(errors) or n == 0:
        raise ValueError(f"{n} gradient trees against {len(errors)} error "
                         f"trees: give one of each per shard")
    packed = [compress(g, e, compiled=True) for g, e in zip(grads, errors)]
    _trace.collective("all-reduce", packed[0][0], n)
    summed = tree_lib.tree_map(lambda q: q.to(torch.int32), packed[0][0])
    for q, _, _ in packed[1:]:
        summed = tree_lib.tree_map(lambda a, b: a + b.to(torch.int32),
                                   summed, q)
    div = lambda t: torch.full_like(t, float(n))
    means = [tree_lib.tree_map(lambda qq, ss: qq.float() * ss / div(ss),
                               summed, s) for _, s, _ in packed]
    return means, [e for _, _, e in packed]
