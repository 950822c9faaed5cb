"""Parameter trees from the reference package into the port.

``params_from_reference`` takes the JAX package's parameter tree as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``: ``blocks`` is a
tuple of stacked per-period dicts with the leading ``n_super`` axis, as
``repro.models.lm.init_params`` builds it) and returns the port's tree,
leaf for leaf, so both packages compute the same function.  The port's
tree has the same layout, so the conversion is a leaf-wise copy.  A tree
that the reference's ``lm.prequantize_params`` built holds quantized
leaves (``codes`` and ``scale`` attributes, still numpy arrays after the
``tree_map``): each becomes the port's ``substrate.QuantizedTensor`` with
int8 codes and fp32 scales.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import substrate
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import lm


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no native bf16: widen
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)   # exact round trip
    return torch.from_numpy(np.array(a)).to(device)       # a writable copy


def params_from_reference(cfg: ModelConfig, np_tree, device=None):
    """The port's parameter tree holding the reference tree's values."""
    lm.check_supported(cfg)
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(walk(v) for v in node)
        if hasattr(node, "codes") and hasattr(node, "scale"):
            return substrate.QuantizedTensor(
                _to_tensor(node.codes, dev).to(torch.int8),
                _to_tensor(node.scale, dev).float())
        return _to_tensor(node, dev)

    return walk(np_tree)
