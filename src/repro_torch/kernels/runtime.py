"""Device resolution shared by every entry point of the port.

The counterpart of the reference's ``kernels/runtime.py``: where the JAX
package chose between a compiled Pallas kernel and interpret mode, the
port chooses the device.  There is no fallback: the default is the card,
the CPU runs only when the caller asks for it, and a missing card raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises when no
    card is present); ``"cpu"`` -> the CPU, where every kernel wrapper
    runs its plain PyTorch version.  Anything else raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' "
                         f"(the default) or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(t, dev):
    """``t`` on ``dev``: itself when it lies there (or is not a tensor: a
    Python scalar, None), else a copy."""
    if not torch.is_tensor(t) or t.device == dev:
        return t
    return t.to(dev)
