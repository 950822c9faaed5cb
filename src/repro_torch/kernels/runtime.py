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


def check_no_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and a kernel wrapper's operand requires
    a gradient: a hand-written kernel records no autograd graph, so its
    output would carry no ``grad_fn`` (a silent zero gradient).  Training
    runs on the ``xla`` / ``ref`` backends (``models.lm.check_trainable``)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an operand requires a gradient, and the kernel has no "
            f"backward pass; run it under torch.no_grad() or train on the "
            f"'xla' or 'ref' gemm backend")
