"""PyTorch / CUDA port of the ArrayFlex serving stack.

Mirrors the layout of the JAX package ``repro`` module for module, so each
module here has a counterpart of the same path there.  Plain tensor code
is PyTorch; the Pallas TPU GEMM kernels are hand-written CUDA kernels for
Hopper (``kernels/csrc``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
