# Hand-written CUDA kernels for the ArrayFlex GEMM (csrc/), their ctypes
# build and bindings, and the planner-driven GEMM substrate above them.
