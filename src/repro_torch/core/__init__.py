"""Core: the paper's timing/power models, the planner and the CNN GEMM
shapes (verbatim copies of the reference's framework-free modules), and
the bit-level systolic-tile simulator on torch tensors."""
