"""Core: the paper's timing/power models and the planner (verbatim copies of
the reference's framework-free modules)."""
