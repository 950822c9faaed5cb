"""Parallel execution: the port's ``parallel/sharding.py`` (the sharding
rules the planner reads, the GEMM-dispatch mesh scope and the shard
contexts of the sharded dispatch, the pipeline-pricing scope) and
``parallel/pipeline.py`` (the single-controller GPipe schedules over a
mesh's "pod" axis and the pipeline-depth cost model)."""
