"""Parallel planning: the port's copy of the reference's
``parallel/sharding.py`` — the framework-free sharding rules the planner
reads, and the pipeline-pricing scope (``use_pp_pricing``,
``gemm_mesh_scope``, the pricing branch of ``gemm_shard_ctx``) that a
disaggregated engine's roles plan under on one device.  The mesh-bound
dispatch (``torch.distributed`` meshes, a ``ShardCtx`` with a mesh,
``batched_shard_ctx`` / ``expert_shard_ctx``, GPipe stages) waits for the
mesh slice."""
