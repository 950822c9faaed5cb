"""Parallel planning: the port's copy of the reference's framework-free
sharding names (``parallel/sharding.py``) that the planner reads.  The
mesh-bound dispatch (``ShardCtx``, the sharded substrate) is not ported
yet."""
