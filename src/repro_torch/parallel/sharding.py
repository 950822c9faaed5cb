"""Sharding rules the planner shares with the (not yet ported) sharded
dispatch.

Port of the framework-free part of the reference's
``parallel/sharding.py``: the dispatch-site tensor-parallel decomposition
(``_COL_SITES`` / ``_ROW_SITES``), the batched-dispatch shard count
(:func:`batched_shard_count`) and the pipeline stage-transfer pricing
(:data:`PP_BOUNDARY_SITE`, :func:`pp_transfer_terms`), verbatim apart
from import paths.  ``core.planner._postshard`` and the role-mesh branch
of ``core.planner.model_gemms`` import them.  The mesh, ``ShardCtx`` and
the scopes that hand a mesh to the substrate come with the sharded
dispatch.
"""
from __future__ import annotations

import math

# The first GEMM a pipeline stage runs per layer: the one site per block
# that carries the role's stage-transfer terms, so the transfer is priced
# once, not once per GEMM.
PP_BOUNDARY_SITE = "attn.wq"


def pp_transfer_terms(role: str, pp_stages: int, rows: int, K: int):
    """(transfer_ops, transfer_cycles) for a role's stage boundary.

    prefill: ``ceil(log2(pp))`` boundary ops — the send pipelines like a
    reduction hop and prices into the per-step period.  decode:
    ``ceil(rows * K / SA_C)`` serialized cycles — the (rows, K)
    activation enters the array at C lanes per cycle before the schedule
    starts.
    """
    if pp_stages <= 1 or not role:
        return (0, 0)
    if role == "prefill":
        return (max(1, math.ceil(math.log2(pp_stages))), 0)
    if role == "decode":
        from repro_torch.kernels.ops import SA_C
        return (0, -(-(rows * K) // SA_C))
    raise ValueError(f"unknown pp_role {role!r}; use prefill|decode")


# dispatch-site (planner.model_gemms label) -> TP decomposition, mirroring
# the parameter rules: _IN_OUT weights column-parallel, _OUT_IN row-parallel
_COL_SITES = {"attn.wq", "attn.wk", "attn.wv", "xattn.wq", "xattn.kv",
              "mlp.wi_gate", "mlp.wi_up", "mlp.wi",
              "mamba.z", "mamba.xbc", "mamba.dt", "unembed", "lm_head"}
_ROW_SITES = {"attn.wo", "xattn.wo", "mlp.wo", "mamba.out"}


def batched_shard_count(batch: int, dp: int, tp: int) -> int:
    """Shard count of a batched dispatch's leading axis: the
    ('data','model') -> 'model' -> 'data' divisibility chain.  The ONE
    definition the sharded dispatch and ``core.planner._postshard``
    (analytic table) share, so the two can never drift: both must divide
    the same runtime batch (B*KV for attention) by the same factor."""
    if dp > 1 and tp > 1 and batch % (dp * tp) == 0:
        return dp * tp
    if tp > 1 and batch % tp == 0:
        return tp
    if dp > 1 and batch % dp == 0:
        return dp
    return 1
