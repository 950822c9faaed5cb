"""Sharding rules the planner and the substrate share, and the pipeline
pricing scope.

Port of the reference's ``parallel/sharding.py``, in two parts so far:

* the framework-free rules ``core.planner._postshard`` and the role-mesh
  branch of ``core.planner.model_gemms`` import: the dispatch-site
  tensor-parallel decomposition (``_COL_SITES`` / ``_ROW_SITES``), the
  batched-dispatch shard count (:func:`batched_shard_count`) and the
  pipeline stage-transfer pricing (:data:`PP_BOUNDARY_SITE`,
  :func:`pp_transfer_terms`), verbatim apart from import paths;
* the pricing half of the GEMM scope: :class:`use_pp_pricing` (the
  ``_PP_PRICING`` context variable), :func:`pricing_shard_ctx`,
  :func:`gemm_mesh_scope` and the pricing branch of
  :func:`gemm_shard_ctx`.  Inside a role's scope the boundary site gets a
  pricing-only ``ShardCtx`` (``mesh is None``): its plan re-picks ``k``
  under the role's transfer terms and the dispatch runs unsharded, as in
  the reference, so a disaggregated engine's roles plan apart on one card.

The mesh itself waits for the mesh slice: ``torch.distributed`` meshes,
the ``ShardCtx`` dispatch with a mesh, ``batched_shard_ctx`` /
``expert_shard_ctx`` and the GPipe stages.  Until then
:func:`check_mesh` refuses a config whose ``mesh_shape`` would shard a
GEMM, and no site gets a context with a mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

# The first GEMM a pipeline stage runs per layer: the one site per block
# that carries the role's stage-transfer terms, so the transfer is priced
# once, not once per GEMM.
PP_BOUNDARY_SITE = "attn.wq"

# (role, pp_stages) of the active pipeline-pricing scope, or None
_PP_PRICING: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_pp_pricing", default=None)


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


class use_pp_pricing:
    """Activate per-role pipeline transfer pricing: inside this scope,
    :func:`gemm_shard_ctx` hands the boundary site a pricing-only
    ShardCtx carrying the role's transfer terms.  Inert unless both a
    role and ``pp_stages > 1`` are given."""

    def __init__(self, role: str, pp_stages: int):
        self.value = ((role, int(pp_stages))
                      if role and pp_stages and pp_stages > 1 else None)
        self._token = None

    def __enter__(self):
        self._token = _PP_PRICING.set(self.value)
        return self

    def __exit__(self, *exc):
        _PP_PRICING.reset(self._token)
        return False


def active_pp_pricing():
    return _PP_PRICING.get()


def pricing_shard_ctx(transfer_ops: int = 0, transfer_cycles: int = 0):
    """A pricing-only ShardCtx (``mesh=None``, replicated specs): the plan
    is keyed and priced with the transfer terms — ``best_k`` re-picks
    under them and the plan cache separates the roles — but the dispatch
    itself runs unsharded."""
    from repro_torch.kernels.substrate import ShardCtx
    return ShardCtx(None, (None, None), (None, None), (None, None),
                    transfer_ops=transfer_ops,
                    transfer_cycles=transfer_cycles)


def mesh_axis_size(mesh, name: str) -> int:
    """Size of a mesh axis; 1 when there is no mesh or it lacks the axis
    (an absent axis means replication)."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get(name, 1))


MESH_SLICE = ("the mesh slice (torch.distributed meshes and the sharded "
              "GEMM dispatch) is not ported yet")


def check_mesh(cfg) -> None:
    """Refuse a ``mesh_shape`` the port cannot honour yet.

    The reference's ``mesh_from_config`` builds a mesh from a 2-axis
    (data, model) shape or a 3-axis (pod, data, model) one, unless
    ``gemm_sharding`` is "none".  A 3-axis mesh whose data and model axes
    are 1 shards no GEMM outside the pipeline (every site's context is
    replicated or the boundary site's pricing-only one), so it plans and
    runs here on one device; any other mesh would shard the dispatch and
    raises, never silently ignored."""
    shape = tuple(getattr(cfg, "mesh_shape", ()) or ())
    mode = getattr(cfg, "gemm_sharding", "auto")
    if mode not in ("auto", "none"):
        raise ValueError(f"unknown gemm_sharding {mode!r}; use auto|none")
    if not shape or mode == "none":
        return
    if len(shape) not in (2, 3):
        raise ValueError(f"mesh_shape must be (data, model) or "
                         f"(pod, data, model), got {shape}")
    if len(shape) == 2 or shape[1] > 1 or shape[2] > 1:
        raise NotImplementedError(
            f"mesh_shape={shape} shards the GEMM dispatch: {MESH_SLICE}; "
            f"use mesh_shape=() (or a (pod, 1, 1) role mesh for pipeline "
            f"pricing) or gemm_sharding='none'")


@contextlib.contextmanager
def gemm_mesh_scope(cfg):
    """Mesh + pipeline-pricing scope for a ModelConfig: the lm entry
    points wrap themselves in it, so the serving engine's roles get their
    plan objectives from the config alone.  The mesh half enters no mesh
    until the mesh slice (:func:`check_mesh` refuses one that would
    shard); the pricing half is the reference's."""
    check_mesh(cfg)
    with use_pp_pricing(getattr(cfg, "pp_role", ""),
                        getattr(cfg, "pp_stages", 0)):
        yield


# dispatch-site (planner.model_gemms label) -> TP decomposition, mirroring
# the parameter rules: _IN_OUT weights column-parallel, _OUT_IN row-parallel
_COL_SITES = {"attn.wq", "attn.wk", "attn.wv", "xattn.wq", "xattn.kv",
              "mlp.wi_gate", "mlp.wi_up", "mlp.wi",
              "mamba.z", "mamba.xbc", "mamba.dt", "unembed", "lm_head"}
_ROW_SITES = {"attn.wo", "xattn.wo", "mlp.wo", "mamba.out"}


def gemm_shard_ctx(site: str, rows: int, K: int, N_out: int, mesh=None):
    """ShardCtx for a 2-D substrate GEMM dispatched at ``site`` (or None).

    Under an active :class:`use_pp_pricing` scope the boundary site
    (:data:`PP_BOUNDARY_SITE`) gets a pricing-only context with the
    role's stage-transfer terms, as in the reference.  Every other site
    dispatches unsharded (None): the reference's mesh branch — column-
    and row-parallel contexts over an active mesh — comes with the mesh
    slice, and a mesh passed here raises."""
    pp = _PP_PRICING.get()
    if pp is not None and site == PP_BOUNDARY_SITE:
        t_ops, t_cyc = pp_transfer_terms(pp[0], pp[1], rows, K)
        return pricing_shard_ctx(transfer_ops=t_ops,
                                 transfer_cycles=t_cyc)
    if mesh is not None:
        raise NotImplementedError(f"gemm_shard_ctx with a mesh: "
                                  f"{MESH_SLICE}")
    return None


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
