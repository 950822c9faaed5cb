"""Sharding rules the planner and the substrate share, the GEMM-dispatch
mesh scope and the pipeline pricing scope.

Port of the reference's ``parallel/sharding.py`` (the parameter
PartitionSpec trees and activation constraints, which only steer XLA's
partitioner, have no counterpart: the port's dispatch slices operands
itself):

* the mesh helpers (:func:`batch_axes`, :func:`all_axes`,
  :func:`_divisible`, :func:`_maybe`), the GEMM mesh scope
  (:class:`use_gemm_mesh`, :func:`mesh_from_config` over
  ``launch.mesh``'s :class:`~repro_torch.launch.mesh.DeviceMesh`) and
  :func:`gemm_mesh_scope`, which the lm entry points enter;
* the shard-context derivation the dispatch runs under a mesh:
  :func:`gemm_shard_ctx` (column-parallel sites shard their output
  columns over "model", row-parallel ones their contraction, every site
  its rows over "data"), :func:`batched_shard_ctx` (the attention
  products' B*KV axis) and :func:`expert_shard_ctx` (expert parallelism
  when ``E % tp == 0``);
* the framework-free rules ``core.planner`` imports (``_COL_SITES`` /
  ``_ROW_SITES``, :func:`batched_shard_count`) and the pipeline
  stage-transfer pricing (:data:`PP_BOUNDARY_SITE`,
  :func:`pp_transfer_terms`, :class:`use_pp_pricing`,
  :func:`pricing_shard_ctx`).

A spec is a tuple with one entry per operand dim: None (replicated), a
mesh axis name, or a tuple of names (the dim split over their product,
the first axis major), as a JAX ``PartitionSpec`` reads.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math

# The first GEMM a pipeline stage runs per layer: the one site per block
# that carries the role's stage-transfer terms, so the transfer is priced
# once, not once per GEMM.
PP_BOUNDARY_SITE = "attn.wq"

# (role, pp_stages) of the active pipeline-pricing scope, or None
_PP_PRICING: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_pp_pricing", default=None)


# ---------------------------------------------------------------------------
# mesh helpers

def mesh_axis_size(mesh, name: str) -> int:
    """Size of a mesh axis; 1 when there is no mesh or it lacks the axis
    (an absent axis means replication).  The single source of truth for
    every shard count (``_divisible``, the contexts below and the
    substrate's spec signatures)."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get(name, 1))


def batch_axes(mesh):
    """The axes the global batch shards over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def all_axes(mesh):
    return tuple(mesh.axis_names)


def _divisible(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    if isinstance(axes, str):
        axes = (axes,)
    return dim % math.prod(mesh_axis_size(mesh, a) for a in axes) == 0


def _maybe(dim: int, mesh, axes):
    """Use `axes` for this dim only if it divides evenly, else replicate."""
    return axes if _divisible(dim, mesh, axes) else None


# ---------------------------------------------------------------------------
# the GEMM-dispatch mesh, scoped through a context variable so model code
# stays mesh-agnostic (the lm entry points activate it from the config)

_GEMM_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_gemm_mesh", default=None)


class use_gemm_mesh:
    """Activate ``mesh`` for shard-context derivation (``None``
    deactivates)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._token = None

    def __enter__(self):
        self._token = _GEMM_MESH.set(self.mesh)
        return self

    def __exit__(self, *exc):
        _GEMM_MESH.reset(self._token)
        return False


def active_gemm_mesh():
    return _GEMM_MESH.get()


def _devices() -> tuple:
    from repro_torch.launch import mesh as mesh_lib
    return tuple(mesh_lib.devices())


@functools.lru_cache(maxsize=None)
def _host_mesh_on(data: int, model: int, devs: tuple):
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.make_host_mesh(data, model, strict=True)


def _host_mesh(data: int, model: int):
    """The strict (data, model) host mesh over the current devices (one
    mesh object per device list)."""
    return _host_mesh_on(data, model, _devices())


@functools.lru_cache(maxsize=None)
def _pod_mesh_on(pod: int, data: int, model: int, offset: int, devs: tuple):
    from repro_torch.launch import mesh as mesh_lib
    return mesh_lib.pod_mesh(pod, data, model, offset)


def _pod_mesh(pod: int, data: int, model: int, offset: int):
    """A ("pod", "data", "model") mesh over the device window ``[offset,
    offset + pod*data*model)``: a disaggregated role's slice of the host
    (prefill pods at offset 0, decode pods after them)."""
    return _pod_mesh_on(pod, data, model, offset, _devices())


def mesh_from_config(cfg):
    """The mesh ``cfg.mesh_shape`` declares, or None.

    A 2-tuple is the (data, model) host mesh; a 3-tuple is a (pod, data,
    model) role mesh windowed at ``cfg.pod_offset``, whose "pod" axis
    carries the pipeline stages (``parallel.pipeline``).  Strict: raises,
    with the fan-out hint, when fewer devices exist than the mesh needs
    (plans for a silently clamped mesh would price other shapes than the
    dispatch runs).  ``gemm_sharding="none"`` keeps replicated dispatch
    regardless of ``mesh_shape``."""
    shape = tuple(getattr(cfg, "mesh_shape", ()) or ())
    mode = getattr(cfg, "gemm_sharding", "auto")
    if mode not in ("auto", "none"):
        raise ValueError(f"unknown gemm_sharding {mode!r}; use auto|none")
    if not shape or mode == "none":
        return None
    if len(shape) == 3:
        return _pod_mesh(int(shape[0]), int(shape[1]), int(shape[2]),
                         int(getattr(cfg, "pod_offset", 0)))
    if len(shape) != 2:
        raise ValueError(f"mesh_shape must be (data, model) or "
                         f"(pod, data, model), got {shape}")
    return _host_mesh(int(shape[0]), int(shape[1]))


# ---------------------------------------------------------------------------
# pipeline-stage transfer pricing (disaggregated prefill/decode roles)

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
    itself runs unsharded (the pipeline's stage hop pays the transfer)."""
    from repro_torch.kernels.substrate import ShardCtx
    return ShardCtx(None, (None, None), (None, None), (None, None),
                    transfer_ops=transfer_ops,
                    transfer_cycles=transfer_cycles)


@contextlib.contextmanager
def gemm_mesh_scope(cfg):
    """Mesh + pipeline-pricing scope for a ModelConfig: the lm entry
    points wrap themselves in it, so every consumer (tests, the serving
    engines) gets sharded dispatch and per-role plan objectives from the
    config alone."""
    with use_gemm_mesh(mesh_from_config(cfg)), \
         use_pp_pricing(getattr(cfg, "pp_role", ""),
                        getattr(cfg, "pp_stages", 0)):
        yield


# ---------------------------------------------------------------------------
# shard contexts of the sharded dispatch

# dispatch-site (planner.model_gemms label) -> TP decomposition, mirroring
# the parameter rules: _IN_OUT weights column-parallel, _OUT_IN row-parallel
_COL_SITES = {"attn.wq", "attn.wk", "attn.wv", "xattn.wq", "xattn.kv",
              "mlp.wi_gate", "mlp.wi_up", "mlp.wi",
              "mamba.z", "mamba.xbc", "mamba.dt", "unembed", "lm_head"}
_ROW_SITES = {"attn.wo", "xattn.wo", "mlp.wo", "mamba.out"}


def gemm_shard_ctx(site: str, rows: int, K: int, N_out: int, mesh=None):
    """ShardCtx for a 2-D substrate GEMM dispatched at ``site`` (or None).

    Column-parallel sites shard ``N_out`` over "model"; row-parallel sites
    shard the contraction ``K`` over "model" (the partial sums add at the
    collapsed-block boundary, before the epilogue); every site shards the
    streamed ``rows`` over "data".  An axis that does not divide its dim
    replicates (the :func:`_maybe` rule); all-replicated returns None
    (unsharded dispatch).  A fused label like ``"mlp.wi_gate+mlp.wi_up"``
    takes its kind from the first component.

    Under an active :class:`use_pp_pricing` scope the boundary site
    (:data:`PP_BOUNDARY_SITE`) instead gets a pricing-only context with
    the role's stage-transfer terms — a role mesh runs data = model = 1,
    so pipeline pricing and TP sharding never need to merge."""
    pp = _PP_PRICING.get()
    if pp is not None and site == PP_BOUNDARY_SITE:
        t_ops, t_cyc = pp_transfer_terms(pp[0], pp[1], rows, K)
        return pricing_shard_ctx(transfer_ops=t_ops,
                                 transfer_cycles=t_cyc)
    mesh = mesh if mesh is not None else _GEMM_MESH.get()
    if mesh is None or not site:
        return None
    from repro_torch.kernels.substrate import ShardCtx
    head = site.split("+")[0]
    kind = ("col" if head in _COL_SITES
            else "row" if head in _ROW_SITES else "rep")
    dsize = mesh_axis_size(mesh, "data")
    dax = "data" if dsize > 1 and rows and rows % dsize == 0 else None
    tp = mesh_axis_size(mesh, "model")
    if kind == "col" and tp > 1 and N_out % tp == 0:
        return ShardCtx(mesh, (dax, None), (None, "model"), (dax, "model"))
    if kind == "row" and tp > 1 and K % tp == 0:
        return ShardCtx(mesh, (dax, "model"), ("model", None), (dax, None),
                        reduce_axes=("model",))
    if dax is None:
        return None
    return ShardCtx(mesh, (dax, None), (None, None), (dax, None))


def batched_shard_count(batch: int, dp: int, tp: int) -> int:
    """Shard count of a batched dispatch's leading axis: the
    ('data','model') -> 'model' -> 'data' divisibility chain.  The ONE
    definition the sharded dispatch (:func:`batched_shard_ctx`) and
    ``core.planner._postshard`` (analytic table) share, so the two can
    never drift: both must divide the same runtime batch (B*KV for
    attention) by the same factor."""
    if dp > 1 and tp > 1 and batch % (dp * tp) == 0:
        return dp * tp
    if tp > 1 and batch % tp == 0:
        return tp
    if dp > 1 and batch % dp == 0:
        return dp
    return 1


def batched_shard_ctx(batch: int, mesh=None):
    """ShardCtx splitting the leading batch dim of a batched GEMM (the
    attention QK/PV products' ``B*KV`` head axis) over the mesh: the full
    ("data", "model") split, else "model" (TP over heads), else "data".
    None when nothing divides.  Batch sharding never changes the
    per-element plan shape — only which device runs which heads."""
    mesh = mesh if mesh is not None else _GEMM_MESH.get()
    if mesh is None:
        return None
    from repro_torch.kernels.substrate import ShardCtx
    d, m = mesh_axis_size(mesh, "data"), mesh_axis_size(mesh, "model")
    s = batched_shard_count(batch, d, m)
    if s == 1:
        return None
    if d > 1 and m > 1 and s == d * m:
        ax = ("data", "model")
    elif m > 1 and s == m:
        ax = "model"
    else:
        ax = "data"
    spec = (ax, None, None)
    return ShardCtx(mesh, spec, spec, spec)


def expert_shard_ctx(num_experts: int, mesh=None):
    """Expert-parallel ShardCtx for ``substrate.expert_gemm``: the expert
    axis splits over "model" when E divides the TP degree, else None
    (replicated dispatch)."""
    mesh = mesh if mesh is not None else _GEMM_MESH.get()
    if mesh is None:
        return None
    tp = mesh_axis_size(mesh, "model")
    if tp <= 1 or num_experts % tp:
        return None
    from repro_torch.kernels.substrate import ShardCtx
    return ShardCtx(mesh, (None, "model", None, None),
                    ("model", None, None), (None, "model", None, None))
