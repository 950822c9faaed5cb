"""Sharding rules: logical parameter / activation axes -> mesh specs, the
GEMM-dispatch mesh scope and the pipeline pricing scope.

Port of the reference's ``parallel/sharding.py``.  Mesh axes: ``pod``
(inter-pod; the pipeline dim in ``parallel.pipeline``), ``data`` (FSDP /
batch) and ``model`` (tensor parallel).  It holds:

* the mesh helpers (:func:`batch_axes`, :func:`all_axes`,
  :func:`_divisible`, :func:`_maybe`);
* the spec tables, with the reference's names and rules: the parameter
  specs (:func:`param_pspec_tree` over ``_IN_OUT`` / ``_OUT_IN`` / the
  ``_MOE_EP`` toggle, :func:`named`), the input and cache specs
  (:func:`token_pspec`, :func:`activation_pspec`, :func:`kv_cache_pspec`,
  :func:`ssm_state_pspec`, :func:`conv_state_pspec`) and the activation
  rules (:func:`activation_rules`, :class:`use_activation_rules`,
  :func:`constrain`).  In the reference they steer XLA's partitioner; on
  the port's single controller every tensor is held whole on the mesh's
  home device and the dispatch slices each GEMM's operands itself, so a
  spec says where a shard *would* live (``runtime.elastic.reshard``
  checks the specs against the shapes, ``models.api``'s ``*_pspecs`` give
  the dry run's tables) and :func:`constrain` resolves its rule and
  returns the tensor unchanged;
* the GEMM mesh scope (:class:`use_gemm_mesh`, :func:`mesh_from_config`
  over ``launch.mesh``'s :class:`~repro_torch.launch.mesh.DeviceMesh`)
  and :func:`gemm_mesh_scope`, which the lm entry points enter;
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
from dataclasses import dataclass

from repro_torch import tree as tree_lib

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
# parameter rules, keyed by (parent, leaf) path suffix

# (in, out) 2D GEMM weights: in->data (FSDP), out->model (TP)
_IN_OUT = {"wq", "wk", "wv", "wi_gate", "wi_up", "wi", "z_proj", "xbc_proj",
           "img_proj", "audio_proj"}
# (in, out) with in->model (TP reduce), out->data
_OUT_IN = {"wo", "out_proj"}
# module-level toggle set by param_pspec_tree per call (E % tp == 0)
_MOE_EP = False


def _param_spec_parts(path_names, leaf) -> tuple:
    """Spec entries for the *trailing* (un-stacked) dims of a leaf."""
    names = [str(n) for n in path_names]
    parent = names[-2] if len(names) >= 2 else ""
    name = names[-1]
    nd = leaf.ndim
    if name == "table":                        # embedding (vocab, d)
        return ("model", "data")
    if name == "b":
        return (_spec_bias(parent),)
    if parent in _IN_OUT and name == "w":
        return ("data", "model")
    if parent in _OUT_IN and name == "w":
        return ("model", "data")
    if parent == "dt_proj" and name == "w":
        return ("data", "model")
    if parent == "lm_head" and name == "w":
        return ("data", "model")
    if name == "router":
        return ("data", None)
    # MoE expert banks: trailing dims (E, d, ff) / (E, ff, d); expert
    # parallel (E over "model") when E divides the TP degree, else the
    # tensor-parallel ff entry survives as the fallback
    if name in ("wi_gate", "wi_up") and parent == "moe":
        return ("model", "data", None) if _MOE_EP else (None, "data", "model")
    if name == "wo" and parent == "moe":
        return ("model", None, "data") if _MOE_EP else (None, "model", "data")
    if name == "conv_w":
        return (None, "model")
    if name == "conv_b":
        return ("model",)
    return (None,) * nd


def _spec_bias(parent: str):
    if parent in _IN_OUT or parent == "dt_proj" or parent == "lm_head":
        return "model"
    return None


def param_pspec_tree(params, mesh, stacked_prefixes=("blocks", "enc_blocks"),
                     moe_experts: int = 0):
    """Spec tree for a parameter tree (leaves: anything with ``shape`` /
    ``ndim``, e.g. ``models.api.abstract_params``' meta tensors).

    Leading dims beyond a rule's trailing entries (the ``n_super`` stack
    of the leaves under ``stacked_prefixes``) get None.  An axis that does
    not divide its dim falls back to replication.  ``moe_experts`` (when
    the model has MoE layers) selects expert-parallel against
    tensor-parallel expert specs."""
    global _MOE_EP
    _MOE_EP = bool(moe_experts) and _divisible(moe_experts, mesh, "model")

    def spec_for(path, leaf):
        parts = list(_param_spec_parts(path, leaf))
        offset = leaf.ndim - len(parts)
        if offset < 0:
            parts = parts[-leaf.ndim:] if leaf.ndim else []
            offset = 0
        full = [None] * offset + parts
        for i, ax in enumerate(full):
            if ax is not None and not _divisible(leaf.shape[i], mesh, ax):
                full[i] = None
        return tuple(full)

    return tree_lib.map_with_path(spec_for, params)


def _P(*entries) -> tuple:
    """A spec from its entries, normalized as a ``PartitionSpec`` is: a
    one-axis tuple entry is that axis's name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _spec_axes(entry) -> tuple:
    """The mesh axes one spec entry names (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def is_spec(x) -> bool:
    """True for a spec leaf of a spec tree: a tuple of None, axis names and
    tuples of axis names (a parameter tree's tuples hold dicts)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def map_specs(fn, tree):
    """``fn(spec)`` over every spec leaf of ``tree``."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return type(tree)(map_specs(fn, v) for v in tree)


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``jax.sharding.NamedSharding``;
    ``runtime.elastic.reshard`` checks a leaf against it)."""
    mesh: object
    spec: tuple


def named(tree_of_pspecs, mesh):
    return map_specs(lambda s: NamedSharding(mesh, s), tree_of_pspecs)


# ---------------------------------------------------------------------------
# activation / input / cache specs

def token_pspec(mesh, global_batch: int):
    ax = batch_axes(mesh)
    return _P(_maybe(global_batch, mesh, ax), None)


def activation_pspec(mesh, global_batch: int):
    ax = batch_axes(mesh)
    return _P(_maybe(global_batch, mesh, ax), None, None)


def kv_cache_pspec(mesh, global_batch: int, cache_len: int, *,
                   stacked: bool = True):
    """(n_super, B, S, KV, hd).  Batch over the data axes when divisible,
    else the sequence dim over everything (long-context decode)."""
    bax = _maybe(global_batch, mesh, batch_axes(mesh))
    if bax is not None and global_batch >= math.prod(
            mesh.shape[a] for a in batch_axes(mesh)):
        seq = _maybe(cache_len, mesh, "model")
        spec = (bax, seq, None, None)
    else:
        seq = _maybe(cache_len, mesh, all_axes(mesh))
        spec = (None, seq, None, None)
    return _P(*((None,) + spec if stacked else spec))


def ssm_state_pspec(mesh, global_batch: int, heads_per_group: int, *,
                    stacked: bool = True):
    """(n_super, B, G, hg, P, N)."""
    bax = _maybe(global_batch, mesh, batch_axes(mesh))
    hax = _maybe(heads_per_group, mesh, "model")
    spec = (bax, None, hax, None, None)
    return _P(*((None,) + spec if stacked else spec))


def conv_state_pspec(mesh, global_batch: int, channels: int, *,
                     stacked: bool = True):
    """(n_super, B, K-1, ch)."""
    bax = _maybe(global_batch, mesh, batch_axes(mesh))
    cax = _maybe(channels, mesh, "model")
    spec = (bax, None, cax)
    return _P(*((None,) + spec if stacked else spec))


# ---------------------------------------------------------------------------
# activation constraints (scoped through a context variable so model code
# stays mesh-agnostic; inert outside the trainer's scope)

_ACT_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_activation_rules", default=None)


def activation_rules(mesh, global_batch: int, cfg=None, kind: str = "train"):
    """The activation constraint set for a (mesh, batch[, model cfg]).

    Full-sequence passes (train / prefill) shard hidden states over
    "model" along the sequence between blocks (Megatron-SP); decode
    (S = 1) keeps them replicated over "model"."""
    bax = _maybe(global_batch, mesh, batch_axes(mesh))
    seq = "model" if kind != "decode" else None
    rules = {
        "hidden": _P(bax, seq, None),            # (B, S, d)
        "logits": _P(bax, None, "model"),        # (B, S, vocab)
        "micro_batch": _P(None, bax, None),      # (n_micro, B/n, S)
        # sequence-sharded attention: q rows over "model", KV replicated
        "attn_qkv": _P(bax, None, None, None),         # (B, T, KV, hd) k/v
        "attn_q_seq": _P(bax, "model", None, None, None),  # (B,S,KV,g,d)
        "attn_stat_seq": _P(bax, "model", None, None),     # (B,S,KV,g)
        "attn_scores_seq": _P(bax, None, None, "model", None),
        # (B,KV,g,S,T)
    }
    if cfg is not None:
        mdl = "model"
        ssm = getattr(cfg, "ssm", None)
        if ssm is not None:
            H = cfg.ssm_heads
            conv_ch = cfg.d_inner + 2 * ssm.n_groups * ssm.d_state
            rules["mamba_xbc"] = _P(bax, None, _maybe(conv_ch, mesh, mdl))
            rules["ssm_x"] = _P(bax, None, _maybe(H, mesh, mdl), None)
        if getattr(cfg, "moe", None) is not None:
            E = cfg.moe.num_experts
            if _divisible(E, mesh, mdl):
                # expert parallel: E over "model"
                rules["moe_buf4"] = _P(bax, mdl, None, None)
                rules["moe_h4"] = _P(bax, mdl, None, None)
            else:
                # TP fallback: (G, E, cap, ff) splits ff over "model"
                rules["moe_buf4"] = _P(bax, None, None, None)
                rules["moe_h4"] = _P(bax, None, None, "model")
    return rules


class use_activation_rules:
    def __init__(self, rules):
        self.rules = rules
        self._token = None

    def __enter__(self):
        self._token = _ACT_RULES.set(self.rules)
        return self

    def __exit__(self, *exc):
        _ACT_RULES.reset(self._token)
        return False


def constraint_spec(name: str, ndim: int):
    """The spec :func:`constrain` resolves for a rank-``ndim`` tensor under
    the active rules (the rule padded with None, or cut, to ``ndim``), or
    None when no rule applies."""
    rules = _ACT_RULES.get()
    if not rules or name not in rules:
        return None
    spec = rules[name]
    if spec is None:
        return None
    parts = list(spec) + [None] * (ndim - len(spec))
    return tuple(parts[:ndim])


def constrain(x, name: str):
    """Apply a named activation constraint if rules are active.

    The reference pins ``x``'s layout for XLA's partitioner here.  A
    single controller holds every tensor whole (the sharded dispatch
    slices each GEMM's operands at launch), so the port resolves the rule
    as the reference does (:func:`constraint_spec`) and returns ``x``
    itself."""
    constraint_spec(name, x.ndim)
    return x


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
