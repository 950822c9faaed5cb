"""Unified LM model family: dense / MoE / hybrid (Jamba) / SSM / VLM /
audio.

Port of the reference's ``models/lm.py``.  Layers are grouped into
*super-blocks* of ``period(cfg)`` sub-layers, and parameter and cache leaves
of ``blocks`` carry a leading ``n_super`` stack dim, as in the reference;
where the reference scans over that dim, the port loops over it eagerly and
works on per-layer views.

The K/V cache is updated **in place**: where the reference rebuilds the
whole cache buffer with ``jnp.where`` on every step, ``attn_decode`` and
``attn_prefill`` write only the new rows into the cache tensors they are
given (which ``decode_step``/``prefill_step`` then return).  The values
written are the same.

An MoE sub-layer (``family == "moe"``) runs attention, then the ln2
rmsnorm and ``nn.moe.moe_apply`` in one global dispatch group at decode
(capacity factor at least 2.0), as the reference's decode path does.  MoE
capacity routing couples the rows of a dispatch, so MoE models prefill
token by token (``supports_batched_prefill`` is False for them).

``forward`` and ``prefill`` run the full sequence at once: attention is
dense up to ``attn_dense_below`` query rows and the chunked scan above
(``nn.attention.attention``), an MoE sub-layer routes one dispatch group
per sequence at the config's capacity factor and adds its aux loss.

The paged steps (``decode_step_paged`` / ``prefill_step_paged``, dense
family only: ``supports_paged_kv``) run against the engine's page pools
(``init_paged_cache``): each layer gathers its block tables' logical view
of the dense cache's length, so they dispatch the same GEMMs as the
dense steps; the pools are updated in place.

A mamba sub-layer (``sublayer_kind(...)["mixer"] == "mamba"``: every
layer of the SSM family, seven of each eight of the hybrid) runs
``nn.mamba``: the chunked SSD scan in ``forward``/``prefill``, the
one-token recurrence in ``decode_step``.  Its cache entry is the fp32
recurrent ``state`` and the ``conv`` window in the cache dtype.  Unlike
the K/V rows, the recurrent leaves are **not** updated in place:
``decode_step`` writes each layer's new state into fresh stacked tensors
and returns them in a new cache tuple, leaving the input's untouched, so
a step that faults part way (or whose logits a caller rejects) can be run
again on the same cache and give a clean step's bytes — the reference's
functional steps behave so.  A sub-layer without an MLP (``d_ff == 0``
outside the MoE layers, as full-width mamba2-370m) has no ln2.

A sliding window (``cfg.sliding_window``) clamps the K/V cache to the
window (``cache_len``) and makes it a ring: decode writes position ``pos``
at slot ``pos % cache_len`` and attends the whole ring once it is full
(``nn.attention.decode_attention(window=)``); ``forward``'s cache keeps
the last ``cache_len`` rows, rolled so that each sits at its ring slot.

A cross-attending sub-layer (``sublayer_kind(...)["cross"]``: every
``cross_attn_every``-th layer of the VLM family, every decoder layer of
the audio family) follows its mixer with the ``lnx`` rmsnorm and
non-causal, RoPE-free attention to a context: the ``frontend.img``
projection of ``batch["image_embeds"]``, or the audio encoder's output
(``_encode_audio``: the ``frontend.audio`` projection of
``batch["frames"]``, then non-causal RoPE'd self-attention + swiglu
layers).  ``forward`` caches the context's K/V as the ``xk`` / ``xv``
leaves; decode reads them and never writes them.  Served from
``init_cache``, they are zeros, as in the reference's engine, which has
no request field for a context.

``loss_fn`` (training) differentiates ``forward`` on the raw parameter
tree on the ``xla`` and ``ref`` backends; the collapse backends raise
(:func:`check_trainable`).  Under autograd each super-block of
``forward`` and each encoder layer of ``encode_audio`` runs under
``cfg.remat`` (:func:`_remat`), and the hidden states and logits pass
``parallel.sharding.constrain`` at the reference's points.

The entry points (``forward``, ``decode_step``, ``prefill_step``, the
paged steps and the pipelined ones) run inside
``parallel.sharding.gemm_mesh_scope(cfg)``, as the reference's do: a
``mesh_shape`` activates the sharded GEMM dispatch (every site derives
its shard context, and the substrate plans and launches per shard), and
a config's ``pp_role`` / ``pp_stages`` price the pipeline stage boundary
into the boundary site's plan (``attn.wq`` re-picks k under the role's
transfer terms; the values do not change).  ``decode_step_pp`` /
``prefill_step_pp`` run the dense stack as GPipe stages over a role
mesh's "pod" axis (``parallel.pipeline.staged_step``).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import substrate
from repro_torch.kernels.runtime import resolve_device, to_device
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import layers
from repro_torch.nn import mamba as mamba_lib
from repro_torch.nn import moe as moe_lib
from repro_torch.parallel import sharding

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# MoE expert-bank leaves ((n_super, E, K, N) once stacked): GEMM weights
# like a linear's ``w``; the router beside them stays fp32
_EXPERT_BANKS = ("wi_gate", "wi_up", "wo")


# ---------------------------------------------------------------------------
# structure helpers

def _lcm(a, b):
    return a * b // math.gcd(a, b)


def period(cfg: ModelConfig) -> int:
    p = 1
    if cfg.family == "hybrid":
        p = _lcm(p, cfg.hybrid_period)
    if cfg.family == "vlm":
        p = _lcm(p, cfg.cross_attn_every)
    if cfg.moe is not None:
        p = _lcm(p, cfg.moe.moe_every)
    assert cfg.n_layers % p == 0, (cfg.n_layers, p)
    return p


def n_super(cfg: ModelConfig) -> int:
    return cfg.n_layers // period(cfg)


def sublayer_kind(cfg: ModelConfig, pos: int) -> dict:
    return dict(
        mixer="attn" if cfg.is_attn_layer(pos) else "mamba",
        cross=cfg.is_cross_attn_layer(pos) or cfg.family == "audio",
        mlp=("moe" if cfg.is_moe_layer(pos) else
             ("dense" if cfg.d_ff else None)),
    )


def _cdtype(cfg):
    return _DTYPES[cfg.compute_dtype]


def _pdtype(cfg):
    return _DTYPES[cfg.param_dtype]


def cross_len(cfg: ModelConfig) -> int:
    return (cfg.n_image_tokens if cfg.family == "vlm"
            else cfg.max_source_positions)


def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    return min(cfg.sliding_window, max_seq) if cfg.sliding_window else max_seq


def _ssm(cfg: ModelConfig) -> SSMConfig:
    return cfg.ssm or SSMConfig()


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a model family the port does not know (every registered
    arch's family runs)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown model family {cfg.family!r}; the port "
            f"runs {', '.join(FAMILIES)}")


def _device(device) -> torch.device:
    """``kernels.runtime.resolve_device``, and ``"meta"``: tensors with a
    shape and a dtype and no storage (``models.api``'s abstract trees)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``, as the reference's ``_remat``: "none"
    runs it as is; "dots" checkpoints it saving the outputs of the dots
    without batch dims (``layers.dots_saveable``); anything else ("full")
    checkpoints it whole, keeping only its inputs for the backward pass.
    A checkpoint acts only under autograd (``layers.checkpointed``):
    serving, ``prefill`` and a forward without gradients run ``fn`` as
    is."""
    if cfg.remat == "none":
        return fn
    policy = layers.dots_saveable if cfg.remat == "dots" else None
    return functools.partial(layers.checkpointed, fn, context_fn=policy)


def _mesh_scoped(fn):
    """Run an entry point inside ``sharding.gemm_mesh_scope(cfg)``."""
    @functools.wraps(fn)
    def scoped(cfg, *args, **kwargs):
        with sharding.gemm_mesh_scope(cfg):
            return fn(cfg, *args, **kwargs)
    return scoped


def _layer(tree, l: int):
    """Layer ``l``'s view of a stacked (leading ``n_super`` dim) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def _unstack(tree, n: int) -> list:
    """Every layer's view of a stacked tree, as :func:`_layer` gives them,
    from one ``unbind`` per tensor leaf: under autograd its backward is one
    ``stack`` of the layers' gradients, where indexing layer by layer
    scatters each layer's gradient into a zeroed copy of the whole stack
    (n times the stack's bytes, written and added)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][l] for k in tree} for l in range(n)]
    if torch.is_tensor(tree):
        return list(tree.unbind(0))
    return [tree[l] for l in range(n)]


# ---------------------------------------------------------------------------
# attention sub-module

def attn_init(gen, cfg: ModelConfig, dtype, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": layers.linear_init(gen, d, H * hd, bias=cfg.qkv_bias,
                                 dtype=dtype, device=device),
        "wk": layers.linear_init(gen, d, KV * hd, bias=cfg.qkv_bias,
                                 dtype=dtype, device=device),
        "wv": layers.linear_init(gen, d, KV * hd, bias=cfg.qkv_bias,
                                 dtype=dtype, device=device),
        "wo": layers.linear_init(gen, H * hd, d, dtype=dtype, device=device),
    }


def _proj_qkv(p, x, kv_src, cfg, cd, norm_scale=None):
    """q of x (B, S, d) and k, v of ``kv_src`` (B, T, d; None: x itself).
    Cross-attention (a ``kv_src``) dispatches at ``xattn.wq`` and both of
    its K/V projections at the one ``xattn.kv`` label, as the reference
    does."""
    B, S = x.shape[0], x.shape[1]
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    be = cfg.gemm_backend
    cross = kv_src is not None
    # ``norm_scale`` (the ln1 scale, self-attention only): the sublayer
    # hands rmsnorm_normalize'd x here and the scale fuses into each
    # projection's kernel prologue
    q = layers.linear(p["wq"], x, cd, site="xattn.wq" if cross else "attn.wq",
                      backend=be, norm_scale=norm_scale).reshape(B, S, H, hd)
    src = x if kv_src is None else kv_src
    T = src.shape[1]
    k = layers.linear(p["wk"], src, cd,
                      site="xattn.kv" if cross else "attn.wk", backend=be,
                      norm_scale=norm_scale).reshape(B, T, KV, hd)
    v = layers.linear(p["wv"], src, cd,
                      site="xattn.kv" if cross else "attn.wv", backend=be,
                      norm_scale=norm_scale).reshape(B, T, KV, hd)
    return q, k, v


def _qkv_at(p, x, cfg: ModelConfig, positions, norm_scale):
    """q, k, v of x (B, S, d), q and k rope'd at ``positions`` (B, S)."""
    q, k, v = _proj_qkv(p, x, None, cfg, _cdtype(cfg), norm_scale)
    return (layers.apply_rope(q, positions, cfg.rope_theta),
            layers.apply_rope(k, positions, cfg.rope_theta), v)


def _attn_wo(p, cfg: ModelConfig, out, site="attn.wo"):
    """The output projection of an attention result (B, S, H, hd)."""
    B, S = out.shape[0], out.shape[1]
    return layers.linear(p["wo"], out.reshape(B, S, -1), _cdtype(cfg),
                         site=site, backend=cfg.gemm_backend)


def attn_full(p, x, cfg: ModelConfig, positions, *, causal=True,
              kv_src=None, norm_scale=None):
    """Full-sequence attention: self-attention (q and k rope'd at
    ``positions``), or cross-attention to ``kv_src`` (no RoPE).  Returns
    (out, (k, v))."""
    if kv_src is None:
        q, k, v = _qkv_at(p, x, cfg, positions, norm_scale)
    else:
        q, k, v = _proj_qkv(p, x, kv_src, cfg, _cdtype(cfg), norm_scale)
    out = attn_lib.attention(
        q, k, v, causal=causal, window=cfg.sliding_window,
        kv_chunk=cfg.attn_kv_chunk, dense_below=cfg.attn_dense_below,
        backend=cfg.gemm_backend)
    return (_attn_wo(p, cfg, out,
                     "attn.wo" if kv_src is None else "xattn.wo"), (k, v))


def attn_decode(p, x, cfg: ModelConfig, cache, pos, norm_scale=None):
    """Single-token attention.  x: (B,1,d); cache: {'k','v'} (B, T, KV, D).

    pos may be a scalar or a (B,) vector (ragged continuous batching).
    Each row's new K/V is written in place at min(pos, T-1), or in a
    sliding window's ring at pos % T."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(B)
    q, k_new, v_new = _qkv_at(p, x, cfg, pos[:, None], norm_scale)
    k_cache, v_cache = cache["k"], cache["v"]
    rows = torch.arange(B, device=x.device)
    cl = k_cache.shape[1]
    slot = pos % cl if cfg.sliding_window else torch.clamp(pos, max=cl - 1)
    k_cache[rows, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v_new[:, 0].to(v_cache.dtype)
    out = attn_lib.decode_attention(q, k_cache, v_cache, pos,
                                    window=cfg.sliding_window,
                                    backend=cfg.gemm_backend)
    return _attn_wo(p, cfg, out), {"k": k_cache, "v": v_cache}


def _paged_write_rows(pos, block_tables, page_size: int):
    """Where each row of a paged decode step writes its new K/V: the flat
    pool row (physical page * page_size + offset) backing min(pos, L-1),
    and whether that page is page 0 (the engine's scratch page: an idle
    row).  The same for every layer of the step."""
    L = block_tables.shape[1] * page_size
    slot = torch.clamp(pos, max=L - 1)
    phys = torch.take_along_dim(block_tables, (slot // page_size)[:, None],
                                dim=1)[:, 0]
    return phys * page_size + slot % page_size, (phys == 0)[:, None, None]


def attn_decode_paged(p, x, cfg: ModelConfig, cache, pos, block_tables,
                      write_rows, norm_scale=None):
    """Single-token attention against the paged K/V pool.

    cache: {'kp','vp'} physical pools (n_pages, page, KV, hd);
    block_tables: (B, n_pg) int64 physical page ids per sequence;
    ``write_rows``: :func:`_paged_write_rows` of this step (the same for
    every layer, so the step computes it once).

    Each row's new K/V is written in place into the page backing
    min(pos, L-1), then the pool is gathered into the (B, L = n_pg*page,
    KV, hd) logical view — L equals the dense cache length by the engine's
    page | max_seq contract — and the mask, softmax and QK/PV dispatches
    are the dense ``attn_decode``'s, which keeps paged and dense greedy
    streams bit-identical.  The reference writes into the gathered view
    and scatters the written page back: the view, and every page a live
    row owns, get the same bytes.  A row whose write lands on the scratch
    page (an idle row) writes back the bytes already there, so the rows
    that alias it all carry identical bytes and the scratch page never
    changes (the reference leaves an idle row's K/V there, which no live
    row attends)."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(B)
    q, k_new, v_new = _qkv_at(p, x, cfg, pos[:, None], norm_scale)
    kp, vp = cache["kp"], cache["vp"]
    flat, idle = write_rows
    for pool, new in ((kp, k_new), (vp, v_new)):
        rows = pool.view((-1,) + pool.shape[2:])
        rows.index_copy_(0, flat, torch.where(
            idle, rows.index_select(0, flat), new[:, 0].to(pool.dtype)))
    out = attn_lib.decode_attention(
        q, attn_lib.gather_pages(kp, block_tables),
        attn_lib.gather_pages(vp, block_tables), pos,
        backend=cfg.gemm_backend)
    return _attn_wo(p, cfg, out), {"kp": kp, "vp": vp}


def _prefill_attend(cfg: ModelConfig, q, k_new, v_new, k_buf, v_buf, pos,
                    lengths, positions):
    """The chunk's K/V written into the (B, L, KV, hd) buffers in place —
    buffer slot j takes chunk element j - pos[b] when that index is a
    valid token of this chunk; the other slots are not written — then
    every query attends over the whole buffer with a ``key_pos <= q_pos``
    mask.  Returns (B, C, H, hd) in q's dtype."""
    B, C = q.shape[0], q.shape[1]
    j = torch.arange(k_buf.shape[1], device=q.device)[None, :]        # (1,L)
    src = j - pos[:, None]                                             # (B,L)
    ok = (src >= 0) & (src < lengths[:, None])
    idx = torch.clamp(src, 0, C - 1)[:, :, None, None]
    k_buf[ok] = torch.take_along_dim(k_new.to(k_buf.dtype), idx, dim=1)[ok]
    v_buf[ok] = torch.take_along_dim(v_new.to(v_buf.dtype), idx, dim=1)[ok]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    qg = q.reshape(B, C, KV, H // KV, hd)
    scale = 1.0 / math.sqrt(hd)
    s = attn_lib.qk_scores(qg, k_buf, backend=cfg.gemm_backend) * scale
    valid = j[:, None, :] <= positions[:, :, None]                     # (B,C,L)
    s = torch.where(valid[:, None, None], s, attn_lib.NEG_INF)
    w = torch.softmax(s.float(), dim=-1).to(v_buf.dtype)
    out = attn_lib.pv_mix(w, v_buf, backend=cfg.gemm_backend)
    return out.reshape(B, C, H, hd).to(q.dtype)


def _chunk_positions(x, pos, lengths):
    dev = x.device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
    positions = pos[:, None] + torch.arange(x.shape[1], device=dev)[None, :]
    return pos, lengths, positions


def attn_prefill(p, x, cfg: ModelConfig, cache, pos, lengths,
                 norm_scale=None):
    """Chunked-prefill attention.  x: (B,C,d) — a chunk of C prompt tokens
    per row starting at absolute position ``pos`` (B,); ``lengths`` (B,) is
    the number of valid tokens in each row's chunk (0 = row not prefilled
    this call: its cache rows are left untouched).

    The valid (row, position) K/V pairs are written into the cache in
    place, then every query attends over the full cache buffer with a
    ``key_pos <= q_pos`` mask.  The numerics mirror ``attn_decode`` step
    for step (same cache-dtype readback, fp32 softmax, same batched
    products), so a chunked prefill reproduces token-by-token decode.
    """
    pos, lengths, positions = _chunk_positions(x, pos, lengths)
    q, k_new, v_new = _qkv_at(p, x, cfg, positions, norm_scale)
    out = _prefill_attend(cfg, q, k_new, v_new, cache["k"], cache["v"], pos,
                          lengths, positions)
    return _attn_wo(p, cfg, out), cache


def attn_prefill_paged(p, x, cfg: ModelConfig, cache, pos, lengths,
                       block_tables, norm_scale=None):
    """Chunked-prefill attention against the paged K/V pool.

    The logical view is gathered as in :func:`attn_decode_paged`; the
    chunk's write, the causal mask and the QK/PV dispatches are then the
    dense ``attn_prefill``'s.  The whole view scatters back (a chunk may
    span pages): rows alias only pages whose gathered bytes they did not
    modify — shared prefix pages (writes start at the page-aligned
    divergence point) and the scratch page — so every duplicate write
    carries identical bytes."""
    pos, lengths, positions = _chunk_positions(x, pos, lengths)
    q, k_new, v_new = _qkv_at(p, x, cfg, positions, norm_scale)
    bt = block_tables
    kp, vp = cache["kp"], cache["vp"]
    k_view = attn_lib.gather_pages(kp, bt)
    v_view = attn_lib.gather_pages(vp, bt)
    out = _prefill_attend(cfg, q, k_new, v_new, k_view, v_view, pos,
                          lengths, positions)
    attn_lib.scatter_pages(kp, bt, k_view)
    attn_lib.scatter_pages(vp, bt, v_view)
    return _attn_wo(p, cfg, out), cache


def cross_attn_decode(p, x, cfg: ModelConfig, cache):
    """One token's cross-attention against the cached context K/V
    (``cache['xk']`` / ``['xv']``, read in the compute dtype)."""
    cd = _cdtype(cfg)
    B = x.shape[0]
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    q = layers.linear(p["wq"], x, cd, site="xattn.wq",
                      backend=cfg.gemm_backend).reshape(B, 1, H, hd)
    out = attn_lib.dense_attention(q, cache["xk"].to(cd),
                                   cache["xv"].to(cd), causal=False,
                                   backend=cfg.gemm_backend)
    return _attn_wo(p, cfg, out, "xattn.wo")


# ---------------------------------------------------------------------------
# sub-layer (one transformer layer)

def sublayer_init(gen, cfg: ModelConfig, pos: int, device):
    """One sub-layer's leaves, by :func:`sublayer_kind`: ln1, the mixer
    (``attn`` or ``mamba``), ``lnx`` and ``xattn`` when it cross-attends,
    and ln2 with ``mlp`` or ``moe`` only when the sub-layer has an
    MLP."""
    check_supported(cfg)
    kind = sublayer_kind(cfg, pos)
    dtype = _pdtype(cfg)
    d = cfg.d_model
    p = {"ln1": layers.rmsnorm_init(d, dtype, device)}
    if kind["mixer"] == "attn":
        p["attn"] = attn_init(gen, cfg, dtype, device)
    else:
        p["mamba"] = mamba_lib.mamba_init(gen, d, _ssm(cfg), dtype, device)
    if kind["cross"]:
        p["lnx"] = layers.rmsnorm_init(d, dtype, device)
        p["xattn"] = attn_init(gen, cfg, dtype, device)
    if kind["mlp"] == "dense":
        p["ln2"] = layers.rmsnorm_init(d, dtype, device)
        p["mlp"] = layers.swiglu_init(gen, d, cfg.d_ff, dtype, device)
    elif kind["mlp"] == "moe":
        m = cfg.moe
        p["ln2"] = layers.rmsnorm_init(d, dtype, device)
        p["moe"] = moe_lib.moe_init(gen, d, m.expert_d_ff or cfg.d_ff,
                                    m.num_experts,
                                    num_shared=m.num_shared_experts,
                                    dtype=dtype, device=device)
    return p


def _mlp(p, cfg, x):
    # ln2 scale fuses into the dual-GEMM swiglu prologue; the residual
    # join fuses into the mlp.wo store
    h = layers.rmsnorm_normalize(x, cfg.rms_eps)
    return layers.swiglu(p["mlp"], h, _cdtype(cfg),
                         backend=cfg.gemm_backend, residual=x,
                         norm_scale=p["ln2"]["scale"])


def _ffn(p, cfg: ModelConfig, kind, x, aux, groups: int):
    """The sub-layer's MLP after its mixer: the dense swiglu, the MoE
    (``groups`` 0: one dispatch group per sequence at the config's
    capacity, with its aux loss; 1: decode's one global group at capacity
    factor at least 2.0, no aux loss) or nothing (``mlp`` None)."""
    if kind["mlp"] == "dense":
        return _mlp(p, cfg, x), aux
    if kind["mlp"] == "moe":
        h = layers.rmsnorm(p["ln2"], x, cfg.rms_eps)
        m = cfg.moe
        y, a = moe_lib.moe_apply(
            p["moe"], h, top_k=m.top_k,
            capacity_factor=(m.capacity_factor if groups == 0
                             else max(m.capacity_factor, 2.0)),
            groups=groups, compute_dtype=_cdtype(cfg),
            aux_loss_weight=m.aux_loss_weight if groups == 0 else 0.0,
            backend=cfg.gemm_backend)
        return x + y, aux + a
    return x, aux


def sublayer_full(p, cfg: ModelConfig, pos: int, x, aux, positions,
                  ctx=None):
    """Full-sequence sub-layer.  Returns (x, aux, cache_entry): for
    attention the rope'd K/V in bf16 (a sliding window's last
    ``cache_len`` positions, rolled to their ring slots), for mamba the
    final fp32 state and the last d_conv - 1 conv inputs in bf16, and for
    a cross-attending sub-layer the context's ``xk`` / ``xv`` in bf16, as
    the reference caches them."""
    kind = sublayer_kind(cfg, pos)
    if kind["mixer"] == "attn":
        # ln1 scale fuses into the q/k/v projection prologues
        h = layers.rmsnorm_normalize(x, cfg.rms_eps)
        out, (k, v) = attn_full(p["attn"], h, cfg, positions,
                                norm_scale=p["ln1"]["scale"])
        S = k.shape[1]
        cl = cache_len(cfg, S)
        k, v = k[:, S - cl:], v[:, S - cl:]
        if cfg.sliding_window and cl > 1:
            k = torch.roll(k, S % cl, dims=1)
            v = torch.roll(v, S % cl, dims=1)
        cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    else:
        h = layers.rmsnorm(p["ln1"], x, cfg.rms_eps)
        out, state, conv = mamba_lib.mamba_forward(
            p["mamba"], h, _ssm(cfg), _cdtype(cfg), backend=cfg.gemm_backend)
        cache = {"state": state.float(), "conv": conv.to(torch.bfloat16)}
    x = x + out
    if kind["cross"]:
        h = layers.rmsnorm(p["lnx"], x, cfg.rms_eps)
        out, (xk, xv) = attn_full(p["xattn"], h, cfg, positions,
                                  causal=False, kv_src=ctx)
        cache["xk"] = xk.to(torch.bfloat16)
        cache["xv"] = xv.to(torch.bfloat16)
        x = x + out
    x, aux = _ffn(p, cfg, kind, x, aux, groups=0)
    return x, aux, cache


def sublayer_decode(p, cfg: ModelConfig, pos_idx: int, x, cache, pos,
                    dst=None):
    """One-token sub-layer.  x: (B,1,d).  Returns (x, cache_entry): the
    attention's K/V written in place into ``cache``, or a mamba layer's
    new ``state`` and ``conv`` window (cast to the cache's dtype), written
    into ``dst``'s ``state``/``conv`` tensors when given, else new ones;
    a mamba layer's ``cache`` is not written, nor are a cross-attending
    sub-layer's ``xk`` / ``xv``."""
    kind = sublayer_kind(cfg, pos_idx)
    if kind["mixer"] == "attn":
        # ln1 scale fuses into the q/k/v projection prologues
        h = layers.rmsnorm_normalize(x, cfg.rms_eps)
        out, entry = attn_decode(p["attn"], h, cfg, cache, pos,
                                 norm_scale=p["ln1"]["scale"])
    else:
        h = layers.rmsnorm(p["ln1"], x, cfg.rms_eps)
        y, state, conv = mamba_lib.mamba_decode_step(
            p["mamba"], h[:, 0], cache["state"], cache["conv"], _ssm(cfg),
            _cdtype(cfg), backend=cfg.gemm_backend,
            out=None if dst is None else (dst["state"], dst["conv"]))
        out = y[:, None]
        entry = {"state": state, "conv": conv.to(cache["conv"].dtype)}
    x = x + out
    if kind["cross"]:
        h = layers.rmsnorm(p["lnx"], x, cfg.rms_eps)
        x = x + cross_attn_decode(p["xattn"], h, cfg, cache)
    x, _ = _ffn(p, cfg, kind, x, 0.0, groups=1)
    return x, entry


def sublayer_prefill(p, cfg: ModelConfig, pos_idx: int, x, cache, pos,
                     lengths):
    """Chunk-of-tokens sub-layer.  x: (B,C,d).  Returns (x, cache); the
    residual/MLP arithmetic is row-wise identical to ``sublayer_decode``.
    Dense MLPs only (``supports_batched_prefill`` gates the callers)."""
    kind = sublayer_kind(cfg, pos_idx)
    assert kind["mixer"] == "attn" and not kind["cross"] \
        and kind["mlp"] == "dense", "use supports_batched_prefill() to gate"
    h = layers.rmsnorm_normalize(x, cfg.rms_eps)
    out, kv = attn_prefill(p["attn"], h, cfg, cache, pos, lengths,
                           norm_scale=p["ln1"]["scale"])
    x = x + out
    return _mlp(p, cfg, x), kv


def _check_paged_kind(cfg, pos_idx):
    kind = sublayer_kind(cfg, pos_idx)
    assert kind["mixer"] == "attn" and not kind["cross"] \
        and kind["mlp"] == "dense", "use supports_paged_kv() to gate"


def _sublayer_decode_paged(p, cfg, pos_idx, x, cache, pos, bt, write_rows):
    """``sublayer_decode`` of a dense sub-layer against the paged pool."""
    _check_paged_kind(cfg, pos_idx)
    h = layers.rmsnorm_normalize(x, cfg.rms_eps)
    out, kv = attn_decode_paged(p["attn"], h, cfg, cache, pos, bt,
                                write_rows, norm_scale=p["ln1"]["scale"])
    return _mlp(p, cfg, x + out), kv


def _sublayer_prefill_paged(p, cfg, pos_idx, x, cache, pos, lengths, bt):
    """``sublayer_prefill`` against the paged pool."""
    _check_paged_kind(cfg, pos_idx)
    h = layers.rmsnorm_normalize(x, cfg.rms_eps)
    out, kv = attn_prefill_paged(p["attn"], h, cfg, cache, pos, lengths, bt,
                                 norm_scale=p["ln1"]["scale"])
    return _mlp(p, cfg, x + out), kv


# ---------------------------------------------------------------------------
# whole model

def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``,
    laid out as the reference's tree: ``blocks`` is a tuple (one entry per
    sub-layer of the period) of stacked dicts with a leading ``n_super``
    dim; the VLM family adds ``img_proj``, the audio family
    ``audio_proj`` and ``enc_blocks``, a one-entry tuple of the encoder
    layers stacked on a leading ``n_encoder_layers`` dim.  On the card
    unless ``device="cpu"``; ``device="meta"`` gives the tree's shapes and
    dtypes and allocates nothing (the draws go to meta tensors, which
    keep none; the generator stays on the CPU, as none lives on meta).

    Each stacked leaf is allocated once, in the parameter dtype, and
    filled layer by layer as the generator draws each layer, so the
    transient memory is one layer's tree (a full-width MoE model's
    stacked expert banks are 19 GB each in bf16)."""
    check_supported(cfg)
    dev = _device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    dtype = _pdtype(cfg)

    def stacked(n, init):
        layer = init()
        out = _map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype,
                                         device=dev), layer)
        for l in range(n):
            if l:
                layer = init()
            _put(out, layer, l)
        return out

    params = {
        "embed": layers.embedding_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dtype, dev),
        "final_norm": layers.rmsnorm_init(cfg.d_model, dtype, dev),
        "blocks": tuple(
            stacked(n_super(cfg),
                    lambda i=i: sublayer_init(gen, cfg, i, dev))
            for i in range(period(cfg))),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.linear_init(gen, cfg.d_model,
                                               cfg.padded_vocab, dtype=dtype,
                                               device=dev)
    if cfg.family == "vlm":
        params["img_proj"] = layers.linear_init(gen, cfg.d_frontend,
                                                cfg.d_model, dtype=dtype,
                                                device=dev)
    if cfg.family == "audio":
        params["audio_proj"] = layers.linear_init(gen, cfg.d_frontend,
                                                  cfg.d_model, dtype=dtype,
                                                  device=dev)
        params["enc_blocks"] = (stacked(
            cfg.n_encoder_layers, lambda: _enc_layer_init(gen, cfg, dev)),)
    return params


def _enc_layer_init(gen, cfg: ModelConfig, device):
    """One audio encoder layer: ln1, self-attention, ln2, swiglu."""
    dtype = _pdtype(cfg)
    return {"ln1": layers.rmsnorm_init(cfg.d_model, dtype, device),
            "attn": attn_init(gen, cfg, dtype, device),
            "ln2": layers.rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                      device)}


def encode_audio(cfg: ModelConfig, params, frames):
    """The audio encoder: ``frames`` (B, F, d_frontend) through the
    ``frontend.audio`` projection, then each encoder layer's non-causal,
    RoPE'd self-attention (the ln1 scale fused into the projections'
    prologues) and swiglu (the ln2 scale in its prologue, the residual in
    ``mlp.wo``'s store), at the decoder's site labels.  Returns
    (B, F, d_model) in the compute dtype."""
    cd = _cdtype(cfg)
    x = layers.linear(params["audio_proj"], frames, cd,
                      site="frontend.audio", backend=cfg.gemm_backend)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(x, p):
        h = layers.rmsnorm_normalize(x, cfg.rms_eps)
        out, _ = attn_full(p["attn"], h, cfg, positions, causal=False,
                           norm_scale=p["ln1"]["scale"])
        x = x + out
        h = layers.rmsnorm_normalize(x, cfg.rms_eps)
        return layers.swiglu(p["mlp"], h, cd, backend=cfg.gemm_backend,
                             residual=x, norm_scale=p["ln2"]["scale"])

    body = _remat(cfg, body)
    for p in _unstack(params["enc_blocks"][0], cfg.n_encoder_layers):
        x = body(x, p)
    return x


def _context(cfg: ModelConfig, params, batch):
    """What the cross-attending sub-layers attend to: the ``frontend.img``
    projection of ``batch['image_embeds']`` (VLM), the encoded
    ``batch['frames']`` (audio), else None."""
    if cfg.family == "vlm":
        cd = _cdtype(cfg)
        return layers.linear(params["img_proj"],
                             batch["image_embeds"].to(cd), cd,
                             site="frontend.img", backend=cfg.gemm_backend)
    if cfg.family == "audio":
        return encode_audio(cfg, params, batch["frames"])
    return None


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _put(stacked, tree, l: int):
    """Copy one layer's tree into index ``l`` of the stacked tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(stacked[k], v, l)
    else:
        stacked[l] = tree


def _is_gemm_weight(key: str, node) -> bool:
    """A linear's ``w`` leaf, or a (stacked) MoE expert bank."""
    return ((key == "w" and node.ndim >= 2)
            or (key in _EXPERT_BANKS and node.ndim >= 3))


def prepare_params(cfg: ModelConfig, params):
    """The served tree: every GEMM weight (linear ``w`` leaves and MoE
    expert banks) cast ONCE to the compute dtype (contiguous), and the
    tied embedding table additionally transposed into a contiguous (d, V)
    ``table_t`` for ``unembed``.  Norm scales, biases and the MoE router
    keep the param dtype, as the reference feeds them.

    The reference casts each weight inside every ``linear`` and
    ``moe_apply`` call and transposes the table on every ``unembed``; in
    eager PyTorch that would re-read and re-write the weights every step.
    The cast is deterministic, so the served tree computes the same
    numbers."""
    cd = _cdtype(cfg)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        if _is_gemm_weight(key, node):
            return node.to(cd).contiguous()
        return node                       # biases, norm scales, router

    out = walk(params)
    table = params["embed"]["table"].to(cd)
    out["embed"] = {"table": table}
    if cfg.tie_embeddings:
        out["embed"]["table_t"] = table.t().contiguous()
    return out


def prequantize_params(cfg: ModelConfig, params):
    """Quantize every GEMM weight leaf once, at load time, for a
    quantizing backend; returns ``params`` unchanged on any other.

    Each linear weight ``w`` becomes a :class:`substrate.QuantizedTensor`
    of its compute-dtype cast — the value ``layers.linear`` hands the
    dispatch — so the codes equal what the dispatch memo would compute,
    and the dispatch never re-quantizes.  Biases, norm scales and the
    embedding lookup table stay; with tied embeddings the table's
    transpose gets a ``table_q`` leaf that ``layers.unembed`` prefers (a
    served tree's float ``table_t`` is dropped for it: unembed never reads
    it again).  MoE expert banks quantize per (layer, expert, column),
    one layer at a time (``substrate.prequantize``); the router stays
    float (``substrate.QUANT_EXEMPT_SITES``)."""
    if not substrate.backend_quantizes(cfg.gemm_backend):
        return params
    cd = _cdtype(cfg)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        if _is_gemm_weight(key, node):
            return substrate.prequantize(node.to(cd))
        return node                       # biases, norm scales, router

    out = walk(params)
    if cfg.tie_embeddings:
        table = params["embed"]["table"].to(cd)
        out["embed"] = {k: v for k, v in out["embed"].items()
                        if k != "table_t"}
        out["embed"]["table_q"] = substrate.prequantize(table.t())
    return out


def _logits(cfg, params, x, cd):
    """fp32 logits via the substrate (site "unembed", tied or untied)."""
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x, backend=cfg.gemm_backend)
    return layers.linear(params["lm_head"], x, cd, site="unembed",
                         backend=cfg.gemm_backend).float()


@_mesh_scoped
def forward(cfg: ModelConfig, params, batch, *, return_cache=False):
    """Returns (logits (B,S,V) fp32, aux_loss, caches-or-None).
    batch['tokens']: (B,S); the VLM family also takes
    ``batch['image_embeds']`` (B, n_image_tokens, d_frontend) and the
    audio family ``batch['frames']`` (B, frames, d_frontend).

    ``caches`` is laid out as :func:`init_cache`'s with ``max_seq = S``
    (bf16), the cross leaves as long as the context: each layer's rope'd
    K/V (a sliding window's last ``cache_len`` rows, rolled), or its
    final fp32 state and bf16 conv window, and the context's ``xk`` /
    ``xv``, written into its slice as the layer runs.  A mamba
    sub-layer's chunked scan needs S to be a multiple of
    ``min(chunk_size, S)``, as the reference asserts."""
    substrate.check_backend(cfg.gemm_backend)
    check_supported(cfg)
    P = period(cfg)
    cd = _cdtype(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = sharding.constrain(layers.embed(params["embed"], tokens, cd),
                           "hidden")
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ctx = _context(cfg, params, batch)
    caches = (init_cache(cfg, B, S, device=x.device,
                         n_cross=None if ctx is None else ctx.shape[1])
              if return_cache else None)
    blocks = [_unstack(params["blocks"][i], n_super(cfg)) for i in range(P)]

    def body(x, aux, p_block):
        block_caches = []
        for i in range(P):
            x, aux, c = sublayer_full(p_block[i], cfg, i, x, aux, positions,
                                      ctx)
            x = sharding.constrain(x, "hidden")
            block_caches.append(c)
        return x, aux, block_caches

    body = _remat(cfg, body)
    for l in range(n_super(cfg)):
        x, aux, block_caches = body(x, aux, [blocks[i][l] for i in range(P)])
        if caches is not None:
            for i, c in enumerate(block_caches):
                _put(caches[i], c, l)
    x = layers.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return (sharding.constrain(_logits(cfg, params, x, cd), "logits"), aux,
            caches)


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a backend that cannot train: the
    collapse backends' CUDA kernels record no autograd graph (their
    outputs would carry no ``grad_fn``: a silent zero gradient), and the
    weight memos they key by tensor identity would go stale as the
    weights change.  The reference cannot differentiate its Pallas
    kernels either; it trains on ``xla``."""
    substrate.check_backend(cfg.gemm_backend)
    if substrate.backend_collapses(cfg.gemm_backend):
        raise NotImplementedError(
            f"{cfg.name}: gemm_backend={cfg.gemm_backend!r} has no backward "
            f"pass; train on 'xla' or 'ref'")


def loss_fn(cfg: ModelConfig, params, batch):
    """Token cross-entropy of :func:`forward`'s logits against
    ``batch['labels']`` (masked by ``batch['loss_mask']`` when given) plus
    the MoE aux loss.  Returns (loss + aux, {'xent', 'aux'}).  Under
    autograd (grad mode on, some leaf of ``params`` requiring a gradient)
    the backend must be able to train (:func:`check_trainable`).

    Differentiate it on the raw parameter tree, never on
    :func:`prepare_params`' served tree: its casts and ``table_t`` are
    copies, and gradients would land on them."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad
            for t in tree_lib.leaves(params)):
        check_trainable(cfg)
    logits, aux, _ = forward(cfg, params, batch)
    loss = layers.softmax_xent(logits, batch["labels"],
                               batch.get("loss_mask"))
    return loss + aux, {"xent": loss, "aux": aux}


def prefill(cfg: ModelConfig, params, batch):
    """Returns (last-token logits (B,V), caches) of :func:`forward`."""
    logits, _, caches = forward(cfg, params, batch, return_cache=True)
    return logits[:, -1], caches


@_mesh_scoped
def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """token: (B,) int; pos: scalar or (B,) int.  Returns (logits (B,V),
    cache): a new cache tuple whose K/V leaves are the input's, updated
    in place (a sliding window's ring at the step's own slot), whose
    ``xk``/``xv`` leaves are the input's, untouched, and whose
    ``state``/``conv`` leaves (mamba sub-layers) are new tensors holding
    the advanced recurrence — the input's are not written, so use the
    returned cache."""
    substrate.check_backend(cfg.gemm_backend)
    check_supported(cfg)
    P = period(cfg)
    cd = _cdtype(cfg)
    x = layers.embed(params["embed"], token[:, None], cd)
    # the advanced recurrent leaves go to fresh stacked tensors, each
    # layer's written in place there by the recurrence itself
    new = tuple({k: (torch.empty_like(t) if k in ("state", "conv") else t)
                 for k, t in c.items()} for c in cache)
    for l in range(n_super(cfg)):
        for i in range(P):
            with substrate.chaos_sublayer(i):
                x, _ = sublayer_decode(
                    _layer(params["blocks"][i], l), cfg, i, x,
                    _layer(cache[i], l), pos,
                    dst=_layer(new[i], l) if "state" in new[i] else None)
    x = layers.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    logits = sharding.constrain(_logits(cfg, params, x, cd), "logits")
    return logits[:, 0], new


def supports_batched_prefill(cfg: ModelConfig) -> bool:
    """True when ``prefill_step`` reproduces the decode path: every
    sub-layer a plain causal-attention + dense-MLP block with a linear
    KV cache."""
    if cfg.sliding_window or cfg.family in ("vlm", "audio"):
        return False
    return all(
        k["mixer"] == "attn" and not k["cross"] and k["mlp"] != "moe"
        for k in (sublayer_kind(cfg, i) for i in range(period(cfg))))


@_mesh_scoped
def prefill_step(cfg: ModelConfig, params, cache, tokens, pos, lengths):
    """Batched chunked prefill: one dispatch sequence for a (B,C) chunk.

    tokens: (B,C) int, right-padded; pos: (B,) absolute start position of
    each row's chunk; lengths: (B,) valid tokens per row (0 = row inactive —
    its cache is untouched).  Returns ``(logits (B,V) at each row's last
    valid chunk token, cache)``; logits rows with ``lengths == 0`` are
    meaningless.  The cache tensors are updated in place."""
    substrate.check_backend(cfg.gemm_backend)
    check_supported(cfg)
    P = period(cfg)
    x = layers.embed(params["embed"], tokens, _cdtype(cfg))
    for l in range(n_super(cfg)):
        for i in range(P):
            x, _ = sublayer_prefill(_layer(params["blocks"][i], l), cfg, i,
                                    x, _layer(cache[i], l), pos, lengths)
    return sharding.constrain(_last_logits(cfg, params, x, lengths),
                              "logits")[:, 0], cache


def _last_logits(cfg, params, x, lengths):
    """Logits (B,1,V) at each row's last valid chunk token of x (B,C,d)."""
    x = layers.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=x.device)
    last = torch.clamp(lengths - 1, 0, x.shape[1] - 1)
    x = torch.take_along_dim(x, last[:, None, None], dim=1)           # (B,1,d)
    return _logits(cfg, params, x, _cdtype(cfg))


# ---------------------------------------------------------------------------
# pipeline-sharded serving steps (GPipe stages over the "pod" mesh axis)

def supports_pipeline(cfg: ModelConfig) -> bool:
    """True when the pp step functions reproduce the dense path bit for
    bit: plain causal-attention + dense-MLP stack (the batched-prefill
    gate) whose ``n_super`` super-blocks split evenly over the stages."""
    pp = cfg.pp_stages
    return (pp > 1 and len(cfg.mesh_shape) == 3
            and cfg.mesh_shape[0] == pp and n_super(cfg) % pp == 0
            and supports_batched_prefill(cfg))


def _check_pp(cfg: ModelConfig):
    if not supports_pipeline(cfg):
        raise ValueError(
            "pipeline step needs pp_stages > 1, a 3-axis mesh_shape whose "
            "'pod' axis equals pp_stages, n_super %% pp == 0 and a "
            "batched-prefill-capable (dense causal) architecture; got "
            f"pp_stages={cfg.pp_stages} mesh_shape={cfg.mesh_shape} "
            f"n_super={n_super(cfg)} family={cfg.family}")


def _placed(tree, dev):
    """A parameter subtree on ``dev`` (the substrate's weight memo: each
    leaf copied once per device, itself where it already lies)."""
    if isinstance(tree, dict):
        return {k: _placed(v, dev) for k, v in tree.items()}
    return substrate.place_weight(tree, dev)


def _pp_step(cfg: ModelConfig, params, cache, tokens, pos, lengths):
    """The pipeline-sharded decode / prefill step both entries share.

    Stage ``s`` of cfg's (pod, data, model) role mesh owns the contiguous
    super-blocks ``[s*NS/pp, (s+1)*NS/pp)`` and their cache slice and runs
    them on its device (``parallel.pipeline.staged_step``: once each, in
    order, the activation hopping to the next stage's device).  Each
    stage runs the SAME sub-layer functions as the colocated path, so the
    values are the colocated step's; only the ``attn.wq`` boundary GEMM
    plans under the role's transfer pricing (``sharding.use_pp_pricing``).
    The final norm and the logits run on the last stage (the only one
    that holds the model's output) and come back to the caller's device.

    The caches stay on the caller's device: a stage on another device
    works on a copy of its slice and writes it back (on one card every
    logical device is the same one, and nothing moves)."""
    from repro_torch.parallel import pipeline
    mesh = sharding.mesh_from_config(cfg)
    devices = pipeline.stage_devices(mesh)
    Pd, cd = period(cfg), _cdtype(cfg)
    per = n_super(cfg) // cfg.pp_stages
    decode = lengths is None
    x0 = layers.embed(params["embed"], tokens, cd)
    home = x0.device

    def stage_fn(s, x, _state):
        dev = x.device
        p_pos, p_len = to_device(pos, dev), to_device(lengths, dev)
        for l in range(s * per, (s + 1) * per):
            for i in range(Pd):
                p = _placed(_layer(params["blocks"][i], l), dev)
                c = _layer(cache[i], l)
                cs = {k: to_device(t, dev) for k, t in c.items()}
                if decode:
                    with substrate.chaos_sublayer(i):
                        x, _ = sublayer_decode(p, cfg, i, x, cs, p_pos)
                else:
                    x, _ = sublayer_prefill(p, cfg, i, x, cs, p_pos, p_len)
                for k, t in cs.items():
                    if t is not c[k]:
                        c[k].copy_(t)
        return x, None

    y, _ = pipeline.staged_step(stage_fn, x0, [None] * len(devices),
                                devices)
    last = _placed({k: v for k, v in params.items() if k != "blocks"},
                   y.device)
    if decode:
        x = layers.rmsnorm(last["final_norm"], y, cfg.rms_eps)
        logits = _logits(cfg, last, x, cd)[:, 0]
    else:
        logits = _last_logits(cfg, last, y,
                              to_device(lengths, y.device))[:, 0]
    return to_device(logits, home), cache


def decode_step_pp(cfg: ModelConfig, params, cache, token, pos):
    """Pipeline-sharded twin of :func:`decode_step` (dense cache only).

    token: (B,) int; pos: scalar or (B,) int.  Returns (logits (B,V),
    cache) equal to :func:`decode_step`'s, the K/V updated in place."""
    substrate.check_backend(cfg.gemm_backend)
    _check_pp(cfg)
    with sharding.gemm_mesh_scope(cfg):
        return _pp_step(cfg, params, cache, token[:, None], pos, None)


def prefill_step_pp(cfg: ModelConfig, params, cache, tokens, pos, lengths):
    """Pipeline-sharded twin of :func:`prefill_step` (dense cache only)."""
    substrate.check_backend(cfg.gemm_backend)
    _check_pp(cfg)
    with sharding.gemm_mesh_scope(cfg):
        return _pp_step(cfg, params, cache, tokens, pos, lengths)


def supports_paged_kv(cfg: ModelConfig) -> bool:
    """True when the paged serving path reproduces dense decoding bit for
    bit: the gate of :func:`supports_batched_prefill` (pure causal
    attention + dense MLP, linear cache) — MoE routing, mamba state,
    cross-attention and sliding-window rings have no page-gather
    equivalence."""
    return supports_batched_prefill(cfg)


@_mesh_scoped
def decode_step_paged(cfg: ModelConfig, params, cache, token, pos,
                      block_tables):
    """Paged twin of :func:`decode_step`: token (B,), pos (B,),
    block_tables (B, n_pg) physical page ids.  cache is
    :func:`init_paged_cache`'s.  Returns (logits (B,V), cache) — the pools
    are updated in place and returned."""
    return _paged_step(cfg, params, cache, token[:, None], pos, None,
                       block_tables)


@_mesh_scoped
def prefill_step_paged(cfg: ModelConfig, params, cache, tokens, pos,
                       lengths, block_tables):
    """Paged twin of :func:`prefill_step`: tokens (B,C) right-padded,
    pos/lengths (B,), block_tables (B, n_pg).  Returns (logits at each
    row's last valid chunk token, cache), the pools updated in place."""
    return _paged_step(cfg, params, cache, tokens, pos, lengths,
                       block_tables)


def _paged_step(cfg, params, cache, tokens, pos, lengths, bt):
    substrate.check_backend(cfg.gemm_backend)
    check_supported(cfg)
    if not supports_paged_kv(cfg):
        raise ValueError(f"{cfg.name}: family does not support the paged "
                         f"KV path (see supports_paged_kv)")
    x = layers.embed(params["embed"], tokens, _cdtype(cfg))
    dev = x.device
    bt = torch.as_tensor(bt, dtype=torch.int64, device=dev)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    if lengths is None:
        pos = pos.expand(x.shape[0])
        write = _paged_write_rows(pos, bt, cache[0]["kp"].shape[2])
    for l in range(n_super(cfg)):
        for i in range(period(cfg)):
            p, c = _layer(params["blocks"][i], l), _layer(cache[i], l)
            if lengths is None:
                x, _ = _sublayer_decode_paged(p, cfg, i, x, c, pos, bt,
                                              write)
            else:
                x, _ = _sublayer_prefill_paged(p, cfg, i, x, c, pos,
                                               lengths, bt)
    if lengths is None:
        x = layers.rmsnorm(params["final_norm"], x, cfg.rms_eps)
        logits = _logits(cfg, params, x, _cdtype(cfg))
    else:
        logits = _last_logits(cfg, params, x, lengths)
    return sharding.constrain(logits, "logits")[:, 0], cache


# ---------------------------------------------------------------------------
# cache construction

def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               dtype=torch.bfloat16, device=None, *, n_cross=None):
    """Zero-initialized decode cache, per sub-layer of the period: an
    attention sub-layer's ``{'k','v'}`` of shape (n_super, B,
    cache_len(max_seq), KV, hd) in ``dtype``; a mamba sub-layer's
    ``{'state','conv'}``: the fp32 state (n_super, B, G, hg, P, N) and
    the conv window (n_super, B, d_conv - 1, conv_ch) in ``dtype``; and a
    cross-attending sub-layer's ``{'xk','xv'}`` besides, (n_super, B,
    n_cross, KV, hd) in ``dtype`` (``n_cross`` None: :func:`cross_len`).
    On the card unless ``device="cpu"`` (``"meta"``: shapes only)."""
    check_supported(cfg)
    dev = _device(device)
    NS = n_super(cfg)
    ssm = _ssm(cfg)
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    cl = cache_len(cfg, max_seq)
    G, N = ssm.n_groups, ssm.d_state
    hg = (cfg.d_inner // ssm.head_dim) // G
    conv_ch = cfg.d_inner + 2 * G * N
    xl = cross_len(cfg) if n_cross is None else n_cross
    out = []
    for i in range(period(cfg)):
        kind = sublayer_kind(cfg, i)
        if kind["mixer"] == "attn":
            shape = (NS, batch_size, cl, KV, hd)
            c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
        else:
            c = {"state": torch.zeros((NS, batch_size, G, hg, ssm.head_dim,
                                       N), dtype=torch.float32, device=dev),
                 "conv": torch.zeros((NS, batch_size, ssm.d_conv - 1,
                                      conv_ch), dtype=dtype, device=dev)}
        if kind["cross"]:
            shape = (NS, batch_size, xl, KV, hd)
            c["xk"] = torch.zeros(shape, dtype=dtype, device=dev)
            c["xv"] = torch.zeros(shape, dtype=dtype, device=dev)
        out.append(c)
    return tuple(out)


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype=torch.bfloat16, device=None):
    """Zero-initialized paged K/V pools for ``decode_step_paged`` /
    ``prefill_step_paged``: per sub-layer of the period ``{'kp','vp'}`` of
    shape (n_super, n_pages, page_size, KV, hd).  Unlike :func:`init_cache`
    there is no batch dimension — residency is the engine's block tables,
    so K/V memory scales with the page budget, not ``max_batch * max_seq``
    (page 0 is the engine's scratch page).  On the card unless
    ``device="cpu"``."""
    if not supports_paged_kv(cfg):
        raise ValueError(f"{cfg.name}: family does not support the paged "
                         f"KV path (see supports_paged_kv)")
    dev = resolve_device(device)
    shape = (n_super(cfg), n_pages, page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return tuple({"kp": torch.zeros(shape, dtype=dtype, device=dev),
                  "vp": torch.zeros(shape, dtype=dtype, device=dev)}
                 for _ in range(period(cfg)))
