"""Unified LM model family — the dense and MoE families are ported so far.

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

Families other than ``dense`` and ``moe`` (hybrid, SSM, VLM, audio),
sliding windows, paged K/V and the pipeline-sharded steps are not ported
yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import substrate
from repro_torch.kernels.runtime import resolve_device
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import layers
from repro_torch.nn import moe as moe_lib

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


def cache_len(cfg: ModelConfig, max_seq: int) -> int:
    return min(cfg.sliding_window, max_seq) if cfg.sliding_window else max_seq


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet (ROADMAP Queue 1)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"Queue 1: other families); only 'dense' and 'moe' run")
    if cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention is not ported yet "
            f"(ROADMAP Queue 1: other families)")


def _layer(tree, l: int):
    """Layer ``l``'s view of a stacked (leading ``n_super`` dim) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


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


def _proj_qkv(p, x, cfg, cd, norm_scale=None):
    B, S = x.shape[0], x.shape[1]
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    be = cfg.gemm_backend
    # ``norm_scale`` (the ln1 scale): the sublayer hands rmsnorm_normalize'd
    # x here and the scale fuses into each projection's kernel prologue
    q = layers.linear(p["wq"], x, cd, site="attn.wq", backend=be,
                      norm_scale=norm_scale).reshape(B, S, H, hd)
    k = layers.linear(p["wk"], x, cd, site="attn.wk", backend=be,
                      norm_scale=norm_scale).reshape(B, S, KV, hd)
    v = layers.linear(p["wv"], x, cd, site="attn.wv", backend=be,
                      norm_scale=norm_scale).reshape(B, S, KV, hd)
    return q, k, v


def attn_full(p, x, cfg: ModelConfig, positions, *, norm_scale=None):
    """Full-sequence causal self-attention.  Returns (out, (k, v)) with
    rope'd keys."""
    cd = _cdtype(cfg)
    q, k, v = _proj_qkv(p, x, cfg, cd, norm_scale)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = attn_lib.attention(
        q, k, v, causal=True, window=cfg.sliding_window,
        kv_chunk=cfg.attn_kv_chunk, dense_below=cfg.attn_dense_below,
        backend=cfg.gemm_backend)
    B, S = x.shape[0], x.shape[1]
    out = layers.linear(p["wo"], out.reshape(B, S, -1), cd, site="attn.wo",
                        backend=cfg.gemm_backend)
    return out, (k, v)


def attn_decode(p, x, cfg: ModelConfig, cache, pos, norm_scale=None):
    """Single-token attention.  x: (B,1,d); cache: {'k','v'} (B, T, KV, D).

    pos may be a scalar or a (B,) vector (ragged continuous batching).
    Each row's new K/V is written in place at min(pos, T-1)."""
    cd = _cdtype(cfg)
    q, k_new, v_new = _proj_qkv(p, x, cfg, cd, norm_scale)
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device).expand(B)
    positions = pos[:, None]
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k_new = layers.apply_rope(k_new, positions, cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    cl = k_cache.shape[1]
    rows = torch.arange(B, device=x.device)
    slot = torch.clamp(pos, max=cl - 1)
    k_cache[rows, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v_new[:, 0].to(v_cache.dtype)
    out = attn_lib.decode_attention(q, k_cache, v_cache, pos,
                                    backend=cfg.gemm_backend)
    out = layers.linear(p["wo"], out.reshape(B, 1, -1), cd, site="attn.wo",
                        backend=cfg.gemm_backend)
    return out, {"k": k_cache, "v": v_cache}


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
    cd = _cdtype(cfg)
    q, k_new, v_new = _proj_qkv(p, x, cfg, cd, norm_scale)
    B, C = x.shape[0], x.shape[1]
    dev = x.device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
    positions = pos[:, None] + torch.arange(C, device=dev)[None, :]   # (B,C)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k_new = layers.apply_rope(k_new, positions, cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    cl = k_cache.shape[1]
    # cache slot j takes chunk element j - pos[b] when that index is a
    # valid token of this chunk; the other slots are not written
    j = torch.arange(cl, device=dev)[None, :]                          # (1,cl)
    src = j - pos[:, None]                                             # (B,cl)
    ok = (src >= 0) & (src < lengths[:, None])
    idx = torch.clamp(src, 0, C - 1)[:, :, None, None]
    k_cache[ok] = torch.take_along_dim(
        k_new.to(k_cache.dtype), idx, dim=1)[ok]
    v_cache[ok] = torch.take_along_dim(
        v_new.to(v_cache.dtype), idx, dim=1)[ok]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = H // KV
    qg = q.reshape(B, C, KV, g, hd)
    scale = 1.0 / math.sqrt(hd)
    s = attn_lib.qk_scores(qg, k_cache, backend=cfg.gemm_backend) * scale
    valid = j[:, None, :] <= positions[:, :, None]                     # (B,C,cl)
    s = torch.where(valid[:, None, None], s, attn_lib.NEG_INF)
    w = torch.softmax(s.float(), dim=-1).to(v_cache.dtype)
    out = attn_lib.pv_mix(w, v_cache, backend=cfg.gemm_backend)
    out = out.reshape(B, C, H, hd).to(q.dtype)
    out = layers.linear(p["wo"], out.reshape(B, C, -1), cd, site="attn.wo",
                        backend=cfg.gemm_backend)
    return out, {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# sub-layer (one transformer layer)

def sublayer_init(gen, cfg: ModelConfig, pos: int, device):
    check_supported(cfg)
    dtype = _pdtype(cfg)
    d = cfg.d_model
    p = {"ln1": layers.rmsnorm_init(d, dtype, device),
         "attn": attn_init(gen, cfg, dtype, device),
         "ln2": layers.rmsnorm_init(d, dtype, device)}
    if sublayer_kind(cfg, pos)["mlp"] == "moe":
        m = cfg.moe
        p["moe"] = moe_lib.moe_init(gen, d, m.expert_d_ff or cfg.d_ff,
                                    m.num_experts,
                                    num_shared=m.num_shared_experts,
                                    dtype=dtype, device=device)
    else:
        p["mlp"] = layers.swiglu_init(gen, d, cfg.d_ff, dtype, device)
    return p


def _mlp(p, cfg, x):
    # ln2 scale fuses into the dual-GEMM swiglu prologue; the residual
    # join fuses into the mlp.wo store
    h = layers.rmsnorm_normalize(x, cfg.rms_eps)
    return layers.swiglu(p["mlp"], h, _cdtype(cfg),
                         backend=cfg.gemm_backend, residual=x,
                         norm_scale=p["ln2"]["scale"])


def sublayer_full(p, cfg: ModelConfig, pos: int, x, aux, positions):
    """Full-sequence sub-layer.  Returns (x, aux, cache_entry): the rope'd
    K/V of every position in bf16, as the reference caches them."""
    kind = sublayer_kind(cfg, pos)
    assert kind["mixer"] == "attn" and not kind["cross"] \
        and kind["mlp"] in ("dense", "moe"), \
        "check_supported() gates the callers"
    # ln1 scale fuses into the q/k/v projection prologues
    h = layers.rmsnorm_normalize(x, cfg.rms_eps)
    out, (k, v) = attn_full(p["attn"], h, cfg, positions,
                            norm_scale=p["ln1"]["scale"])
    cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    x = x + out
    if kind["mlp"] == "moe":
        h = layers.rmsnorm(p["ln2"], x, cfg.rms_eps)
        m = cfg.moe
        y, a = moe_lib.moe_apply(p["moe"], h, top_k=m.top_k,
                                 capacity_factor=m.capacity_factor,
                                 groups=0,  # one dispatch group per sequence
                                 compute_dtype=_cdtype(cfg),
                                 aux_loss_weight=m.aux_loss_weight,
                                 backend=cfg.gemm_backend)
        return x + y, aux + a, cache
    return _mlp(p, cfg, x), aux, cache


def sublayer_decode(p, cfg: ModelConfig, pos_idx: int, x, cache, pos):
    """One-token sub-layer.  x: (B,1,d).  Returns (x, cache)."""
    kind = sublayer_kind(cfg, pos_idx)
    assert kind["mixer"] == "attn" and not kind["cross"] \
        and kind["mlp"] in ("dense", "moe"), \
        "check_supported() gates the callers"
    # ln1 scale fuses into the q/k/v projection prologues
    h = layers.rmsnorm_normalize(x, cfg.rms_eps)
    out, kv = attn_decode(p["attn"], h, cfg, cache, pos,
                          norm_scale=p["ln1"]["scale"])
    x = x + out
    if kind["mlp"] == "moe":
        h = layers.rmsnorm(p["ln2"], x, cfg.rms_eps)
        m = cfg.moe
        y, _ = moe_lib.moe_apply(p["moe"], h, top_k=m.top_k,
                                 capacity_factor=max(m.capacity_factor, 2.0),
                                 groups=1,  # decode: one global group
                                 compute_dtype=_cdtype(cfg),
                                 aux_loss_weight=0.0,
                                 backend=cfg.gemm_backend)
        return x + y, kv
    return _mlp(p, cfg, x), kv


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


# ---------------------------------------------------------------------------
# whole model

def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``,
    laid out as the reference's tree: ``blocks`` is a tuple (one entry per
    sub-layer of the period) of stacked dicts with a leading ``n_super``
    dim.  On the card unless ``device="cpu"``.

    Each stacked leaf is allocated once, in the parameter dtype, and
    filled layer by layer as the generator draws each layer, so the
    transient memory is one layer's tree (a full-width MoE model's
    stacked expert banks are 19 GB each in bf16)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = _pdtype(cfg)

    def stacked(i):
        n = n_super(cfg)
        layer = sublayer_init(gen, cfg, i, dev)
        out = _map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype,
                                         device=dev), layer)
        for l in range(n):
            if l:
                layer = sublayer_init(gen, cfg, i, dev)
            _put(out, layer, l)
        return out

    params = {
        "embed": layers.embedding_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dtype, dev),
        "final_norm": layers.rmsnorm_init(cfg.d_model, dtype, dev),
        "blocks": tuple(stacked(i) for i in range(period(cfg))),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.linear_init(gen, cfg.d_model,
                                               cfg.padded_vocab, dtype=dtype,
                                               device=dev)
    return params


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


def forward(cfg: ModelConfig, params, batch, *, return_cache=False):
    """Returns (logits (B,S,V) fp32, aux_loss, caches-or-None).
    batch['tokens']: (B,S).

    ``caches`` is laid out as :func:`init_cache`'s with ``max_seq = S``:
    per sub-layer of the period a dict ``{'k','v'}`` of bf16 tensors
    (n_super, B, S, KV, hd), each layer's rope'd K/V written into its
    slice as the layer runs."""
    substrate.check_backend(cfg.gemm_backend)
    check_supported(cfg)
    P = period(cfg)
    cd = _cdtype(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = layers.embed(params["embed"], tokens, cd)
    positions = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = (init_cache(cfg, B, S, device=x.device) if return_cache
              else None)
    for l in range(n_super(cfg)):
        for i in range(P):
            x, aux, c = sublayer_full(_layer(params["blocks"][i], l), cfg, i,
                                      x, aux, positions)
            if caches is not None:
                _put(caches[i], c, l)
    x = layers.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return _logits(cfg, params, x, cd), aux, caches


def prefill(cfg: ModelConfig, params, batch):
    """Returns (last-token logits (B,V), caches) of :func:`forward`."""
    logits, _, caches = forward(cfg, params, batch, return_cache=True)
    return logits[:, -1], caches


def decode_step(cfg: ModelConfig, params, cache, token, pos):
    """token: (B,) int; pos: scalar or (B,) int.  Returns (logits (B,V),
    cache) — the cache tensors are updated in place and returned."""
    substrate.check_backend(cfg.gemm_backend)
    check_supported(cfg)
    P = period(cfg)
    cd = _cdtype(cfg)
    x = layers.embed(params["embed"], token[:, None], cd)
    for l in range(n_super(cfg)):
        for i in range(P):
            x, _ = sublayer_decode(_layer(params["blocks"][i], l), cfg, i, x,
                                   _layer(cache[i], l), pos)
    x = layers.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return _logits(cfg, params, x, cd)[:, 0], cache


def supports_batched_prefill(cfg: ModelConfig) -> bool:
    """True when ``prefill_step`` reproduces the decode path: every
    sub-layer a plain causal-attention + dense-MLP block with a linear
    KV cache."""
    if cfg.sliding_window or cfg.family in ("vlm", "audio"):
        return False
    return all(
        k["mixer"] == "attn" and not k["cross"] and k["mlp"] != "moe"
        for k in (sublayer_kind(cfg, i) for i in range(period(cfg))))


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
    cd = _cdtype(cfg)
    C = tokens.shape[1]
    x = layers.embed(params["embed"], tokens, cd)
    for l in range(n_super(cfg)):
        for i in range(P):
            x, _ = sublayer_prefill(_layer(params["blocks"][i], l), cfg, i,
                                    x, _layer(cache[i], l), pos, lengths)
    x = layers.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=x.device)
    last = torch.clamp(lengths - 1, 0, C - 1)
    x = torch.take_along_dim(x, last[:, None, None], dim=1)           # (B,1,d)
    return _logits(cfg, params, x, cd)[:, 0], cache


# ---------------------------------------------------------------------------
# cache construction

def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zero-initialized decode cache: per sub-layer of the period a dict
    ``{'k','v'}`` of shape (n_super, B, max_seq, KV, hd).  On the card
    unless ``device="cpu"``."""
    check_supported(cfg)
    dev = resolve_device(device)
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    cl = cache_len(cfg, max_seq)
    shape = (n_super(cfg), batch_size, cl, KV, hd)
    return tuple({"k": torch.zeros(shape, dtype=dtype, device=dev),
                  "v": torch.zeros(shape, dtype=dtype, device=dev)}
                 for _ in range(period(cfg)))
