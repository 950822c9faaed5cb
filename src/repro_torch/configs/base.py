"""Configuration dataclasses for the ArrayFlex PyTorch port.

Every assigned architecture is expressed as a :class:`ModelConfig`; every
input-shape cell as a :class:`ShapeConfig`.  Configs are plain frozen
dataclasses so they hash, print, and round-trip through the launcher CLI.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (GShard/Mixtral-style token-choice)."""

    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    # Which layers are MoE: every `moe_every`-th layer starting at `moe_offset`.
    moe_every: int = 1
    moe_offset: int = 0
    # d_ff of each expert (may differ from the dense d_ff).
    expert_d_ff: int = 0
    # Number of shared (always-on) experts, DeepSeek-style.  0 for the pool.
    num_shared_experts: int = 0
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) sub-config."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  One instance per assigned arch."""

    name: str = "unnamed"
    # dense | moe | hybrid | ssm | vlm | audio
    family: str = "dense"
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 32000
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # Sliding-window attention; 0 disables.
    sliding_window: int = 0
    # MoE / SSM sub-configs (None when not used by the family).
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Jamba): period of the attn/mamba interleave, and which index
    # within each period is the attention layer.
    hybrid_period: int = 8
    hybrid_attn_index: int = 4
    # vlm: cross-attention layers every `cross_attn_every` layers.
    cross_attn_every: int = 5
    n_image_tokens: int = 1600
    d_frontend: int = 1280       # raw vision/audio embedding width (pre-projection)
    # audio (enc-dec): number of encoder layers (decoder gets n_layers).
    n_encoder_layers: int = 0
    max_source_positions: int = 1500
    # --- numerics / execution policy -------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # remat: "none" | "dots" | "full"
    remat: str = "full"
    scan_layers: bool = True
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    # use dense (unchunked) attention below this seq_len
    attn_dense_below: int = 2048
    logit_softcap: float = 0.0
    # --- ArrayFlex integration -------------------------------------------
    # Execution backend every model GEMM dispatches through
    # (kernels.substrate registry): "xla" (plain torch.matmul),
    # "arrayflex" (the hand-written CUDA K-collapse kernel at the
    # planner's Eq.(6) k; its plain PyTorch version on CPU tensors),
    # "ref" (fp32 oracle).  Validated against substrate.backends() at the
    # execution entry points (lm.decode_step / prefill_step, the serving
    # engine, serve.py) so an unknown name fails with the registered list.
    gemm_backend: str = "xla"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over any mesh axis."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        ssm = self.ssm or SSMConfig()
        return ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        ssm = self.ssm or SSMConfig()
        return self.d_inner // ssm.head_dim

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return i % self.hybrid_period == self.hybrid_attn_index
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return i % self.moe.moe_every == self.moe.moe_offset

    def is_cross_attn_layer(self, i: int) -> bool:
        if self.family != "vlm":
            return False
        return i % self.cross_attn_every == (self.cross_attn_every - 1)

    # ---- parameter counting (used by roofline MODEL_FLOPS) --------------
    def param_count(self, active_only: bool = False) -> int:
        d, ff, hd = self.d_model, self.d_ff, self.resolved_head_dim
        q_dim = self.n_heads * hd
        kv_dim = self.n_kv_heads * hd
        attn = d * q_dim + 2 * d * kv_dim + q_dim * d
        dense_mlp = 3 * d * ff
        ssm = self.ssm or SSMConfig()
        d_in = self.d_inner
        bc = 2 * ssm.n_groups * ssm.d_state
        nh = self.ssm_heads
        mamba = d * (2 * d_in + bc + nh) + d_in * d + ssm.d_conv * (d_in + bc)
        total = 0
        n_layers = self.n_layers + self.n_encoder_layers
        for i in range(self.n_layers):
            if self.family == "ssm":
                total += mamba
            elif self.family == "hybrid":
                total += attn if self.is_attn_layer(i) else mamba
            else:
                total += attn
            if self.is_cross_attn_layer(i):
                total += attn  # cross-attention projections
            if self.is_moe_layer(i):
                m = self.moe
                eff = m.expert_d_ff or ff
                n_e = (m.top_k + m.num_shared_experts) if active_only else (
                    m.num_experts + m.num_shared_experts)
                total += 3 * d * eff * n_e + d * m.num_experts
            elif self.family != "ssm" or self.d_ff:
                if self.d_ff:
                    total += dense_mlp
        for _ in range(self.n_encoder_layers):
            total += attn + dense_mlp
        total += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        total += n_layers * 2 * d + d  # norms
        return total


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    # train | prefill | decode
    kind: str = "train"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes = dict(
        n_layers=max(2, cfg.hybrid_period) if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        n_image_tokens=16 if cfg.family == "vlm" else cfg.n_image_tokens,
        cross_attn_every=2 if cfg.family == "vlm" else cfg.cross_attn_every,
        d_frontend=32,
        attn_dense_below=4096,
        remat="none",
        max_source_positions=64,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, expert_d_ff=128)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=32)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
