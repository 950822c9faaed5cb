"""Three-term roofline model, priced on one NVIDIA H100 80GB HBM3 (SXM5).

Port of the reference's ``roofline/model.py``; the TPU v5e constants are
replaced by the card's datasheet figures (NVIDIA H100 80GB HBM3, SXM5,
700 W, datasheet):

  compute    = FLOPs_per_device / PEAK_FLOPS_BF16
  memory     = HBM_bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

The per-device counts come from ``roofline.trace`` (a dispatch-mode
tracer of the eager step), not from a compiled program.  Two readings
of the terms are the reference's own: the bf16 peak also prices the
fp32 products the ``xla`` backend's training step runs (the reference
prices every dot at its bf16 peak too), and the collective term prices
the port's inter-shard copies as if they crossed NVLink, although the
logical devices of one card share its memory and those copies are
device-local.  MODEL_FLOPS uses the 6·N·D / 2·N·D convention with
N = active parameters for MoE; an attention-inclusive variant is also
reported so long-context cells have an honest useful-FLOPs ratio.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig

# NVIDIA H100 80GB HBM3 (SXM5), 700 W, datasheet
PEAK_FLOPS_BF16 = 989.4e12      # dense bf16 FLOP/s (not the sparse 1979)
HBM_BW = 3.35e12                # bytes/s
LINK_BW = 450e9                 # bytes/s: NVLink 4's 900 GB/s, one direction
HBM_BYTES = 80 * 2**30          # device memory, for the fits verdict


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute-term share of the binding term: 1.0 = compute-bound at
        peak; <1 means memory/collective dominate."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0


def terms_from_analysis(hlo: dict) -> RooflineTerms:
    return RooflineTerms(
        compute_s=hlo["flops_per_device"] / PEAK_FLOPS_BF16,
        memory_s=hlo["hbm_bytes_per_device"] / HBM_BW,
        collective_s=hlo["collective_total_per_device"] / LINK_BW,
    )


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Useful-FLOPs estimates (whole job, all devices)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        toks = shape.tokens
        base = 6.0 * n_active * toks
        fwd_mult = 3.0
    elif shape.kind == "prefill":
        toks = shape.tokens
        base = 2.0 * n_active * toks
        fwd_mult = 1.0
    else:  # decode: one token per sequence
        toks = shape.global_batch
        base = 2.0 * n_active * toks
        fwd_mult = 1.0

    # attention score/value flops (excluded from the 6ND convention)
    hd = cfg.resolved_head_dim
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i))
    S = shape.seq_len
    B = shape.global_batch
    win = cfg.sliding_window or 0
    if shape.kind == "decode":
        ctx = min(S, win) if win else S
        attn = 4.0 * n_attn * B * ctx * cfg.n_heads * hd
    else:
        if win and win < S:
            pairs = S * win - win * win / 2.0
        else:
            pairs = S * S / 2.0
        attn = 4.0 * n_attn * B * pairs * cfg.n_heads * hd * fwd_mult
        attn += (4.0 * cfg.n_encoder_layers * B * S * S
                 * cfg.n_heads * hd * fwd_mult)
    return {"model_flops": base, "model_flops_with_attn": base + attn,
            "n_active_params": n_active,
            "n_params": cfg.param_count()}
