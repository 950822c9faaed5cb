"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536  [arXiv:2403.19887; hf]

Jamba blocks have period 8: one attention layer (index 4 within the period)
and seven Mamba layers; every other layer carries a 16-expert top-2 MoE MLP.
NOTE (DESIGN.md §Arch-applicability): the SSM layers use the Mamba-2 SSD
formulation rather than Jamba's original Mamba-1 selective scan — the SSD
dual form is the TPU-native (matmul-friendly) expression of the same SSM.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    hybrid_period=8,
    hybrid_attn_index=4,
    moe=MoEConfig(num_experts=16, top_k=2, moe_every=2, moe_offset=1,
                  expert_d_ff=24576),
    ssm=SSMConfig(d_state=128, head_dim=128, n_groups=1),
    rope_theta=1e6,
)
