"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768  [arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, moe_every=1, expert_d_ff=16384),
    rope_theta=1e6,
)
