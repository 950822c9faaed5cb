"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, fine-grained experts.

48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936  [hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=8, moe_every=1, expert_d_ff=768),
    rope_theta=1e6,
)
