"""llama-3.2-vision-90b [vlm] — decoder with interleaved image cross-attention.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings of width ``d_frontend``; a learned projection
maps them to d_model and every 5th layer cross-attends to them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    cross_attn_every=5,
    n_image_tokens=1600,
    d_frontend=1280,
    rope_theta=5e5,
)
