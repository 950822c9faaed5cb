"""whisper-base [audio] — encoder-decoder; conv frontend is a STUB.

6L(dec)+6L(enc) d_model=512 8H d_ff=2048 vocab=51865  [arXiv:2212.04356]

Per the assignment the conv frontend is a stub: ``input_specs()`` provides
precomputed frame embeddings (batch, frames, d_model).  ``seq_len`` of each
shape cell is interpreted as the number of encoder frames; the decoder length
is seq_len // 8 for train/prefill, and for decode shapes the decoder KV cache
is seq_len long while cross-attending to ``max_source_positions`` frames.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    max_source_positions=1500,
    rope_theta=1e4,
)
