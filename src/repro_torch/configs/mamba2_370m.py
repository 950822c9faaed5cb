"""mamba2-370m [ssm] — attention-free, SSD (state-space duality).

48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=16,          # unused (attention-free); kept for head_dim bookkeeping
    n_kv_heads=16,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
)
