"""Architecture & shape registry of the port.

``get_config(name)`` returns the full published config; ``reduced(cfg)`` a
smoke-test sized config of the same family.  Only the architectures the
port serves so far are registered.
"""
from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, reduced,
)

from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe

ARCHS = {c.name: c for c in (_qwen2, _qwen3moe)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
