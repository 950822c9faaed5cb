"""Architecture & shape registry of the port.

``get_config(name)`` returns the full published config; ``get_shape(name)``
one of the four assigned input-shape cells; ``reduced(cfg)`` a smoke-test
sized config of the same family.  All ten of the reference's architectures
are registered, in its order, and the port runs every one of them
(``models.lm.check_supported``).
"""
from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K, reduced,
)

from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.llama_3_2_vision_90b import CONFIG as _llamavis
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.llama3_8b import CONFIG as _llama3
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2

ARCHS = {c.name: c for c in (
    _jamba, _mixtral, _qwen3moe, _llamavis, _qwen2,
    _llama3, _qwen25, _stablelm, _whisper, _mamba2,
)}

# Sub-quadratic (or bounded-KV) archs that can run the 500k-token decode
# cell; mixtral qualifies via its 4096-token sliding window (bounded KV).
LONG_CONTEXT_ARCHS = {"jamba-1.5-large-398b", "mamba2-370m", "mixtral-8x22b"}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]


def cell_is_runnable(arch: str, shape: str) -> (bool, str):
    """Whether (arch x shape) is a live dry-run cell, and why not if not."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "long_500k needs sub-quadratic attention (full-attn arch)"
    return True, ""


def all_cells():
    """Every live (arch, shape) pair."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            ok, _ = cell_is_runnable(a, s)
            if ok:
                out.append((a, s))
    return out
