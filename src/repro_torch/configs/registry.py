"""Architecture registry: ``--arch <id>`` resolution for every assigned
config (plus the paper's own BERT-Large) -- the port's own copy of
``repro/configs/registry.py``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (
    bert_large,
    gemma2_9b,
    jamba_v0_1_52b,
    minicpm_2b,
    mixtral_8x22b,
    pixtral_12b,
    qwen2_moe_a2_7b,
    rwkv6_3b,
    stablelm_12b,
    starcoder2_15b,
    whisper_base,
)
from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        minicpm_2b, mixtral_8x22b, qwen2_moe_a2_7b, whisper_base,
        stablelm_12b, rwkv6_3b, gemma2_9b, starcoder2_15b,
        jamba_v0_1_52b, pixtral_12b, bert_large,
    )
}

ASSIGNED: List[str] = [
    "minicpm-2b", "mixtral-8x22b", "qwen2-moe-a2.7b", "whisper-base",
    "stablelm-12b", "rwkv6-3b", "gemma2-9b", "starcoder2-15b",
    "jamba-v0.1-52b", "pixtral-12b",
]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_configs() -> List[str]:
    return sorted(ARCHS)


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Sub-quadratic variant for the ``long_500k`` decode shape: cap any
    *full* attention layers in hybrid archs with a 4096 sliding window
    (used for jamba -- DESIGN.md §5).  Pure-attention archs are not
    eligible and raise."""
    if cfg.is_attention_free:
        return cfg
    if cfg.arch_type == "hybrid":
        pattern = tuple(
            dataclasses.replace(s, window=4096)
            if s.kind == "attn" and s.window is None else s
            for s in cfg.pattern
        )
        return dataclasses.replace(cfg, pattern=pattern)
    if cfg.supports_long_context() or any(
            s.window is not None for s in cfg.pattern):
        return cfg                    # SWA (mixtral) / alternating (gemma2)
    raise ValueError(
        f"{cfg.name} is pure full-attention; long_500k is skipped for it "
        "(DESIGN.md §5)")


def long_context_archs() -> List[str]:
    """Archs that run the long_500k shape (DESIGN.md §5)."""
    return ["rwkv6-3b", "jamba-v0.1-52b", "mixtral-8x22b", "gemma2-9b"]
