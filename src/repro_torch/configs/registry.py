"""Architecture registry: ``--arch <id>`` resolution for the configs the
port supports so far (the JAX registry, ``repro/configs/registry.py``,
holds the full assigned pool; the others arrive with the model zoo)."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import bert_large
from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {bert_large.CONFIG.name: bert_large.CONFIG}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port supports "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


def list_configs() -> List[str]:
    return sorted(ARCHS)
