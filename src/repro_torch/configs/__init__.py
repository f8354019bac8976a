"""Architecture configs: one module per assigned arch + the paper's own
ADMM problem configs. ``get_config(name)`` / ``get_reduced(name)`` are the
public entry points; ``ARCHS`` lists all assigned ids.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = [
    "codeqwen15_7b",
    "yi_9b",
    "granite_34b",
    "command_r_35b",
    "llama4_scout_17b_a16e",
    "qwen2_moe_a27b",
    "llava_next_34b",
    "seamless_m4t_medium",
    "xlstm_125m",
    "recurrentgemma_2b",
]

# canonical ids from the assignment -> module names
ALIASES = {
    "codeqwen1.5-7b": "codeqwen15_7b",
    "yi-9b": "yi_9b",
    "granite-34b": "granite_34b",
    "command-r-35b": "command_r_35b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "llava-next-34b": "llava_next_34b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "xlstm-125m": "xlstm_125m",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    return _module(name).reduced()


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
