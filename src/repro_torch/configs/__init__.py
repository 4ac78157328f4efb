"""System and model configurations (port of ``src/repro/configs``).

``get_config(name)`` resolves a model architecture by the reference's
names and aliases: all ten of the reference's architectures are ported;
``list_configs()`` lists them.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, RecurrentConfig, SHAPES, SSMConfig, ShapeConfig,
    reduced,
)

ARCHS = (
    "qwen3_32b",
    "qwen15_4b",
    "gemma2_9b",
    "minicpm_2b",
    "deepseek_moe_16b",
    "arctic_480b",
    "recurrentgemma_9b",
    "mamba2_27b",
    "qwen2_vl_7b",
    "whisper_large_v3",
)

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS.update({
    "qwen3-32b": "qwen3_32b",
    "qwen1.5-4b": "qwen15_4b",
    "gemma2-9b": "gemma2_9b",
    "minicpm-2b": "minicpm_2b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "arctic-480b": "arctic_480b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-2.7b": "mamba2_27b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-large-v3": "whisper_large_v3",
})


def get_config(name: str) -> ModelConfig:
    arch = _ALIAS.get(name, name).replace("-", "_").replace(".", "")
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def list_configs() -> list:
    return list(ARCHS)
