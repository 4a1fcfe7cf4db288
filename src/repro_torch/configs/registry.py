"""Arch registry: ``--arch <id>`` resolution for launchers/tests."""
from __future__ import annotations

import importlib

from repro_torch.models import ModelConfig, reduced

ARCHS: dict[str, str] = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen2.5-14b": "qwen2_5_14b",
    "minitron-8b": "minitron_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "stablelm-1.6b": "stablelm_1_6b",
    "zamba2-2.7b": "zamba2_2_7b",
    "chameleon-34b": "chameleon_34b",
    "mamba2-2.7b": "mamba2_2_7b",
    "hubert-xlarge": "hubert_xlarge",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; one of {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


def get_reduced(arch: str, **overrides) -> ModelConfig:
    """Smoke-test sized config of the same family (CPU-runnable)."""
    return reduced(get_config(arch), **overrides)
