"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced_config(arch_id)``.

The port's own copy of the reference registry, holding the architectures
the port serves: the dense llama family and the qwen3 MoE.  Every
architecture lives in its own module exposing ``CONFIG`` (the exact
published shape) and ``reduced()`` (a tiny same-family config for CPU
tests).  The other families arrive with their model code (ROADMAP
queue 1, "Remaining families").
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, MoEConfig, QuantConfig,
                                      ShapeConfig, SSMConfig, SHAPES,
                                      SHAPES_BY_NAME)

ARCH_IDS = (
    "tinyllama-1.1b",
    "llama2-7b",
    "qwen3-moe-30b-a3b",
    "smollm-135m",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch]).reduced()


__all__ = ["ModelConfig", "MoEConfig", "QuantConfig", "ShapeConfig", "SSMConfig",
           "SHAPES", "SHAPES_BY_NAME", "ARCH_IDS", "get_config", "get_reduced_config"]
