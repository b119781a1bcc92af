"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced_config(arch_id)``.

The port's own copy of the reference registry, holding every architecture
of the families the port runs: the dense llama family (TinyLlama-1.1B,
LLaMA-2-7B, Mistral-7B, Command-R-35B, LLaMA-3-405B, SmolLM-135M), the MoE
family (Qwen3-30B-A3B, Moonlight-16B-A3B), the VLM (PaliGemma-3B: a gemma
decoder over a patch-embedding prefix), RWKV6-3B (linear attention with
data-dependent decay), the hybrid Zamba2-1.2B (a Mamba2 backbone with
one shared attention block) and the encoder-decoder whisper-small (a
transformer encoder over stub frame embeddings, and a decoder with
cross-attention to it): every architecture of the reference.  Every
architecture lives in its own module exposing ``CONFIG`` (the exact
published shape) and ``reduced()`` (a tiny same-family config for CPU
tests), each a copy of the reference's.
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
    "mistral-7b",
    "command-r-35b",
    "llama3-405b",
    "moonshot-v1-16b-a3b",
    "whisper-small",
    "paligemma-3b",
    "rwkv6-3b",
    "zamba2-1.2b",
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
