"""``--arch <id>`` resolution for the port's entry points.

Every architecture of the reference's registry is registered: the dense,
MoE, ssm and hybrid families', the encoder-decoder ``whisper-medium`` and
the VLM ``pixtral-12b``.  ``dbrx-132b`` and the larger dense archs
(``mistral-large-123b``, ``qwen1.5-32b``) do not fit one card at full
depth: their CPU smoke configs run whole, their full configs at a cut
depth.  The paper's own
Llama 3.1 70B / 405B are in ``llama3_paper.py`` and, as in the reference,
are not ``--arch`` ids."""
from __future__ import annotations

import importlib

from ..models.common import ModelConfig

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "dbrx-132b": "dbrx_132b",
    "rwkv6-7b": "rwkv6_7b",
    "hymba-1.5b": "hymba_1_5b",
    "mistral-large-123b": "mistral_large_123b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen1.5-32b": "qwen1_5_32b",
    "whisper-medium": "whisper_medium",
    "pixtral-12b": "pixtral_12b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


__all__ = ["ARCH_IDS", "get_config", "get_smoke"]
