"""``--arch <id>`` resolution for the port's entry points.

Only the architectures whose family the port runs (dense, moe, ssm,
hybrid) are registered; the others (whisper, pixtral, the other dense
archs) arrive with ROADMAP item 10 (other families).
``dbrx-132b`` is there for its CPU smoke config: the full model does not
fit one card."""
from __future__ import annotations

import importlib

from ..models.common import ModelConfig

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "dbrx-132b": "dbrx_132b",
    "rwkv6-7b": "rwkv6_7b",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(
            f"arch {arch!r} is not ported yet (known: {list(_MODULES)}); "
            "the other dense, MoE, ssm and hybrid archs and the other "
            "families arrive with ROADMAP item 10")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE


__all__ = ["ARCH_IDS", "get_config", "get_smoke"]
