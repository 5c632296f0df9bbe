"""Config registry of the port: the architectures it can build so far."""
from __future__ import annotations

from . import (mamba2_27b, qwen2_moe_a27b, qwen15_32b, smollm_135m,
               zamba2_7b)
from .base import SHAPES, ArchConfig, ShapeCell, shape_by_name

_MODULES = {"qwen1.5-32b": qwen15_32b, "smollm-135m": smollm_135m,
            "zamba2-7b": zamba2_7b, "mamba2-2.7b": mamba2_27b,
            "qwen2-moe-a2.7b": qwen2_moe_a27b}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].reduced()


__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "ARCH_IDS", "get_config",
           "get_reduced", "shape_by_name"]
