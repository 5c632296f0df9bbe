"""Config registry of the port: every architecture the JAX package
builds."""
from __future__ import annotations

from . import (deepseek_v2_236b, gemma2_27b, mamba2_27b, pixtral_12b,
               qwen15_32b, qwen2_moe_a27b, smollm_135m, stablelm_12b,
               whisper_tiny, zamba2_7b)
from .base import SHAPES, ArchConfig, ShapeCell, shape_by_name

_MODULES = {
    "qwen1.5-32b": qwen15_32b,
    "gemma2-27b": gemma2_27b,
    "stablelm-12b": stablelm_12b,
    "smollm-135m": smollm_135m,
    "zamba2-7b": zamba2_7b,
    "mamba2-2.7b": mamba2_27b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "whisper-tiny": whisper_tiny,
    "pixtral-12b": pixtral_12b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].reduced()


def cells(arch_id: str):
    """All (arch, shape) cells for this arch, with skip markers, as the
    reference's: a list of (ShapeCell, runnable, reason)."""
    cfg = get_config(arch_id)
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.subquadratic:
            out.append((s, False, "skipped: pure full-attention arch "
                                  "(DESIGN.md §4)"))
        else:
            out.append((s, True, ""))
    return out


__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "ARCH_IDS", "get_config",
           "get_reduced", "cells", "shape_by_name"]
