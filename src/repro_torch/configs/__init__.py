"""Config registry of the port: the architectures it can build so far."""
from __future__ import annotations

from . import mamba2_27b, smollm_135m
from .base import SHAPES, ArchConfig, ShapeCell, shape_by_name

_MODULES = {"smollm-135m": smollm_135m, "mamba2-2.7b": mamba2_27b}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return _MODULES[arch_id].reduced()


__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "ARCH_IDS", "get_config",
           "get_reduced", "shape_by_name"]
