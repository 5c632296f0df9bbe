"""AdamW over the port's parameter trees.

Counterpart of src/repro/training/optimizer.py: the same ``AdamWConfig``
fields and defaults, ``lr_at`` (linear warmup, then cosine to
``min_lr_frac``, in f32), ``adamw_init`` (m and v in their configured
dtypes, f32 ``master`` copies with ``master=True``, an int32 ``step``),
``global_norm`` and ``adamw_update``. Parameters, moments and masters are
trees of dicts and lists of tensors, as the port's parameters are; the
step and the scalars derived from it are 0-d tensors on the parameters'
device, so an update never waits on the device.

``adamw_update`` is functional, as the reference's is: it returns new
trees and leaves its arguments untouched. Each leaf runs its own chain
(g -> m -> v -> update) under ``torch.no_grad()``, so its f32 temporaries
are freed before the next leaf starts (the reference's single per-leaf
map, for the same reason).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..models.transformer import TORCH_DTYPES


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    master: bool = False
    # moment dtypes: a bf16 first moment halves its memory; v stays f32
    # for a stable rsqrt
    m_dtype: str = "float32"
    v_dtype: str = "float32"


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of dicts, lists and tuples of the
    same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in its order."""
    out = []
    tree_map(out.append, tree)
    return out


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; f32."""
    s = step.float()
    warm = cfg.lr * torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(s < cfg.warmup_steps, warm, cfg.lr * cos)


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    leaf = tree_leaves(params)[0]
    state = {
        "m": tree_map(lambda p: torch.zeros(
            p.shape, dtype=TORCH_DTYPES[cfg.m_dtype], device=p.device),
            params),
        "v": tree_map(lambda p: torch.zeros(
            p.shape, dtype=TORCH_DTYPES[cfg.v_dtype], device=p.device),
            params),
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }
    if cfg.master:
        state["master"] = tree_map(lambda p: p.detach().float().clone(),
                                   params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict,
                 cfg: AdamWConfig, *,
                 grad_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, dict, dict]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}); the
    gradients are clipped to ``grad_clip`` by their global norm first
    (``grad_norm`` where the caller has it: the norm over every rank's
    shards)."""
    step = state["step"] + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = (torch.clamp(cfg.grad_clip / (gn + 1e-12), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = lr_at(cfg, step)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    def leaf(p, g, m, v, master=None):
        g32 = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32.square()
        b = master.float() if master is not None else p.float()
        nb = b - lr * ((m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
                       + cfg.weight_decay * b)
        out = (nb.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype))
        return out + (nb,) if master is not None else out

    rest = [grads, state["m"], state["v"]]
    if cfg.master:
        rest.append(state["master"])
    tup = tree_map(leaf, params, *rest)
    new_state = {"m": _pick(tup, 1), "v": _pick(tup, 2), "step": step}
    if cfg.master:
        new_state["master"] = _pick(tup, 3)
    return _pick(tup, 0), new_state, {"grad_norm": gn, "lr": lr}


def _pick(tree, i: int):
    """Element ``i`` of every tuple leaf of a tree of per-leaf results."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
