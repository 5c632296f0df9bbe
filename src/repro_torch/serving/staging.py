"""Stage partitioning of the LMs (paper §III-B1 on transformers).

Counterpart of src/repro/serving/staging.py (the dense, vlm, gemma2, ssm
and moe families; the hybrid is refused, as there). A stacked LM is cut
into ``n_stages`` contiguous layer groups (gemma2: groups of its
(local, global) blocks, ``n_layers // 2`` of them); each stage is a function
(hidden, cache_slice) -> (hidden, cache_slice), so DARIS can preempt and
migrate between groups. Stage 0 owns the embedding, the last stage the
final norm and logits. Migration moves the inter-stage hidden and the cache
slices to the target context's device between stage programs.

The moe family is cut as the reference cuts it: the boundaries run over
``cfg.n_layers`` and slice only ``params["layers"]``, so the leading dense
layers (deepseek's first) never run staged and the last stages may hold
no layer (ROADMAP.md §3, R4).
"""
from __future__ import annotations

from typing import Callable, List

import torch

from ..models import transformer
from ..models.api import Model


def stage_boundaries(n_layers: int, n_stages: int) -> List[tuple]:
    per = n_layers // n_stages
    rem = n_layers % n_stages
    out = []
    lo = 0
    for i in range(n_stages):
        hi = lo + per + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _n_scan(cfg) -> int:
    """Entries of the stacked layer axis the stages cut (gemma2: blocks of
    two layers; moe: ``n_layers``, as the reference counts it)."""
    return cfg.n_layers // (2 if cfg.local_global_alternating else 1)


def make_lm_stage_fns(model: Model, n_stages: int = 4,
                      in_place: bool = False) -> List[Callable]:
    """Stage callables of the dense, vlm, gemma2, ssm and moe families (moe
    layers on the dense expert oracle, as the reference stages them):

    stage_fn(params, hidden_or_tokens, cache_slice, positions)
      -> (hidden_or_logits, new_cache_slice)

    With ``in_place`` (a decode step, one token) each layer writes its new
    slots, or its new SSM state, conv histories and ``length``, into the
    ``cache_slice`` it was given, and ``new_cache_slice`` is that same
    tree (``transformer.run_layers``): for a stage program, whose slice is
    its own static copy; never for a slice of a cache that must stay as
    it is (``slice_cache``'s views of a donor)."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        raise NotImplementedError(
            "hybrid staging follows group boundaries; use n_stages == "
            "n_layers // attn_every")
    bounds = stage_boundaries(_n_scan(cfg), n_stages)

    def make(i):
        lo, hi = bounds[i]

        def stage(params, x, cache_slice, positions):
            if i == 0 and not torch.is_floating_point(x):
                x = transformer.embed(params, cfg, x)
            layers = transformer.index_tree(params["layers"], slice(lo, hi))
            x, new_cache, _ = transformer.run_layers(
                layers, x, cfg, positions, cache_slice, moe_oracle=True,
                in_place=in_place)
            if i == n_stages - 1:
                x = transformer.logits(params, cfg, x)
            return x, new_cache

        return stage

    return [make(i) for i in range(n_stages)]


def slice_cache(cfg, cache: dict, stage_idx: int, n_stages: int) -> dict:
    """Cache slice owned by one stage (moe at its ``"layers"`` level): views
    into ``cache``, which the functional cache update never writes."""
    lo, hi = stage_boundaries(_n_scan(cfg), n_stages)[stage_idx]
    if cfg.family == "moe" and "layers" in cache:
        cache = cache["layers"]
    return transformer.index_tree(cache, slice(lo, hi))


def migrate(tree, target: torch.device):
    """Zero-delay migration: move the inter-stage state onto the target
    context's device at a stage boundary. A no-op for tensors already
    there, and for a tree none of whose tensors moves: the tree itself,
    so that a call made ready on it (``RealtimeBackend``) stays the next
    stage's."""
    if isinstance(tree, dict):
        out = {k: migrate(v, target) for k, v in tree.items()}
        return tree if all(out[k] is v for k, v in tree.items()) else out
    if isinstance(tree, (list, tuple)):
        out = [migrate(v, target) for v in tree]
        return (tree if all(a is b for a, b in zip(out, tree))
                else type(tree)(out))
    if isinstance(tree, torch.Tensor):
        return tree.to(target, non_blocking=True)
    return tree
