"""Model API of the port: ``build_model(cfg)`` -> ``Model``.

Counterpart of src/repro/models/api.py for the dense, moe, ssm and hybrid
LM families:

    init_params(seed)                 -> params (dict of tensors)
    init_cache(batch_size, max_len)   -> cache (dict of tensors)
    prefill(params, batch)            -> (logits, cache)
    decode_step(params, batch)        -> (logits, cache)

``params_from_jax`` carries a parameter (or cache) tree exported from the
JAX package through numpy into tensors, leaf by leaf, so that both packages
can be fed the same weights.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import transformer


class Model:
    """An LM of a ported family on one device; methods are plain
    functions of tensors."""

    def __init__(self, cfg, device: torch.device):
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = device

    def init_params(self, seed: int = 0) -> dict:
        """The reference's distributions drawn from a torch.Generator seeded
        with ``seed`` (not JAX's numbers: use ``params_from_jax`` for
        those)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return transformer.init_lm(gen, self.cfg, self.device)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return transformer.init_cache(self.cfg, batch, max_len, self.device)

    def prefill(self, params: dict, batch: Dict[str, torch.Tensor]):
        return transformer.forward(params, self.cfg, batch["tokens"],
                                   cache=batch["cache"])

    def decode_step(self, params: dict, batch: Dict[str, torch.Tensor]):
        return transformer.forward(params, self.cfg, batch["tokens"],
                                   cache=batch["cache"])


def build_model(arch_cfg, *, device: DeviceLike = None) -> Model:
    """A ``Model`` on the card, or on ``device`` when the caller names one;
    raises when no GPU is present and no device is named."""
    return Model(arch_cfg, resolve_device(device))


def params_from_jax(tree, *, device: DeviceLike = None):
    """Leaf-by-leaf ``torch.from_numpy(leaf).to(device)`` over a tree of
    dicts/lists of numpy arrays (e.g. ``jax.device_get(params)``); every
    leaf keeps its dtype. numpy's bfloat16 (ml_dtypes), which torch cannot
    view, passes through float32 on its way to ``torch.bfloat16``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device=dev) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)   # a writable copy
