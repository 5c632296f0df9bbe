"""Model API of the port: ``build_model(cfg)`` -> ``Model``.

Counterpart of src/repro/models/api.py for every family (dense, vlm, moe,
ssm, hybrid and encdec):

    init_params(seed)                 -> params (dict of tensors)
    loss(params, batch)               -> 0-d f32 tensor (training)
    init_cache(batch_size, max_len)   -> cache (dict of tensors)
    prefill(params, batch)            -> (logits, cache)
    decode_step(params, batch)        -> (logits, cache)
    encode(params, frames)            -> encoder states (encdec)

An encdec ``prefill`` batch holds ``"frames"`` [B, F, d], ``"tokens"`` and
``"cache"``; its ``decode_step`` batch ``"tokens"``, ``"enc_out"`` (from
``encode``) and ``"cache"``. A vlm batch may hold ``"image_embeds"``
[B, N, d], which go before the token embeddings only where no cache is
given, as in the reference: ``prefill`` always has a cache and drops them.

``params_from_jax`` carries a parameter (or cache) tree exported from the
JAX package through numpy into tensors, leaf by leaf, so that both packages
can be fed the same weights.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import encdec, transformer


def loss_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL in f32 (logsumexp less the gold logit), over the
    positions ``mask`` keeps where one is given."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


class Model:
    """An LM (or whisper's encoder-decoder) on one device; methods are
    plain functions of tensors."""

    AUX_WEIGHT = 0.01          # the moe layers' load-balance loss, a layer

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = device

    def init_params(self, seed: int = 0) -> dict:
        """The reference's distributions drawn from a torch.Generator seeded
        with ``seed`` (not JAX's numbers: use ``params_from_jax`` for
        those)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if self.cfg.family == "encdec":
            return encdec.init_encdec(gen, self.cfg, self.device)
        return transformer.init_lm(gen, self.cfg, self.device)

    def init_cache(self, batch: int, max_len: int) -> dict:
        if self.cfg.family == "encdec":
            return encdec.init_dec_cache(self.cfg, batch, max_len,
                                         self.device)
        return transformer.init_cache(self.cfg, batch, max_len, self.device)

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """encdec: frame embeddings [B, F, d] -> encoder states [B, F, d]."""
        return encdec.encode(params, frames, self.cfg)

    def _lm_forward(self, params: dict, batch: Dict[str, torch.Tensor],
                    cache: Optional[dict] = None, **kw):
        cfg = self.cfg
        if cfg.family == "vlm":
            tok = params["embed"][batch["tokens"].long()]
            if "image_embeds" in batch and cache is None:
                tok = torch.cat([batch["image_embeds"].to(tok.dtype), tok],
                                dim=1)
            return transformer.forward(params, cfg, embeds=tok, cache=cache,
                                       **kw)
        return transformer.forward(params, cfg, batch["tokens"], cache=cache,
                                   **kw)

    def loss(self, params: dict, batch: Dict[str, torch.Tensor], *,
             q_chunk: int = 0, remat: str = "none") -> torch.Tensor:
        """The training loss of ``batch`` (``"tokens"`` [B, S]; encdec also
        ``"frames"``, vlm optionally ``"image_embeds"``): next-token NLL;
        encdec teacher-forced on ``tokens[:, :-1]``; vlm over the token
        rows after the image rows; moe plus ``AUX_WEIGHT`` times the aux
        loss over ``n_layers``. ``q_chunk`` and ``remat`` as in
        ``transformer.forward``."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.family == "encdec":
            enc_out = encdec.encode(params, batch["frames"], cfg)
            logits, _ = encdec.decode(params, tokens[:, :-1], enc_out, cfg,
                                      q_chunk=q_chunk, remat=remat)
            return loss_from_logits(logits, tokens[:, 1:])
        logits, _, aux = self._lm_forward(params, batch, q_chunk=q_chunk,
                                          remat=remat, with_aux=True)
        if cfg.family == "vlm" and "image_embeds" in batch:
            logits = logits[:, batch["image_embeds"].shape[1]:]
        loss = loss_from_logits(logits[:, :-1], tokens[:, 1:])
        if cfg.n_experts:
            loss = loss + self.AUX_WEIGHT * aux / max(cfg.n_layers, 1)
        return loss

    def prefill(self, params: dict, batch: Dict[str, torch.Tensor]):
        if self.cfg.family == "encdec":
            enc_out = encdec.encode(params, batch["frames"], self.cfg)
            return encdec.decode(params, batch["tokens"], enc_out, self.cfg,
                                 cache=batch["cache"])
        return self._lm_forward(params, batch, cache=batch["cache"])

    def decode_step(self, params: dict, batch: Dict[str, torch.Tensor]):
        if self.cfg.family == "encdec":
            return encdec.decode(params, batch["tokens"], batch["enc_out"],
                                 self.cfg, cache=batch["cache"])
        return self._lm_forward(params, batch, cache=batch["cache"])


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
