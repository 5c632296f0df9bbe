"""Model API of the port: ``build_model(cfg)`` -> ``Model``.

Counterpart of src/repro/models/api.py for every family (dense, vlm, moe,
ssm, hybrid and encdec):

    init_params(seed)                 -> params (dict of tensors)
    loss(params, batch)               -> 0-d f32 tensor (training)
    init_cache(batch_size, max_len)   -> cache (dict of tensors)
    prefill(params, batch)            -> (logits, cache)
    decode_step(params, batch)        -> (logits, cache)
    encode(params, frames)            -> encoder states (encdec)
    input_specs(cell)                 -> meta-tensor stand-ins per shape cell
    model_flops(cell)                 -> MODEL_FLOPS per the roofline contract
                                         (6·N_active·D train, 2·N_active·D
                                         inference; N excludes embeddings)

``param_counts``, ``model_flops``, ``param_bytes``, ``kv_cache_bytes`` and
``analytic_hbm_bytes`` are the reference's published accounting, the same
arithmetic on the same config. Head padding for tensor parallelism
(``build_model(pad_for_tp=)``; qwen1.5 40 -> 48 heads) changes the config
that drives parameters and compute; the published config (``Model.orig``)
drives MODEL_FLOPS, so the roofline ratio shows the padding's waste.

With ``dist`` (``ShardingRules.dist_ctx()``) the forward runs as one rank
of a mesh on that rank's shards (``parallel/sharding.py``): heads, ffn,
vocab and experts split over the ``model`` axis with explicit collectives,
weights gathered over the data axes where the rules shard them there.

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

from ..configs.base import ArchConfig, ShapeCell
from ..device import DeviceLike, resolve_device
from . import encdec, transformer
from .transformer import TORCH_DTYPES


def pad_heads_for_tp(cfg: ArchConfig, tp: int = 16) -> ArchConfig:
    """TP-alignment padding, as the reference's.

    * heads: pad up to a multiple of tp when close (qwen1.5 40->48); tiny
      archs (smollm 9H, whisper 6H) stay unpadded -> replicated attention.
    * vocab: pad to a multiple of tp (whisper 51865->51872, mamba2
      50280->50288) so logits/embedding shard; the dummy tokens are never
      emitted and their logits are dead weight."""
    if cfg.vocab_size % tp:
        cfg = cfg.replace(vocab_size=cfg.vocab_size
                          + (tp - cfg.vocab_size % tp))
    if cfg.n_heads == 0 or cfg.n_heads % tp == 0:
        return cfg
    padded = cfg.n_heads + (tp - cfg.n_heads % tp)
    if padded <= cfg.n_heads * 1.25:   # accept <=25% head padding
        kv = cfg.n_kv_heads
        if kv == cfg.n_heads:
            kv = padded
        return cfg.replace(n_heads=padded, n_kv_heads=kv,
                           head_dim=cfg.resolved_head_dim)
    return cfg


def _itemsize(dtype: str) -> int:
    return TORCH_DTYPES[dtype].itemsize


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

    def __init__(self, cfg, device: torch.device,
                 orig_cfg: Optional[ArchConfig] = None,
                 dist: Optional[dict] = None):
        self.cfg = cfg
        self.device = device
        self.orig = orig_cfg or cfg
        # distribution context (ShardingRules.dist_ctx()): this rank's
        # place on the mesh, its groups and the parameters' specs
        self.dist = dist

    def init_params(self, seed: int = 0) -> dict:
        """The reference's distributions drawn from a torch.Generator seeded
        with ``seed`` (not JAX's numbers: use ``params_from_jax`` for
        those). On the ``meta`` device only the shapes and dtypes."""
        gen = None
        if self.device.type != "meta":
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

    def _cons(self):
        if self.dist is None:
            return None
        from ..parallel.sharding import ActConstraint
        return ActConstraint(self.dist)

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """encdec: frame embeddings [B, F, d] -> encoder states [B, F, d]."""
        return encdec.encode(params, frames, self.cfg, cons=self._cons(),
                             dist=self.dist)

    def _lm_forward(self, params: dict, batch: Dict[str, torch.Tensor],
                    cache: Optional[dict] = None, **kw):
        cfg = self.cfg
        kw.setdefault("dist", self.dist)
        if cfg.family == "vlm":
            tok = transformer.lookup(params["embed"], batch["tokens"],
                                     cfg.vocab_size, kw["dist"])
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
            enc_out = self.encode(params, batch["frames"])
            logits, _ = encdec.decode(params, tokens[:, :-1], enc_out, cfg,
                                      q_chunk=q_chunk, remat=remat,
                                      cons=self._cons(), dist=self.dist)
            return self._nll(logits, tokens[:, 1:])
        logits, _, aux = self._lm_forward(params, batch, q_chunk=q_chunk,
                                          remat=remat, with_aux=True)
        if cfg.family == "vlm" and "image_embeds" in batch:
            logits = logits[:, batch["image_embeds"].shape[1]:]
        loss = self._nll(logits[:, :-1], tokens[:, 1:])
        if cfg.n_experts:
            loss = loss + self.AUX_WEIGHT * aux / max(cfg.n_layers, 1)
        return loss

    def _nll(self, logits: torch.Tensor, targets: torch.Tensor):
        """The mean NLL; under ``dist`` the logits are this rank's vocab
        slice and the loss is the vocab-parallel one."""
        if self.dist is not None:
            from ..parallel.sharding import vocab_parallel_nll
            return vocab_parallel_nll(logits, targets, self.dist)
        return loss_from_logits(logits, targets)

    def prefill(self, params: dict, batch: Dict[str, torch.Tensor], *,
                q_chunk: int = 0):
        if self.cfg.family == "encdec":
            enc_out = self.encode(params, batch["frames"])
            return encdec.decode(params, batch["tokens"], enc_out, self.cfg,
                                 cache=batch["cache"], q_chunk=q_chunk,
                                 cons=self._cons(), dist=self.dist)
        return self._lm_forward(params, batch, cache=batch["cache"],
                                q_chunk=q_chunk)

    def decode_step(self, params: dict, batch: Dict[str, torch.Tensor]):
        if self.cfg.family == "encdec":
            return encdec.decode(params, batch["tokens"], batch["enc_out"],
                                 self.cfg, cache=batch["cache"],
                                 cons=self._cons(), dist=self.dist)
        return self._lm_forward(params, batch, cache=batch["cache"])

    # ---------------------------------------------------------------- specs
    def input_specs(self, cell: ShapeCell) -> Dict:
        """Meta-tensor stand-ins (shape and dtype) for every model input of
        this cell, in the reference's dict layout."""
        cfg = self.cfg
        b, s = cell.global_batch, cell.seq_len
        meta = torch.device("meta")
        dt = TORCH_DTYPES[cfg.dtype]

        def sd(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=meta)

        def cache():
            if cfg.family == "encdec":
                return encdec.init_dec_cache(cfg, b, s, meta)
            return transformer.init_cache(cfg, b, s, meta)

        i32 = torch.int32
        if cfg.family == "encdec":
            frames = sd((b, cfg.encoder_frames, cfg.d_model), dt)
            if cell.kind == "train":
                return {"frames": frames, "tokens": sd((b, s), i32)}
            if cell.kind == "prefill":
                return {"frames": frames, "tokens": sd((b, s), i32),
                        "cache": cache()}
            return {"tokens": sd((b, 1), i32), "cache": cache(),
                    "enc_out": frames}
        if cfg.family == "vlm":
            n_img = cfg.n_image_tokens
            img = sd((b, n_img, cfg.d_model), dt)
            if cell.kind == "train":
                return {"tokens": sd((b, s - n_img), i32),
                        "image_embeds": img}
            if cell.kind == "prefill":
                return {"tokens": sd((b, s - n_img), i32),
                        "image_embeds": img, "cache": cache()}
            return {"tokens": sd((b, 1), i32), "cache": cache()}
        if cell.kind == "train":
            return {"tokens": sd((b, s), i32)}
        if cell.kind == "prefill":
            return {"tokens": sd((b, s), i32), "cache": cache()}
        return {"tokens": sd((b, 1), i32), "cache": cache()}

    # --------------------------------------------------------------- flops
    def param_counts(self) -> Dict[str, float]:
        """Analytic param counts from the *published* config."""
        c = self.orig
        d = c.d_model
        counts = {"embed": c.vocab_size * d * (1 if c.tie_embeddings else 2)}
        hd = c.resolved_head_dim
        attn = d * hd * (c.n_heads * 2 + c.n_kv_heads * 2) if c.n_heads else 0
        if c.use_mla:
            qk = c.qk_nope_head_dim + c.qk_rope_head_dim
            attn = (d * c.q_lora_rank + c.q_lora_rank * c.n_heads * qk
                    + d * (c.kv_lora_rank + c.qk_rope_head_dim)
                    + c.kv_lora_rank * c.n_heads * (c.qk_nope_head_dim
                                                    + c.v_head_dim)
                    + c.n_heads * c.v_head_dim * d)
        mlp = 3 * d * c.d_ff
        ssm = 0
        if c.ssm_state:
            di = c.d_inner
            ssm = (2 * d * di + d * 2 * c.ssm_ngroups * c.ssm_state
                   + d * c.ssm_nheads + di * d)
        if c.family == "dense" or c.family == "vlm":
            per_layer = attn + mlp
            layers = c.n_layers * per_layer
            active = layers
        elif c.family == "moe":
            routed = 3 * d * c.moe_d_ff
            shared = 3 * d * c.shared_d_ff if c.shared_d_ff else 0
            moe_layer = attn + routed * c.n_experts + shared + d * c.n_experts
            dense_layer = attn + mlp
            n_moe = c.n_layers - c.n_dense_layers
            layers = n_moe * moe_layer + c.n_dense_layers * dense_layer
            active = (n_moe * (attn + routed * c.n_experts_active + shared
                               + d * c.n_experts)
                      + c.n_dense_layers * dense_layer)
        elif c.family == "ssm":
            layers = c.n_layers * ssm
            active = layers
        elif c.family == "hybrid":
            d2 = 2 * d
            shared_attn = (d2 * hd * (c.n_heads + 2 * c.n_kv_heads)
                           + c.n_heads * hd * d + d * d + 3 * d * c.d_ff)
            layers = c.n_layers * ssm + shared_attn
            n_apps = c.n_layers // c.attn_every
            active = c.n_layers * ssm + n_apps * shared_attn
        elif c.family == "encdec":
            enc_layer = attn + 2 * d * c.d_ff
            layers = (c.n_encoder_layers * enc_layer
                      + c.n_layers * (2 * attn + 2 * d * c.d_ff))
            active = layers
        else:
            raise ValueError(c.family)
        counts["layers"] = float(layers)
        counts["active"] = float(active)
        counts["total"] = float(layers) + counts["embed"]
        return counts

    def model_flops(self, cell: ShapeCell) -> float:
        """MODEL_FLOPS per the roofline contract: 6·N·D train, 2·N·D infer
        (N = active non-embedding params, D = tokens processed)."""
        n_active = self.param_counts()["active"]
        if cell.kind == "train":
            tokens = cell.global_batch * cell.seq_len
            return 6.0 * n_active * tokens
        if cell.kind == "prefill":
            tokens = cell.global_batch * cell.seq_len
            return 2.0 * n_active * tokens
        return 2.0 * n_active * cell.global_batch   # one decode step

    def param_bytes(self) -> float:
        return self.param_counts()["total"] * _itemsize(self.cfg.dtype)

    def kv_cache_bytes(self, batch: int, seq: int) -> float:
        """Total KV/state cache bytes for the whole batch."""
        c = self.cfg
        if c.family == "ssm":
            per = (c.ssm_nheads * c.ssm_headdim * c.ssm_state * 4
                   + (c.ssm_conv_width - 1)
                   * (c.d_inner + 2 * c.ssm_ngroups * c.ssm_state) * 2)
            return batch * c.n_layers * per
        kb = (1 if c.kv_cache_dtype == "int8"
              else _itemsize(c.kv_cache_dtype))
        hd = c.resolved_head_dim
        if c.use_mla:
            per_tok = (c.kv_lora_rank + c.qk_rope_head_dim) * kb
            return batch * seq * c.n_layers * per_tok
        if c.family == "hybrid":
            n_apps = c.n_layers // max(c.attn_every, 1)
            ssm = c.ssm_nheads * c.ssm_headdim * c.ssm_state * 4
            return (batch * c.n_layers * ssm
                    + batch * seq * n_apps * 2 * c.n_kv_heads * hd * kb)
        per_tok = 2 * c.n_kv_heads * hd * kb
        if c.local_global_alternating and c.sliding_window:
            half = c.n_layers // 2
            return (batch * seq * half * per_tok
                    + batch * min(seq, c.sliding_window) * half * per_tok)
        return batch * seq * c.n_layers * per_tok

    def analytic_hbm_bytes(self, cell: ShapeCell, accum: int = 1) -> float:
        """Napkin per-step HBM traffic (whole job, summed over chips) for
        the roofline memory term: weights/grads/optimizer traffic,
        activation read/write and cache traffic, as the reference's."""
        c = self.cfg
        p_bytes = self.param_bytes()
        tokens = cell.global_batch * cell.seq_len
        d = c.d_model
        act_unit = tokens * d * _itemsize(c.dtype)
        depth = max(c.n_layers, 1)
        if cell.kind == "train":
            w_traffic = 3.0 * p_bytes * accum       # fwd+bwd+remat reads
            g_traffic = 4.0 * p_bytes * accum       # grad arena rw (f32-ish)
            opt_traffic = 10.0 * p_bytes            # adam m/v rw + update
            act_traffic = 16.0 * act_unit * depth
            return w_traffic + g_traffic + opt_traffic + act_traffic
        if cell.kind == "prefill":
            cache_w = self.kv_cache_bytes(cell.global_batch, cell.seq_len)
            return p_bytes + 12.0 * act_unit * depth + cache_w
        # decode: params + full cache read dominate one step
        cache_r = self.kv_cache_bytes(cell.global_batch, cell.seq_len)
        act_dec = (cell.global_batch * d * depth * 12
                   * _itemsize(c.dtype))
        return p_bytes + cache_r + act_dec


def build_model(arch_cfg, *, pad_for_tp: Optional[int] = None,
                dist: Optional[dict] = None,
                device: DeviceLike = None) -> Model:
    """A ``Model`` on the card, or on ``device`` when the caller names one;
    raises when no GPU is present and no device is named. ``pad_for_tp``
    pads heads and vocab for that tensor-parallel width
    (``pad_heads_for_tp``) and, for MoE, sets ``ep_shards`` to it; the
    published config stays ``Model.orig``."""
    cfg = arch_cfg
    if pad_for_tp:
        cfg = pad_heads_for_tp(arch_cfg, pad_for_tp)
        if cfg.n_experts:
            cfg = cfg.replace(ep_shards=pad_for_tp)
    return Model(cfg, resolve_device(device), orig_cfg=arch_cfg, dist=dist)


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
