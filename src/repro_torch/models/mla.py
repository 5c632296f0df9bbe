"""DeepSeek-V2 Multi-head Latent Attention (MLA).

Counterpart of src/repro/models/mla.py. Two paths:

* naive (prefill, or no cache): the latent is up-projected to per-head
  K/V; ``k = concat(k_nope, k_rope)`` with the single rope head broadcast
  over the heads, v zero-padded to the qk width, and the attention runs
  through the flash-attention kernel at that width (H = KV heads; 192 at
  full width, which the kernel's CUDA-core instance takes); the output is
  sliced back to ``v_head_dim``.
* absorbed (decode with a cache): ``k_up`` is absorbed into the query and
  ``v_up`` into the output, so the step attends the (kv_lora + rope)
  latent cache directly. As in the reference this is plain products and a
  masked f32 softmax outside any kernel, in the reference's order.

Parameters keep the reference layouts (``q_up [q_lora, H, nope + rope]``,
``k_up [kv_lora, H, nope]``, ``v_up [kv_lora, H, v]``, ``wo [H, v, d]``).
Cache: ``{"latent": [B, T, kv_lora], "k_rope": [B, T, rope]`` (after
rope), ``"slots_pos": [T]``, ``"length"``}.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import flash_attention as _fa
from ..parallel.sharding import Region
from .attention import gather_seq, seq_split, slice_seq, write_slots
from .layers import apply_rope, dense_init, rms_norm

NEG_INF = -2.0e38               # the reference's additive mask value


def init_mla(gen: torch.Generator, cfg, dtype: torch.dtype, *, lead=(),
             device: Optional[torch.device] = None) -> dict:
    """One MLA block's parameters, or a stack of them under ``lead``."""
    lead = tuple(lead)
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    q_r, kv_r = cfg.q_lora_rank, cfg.kv_lora_rank

    def dense(shape, fan_in, scale=None):
        return dense_init(gen, lead + shape, dtype, fan_in=fan_in,
                          scale=scale, device=device)

    return {
        "q_down": dense((d, q_r), d),
        "q_norm": torch.ones(lead + (q_r,), dtype=dtype, device=device),
        "q_up": dense((q_r, h, qk), q_r),
        "kv_down": dense((d, kv_r + cfg.qk_rope_head_dim), d),
        "kv_norm": torch.ones(lead + (kv_r,), dtype=dtype, device=device),
        "k_up": dense((kv_r, h, cfg.qk_nope_head_dim), kv_r),
        "v_up": dense((kv_r, h, cfg.v_head_dim), kv_r),
        "wo": dense((h, cfg.v_head_dim, d), h,
                    scale=(h * cfg.v_head_dim) ** -0.5),
    }


def make_mla_cache(batch: int, max_len: int, cfg,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Optional[torch.device] = None) -> dict:
    return {
        "latent": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                              dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
        "slots_pos": torch.full((max_len,), -1, dtype=torch.int32,
                                device=device),
    }


def _project_q(params: dict, x: torch.Tensor, cfg, positions,
               share=lambda t: t):
    cq = share(rms_norm(x @ params["q_down"], params["q_norm"]))
    b, s, _ = cq.shape
    q_up = params["q_up"]
    r, h, qk = q_up.shape
    q = (cq @ q_up.reshape(r, h * qk)).view(b, s, h, qk)
    nope = cfg.qk_nope_head_dim
    return q[..., :nope], apply_rope(q[..., nope:], positions,
                                     cfg.rope_theta)


def _project_latent(params: dict, x: torch.Tensor, cfg, positions,
                    share=lambda t: t):
    ckv = x @ params["kv_down"]
    r = cfg.kv_lora_rank
    latent = share(rms_norm(ckv[..., :r], params["kv_norm"]))
    # the shared single-head rope key
    k_rope = apply_rope(share(ckv[..., None, r:]), positions,
                        cfg.rope_theta)[..., 0, :]
    return latent, k_rope


def mla_block(params: dict, x: torch.Tensor, *, cfg,
              positions: torch.Tensor,
              cache: Optional[dict] = None, q_chunk: int = 0, cons=None,
              dist: Optional[dict] = None) -> tuple:
    """x [B, S, d] -> (out [B, S, d], new_cache | None); one token with a
    cache runs absorbed. ``q_chunk`` blocks the naive path's queries in
    the flash call's plain version. Under ``dist`` with the heads split
    over the model axis the block runs on this rank's heads (``q_up``,
    ``k_up``, ``v_up``, ``wo``), the output summed over the ranks; a
    latent cache split on its sequence axis is gathered whole, written,
    and cut back to this rank's part. Under sequence parallelism ``x`` is
    this rank's rows: the low-rank projections and their norms run on
    them, and the query and kv latents and the rope key are gathered
    whole along the sequence (the reference's ``cons.hidden`` on the
    latent) before the heads."""
    reg = Region(dist, "shard_heads")
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    # the low-rank outputs enter the heads' region: read in part by each
    # rank's heads (their gradients summed over the ranks), gathered along
    # the sequence first under sequence parallelism
    q_nope, q_rope = _project_q(params, x, cfg, positions, reg.enter)
    latent, k_rope = _project_latent(params, x, cfg, positions, reg.enter)
    if cons is not None:
        q_nope, q_rope = cons.heads(q_nope), cons.heads(q_rope)
        latent = cons.hidden(latent)
    b, s, _ = latent.shape

    new_cache = full = None
    if cache is not None:
        spmd, axes = seq_split(dist, "latent_seq")
        whole = cache if spmd is None else gather_seq(cache, spmd, axes)
        start = whole["length"]
        slot = torch.remainder(start, whole["latent"].shape[1])
        full = dict(whole)
        full["latent"] = write_slots(whole["latent"], latent, slot, 1)
        full["k_rope"] = write_slots(whole["k_rope"], k_rope, slot, 1)
        pos_new = start + torch.arange(s, dtype=torch.int32, device=x.device)
        full["slots_pos"] = write_slots(whole["slots_pos"], pos_new,
                                        slot, 0)
        full["length"] = start + s
        new_cache = full if spmd is None else slice_seq(full, spmd, axes)

    if cache is not None and s == 1:
        # ----- absorbed decode over the latent cache -----
        lat = full["latent"].to(x.dtype)                      # [B, T, R]
        kr = full["k_rope"].to(x.dtype)                       # [B, T, Rr]
        kv_pos = full["slots_pos"]
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["k_up"])
        sc = (torch.einsum("bshr,btr->bhst", q_lat, lat)
              + torch.einsum("bshk,btk->bhst", q_rope, kr)).float() * scale
        qp = (positions[None] if positions.dim() == 1 else positions)
        qp = qp.expand(b, s)[:, :, None].int()
        kp = kv_pos[None, None, :].int()
        ok = (kp >= 0) & (kp <= qp)                            # [B, S, T]
        bias = torch.where(ok, 0.0, NEG_INF).float()
        p = torch.softmax(sc + bias[:, None], dim=-1).to(x.dtype)
        out_lat = torch.einsum("bhst,btr->bshr", p, lat)
        o = torch.einsum("bshr,rhv->bshv", out_lat, params["v_up"])
        y = torch.einsum("bshv,hvd->bsd", o, params["wo"])
        return reg.leave(y), new_cache

    # ----- naive path (prefill; attends on the fresh latents) -----
    k_up, v_up = params["k_up"], params["v_up"]
    r, h, nope = k_up.shape
    vd = v_up.shape[-1]
    k_nope = (latent @ k_up.reshape(r, h * nope)).view(b, s, h, nope)
    v = (latent @ v_up.reshape(r, h * vd)).view(b, s, h, vd)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, k_rope.shape[-1])], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    v = F.pad(v, (0, q.shape[-1] - vd))         # the reference's _pad_v
    out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, scale=scale,
                              q_chunk=q_chunk)
    out = out.transpose(1, 2)[..., :vd]
    y = out.reshape(b, s, h * vd) @ params["wo"].reshape(h * vd, -1)
    return reg.leave(y), new_cache
