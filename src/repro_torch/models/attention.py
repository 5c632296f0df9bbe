"""GQA attention of the LM paths: projections, rope, KV cache, and the
prefill and decode attention kernels.

Counterpart of src/repro/models/attention.py (self-attention; no
cross-attention yet). Parameters keep the reference layouts: ``wq
[d, H, Dh]``, ``wk/wv [d, KV, Dh]``, ``wo [H, Dh, d_out]`` (``d_out`` is
``d`` but for zamba2's shared block, which attends over ``2 d`` and
projects back to ``d``). KV caches are dicts ``{"k", "v", "slots_pos",
"length"}`` with ``k/v [B, T, KV, Dh]``, ``slots_pos [T]`` (absolute
position per slot, -1 = empty) and a 0-d ``length``; an int8 cache adds
``k_scale/v_scale [B, T, KV]`` f32, one absmax scale per token and head.

Prefill (more than one query token, or no cache) attends on the fresh k/v
through the flash-attention kernel; decode (one token) reads the whole
cache through the decode-attention kernel, which takes the cache's own
layout through strides. An int8 cache is dequantized to the compute dtype
before that kernel, as the reference dequantizes outside its kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import decode_attention as _dec
from ..kernels import flash_attention as _fa
from .layers import apply_rope, dense_init

def init_attention(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
                   head_dim: int, dtype: torch.dtype, *, lead=(),
                   qkv_bias: bool = False, d_out: Optional[int] = None,
                   device: Optional[torch.device] = None) -> dict:
    """Parameters for one attention block, or a stack of them when ``lead``
    (e.g. ``(n_layers,)``) is given; ``wo`` maps back to ``d_out``
    (default ``d``)."""
    lead = tuple(lead)
    d_out = d if d_out is None else d_out
    p = {
        "wq": dense_init(gen, lead + (d, n_heads, head_dim), dtype,
                         fan_in=d, device=device),
        "wk": dense_init(gen, lead + (d, n_kv, head_dim), dtype, fan_in=d,
                         device=device),
        "wv": dense_init(gen, lead + (d, n_kv, head_dim), dtype, fan_in=d,
                         device=device),
        "wo": dense_init(gen, lead + (n_heads, head_dim, d_out), dtype,
                         fan_in=n_heads, scale=(n_heads * head_dim) ** -0.5,
                         device=device),
    }
    if qkv_bias:
        for name, heads in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(lead + (heads, head_dim), dtype=dtype,
                                  device=device)
    return p


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
def make_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[torch.device] = None) -> dict:
    cache = {
        "length": torch.zeros((), dtype=torch.int32, device=device),
        "slots_pos": torch.full((max_len,), -1, dtype=torch.int32,
                                device=device),
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
    }
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((batch, max_len, n_kv),
                                      dtype=torch.float32, device=device)
    return cache


def _quant(x: torch.Tensor) -> tuple:
    """Per-token, per-head absmax int8 codes: scale = max|x| / 127 (at
    least 1e-8), codes = round-half-to-even(x / scale); no clamp, as in the
    reference (|x| / scale <= 127 by construction)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def _dequant(q: torch.Tensor, scale: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def update_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    start: torch.Tensor) -> dict:
    """Write k/v [B, S_new, KV, D] at absolute position ``start`` (a 0-d
    tensor, so the host never waits for the device to learn it).

    Functional, as in the reference: returns a new cache and leaves
    ``cache`` untouched. The staged payloads share one prefilled donor
    cache across every job and lane, so an in-place write would corrupt
    it for all of them. The slot is clamped to keep the block inside the
    buffer, as ``lax.dynamic_update_slice`` clamps it."""
    out = dict(cache)
    s_new = k_new.shape[1]
    s_max = cache["k"].shape[1]
    dev = cache["k"].device
    start = torch.as_tensor(start, dtype=torch.int32, device=dev)
    length_new = start + s_new
    if s_new > s_max:
        # ring cache smaller than the prefill: keep only the window tail
        k_new = k_new[:, -s_max:]
        v_new = v_new[:, -s_max:]
        start = start + (s_new - s_max)
        s_new = s_max
        slot = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        slot = torch.remainder(start, s_max)
    slot = torch.clamp(slot, 0, s_max - s_new).long()
    ar = torch.arange(s_new, device=dev)
    idx = slot + ar
    if cache["k"].dtype == torch.int8:
        (kq, ks), (vq, vs) = _quant(k_new), _quant(v_new)
        out["k_scale"] = cache["k_scale"].index_copy(1, idx, ks)
        out["v_scale"] = cache["v_scale"].index_copy(1, idx, vs)
    else:
        kq, vq = k_new.to(cache["k"].dtype), v_new.to(cache["v"].dtype)
    out["k"] = cache["k"].index_copy(1, idx, kq)
    out["v"] = cache["v"].index_copy(1, idx, vq)
    out["slots_pos"] = cache["slots_pos"].index_copy(
        0, idx, (start + ar).to(torch.int32))
    out["length"] = length_new
    return out


def read_kv_cache(cache: dict, compute_dtype: torch.dtype) -> tuple:
    """Full-cache k/v in compute dtype + kv positions (-1 where empty)."""
    if cache["k"].dtype == torch.int8:
        return (_dequant(cache["k"], cache["k_scale"], compute_dtype),
                _dequant(cache["v"], cache["v_scale"], compute_dtype),
                cache["slots_pos"])
    return (cache["k"].to(compute_dtype), cache["v"].to(compute_dtype),
            cache["slots_pos"])


# ---------------------------------------------------------------------------
# Full attention block (projections + rope + core + output)
# ---------------------------------------------------------------------------
def attention_block(params: dict, x: torch.Tensor, *, positions: torch.Tensor,
                    rope_theta: float = 10000.0, causal: bool = True,
                    window: int = 0, attn_softcap: float = 0.0,
                    scale: Optional[float] = None,
                    cache: Optional[dict] = None) -> tuple:
    """x [B, S, d] -> (out [B, S, d], new_cache | None).

    - prefill: cache=None, or a fresh cache to fill;
    - decode: the cache holds the history, x is the new token."""
    b, s, d = x.shape
    h, dh = params["wq"].shape[-2:]
    kvh = params["wk"].shape[-2]
    q = (x @ params["wq"].reshape(d, h * dh)).view(b, s, h, dh)
    k = (x @ params["wk"].reshape(d, kvh * dh)).view(b, s, kvh, dh)
    v = (x @ params["wv"].reshape(d, kvh * dh)).view(b, s, kvh, dh)
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if rope_theta > 0.0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    if scale is None:
        scale = dh ** -0.5

    new_cache = None
    if cache is not None:
        new_cache = update_kv_cache(cache, k, v, cache["length"])
    if cache is None or s > 1:
        # prefill from scratch: attend on the fresh k/v
        out = _fa.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, softcap=attn_softcap,
            scale=scale).transpose(1, 2)
    else:
        kc, vc, kv_pos = read_kv_cache(new_cache, x.dtype)
        q_pos = (positions if positions.dim() == 1
                 else positions[:, -1]).reshape(-1).expand(b)
        out = _dec.decode_attention(
            q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), kv_pos, q_pos,
            window=window, softcap=attn_softcap, scale=scale)[:, None]
    y = out.reshape(b, s, h * dh) @ params["wo"].reshape(h * dh, -1)
    return y, new_cache
