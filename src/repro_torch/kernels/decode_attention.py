"""Decode attention (one query token against a KV cache): CUDA kernel and
plain version.

Replaces the Pallas kernel ``decode_attention``
(src/repro/kernels/decode_attention.py). Kernel source:
``csrc/decode_attention.cu``.

What bounds it on the H100: bytes. Every visible slot's K and V is read once
and used for about 4 operations per byte (g query heads share it), far
below the roughly 295 operations per byte at which the tensor cores would
become the limit. The design reads each K/V byte once per (batch row, KV
head) block for all g query heads of the group, reads the model's
[B, T, KV, Dh] cache through strides instead of transposing it every step,
and keeps the softmax state in f32 on chip. It runs B x KV blocks, which
leaves most of the 132 SMs idle at decode batch sizes: splitting the cache
across blocks is the next step (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _lib

NEG_INF = -1.0e30


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_pos: torch.Tensor, q_pos: torch.Tensor, *,
                           window: int = 0, softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,Dh], k/v [B,KV,S,Dh], kv_pos [S] (-1 = empty), q_pos [B]
    -> [B,H,Dh]; f32 softmax."""
    decode_attention.counts.plain(q)
    b, h, dh = q.shape
    kvh, s = k.shape[1], k.shape[2]
    g = h // kvh
    if scale is None:
        scale = dh ** -0.5
    qg = q.reshape(b, kvh, g, dh).float()
    logits = torch.einsum("bkgd,bktd->bkgt", qg, k.float()) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    kp = kv_pos.long()[None]
    qp = q_pos.long()[:, None]
    ok = (kp >= 0) & (kp <= qp)
    if window > 0:
        ok = ok & (qp - kp < window)
    logits = torch.where(ok[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    return out.reshape(b, h, dh).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_pos: torch.Tensor, q_pos: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, Dh]; k/v: [B, KV, S, Dh], any strides with Dh contiguous;
    kv_pos: [S] int (-1 = empty slot); q_pos: [B] int -> out [B, H, Dh].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_pos, q_pos, window=window,
                                      softcap=softcap, scale=scale)
    name = "decode_attention"
    _lib.require_cuda(name, q, k, v, kv_pos, q_pos)
    b, h, dh = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b
            or k.shape[3] != dh or h % k.shape[1] or k.shape[2] == 0):
        raise ValueError(f"{name}: q {tuple(q.shape)} with k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    kvh, s = k.shape[1], k.shape[2]
    if kv_pos.shape != (s,) or q_pos.shape != (b,):
        raise ValueError(f"{name}: kv_pos {tuple(kv_pos.shape)} / q_pos "
                         f"{tuple(q_pos.shape)} for S={s}, B={b}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ ({q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous")
    if scale is None:
        scale = dh ** -0.5
    kv_pos = kv_pos.to(torch.int32).contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    if b:
        st = _lib.strides((q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)))
        err = _lib.lib().repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), b, h, kvh, s, dh, st,
            float(scale), int(window), float(softcap),
            _lib.dtype_code(q, name), _lib.stream_handle(q.device))
        _lib.check(err, name)
        decode_attention.counts.launched()
    return out


decode_attention.counts = _lib.Counts()
