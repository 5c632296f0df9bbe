"""Prefill (flash) attention: CUDA kernel and plain version.

Replaces the Pallas kernel ``flash_attention``
(src/repro/kernels/flash_attention.py). Kernel source:
``csrc/flash_attention.cu``.

What bounds it on the H100: a causal prefill of S tokens does about
S^2 x Dh multiply-adds per head against 4 x S x Dh values moved. At the
donor prefill's S = 512 in bf16 that is still on the bytes side of the
tensor cores' line (about 2 us for q, k, v and the output), in f32 on the
CUDA cores it is operations. The design keeps the [S, S] scores on chip
(one block per query tile walks the KV tiles in shared memory with an f32
online softmax) and skips the tiles that the causal mask or the window
hide entirely. Its products run on the f32 CUDA cores, not the tensor
cores, so it is far from the bound: moving the two products onto
``wgmma`` is the next step (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _lib

NEG_INF = -1.0e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,S,Dh], k/v [B,KV,S,Dh] -> [B,H,S,Dh]; f32 softmax."""
    flash_attention.counts.plain(q)
    b, h, s, dh = q.shape
    kvh = k.shape[1]
    g = h // kvh
    if scale is None:
        scale = dh ** -0.5
    qg = q.reshape(b, kvh, g, s, dh).float()
    logits = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (qpos - kpos < window)
    logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return out.reshape(b, h, s, dh).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, S, Dh]; k/v: [B, KV, S, Dh], any strides with Dh
    contiguous -> contiguous [B, H, S, Dh].

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    name = "flash_attention"
    _lib.require_cuda(name, q, k, v)
    b, h, s, dh = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b
            or k.shape[2] != s or k.shape[3] != dh or h % k.shape[1]):
        raise ValueError(f"{name}: q {tuple(q.shape)} with k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ ({q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous")
    if scale is None:
        scale = dh ** -0.5
    out = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    if b and s:
        st = _lib.strides((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)))
        err = _lib.lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            k.shape[1], s, dh, st, float(scale), int(causal), int(window),
            float(softcap), _lib.dtype_code(q, name),
            _lib.stream_handle(q.device))
        _lib.check(err, name)
        flash_attention.counts.launched()
    return out


flash_attention.counts = _lib.Counts()
