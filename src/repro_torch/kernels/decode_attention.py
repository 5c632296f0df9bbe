"""Decode attention (one query token against a KV cache): CUDA kernel and
plain version.

Replaces the Pallas kernel ``decode_attention``
(src/repro/kernels/decode_attention.py, body ``_decode_kernel``). Kernel
source: ``csrc/decode_attention.cu``.

What bounds it on the H100: bytes. Every visible slot's K and V is read once
and used for about 4 operations a byte (g query heads share it), far below
the roughly 295 operations a byte at which the tensor cores would become
the limit. At decode batch sizes the cache is small, so latency sets the
time unless enough blocks read it at once. The design splits each
sequence's cache into ``n_split`` chunks (``decode_split``: enough
B x KV x n_split blocks to fill the card, and no split that starts at or
past S); each block reads its chunk's K/V once, as 16-byte asynchronous
copies, for all g query heads of its KV head, and writes f32 partials
(m, l, acc); a second kernel merges them. The cache is read through
strides (the model's [B, T, KV, Dh] layout, no transpose), the softmax
state stays f32, and masked logits are -1e30 as in Pallas, so a query that
sees no slot gets the mean of V. The two kernels serve f32 and bf16 alike;
each call counts one launch of each (``counts.by_instance`` ``split`` and
``combine``, their grids in ``counts.grids``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

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


MIN_CHUNK, MAX_CHUNK, CHUNK_STEP = 16, 64, 16
BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def decode_split(s: int, b: int, kvh: int, n_sm: int) -> Tuple[int, int]:
    """(chunk, n_split): slots per split, a multiple of ``CHUNK_STEP``
    between ``MIN_CHUNK`` and ``MAX_CHUNK``, sized so that b x kvh x n_split
    blocks give ``BLOCKS_PER_SM`` per SM where the cache is long enough;
    n_split = ceil(s / chunk), so no split starts at or past s."""
    def cdiv(a: int, d: int) -> int:
        return -(-a // d)
    want = cdiv(BLOCKS_PER_SM * n_sm, b * kvh)        # splits per (b, kv)
    chunk = cdiv(cdiv(s, want), CHUNK_STEP) * CHUNK_STEP
    chunk = min(MAX_CHUNK, max(MIN_CHUNK, chunk))
    return chunk, cdiv(s, chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_flops(q_shape, k_shape, v_shape, kv_pos_shape, q_pos_shape,
                 window, softcap, scale, out_shape=None, **kw) -> int:
    """The products the kernel performs: q . k and p . v over every slot
    of the cache (it reads them all, windowed or empty ones too), 2 Dh a
    (head, slot) pair each."""
    b, h, dh = q_shape
    return 4 * b * h * k_shape[2] * dh


def _fake(q, k, v, kv_pos, q_pos, window, softcap, scale):
    return q.new_empty(q.shape)


_op = _lib.define_op(
    "decode_attention",
    "decode_attention(Tensor q, Tensor k, Tensor v, Tensor kv_pos, "
    "Tensor q_pos, int window, float softcap, float? scale) -> Tensor",
    lambda q, k, v, kp, qp, w, sc, scale: decode_attention_plain(
        q, k, v, kp, qp, window=w, softcap=sc, scale=scale),
    lambda *a: _launch(*a), _fake, decode_flops)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_pos: torch.Tensor, q_pos: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, Dh]; k/v: [B, KV, S, Dh], any strides with Dh contiguous;
    kv_pos: [S] int (-1 = empty slot); q_pos: [B] int -> out [B, H, Dh].

    CPU tensors take the plain version; CUDA tensors launch the split
    kernel and its merge, counted as instances ``split`` and ``combine``
    with the grid of each. No path trains through decode (nor does the
    reference), so on a non-CPU input that autograd would record the
    wrapper raises rather than return a result cut from the graph.

    The call is the operator ``repro_torch::decode_attention`` (``_lib.
    define_op``): its fake kernel gives the output's shape on fake and meta
    tensors and ``decode_flops`` its count under ``FlopCounterMode``."""
    if _lib.needs_grad(q, k, v):
        if q.device.type == "cpu":        # the plain version keeps the graph
            return decode_attention_plain(q, k, v, kv_pos, q_pos,
                                          window=window, softcap=softcap,
                                          scale=scale)
        raise RuntimeError("decode_attention: the kernel has no backward, "
                           "and no training path runs decode; call it "
                           "under torch.no_grad() or on inputs that need no "
                           "gradient")
    return _op(q, k, v, kv_pos, q_pos, window, softcap, scale)


def _launch(q, k, v, kv_pos, q_pos, window, softcap, scale):
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
        chunk, n_split = decode_split(
            s, b, kvh, _sm_count(q.device.index if q.device.index is not None
                                 else torch.cuda.current_device()))
        ws = torch.empty(b * h * n_split * (dh + 2), dtype=torch.float32,
                         device=q.device)
        st = _lib.strides((q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)))
        err = _lib.lib().repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), ws.data_ptr(), b, h, kvh, s, dh,
            st, float(scale), int(window), float(softcap), chunk, n_split,
            _lib.dtype_code(q, name), _lib.stream_handle(q.device))
        _lib.check(err, name)
        # the C entry launched both kernels: count each, with its grid (the
        # shape leaves out the cache's slots, which only set the split)
        shape = (f"B{b} H{h} KV{kvh} Dh{dh} {_lib.dtype_name(q)}"
                 + _lib.options_key(window=window, softcap=softcap))
        decode_attention.counts.launched("split", (n_split, kvh, b), shape)
        decode_attention.counts.launched("combine", (h, b), shape)
    return out


decode_attention.counts = _lib.Counts()
