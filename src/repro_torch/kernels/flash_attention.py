"""Prefill (flash) attention: CUDA kernel and plain version.

Replaces the Pallas kernel ``flash_attention``
(src/repro/kernels/flash_attention.py, body ``_flash_kernel``). Kernel
source: ``csrc/flash_attention.cu``.

What bounds it on the H100: a causal prefill of S tokens does about
2 S^2 Dh operations per head against 4 S Dh values moved. At the donor
prefill's S = 512, Dh = 64 in bf16 that is on the bytes side of the tensor
cores' line (about 2 us for q, k, v and the output); neither bound is near:
the time goes to each KV tile's softmax on the CUDA cores between two small
products, the barriers around them and the tile loads (PERF.md). Two
hand-written instances, chosen by ``flash_instance``
from dtype, shapes, strides and alignment (a plain function, never a retry
after a failure):

- ``tensor_core``: bf16, Dh 64, 112, 128, 160 or 192, every stride but
  the head dimension's a multiple of 8 elements and every base 16-byte
  aligned. One warpgroup per 64-row query tile runs both products on
  ``wgmma`` (Q K^T from shared memory; P V with P as the register A operand
  and V read MN-major through the transpose bit), the online softmax in
  registers, and K/V tiles arriving by ``cp.async`` in a bf16 ring under
  the 128-byte swizzle. Tiles are padded to whole 64-column blocks (Dh 112
  to 128, 160 to 192) and only the columns below Dh are stored;
  ``flash_plan`` gives a width's padding, ring and shared memory. P is
  rounded to bf16 before the second product, as SDPA does (the Pallas
  kernel multiplies P by V in f32); the 3e-2 bf16 tolerance covers it.
- ``cuda_core``: everything else (f32 IO, where TF32 would miss the 2e-4
  tolerance; other head dimensions; unaligned strides or bases): products
  on the f32 CUDA cores from f32 tiles in shared memory.

Both keep the [S, S_kv] scores on chip with an f32 online softmax and skip
the KV tiles that the causal mask or the window hide entirely. Keys and
values may be of their own length S_kv when the call is not causal
(whisper's cross-attention to its encoder states, which the reference
computes outside any kernel); query row i and key j sit at positions i
and j.

Under autograd (grad mode on and q, k or v requiring grad) the call goes
through ``FlashAttentionFunction``: the kernel's forward, and a backward
that recomputes the plain version (the reference has no backward kernel;
without the Function the kernel's output would carry no gradient).

The forward is the operator ``repro_torch::flash_attention`` (``_lib.
define_op``): the plain version for CPU tensors, the kernel for CUDA ones,
the output's shape on fake and meta tensors, and ``flash_flops`` under
``FlopCounterMode``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _lib

NEG_INF = -1.0e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0,
                          scale: Optional[float] = None,
                          q_chunk: int = 0) -> torch.Tensor:
    """q [B,H,S,Dh], k/v [B,KV,S_kv,Dh] -> [B,H,S,Dh]; f32 softmax. Query
    row i and key j sit at positions i and j. ``q_chunk`` (as the
    reference's ``mha``): where it divides S and is less than S, query
    blocks of ``q_chunk`` rows attend to all keys one after another, so
    that the f32 scores take [B, H, q_chunk, S_kv] at a time; the result
    is the same."""
    flash_attention.counts.plain(q)
    return _attention_math(q, k, v, causal, window, softcap, scale, q_chunk)


def _q_blocks(s: int, q_chunk: int) -> list:
    """The query rows' blocks: ``q_chunk`` rows each where the reference
    would block them (``q_chunk`` divides S and is less than it), else
    one block."""
    if q_chunk and s > q_chunk and s % q_chunk == 0:
        return [(r, r + q_chunk) for r in range(0, s, q_chunk)]
    return [(0, s)]


def _attention_math(q, k, v, causal, window, softcap, scale, q_chunk=0):
    outs = [_attend(q[:, :, r0:r1], k, v, r0, causal, window, softcap, scale)
            for r0, r1 in _q_blocks(q.shape[2], q_chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def _attend(q, k, v, q0, causal, window, softcap, scale):
    """Query rows at positions ``q0 ..`` against every key."""
    b, h, s, dh = q.shape
    kvh, s_kv = k.shape[1], k.shape[2]
    g = h // kvh
    if scale is None:
        scale = dh ** -0.5
    qg = _lib.at_least_f32(q.reshape(b, kvh, g, s, dh))
    logits = torch.einsum("bkgqd,bktd->bkgqt", qg,
                          _lib.at_least_f32(k)) * scale
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(q0, q0 + s, device=q.device)[:, None]
    kpos = torch.arange(s_kv, device=q.device)[None, :]
    ok = torch.ones((s, s_kv), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (qpos - kpos < window)
    logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", p, _lib.at_least_f32(v))
    return out.reshape(b, h, s, dh).to(q.dtype)


TENSOR_CORE_DH = (64, 112, 128, 160, 192)
COL_BLOCK = 64 * 128       # bytes of one [64, 64] bf16 column block
SMEM_PER_SM = 233_472      # shared memory an H100 SM holds (228 KB)
SMEM_RESERVED = 1024       # the runtime's share of each resident block


class FlashPlan(NamedTuple):
    """The shared memory of a tensor-core launch (``csrc/flash_attention.
    cu``, ``tensor_core::Plan``, which computes the same)."""
    dh: int
    dp: int              # Dh padded to whole 64-element column blocks
    tile_bytes: int      # one [64, dp] bf16 tile
    stages: int          # (K, V) stages in the ring
    smem_bytes: int      # 1024 (alignment) + Q + stages x (K, V)
    blocks_per_sm: int   # resident blocks an SM by shared memory


def flash_plan(dh: int) -> FlashPlan:
    """The plan the tensor-core instance takes at head dimension ``dh``;
    raises for a width it is not built for. Dh 64 and 128 keep two K/V
    stages, the next tile copied into the other stage; Dh 112, 160 and 192
    hold one stage, K and V copied apart, which leaves shared memory for
    more resident blocks (at DP 192 two against one) and measured faster at
    each of those widths (PERF.md §6 row 4)."""
    if dh not in TENSOR_CORE_DH:
        raise ValueError(f"flash_attention: no tensor-core instance at Dh "
                         f"{dh} (only {TENSOR_CORE_DH})")
    stages = 2 if dh in (64, 128) else 1
    dp = -(-dh // 64) * 64
    tile = dp // 64 * COL_BLOCK
    smem = 1024 + tile * (1 + 2 * stages)
    return FlashPlan(dh, dp, tile, stages, smem,
                     SMEM_PER_SM // (smem + SMEM_RESERVED))


PLAN_KEYS = ("dp", "tile_bytes", "stages", "smem_bytes", "blocks_per_sm",
             "resident_blocks_per_sm", "registers", "local_bytes")


def card_plan(dh: int) -> dict:
    """What the built tensor-core kernel at ``flash_plan(dh)`` reports
    (``repro_flash_wgmma_plan``; needs the card): its own plan's numbers,
    the blocks an SM the runtime lets reside (registers too), and its
    registers and spilled (local) bytes a thread."""
    flash_plan(dh)
    out = (ctypes.c_int * len(PLAN_KEYS))()
    _lib.check(_lib.lib().repro_flash_wgmma_plan(dh, out), "flash_attention")
    return dict(zip(PLAN_KEYS, out))


def flash_instance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel instance that takes these inputs: ``"tensor_core"``
    (``wgmma``) for bf16 with Dh in ``TENSOR_CORE_DH``, every stride but the
    head dimension's a multiple of 8 elements and every base 16-byte
    aligned; ``"cuda_core"`` for anything else."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in TENSOR_CORE_DH:
        return "cuda_core"
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1]):
            return "cuda_core"
    return "tensor_core"


def _shape_key(q, k, causal, window, softcap) -> str:
    """A call's shape as its launch and backward counts name it."""
    b, h, s, dh = q.shape
    return (f"B{b} H{h} KV{k.shape[1]} S{s} Dh{dh} {_lib.dtype_name(q)}"
            + _lib.options_key(s_kv=(k.shape[2], s), full=not causal,
                               window=window, softcap=softcap))


def _cpu(q, k, v, causal, window, softcap, scale, q_chunk):
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale,
                                 q_chunk=q_chunk)


def _cuda(q, k, v, causal, window, softcap, scale, q_chunk):
    return _launch(q, k, v, causal, window, softcap, scale)


def _fake(q, k, v, causal, window, softcap, scale, q_chunk):
    return q.new_empty(q.shape)


def visited_keys(s: int, s_kv: int, causal: bool, window: int,
                 bq: int = 64, bk: int = 64) -> int:
    """Sum over query rows of the keys in the tiles the kernel visits for
    that row's query tile (both instances: ``bq`` query rows a block, key
    tiles of ``bk`` from the window's first tile to the causal end)."""
    total = 0
    for q0 in range(0, s, bq):
        q_last = min(q0 + bq, s) - 1
        k_end = q_last + 1 if causal else s_kv
        k_begin = max(0, q0 - window + 1) // bk * bk if window > 0 else 0
        n_tiles = max(0, -(-(k_end - k_begin) // bk))
        keys = min(n_tiles * bk, s_kv - k_begin)
        total += (q_last + 1 - q0) * keys
    return total


def flash_flops(q_shape, k_shape, v_shape, causal, window, softcap, scale,
                q_chunk, out_shape=None, **kw) -> int:
    """The products the kernel performs: S = Q K^T and P V over the keys of
    every visited tile, 2 Dh a (query, key) pair each."""
    b, h, s, dh = q_shape
    return 4 * b * h * dh * visited_keys(s, k_shape[2], causal, window)


_op = _lib.define_op(
    "flash_attention",
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int window, "
    "float softcap, float? scale, int q_chunk) -> Tensor",
    _cpu, _cuda, _fake, flash_flops)


def _forward(q, k, v, causal, window, softcap, scale, q_chunk):
    """The operator: the plain version for CPU tensors, the kernel for CUDA
    ones."""
    return _op(q, k, v, causal, window, softcap, scale, q_chunk)


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` under autograd: the wrapper's forward (the
    kernel for CUDA tensors), and a backward that recomputes the plain
    version from the saved q, k, v and differentiates it, one query block
    of ``q_chunk`` rows at a time (so the recompute's f32 scores take [B,
    H, q_chunk, S_kv]); the blocks' k and v gradients are summed in f32
    and rounded once, and GQA's group sum falls out of the plain version's
    broadcast. The reference has no backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, softcap, scale, q_chunk)
        return _forward(q, k, v, causal, window, softcap, scale, q_chunk)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        causal, window, softcap, scale, q_chunk = ctx.opts
        dq, dk, dv = [], None, None
        kf, vf = _lib.at_least_f32(k), _lib.at_least_f32(v)
        with _lib.recompute("flash_attention", flash_attention.counts,
                            _shape_key(q, k, causal, window, softcap)):
            for r0, r1 in _q_blocks(q.shape[2], q_chunk):
                gq, gk, gv = _lib.plain_grads(
                    lambda a, b, c, r0=r0: _attend(a, b, c, r0, causal,
                                                   window, softcap, scale),
                    (q[:, :, r0:r1], kf, vf), (g[:, :, r0:r1],))
                dq.append(gq)
                dk = gk if dk is None else dk + gk
                dv = gv if dv is None else dv + gv
        dq = dq[0] if len(dq) == 1 else torch.cat(dq, dim=2)
        return (dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None,
                None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: Optional[float] = None,
                    q_chunk: int = 0,
                    instance: Optional[str] = None) -> torch.Tensor:
    """q: [B, H, S, Dh]; k/v: [B, KV, S_kv, Dh], any strides with Dh
    contiguous -> contiguous [B, H, S, Dh]. ``S_kv`` may differ from
    ``S`` only when ``causal`` is false (cross-attention). ``q_chunk``
    blocks the plain version's queries (the kernel tiles them anyway and
    ignores it).

    CPU tensors take the plain version; CUDA tensors launch the instance
    that ``flash_instance`` names. Where autograd records the call, it
    goes through ``FlashAttentionFunction``. ``instance`` launches that
    instance on CUDA tensors instead (to time the two at the same shapes;
    no model path passes it), without autograd."""
    name = "flash_attention"
    b, h, s, dh = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b
            or k.shape[3] != dh or h % k.shape[1]
            or (causal and k.shape[2] != s)):
        raise ValueError(f"{name}: q {tuple(q.shape)} with k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)} (causal="
                         f"{causal} needs as many keys as queries)")
    if instance is not None:
        if _lib.needs_grad(q, k, v):
            raise ValueError(f"{name}: an explicit instance has no backward")
        return _launch(q, k, v, causal, window, softcap, scale, instance)
    if _lib.needs_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, causal, window, softcap,
                                            scale, q_chunk)
    return _forward(q, k, v, causal, window, softcap, scale, q_chunk)


def _launch(q, k, v, causal, window, softcap, scale, instance=None):
    """One counted launch on CUDA tensors: ``instance`` (the one
    ``flash_instance`` names unless given; a ``"tensor_core"`` the inputs do
    not allow raises)."""
    name = "flash_attention"
    b, h, s, dh = q.shape
    _lib.require_cuda(name, q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v dtypes differ ({q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous")
    if scale is None:
        scale = dh ** -0.5
    s_kv = k.shape[2]
    out = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    if b and s and s_kv:
        st = _lib.strides((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)))
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                h, k.shape[1], s, s_kv, dh, st, float(scale), int(causal),
                int(window), float(softcap))
        allowed = flash_instance(q, k, v)
        instance = instance or allowed
        if instance == "tensor_core" and allowed == "tensor_core":
            err = _lib.lib().repro_flash_attention_wgmma(
                *args, _lib.stream_handle(q.device))
        elif instance == "cuda_core":
            err = _lib.lib().repro_flash_attention(
                *args, _lib.dtype_code(q, name), _lib.stream_handle(q.device))
        else:
            raise ValueError(f"{name}: instance {instance}"
                             f" at {_shape_key(q, k, causal, window, softcap)}"
                             f", where the inputs allow {allowed}")
        _lib.check(err, name)
        flash_attention.counts.launched(
            instance, shape=_shape_key(q, k, causal, window, softcap))
    return out


flash_attention.counts = _lib.Counts()
