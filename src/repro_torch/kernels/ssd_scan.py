"""Mamba2 SSD chunked scan: CUDA kernel and plain version.

Replaces the Pallas kernel ``ssd`` (src/repro/kernels/ssd_scan.py). Kernel
source: ``csrc/ssd_scan.cu``; its note says what bounds it. The plain
version is the model's chunked reference, ``models.mamba2.ssd_reference``
(the JAX package's ``kernels/ref.py`` points at the same function).

The kernel takes B and C per group (no copy per head), dt in f32 after the
softplus, and an optional f32 initial state; it returns ``y`` in x's dtype
and the final state in f32. It needs ``L % chunk == 0`` (the model pads
with dt = 0 tokens), ``H % G == 0``, a head dim of at most 64 and a state
dim of at most 128: every assigned architecture fits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib

MAX_HEADDIM, MAX_STATE = 64, 128


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, chunk: int = 256,
              init_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    ssd.counts.plain(x)
    from ..models.mamba2 import ssd_reference   # the model's own reference
    return ssd_reference(x, dt, a_log, b, c, chunk, init_state)


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, chunk: int = 256,
        init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,L,H,P]; dt [B,L,H] (post-softplus); a_log [H]; b/c [B,L,G,N];
    init_state [B,H,P,N] or None -> (y [B,L,H,P], final_state [B,H,P,N]
    f32). CPU tensors take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a_log, b, c, chunk, init_state)
    name = "ssd"
    tensors = [x, dt, a_log, b, c] + ([] if init_state is None
                                      else [init_state])
    _lib.require_cuda(name, *tensors)
    bs, ln, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (dt.shape != (bs, ln, h) or a_log.shape != (h,)
            or b.shape != (bs, ln, g, n) or c.shape != b.shape
            or (init_state is not None
                and init_state.shape != (bs, h, p, n))):
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a_log {tuple(a_log.shape)}, b {tuple(b.shape)}, "
                         f"c {tuple(c.shape)}")
    if chunk <= 0 or ln % chunk or g == 0 or h % g:
        raise ValueError(f"{name}: L={ln} must be a multiple of chunk={chunk} "
                         f"and H={h} of G={g}")
    if p > MAX_HEADDIM or n > MAX_STATE:
        raise ValueError(f"{name}: the kernel covers head dims up to "
                         f"{MAX_HEADDIM} and states up to {MAX_STATE}, got "
                         f"P={p}, N={n}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"{name}: x, b and c must share a dtype, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    code = _lib.dtype_code(x, name)
    x, b, c = x.contiguous(), b.contiguous(), c.contiguous()
    dt = dt.float().contiguous()
    a32 = a_log.float().contiguous()
    s0 = None if init_state is None else init_state.float().contiguous()
    y = torch.empty_like(x)
    sf = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    if bs and ln:
        err = _lib.lib().repro_ssd(
            x.data_ptr(), dt.data_ptr(), a32.data_ptr(), b.data_ptr(),
            c.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), sf.data_ptr(), bs, ln, h, p, g, n, chunk, code,
            _lib.stream_handle(x.device))
        _lib.check(err, name)
        ssd.counts.launched()
    elif s0 is not None:
        sf.copy_(s0)
    else:
        sf.zero_()
    return y, sf


ssd.counts = _lib.Counts()
