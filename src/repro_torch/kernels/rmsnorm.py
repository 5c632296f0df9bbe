"""RMSNorm and fused residual-add + RMSNorm: CUDA kernel and plain version.

Replaces the Pallas kernels ``rmsnorm`` and ``rmsnorm_residual``
(src/repro/kernels/rmsnorm.py). Kernel source: ``csrc/rmsnorm.cu``.

What bounds it on the H100: bytes. Each row is read once (twice for the
fused variant's x and r) and written once, with a handful of f32 operations
per element. At the decode path's 4 rows of 576 the whole call moves a few
KB, so it is bound by the launch, not by the 3.35 TB/s of device memory.
The design does the least a launch can: one block per row, one f32
block-wide reduction, the second pass served from L1, and the residual add
fused so that the sum never makes a round trip through device memory.

``rmsnorm_residual`` norms the unrounded f32 sum ``x + r``, as the Pallas
kernel does; the plain version below keeps that order.
"""
from __future__ import annotations

import torch

from . import _lib


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
                  plus_one: bool = False) -> torch.Tensor:
    rmsnorm.counts.plain(x)
    return _norm_f32(x.float(), weight, eps, plus_one).to(x.dtype)


def rmsnorm_residual_plain(x: torch.Tensor, residual: torch.Tensor,
                           weight: torch.Tensor, *, eps: float = 1e-6,
                           plus_one: bool = False):
    rmsnorm_residual.counts.plain(x)
    s = x.float() + residual.float()
    return _norm_f32(s, weight, eps, plus_one).to(x.dtype), s.to(x.dtype)


def _norm_f32(xf: torch.Tensor, weight: torch.Tensor, eps: float,
              plus_one: bool) -> torch.Tensor:
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:                      # gemma-style (1 + w) parameterization
        w = 1.0 + w
    return y * w


def _launch(x, residual, weight, eps, plus_one, name):
    if residual is None:
        _lib.require_cuda(name, x, weight)
    else:
        _lib.require_cuda(name, x, residual, weight)
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError(f"{name}: residual {tuple(residual.shape)} "
                             f"{residual.dtype} does not match x "
                             f"{tuple(x.shape)} {x.dtype}")
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} for rows of "
                         f"{d}")
    xf = x.contiguous().view(-1, d)
    rf = None if residual is None else residual.contiguous().view(-1, d)
    w = weight.contiguous()
    out = torch.empty_like(xf)
    res = None if rf is None else torch.empty_like(xf)
    m = xf.shape[0]
    if m and d:
        err = _lib.lib().repro_rmsnorm(
            xf.data_ptr(), None if rf is None else rf.data_ptr(),
            w.data_ptr(), out.data_ptr(),
            None if res is None else res.data_ptr(), m, d, eps,
            int(plus_one), _lib.dtype_code(xf, name), _lib.dtype_code(w, name),
            _lib.stream_handle(x.device))
        _lib.check(err, name)
        (rmsnorm if residual is None else rmsnorm_residual).counts.launched()
    out = out.view(x.shape)
    return out if res is None else (out, res.view(x.shape))


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """x: [..., D] -> normalized [..., D] in x's dtype (f32 inside).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps=eps, plus_one=plus_one)
    return _launch(x, None, weight, eps, plus_one, "rmsnorm")


def rmsnorm_residual(x: torch.Tensor, residual: torch.Tensor,
                     weight: torch.Tensor, *, eps: float = 1e-6,
                     plus_one: bool = False):
    """Fused ``(rmsnorm(x + residual), x + residual)``; the norm reads the
    unrounded f32 sum. CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return rmsnorm_residual_plain(x, residual, weight, eps=eps,
                                      plus_one=plus_one)
    return _launch(x, residual, weight, eps, plus_one, "rmsnorm_residual")


rmsnorm.counts = _lib.Counts()
rmsnorm_residual.counts = _lib.Counts()
