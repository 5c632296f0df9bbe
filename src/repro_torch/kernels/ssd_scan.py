"""Mamba2 SSD chunked scan: CUDA kernel and plain version.

Replaces the Pallas kernel ``ssd`` (src/repro/kernels/ssd_scan.py). Kernel
source: ``csrc/ssd_scan.cu``; its note says what bounds it. The plain
version is the model's chunked reference, ``models.mamba2.ssd_reference``
(the JAX package's ``kernels/ref.py`` points at the same function).

Two hand-written instances, chosen by ``ssd_instance`` from dtype, shapes
and alignment (a plain function, never a retry after a failure):

- ``tensor_core``: bf16, head dim 64, state dim 64 or 128, chunk a
  multiple of 64, 16-byte aligned bases. Its products run on ``wgmma``:
  one kernel carries each (batch row, head)'s state through the chunks in
  its f32 accumulators, a second computes every (query tile, chunk, batch
  row x head) in parallel. One call is these two launches, counted each
  under its own name (``INSTANCE_KERNELS``).
- ``cuda_core``: everything else (f32, the reduced config's P 16 / N 16 /
  chunk 8, ragged chunks such as 96): products on the f32 CUDA cores, one
  block per (batch row, head).

The kernel takes B and C per group (no copy per head), dt in f32 after the
softplus, and an optional f32 initial state; it returns ``y`` in x's dtype
and the final state in f32. It needs ``L % chunk == 0`` (the model pads
with dt = 0 tokens), ``H % G == 0``, a head dim of at most 64 and a state
dim of at most 128: every assigned architecture fits.

Under autograd (grad mode on and an input requiring grad) the call goes
through ``SsdFunction``: the kernel's forward, and a backward that
recomputes the plain version (the reference has no backward kernel;
without the Function the kernel's outputs would carry no gradient).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib

MAX_HEADDIM, MAX_STATE = 64, 128
TENSOR_CORE_P, TENSOR_CORE_N = 64, (64, 128)
# the kernels one call of each instance launches, as the counts name them
INSTANCE_KERNELS = {"tensor_core": ("tensor_core/states", "tensor_core/out"),
                    "cuda_core": ("cuda_core",)}


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, chunk: int = 256,
              init_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    ssd.counts.plain(x)
    from ..models.mamba2 import ssd_reference   # the model's own reference
    return ssd_reference(x, dt, a_log, b, c, chunk, init_state)


def ssd_instance(x: torch.Tensor, b: torch.Tensor, chunk: int,
                 c: Optional[torch.Tensor] = None) -> str:
    """The kernel instance that takes these inputs: ``"tensor_core"``
    (``wgmma``) for bf16 x with head dim ``TENSOR_CORE_P``, a state dim in
    ``TENSOR_CORE_N``, a chunk that is a multiple of 64 and 16-byte aligned
    bases (x, b and, when given, c, each as the wrapper hands it to the
    kernel: contiguous); ``"cuda_core"`` for anything else."""
    if (x.dtype != torch.bfloat16 or x.shape[-1] != TENSOR_CORE_P
            or b.shape[-1] not in TENSOR_CORE_N or chunk % 64):
        return "cuda_core"
    for t in (x, b) + (() if c is None else (c,)):
        if t.is_contiguous() and t.data_ptr() % 16:
            return "cuda_core"
    return "tensor_core"


def _shape_key(x, b, chunk) -> str:
    """A call's shape as its launch and backward counts name it."""
    bs, ln, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    return f"B{bs} L{ln} H{h} P{p} N{n} G{g} Q{chunk} {_lib.dtype_name(x)}"


class SsdFunction(torch.autograd.Function):
    """``ssd`` under autograd: the wrapper's forward (the kernel for CUDA
    tensors), and a backward that recomputes ``ssd_reference`` from the
    saved inputs and differentiates both outputs (y and the final state)
    to x, dt, a_log, b, c and the initial state. The reference has no
    backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk, init_state):
        ctx.save_for_backward(x, dt, a_log, b, c, init_state)
        ctx.chunk = chunk
        return _forward(x, dt, a_log, b, c, chunk, init_state)

    @staticmethod
    def backward(ctx, gy, gs):
        x, dt, a_log, b, c, s0 = ctx.saved_tensors
        chunk = ctx.chunk
        from ..models.mamba2 import ssd_reference
        with _lib.recompute("ssd", ssd.counts, _shape_key(x, b, chunk)):
            gx, gdt, ga, gb, gc, g0 = _lib.plain_grads(
                lambda *t: ssd_reference(*t[:5], chunk, t[5]),
                (x, dt, a_log, b, c, s0), (gy, gs))
        return gx, gdt, ga, gb, gc, None, g0


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, chunk: int = 256,
        init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,L,H,P]; dt [B,L,H] (post-softplus); a_log [H]; b/c [B,L,G,N];
    init_state [B,H,P,N] or None -> (y [B,L,H,P], final_state [B,H,P,N]
    f32). CPU tensors take the plain version; CUDA tensors the kernel.
    Where autograd records the call, it goes through ``SsdFunction``."""
    if _lib.needs_grad(x, dt, a_log, b, c, init_state):
        return SsdFunction.apply(x, dt, a_log, b, c, chunk, init_state)
    return _forward(x, dt, a_log, b, c, chunk, init_state)


def ssd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk,
              init_shape=None, out_shape=None, **kw) -> int:
    """The products of the chunked scan, chunk by chunk and head by head
    (Q = chunk): C B^T (2 Q^2 N), its decay-weighted product with X (2 Q^2
    P), the chunk's state B^T X (2 Q N P) and the carried state's read C S
    (2 Q N P)."""
    bs, ln, h, p = x_shape
    n, q = b_shape[3], chunk
    return bs * h * (ln // q) * (2 * q * q * n + 2 * q * q * p + 4 * q * n * p)


def _fake(x, dt, a_log, b, c, chunk, init_state):
    bs, ln, h, p = x.shape
    return (x.new_empty(x.shape),
            x.new_empty((bs, h, p, b.shape[3]), dtype=torch.float32))


_op = _lib.define_op(
    "ssd", "ssd(Tensor x, Tensor dt, Tensor a_log, Tensor b, Tensor c, "
    "int chunk, Tensor? init_state) -> (Tensor, Tensor)",
    lambda *a: ssd_plain(*a), lambda *a: _launch_checked(*a), _fake,
    ssd_flops)


def _forward(x, dt, a_log, b, c, chunk, init_state):
    """The operator ``repro_torch::ssd``: the plain version for CPU
    tensors, the kernel for CUDA ones; on fake and meta tensors its
    outputs' shapes, and ``ssd_flops`` under ``FlopCounterMode``."""
    return _op(x, dt, a_log, b, c, chunk, init_state)


def _launch_checked(x, dt, a_log, b, c, chunk, init_state):
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
    _lib.dtype_code(x, name)
    x, b, c = x.contiguous(), b.contiguous(), c.contiguous()
    dt = dt.float().contiguous()
    a32 = a_log.float().contiguous()
    s0 = None if init_state is None else init_state.float().contiguous()
    if not (bs and ln):
        sf = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
              if s0 is None else s0.clone())
        return torch.empty_like(x), sf
    instance = ssd_instance(x, b, chunk, c)
    y, sf, grids = launch(x, dt, a32, b, c, chunk, s0, instance)
    for kernel, grid in zip(INSTANCE_KERNELS[instance], grids):
        ssd.counts.launched(kernel, grid, _shape_key(x, b, chunk))
    return y, sf


def launch(x, dt, a32, b, c, chunk, s0, instance):
    """One call of ``instance`` on checked, contiguous CUDA inputs (dt,
    a32 and s0 in f32); returns (y, final state, the grid of each kernel it
    launched, in ``INSTANCE_KERNELS``' order). ``ssd`` picks the instance
    and counts the launches; a caller that
    forces the CUDA-core instance on shapes the tensor cores take (a
    comparison, as in chip_smoke.py) goes through here uncounted."""
    bs, ln, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    y = torch.empty_like(x)
    sf = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    if instance == "tensor_core":
        if s0 is not None and s0.data_ptr() % 16:   # read as float4
            s0 = s0.clone()
        nc = ln // chunk
        # the state entering each chunk, as a bf16 high part and residual
        states = (torch.empty((bs, h, nc, 2, p, n), dtype=torch.bfloat16,
                              device=x.device)
                  if nc > 1 or s0 is not None else None)
        err = _lib.lib().repro_ssd_wgmma(
            x.data_ptr(), dt.data_ptr(), a32.data_ptr(), b.data_ptr(),
            c.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
            sf.data_ptr(), None if states is None else states.data_ptr(), bs,
            ln, h, p, g, n, chunk, _lib.stream_handle(x.device))
        grids = ((bs * h,), (chunk // 64, nc, bs * h))
    else:
        err = _lib.lib().repro_ssd(
            x.data_ptr(), dt.data_ptr(), a32.data_ptr(), b.data_ptr(),
            c.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
            sf.data_ptr(), bs, ln, h, p, g, n, chunk,
            _lib.dtype_code(x, "ssd"), _lib.stream_handle(x.device))
        grids = ((bs * h,),)
    _lib.check(err, "ssd")
    return y, sf, grids


ssd.counts = _lib.Counts()
