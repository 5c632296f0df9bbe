"""RMSNorm and fused residual-add + RMSNorm: CUDA kernel and plain version.

Replaces the Pallas kernels ``rmsnorm`` and ``rmsnorm_residual``
(src/repro/kernels/rmsnorm.py). Kernel source: ``csrc/rmsnorm.cu``.

What bounds it on the H100: bytes. Each row is read once (x and r for the
fused variant) and written once, with a handful of f32 operations per
element. At decode batch (4 rows of 576-5120) the call moves 5-41 KB, so
its time is latency: the launch, and how many dependent loads each thread
waits on. At prefill (2048 rows) it is the 3.35 TB/s of device memory.
The kernel keeps each thread's share of the row (and of the weight) in
registers after one round of 16-byte loads and gives a row a warp or a
CTA. ``rmsnorm_plan`` picks that plan from the shapes, dtype and
alignment; the residual add is fused so that the sum never makes a round
trip through device memory.

``rmsnorm_residual`` norms the unrounded f32 sum ``x + r``, as the Pallas
kernel does; the plain version below keeps that order.

Under autograd (grad mode on and an input that requires grad) both go
through ``RmsNormFunction``: the kernel's forward, and a backward that
recomputes the plain version from the saved inputs. The kernel writes into
a fresh tensor that autograd cannot see, so without the Function a
parameter behind the norm would get no gradient on the card. The reference
has no backward kernel (no ``custom_vjp``), so none is written here.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import _lib

H100_SMS = 132
MAX_THREADS = 256        # threads a CTA (csrc/rmsnorm.cu: MAX_THREADS)
VPT_CHOICES = (1, 2, 4, 8)   # vectors a thread (the kernel's instances)
SCALAR_VPT_CHOICES = VPT_CHOICES + (16, 32)   # the scalar instance's
ROWS_PER_CTA = 4         # rows of a CTA when each row takes one warp


@dataclass(frozen=True)
class RmsPlan:
    """How the kernel covers [M, D]: ``tpr`` threads a row,
    ``rows_per_cta`` rows a CTA, ``vpt`` vectors of ``vec`` elements a
    thread (``vec`` 1: the scalar instance); ``early_w`` loads the
    weights with x, before the sum."""
    vec: int
    tpr: int
    rows_per_cta: int
    vpt: int
    early_w: bool = True

    @property
    def threads(self) -> int:
        return self.tpr * self.rows_per_cta

    @functools.cached_property
    def c_args(self) -> tuple:
        """The plan's arguments to the C entry, in its order."""
        return (self.tpr, self.rows_per_cta, self.vpt, self.vec,
                int(self.early_w))

    def grid(self, m: int) -> int:
        return -(-m // self.rows_per_cta)

    @functools.cached_property
    def instance(self) -> str:
        kind = "warp" if self.tpr == 32 else "block"
        return kind if self.vec > 1 else f"{kind}_scalar"


def _round32(n: int) -> int:
    return -(-n // 32) * 32


def _vpt(n: int) -> int:
    return next(v for v in VPT_CHOICES if v >= n)


# called on every launch: cached, so that planning costs the host ~2 us
@functools.lru_cache(maxsize=1024)
def rmsnorm_plan(m: int, d: int, dtype: torch.dtype,
                 aligned: bool = True) -> RmsPlan:
    """The kernel's plan for ``m`` rows of ``d`` elements of ``dtype``.

    16-byte vectors when ``d`` is a multiple of their width and every base
    is 16-byte ``aligned``, else the scalar instance. Many rows (at least
    half as many as SMs) of at most 256 vectors: a warp a row, 4 rows a
    CTA. Otherwise a row takes one CTA with the fewest vectors a thread
    (1-8, or up to 32 in the scalar instance) that keep it within 256
    threads. Few rows load the weights early (the call is one round trip
    of latency); many rows after the sum (the registers they would hold
    cut the CTAs in flight)."""
    vec = 16 // dtype.itemsize
    if not aligned or d % vec:
        vec = 1
    nvec = -(-d // vec)
    many = m >= H100_SMS // 2
    if many and nvec <= 32 * VPT_CHOICES[-1]:
        return RmsPlan(vec, 32, ROWS_PER_CTA, _vpt(-(-nvec // 32)),
                       early_w=False)
    for vpt in VPT_CHOICES if vec > 1 else SCALAR_VPT_CHOICES:
        tpr = _round32(-(-nvec // vpt))
        if tpr <= MAX_THREADS:
            return RmsPlan(vec, tpr, 1, vpt, early_w=not many)
    raise ValueError(f"rmsnorm: width {d} is past what the kernel covers")


def plan_for(x: torch.Tensor, *others: torch.Tensor) -> RmsPlan:
    """``rmsnorm_plan`` for x viewed as rows of its last dimension, with
    the alignment of x's and the others' base pointers."""
    d = x.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others))
    return rmsnorm_plan(x.numel() // max(d, 1), d, x.dtype, aligned)


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
                  plus_one: bool = False) -> torch.Tensor:
    rmsnorm.counts.plain(x)
    return _rmsnorm_math(x, weight, eps, plus_one)


def rmsnorm_residual_plain(x: torch.Tensor, residual: torch.Tensor,
                           weight: torch.Tensor, *, eps: float = 1e-6,
                           plus_one: bool = False):
    rmsnorm_residual.counts.plain(x)
    return _residual_math(x, residual, weight, eps, plus_one)


def _rmsnorm_math(x, weight, eps, plus_one):
    return _norm_f32(_lib.at_least_f32(x), weight, eps, plus_one).to(x.dtype)


def _residual_math(x, residual, weight, eps, plus_one):
    s = _lib.at_least_f32(x) + _lib.at_least_f32(residual)
    return _norm_f32(s, weight, eps, plus_one).to(x.dtype), s.to(x.dtype)


def _norm_f32(xf: torch.Tensor, weight: torch.Tensor, eps: float,
              plus_one: bool) -> torch.Tensor:
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = _lib.at_least_f32(weight)
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
        # plan_for's rule on the pointers the call passes anyway
        px, pw = xf.data_ptr(), w.data_ptr()
        pr = None if rf is None else rf.data_ptr()
        pl = rmsnorm_plan(m, d, xf.dtype, (px | pw | (pr or 0)) % 16 == 0)
        err = _lib.lib().repro_rmsnorm(
            px, pr, pw, out.data_ptr(),
            None if res is None else res.data_ptr(), m, d, eps,
            int(plus_one), _lib.dtype_code(xf, name), _lib.dtype_code(w, name),
            *pl.c_args, _lib.stream_handle(x.device))
        _lib.check(err, name)
        (rmsnorm if residual is None else rmsnorm_residual).counts.launched(
            pl.instance, (pl.grid(m),), _shape_key(xf, plus_one))
    out = out.view(x.shape)
    return out if res is None else (out, res.view(x.shape))


def _shape_key(x: torch.Tensor, plus_one: bool) -> str:
    """A call's shape as its launch and backward counts name it."""
    d = x.shape[-1]
    return (f"{x.numel() // max(d, 1)}x{d} {_lib.dtype_name(x)}"
            + (" plus_one" if plus_one else ""))


def _norm_flops(*args, out_shape=None, **kw) -> int:
    """The norms multiply no matrices: 0 under ``FlopCounterMode``, which
    counts the products of matmuls, convolutions and attention only."""
    return 0


_op = _lib.define_op(
    "rmsnorm", "rmsnorm(Tensor x, Tensor weight, float eps, bool plus_one) "
    "-> Tensor",
    lambda x, w, eps, po: rmsnorm_plain(x, w, eps=eps, plus_one=po),
    lambda x, w, eps, po: _launch(x, None, w, eps, po, "rmsnorm"),
    lambda x, w, eps, po: x.new_empty(x.shape), _norm_flops)
_op_residual = _lib.define_op(
    "rmsnorm_residual",
    "rmsnorm_residual(Tensor x, Tensor residual, Tensor weight, float eps, "
    "bool plus_one) -> (Tensor, Tensor)",
    lambda x, r, w, eps, po: rmsnorm_residual_plain(x, r, w, eps=eps,
                                                    plus_one=po),
    lambda x, r, w, eps, po: _launch(x, r, w, eps, po, "rmsnorm_residual"),
    lambda x, r, w, eps, po: (x.new_empty(x.shape), x.new_empty(x.shape)),
    _norm_flops)


def _forward(x, residual, weight, eps, plus_one):
    """The operators: the plain version for CPU tensors, the kernel for
    CUDA ones."""
    if residual is None:
        return _op(x, weight, eps, plus_one)
    return _op_residual(x, residual, weight, eps, plus_one)


class RmsNormFunction(torch.autograd.Function):
    """``rmsnorm`` (``residual`` None) or ``rmsnorm_residual`` under
    autograd: the forward is the wrapper's (the kernel for CUDA tensors);
    the backward recomputes the plain version from the saved inputs and
    differentiates it (the reference has no backward kernel)."""

    @staticmethod
    def forward(ctx, x, residual, weight, eps, plus_one):
        ctx.save_for_backward(x, residual, weight)
        ctx.eps, ctx.plus_one = eps, plus_one
        return _forward(x, residual, weight, eps, plus_one)

    @staticmethod
    def backward(ctx, *grads):
        x, r, w = ctx.saved_tensors
        eps, plus_one = ctx.eps, ctx.plus_one
        fn = rmsnorm if r is None else rmsnorm_residual
        with _lib.recompute(fn.__name__, fn.counts, _shape_key(x, plus_one)):
            if r is None:
                gx, gw = _lib.plain_grads(
                    lambda a, c: _rmsnorm_math(a, c, eps, plus_one), (x, w),
                    grads)
                return gx, None, gw, None, None
            gx, gr, gw = _lib.plain_grads(
                lambda a, b, c: _residual_math(a, b, c, eps, plus_one),
                (x, r, w), grads)
            return gx, gr, gw, None, None


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    """x: [..., D] -> normalized [..., D] in x's dtype (f32 inside).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Where autograd records the call, it goes through ``RmsNormFunction``."""
    if _lib.needs_grad(x, weight):
        return RmsNormFunction.apply(x, None, weight, eps, plus_one)
    return _forward(x, None, weight, eps, plus_one)


def rmsnorm_residual(x: torch.Tensor, residual: torch.Tensor,
                     weight: torch.Tensor, *, eps: float = 1e-6,
                     plus_one: bool = False):
    """Fused ``(rmsnorm(x + residual), x + residual)``; the norm reads the
    unrounded f32 sum. CPU tensors take the plain version; under autograd
    the call goes through ``RmsNormFunction``."""
    if _lib.needs_grad(x, residual, weight):
        return RmsNormFunction.apply(x, residual, weight, eps, plus_one)
    return _forward(x, residual, weight, eps, plus_one)


rmsnorm.counts = _lib.Counts()
rmsnorm_residual.counts = _lib.Counts()
