"""Fused contention + ETA over one rate-group: CUDA kernel and plain version.

Replaces src/repro/kernels/contention_eta.py and keeps its names:

* ``rates`` / ``fused`` stand for the jitted float64 pass (``_kernel_f64``)
  that the epoch engine calls above ``KERNEL_MIN`` lanes per rate-group;
  they return the bits of ``ContentionModel.rates_seq``;
* ``fused_f32`` stands for the Pallas kernel ``fused_pallas``: the same
  pass in float32, for analytic fleet sweeps.

Kernel source: ``csrc/contention_eta.cu`` (one block per call, the three
sums taken left to right by one thread; see the note there on what bounds
it). ``device_model`` is the ``DeviceModel`` (the JAX module calls it
``device``); ``device`` is the torch device the pass runs on: the card
unless the caller names another, and the plain version for the CPU. The
wrapper copies the host lists to the card, launches on the current stream
and reads the result back before it returns.

Which sum. ``rates_seq`` sums with Python's builtin ``sum()``, and since
CPython 3.12 that is Neumaier's compensated sum, not a plain left-to-right
add: the JAX kernels, which add left to right, no longer return its bits on
this interpreter once a group passes a hundred or so lanes. ``compensated``
picks the algorithm: ``None`` (the default) follows this interpreter's
``sum()``, so the engine stays bit-identical to ``rates_seq``;
``compensated=False`` adds left to right, the JAX kernels' order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import _lib

# True where builtin sum() compensates (CPython >= 3.12): a plain
# left-to-right sum of these four gives 0.0
SUM_IS_COMPENSATED = sum([1.0, 1e100, 1.0, -1e100]) == 2.0
RATE_FLOOR = 1e-6


def available() -> bool:
    """True when the kernel can run in this process (a CUDA device)."""
    return torch.cuda.is_available()


# ------------------------------------------------------------------ plain
def _serial_sum(vals: List[float], compensated: bool, scalar) -> float:
    """Left-to-right sum in ``scalar``'s precision; ``compensated`` follows
    CPython 3.12's builtin ``sum()`` over floats step for step."""
    f, c = scalar(0.0), scalar(0.0)
    if not compensated:
        for v in vals:
            f = f + scalar(v)
        return f
    for v in vals:
        x = scalar(v)
        t = f + x
        if abs(f) >= abs(x):
            c = c + ((f - t) + x)
        else:
            c = c + ((x - t) + f)
        f = t
    if c and np.isfinite(c):
        f = f + c
    return f


def _pass_plain(x: torch.Tensor, now: float, dm, compensated: bool):
    """The contention + ETA pass over ``x = [u; ns; mf; rem]`` ([4, m]), one
    IEEE-754 operation at a time in ``x``'s dtype, in the op order of
    ``ContentionModel.rates_arrays``. Returns (speed, rate, eta)."""
    dt, dev = x.dtype, x.device
    scalar = float if dt == torch.float64 else np.float32

    def t(v) -> torch.Tensor:
        return torch.tensor(float(v), dtype=dt, device=dev)

    u, ns, mf, rem = x.unbind(0)
    m = u.shape[0]
    one = scalar(1.0)
    n_units, bubble = scalar(dm.n_units), scalar(dm.bubble)
    l2p, mm = scalar(dm.l2_pressure), scalar(m)
    total = _serial_sum(u.tolist(), compensated, scalar)
    if total > n_units:
        u = u * t(n_units / total)
    gain = (one - bubble / mm) / (one - bubble)
    speeds = torch.minimum(t(1.0), torch.minimum(u, ns) / ns * t(gain))
    used = _serial_sum((speeds * ns).tolist(), compensated, scalar)
    budget = n_units * (one + bubble * (one - one / mm))
    if used > budget:
        speeds = speeds * t(budget / used)
    thrash = one + l2p * max(mm - one, scalar(0.0))
    phi = _serial_sum((mf * speeds).tolist(), compensated, scalar) * thrash
    if phi > one:
        speeds = speeds / ((t(1.0) - mf) + mf * t(phi))
    floor = t(RATE_FLOOR)
    rate = torch.where(speeds > floor, speeds, floor)
    return speeds, rate, t(now) + rem / rate


def lane_columns(u, ns, mf, rem, dtype: torch.dtype) -> torch.Tensor:
    """[4, m] host tensor of the lanes' columns (rem zero when absent),
    rounded to ``dtype`` as the JAX module rounds them."""
    m = len(u)
    cols = [np.asarray(v, np.float64).reshape(m) for v in (u, ns, mf)]
    cols.append(np.zeros(m) if rem is None
                else np.asarray(rem, np.float64).reshape(m))
    return torch.from_numpy(np.stack(cols)).to(dtype)


def _compensated(flag: Optional[bool]) -> bool:
    return SUM_IS_COMPENSATED if flag is None else bool(flag)


def rates_plain(device_model, u: Sequence[float], ns: Sequence[float],
                mf: Sequence[float], *, device: DeviceLike = "cpu",
                compensated: Optional[bool] = None) -> List[float]:
    """Plain version of ``rates`` on ``device`` (the CPU unless named)."""
    if len(u) == 0:
        return []
    x = lane_columns(u, ns, mf, None, torch.float64).to(torch.device(device))
    fused.counts.plain(x)
    speed, _, _ = _pass_plain(x, 0.0, device_model, _compensated(compensated))
    return speed.tolist()


def fused_plain(device_model, now: float, u, ns, mf, rem, *,
                device: DeviceLike = "cpu",
                compensated: Optional[bool] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Plain version of ``fused`` on ``device`` (the CPU unless named)."""
    if len(u) == 0:
        z = np.empty(0)
        return z, z
    x = lane_columns(u, ns, mf, rem, torch.float64).to(torch.device(device))
    fused.counts.plain(x)
    _, rate, eta = _pass_plain(x, now, device_model,
                               _compensated(compensated))
    return rate.cpu().numpy(), eta.cpu().numpy()


def fused_f32_plain(device_model, now: float, u, ns, mf, rem, *,
                    device: DeviceLike = "cpu"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Plain version of ``fused_f32`` on ``device`` (the CPU unless named):
    float32 throughout, sums left to right, as ``fused_pallas``."""
    if len(u) == 0:
        z = np.empty(0, np.float32)
        return z, z
    x = lane_columns(u, ns, mf, rem, torch.float32).to(torch.device(device))
    fused_f32.counts.plain(x)
    _, rate, eta = _pass_plain(x, now, device_model, False)
    return rate.cpu().numpy(), eta.cpu().numpy()


# ----------------------------------------------------------------- kernel
def launch(x: torch.Tensor, out: torch.Tensor, now: float, device_model,
           compensated: bool) -> None:
    """Launch the kernel on CUDA tensors ``x`` [4, m] -> ``out`` [3, m]
    (speed, rate, eta) on the current stream; no copy, no synchronize."""
    name = "contention_eta"
    _lib.require_cuda(name, x, out)
    if (x.dim() != 2 or x.shape[0] != 4 or out.shape != (3, x.shape[1])
            or out.dtype != x.dtype or not x.is_contiguous()
            or not out.is_contiguous()):
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}, out "
                         f"{tuple(out.shape)} {out.dtype}")
    if x.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"{name}: float64 or float32 lanes, got {x.dtype}")
    err = _lib.lib().repro_contention_eta(
        x.data_ptr(), out.data_ptr(), x.shape[1], float(now),
        float(device_model.n_units), float(device_model.bubble),
        float(device_model.l2_pressure), int(compensated),
        _lib.dtype_code(x, name), _lib.stream_handle(x.device))
    _lib.check(err, name)
    (fused if x.dtype == torch.float64 else fused_f32).counts.launched()


def _round_trip(x: torch.Tensor, dev: torch.device, now: float, dm,
                compensated: bool) -> torch.Tensor:
    xd = x.to(dev)
    out = torch.empty((3, x.shape[1]), dtype=x.dtype, device=dev)
    launch(xd, out, now, dm, compensated)
    return out.cpu()                  # waits for the current stream


def rates(device_model, u: Sequence[float], ns: Sequence[float],
          mf: Sequence[float], *, device: DeviceLike = None,
          compensated: Optional[bool] = None) -> List[float]:
    """Bit-exact drop-in for ``ContentionModel.rates_seq`` (pre-clamp speed
    fractions). CPU takes the plain version; the card launches the
    kernel."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return rates_plain(device_model, u, ns, mf, compensated=compensated)
    if len(u) == 0:
        return []
    x = lane_columns(u, ns, mf, None, torch.float64)
    return _round_trip(x, dev, 0.0, device_model,
                       _compensated(compensated))[0].tolist()


def fused(device_model, now: float, u: Sequence[float], ns: Sequence[float],
          mf: Sequence[float], rem: Sequence[float], *,
          device: DeviceLike = None, compensated: Optional[bool] = None
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Fused contention + ETA: ``(rates, etas)`` as float64 arrays of length
    ``len(u)``; rates carry the engine's 1e-6 clamp and
    ``eta = now + rem / rate``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return fused_plain(device_model, now, u, ns, mf, rem,
                           compensated=compensated)
    if len(u) == 0:
        z = np.empty(0)
        return z, z
    out = _round_trip(lane_columns(u, ns, mf, rem, torch.float64), dev, now,
                      device_model, _compensated(compensated))
    return out[1].numpy(), out[2].numpy()


def fused_f32(device_model, now: float, u, ns, mf, rem, *,
              device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """Float32 counterpart of ``fused_pallas``: ``(rates, etas)`` as float32
    arrays; sums left to right. Not the engines' bit-exact path."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return fused_f32_plain(device_model, now, u, ns, mf, rem)
    if len(u) == 0:
        z = np.empty(0, np.float32)
        return z, z
    out = _round_trip(lane_columns(u, ns, mf, rem, torch.float32), dev, now,
                      device_model, False)
    return out[1].numpy(), out[2].numpy()


fused.counts = _lib.Counts()          # the f64 kernel, behind rates and fused
rates.counts = fused.counts
fused_f32.counts = _lib.Counts()
