"""Fused contention + ETA over one rate-group: CUDA kernel and plain version.

Replaces src/repro/kernels/contention_eta.py and keeps its names:

* ``rates`` / ``fused`` stand for the jitted float64 pass (``_kernel_f64``)
  that the epoch engine calls above ``KERNEL_MIN`` lanes per rate-group;
  they return the bits of ``ContentionModel.rates_seq``;
* ``fused_f32`` stands for the Pallas kernel ``fused_pallas``: the same
  pass in float32, for analytic fleet sweeps.

Kernel source: ``csrc/contention_eta.cu`` (one block per call, the lanes
resident in shared memory up to ``resident_max``, the sums' serial chains
read ahead from registers, a compensated sum split over two warps; see the
note there on what bounds it). ``device_model`` is the ``DeviceModel`` (the
JAX module calls it ``device``); ``device`` is the torch device the pass
runs on: the card unless the caller names another, and the plain version
for the CPU. The columns may be lists, numpy arrays or CPU tensors. On the
card the wrapper writes them into a pinned buffer (one numpy assignment a
column), copies the [4, m] block to the card asynchronously, launches on
the current stream, copies back only the rows it returns into pinned
memory, and synchronizes the current stream once.

Which sum. ``rates_seq`` sums with Python's builtin ``sum()``, and since
CPython 3.12 that is Neumaier's compensated sum, not a plain left-to-right
add: the JAX kernels, which add left to right, no longer return its bits on
this interpreter once a group passes a hundred or so lanes. ``compensated``
picks the algorithm: ``None`` (the default) follows this interpreter's
``sum()``, so the engine stays bit-identical to ``rates_seq``;
``compensated=False`` adds left to right, the JAX kernels' order.
"""
from __future__ import annotations

import array
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import _lib

# True where builtin sum() compensates (CPython >= 3.12): a plain
# left-to-right sum of these four gives 0.0
SUM_IS_COMPENSATED = sum([1.0, 1e100, 1.0, -1e100]) == 2.0
RATE_FLOOR = 1e-6
_NP = {torch.float64: np.float64, torch.float32: np.float32}

# csrc/contention_eta.cu: the kernel's shared-memory layout and chain
COLUMNS = 5            # u (then the products), ns, mf, speed, f's partials
PAD = 32               # a column holds m rounded up to PAD lanes
HEAD = 128             # bytes ahead of the columns (mbarrier, broadcast)
CHAIN_CHUNK = 256      # lanes a compensated sum's warps hand over at a time
CHAIN_RING = 8         # f64 lanes between the f chain's checkpoints
H100_SMEM_OPTIN = 232448   # shared memory a block may take on the H100


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


def lane_columns(u, ns, mf, rem, dtype: torch.dtype,
                 out: Optional[np.ndarray] = None) -> torch.Tensor:
    """[4, m] host tensor of the lanes' columns (rem zero when absent),
    rounded to ``dtype`` as the JAX module rounds them. Each column may be
    a list, a numpy array or a CPU tensor, each converted in one call.
    ``out``: a [4, >= m] array of ``dtype`` to write into (the result is a
    view of its first m columns)."""
    m = len(u)
    if out is None:
        out = np.empty((4, m), _NP[dtype])
    for k, col in enumerate((u, ns, mf, rem)):
        if isinstance(col, torch.Tensor):
            col = col.numpy()
        elif col is not None and not isinstance(col, np.ndarray):
            # a list: array.array reads its floats in one C loop, about
            # twice as fast as numpy's own conversion of a list
            col = np.frombuffer(array.array("d", col), np.float64)
        out[k, :m] = 0.0 if col is None else col
    return torch.from_numpy(out[:, :m])


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
def col_stride(m: int) -> int:
    """Elements a column of m lanes takes in the kernel's layout."""
    return -(-m // PAD) * PAD


def resident_max(dtype: torch.dtype, smem_bytes: int = H100_SMEM_OPTIN) -> int:
    """Most lanes whose columns the kernel keeps in shared memory (5,792 in
    float64 and 11,616 in float32 with the H100's 232,448 bytes a block)."""
    elt = _NP[dtype]().itemsize
    return (smem_bytes - HEAD) // (COLUMNS * elt) // PAD * PAD


def contention_instance(m: int, dtype: torch.dtype,
                        smem_bytes: int = H100_SMEM_OPTIN) -> str:
    """``resident`` (columns in shared memory) or ``tiled`` (columns in a
    device-memory workspace), as ``launch`` picks for ``m`` lanes."""
    return "resident" if m <= resident_max(dtype, smem_bytes) else "tiled"


_smem: Dict[int, int] = {}


def smem_optin(device: torch.device) -> int:
    """Shared memory a block may opt into on ``device`` (queried once)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _smem:
        with torch.cuda.device(idx):
            n = _lib.lib().repro_smem_optin()
        if n < 0:
            _lib.check(-n, "contention_eta")
        _smem[idx] = n
    return _smem[idx]


def launch(x: torch.Tensor, out: torch.Tensor, now: float, device_model,
           compensated: bool) -> None:
    """Launch the kernel on CUDA tensors ``x`` [4, m] -> ``out`` [3, m]
    (speed, rate, eta) on the current stream; no copy, no synchronize.
    Rows may be strided (a view of wider rows); elements are contiguous."""
    name = "contention_eta"
    _lib.require_cuda(name, x, out)
    m = x.shape[1] if x.dim() == 2 else -1
    if (x.dim() != 2 or x.shape[0] != 4 or out.shape != (3, m)
            or out.dtype != x.dtype or x.stride(1) != 1 or out.stride(1) != 1
            or x.stride(0) < m or out.stride(0) < m):
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}, out "
                         f"{tuple(out.shape)} {out.dtype}")
    if x.dtype not in _NP:
        raise TypeError(f"{name}: float64 or float32 lanes, got {x.dtype}")
    inst = contention_instance(m, x.dtype, smem_optin(x.device))
    ws = (torch.empty(COLUMNS * col_stride(m), dtype=x.dtype,
                      device=x.device) if inst == "tiled" else None)
    err = _lib.lib().repro_contention_eta(
        x.data_ptr(), x.stride(0), out.data_ptr(), out.stride(0),
        None if ws is None else ws.data_ptr(), m, float(now),
        float(device_model.n_units), float(device_model.bubble),
        float(device_model.l2_pressure), int(compensated), int(ws is not None),
        _lib.dtype_code(x, name), _lib.stream_handle(x.device))
    _lib.check(err, name)
    _counts(x.dtype).launched(inst)


def _counts(dtype: torch.dtype) -> _lib.Counts:
    return (fused if dtype == torch.float64 else fused_f32).counts


class _Staging:
    """Pinned host and device buffers of one (device, dtype), grown on
    demand and reused: the lanes go in as one [4, m] block, the rows the
    caller returns come back in one copy (csrc: the round trip's C entry).
    The lock holds a call's use of them from the first write to the last
    read."""

    def __init__(self, device: torch.device, dtype: torch.dtype) -> None:
        self.device, self.dtype = device, dtype
        self.code = _lib.dtype_code(torch.empty(0, dtype=dtype), "staging")
        self.smem = smem_optin(device)
        self.lock = threading.Lock()
        self.cap = 0
        self.ws: Optional[torch.Tensor] = None

    def grow(self, mp: int) -> None:
        if mp <= self.cap:
            return
        self.cap = max(mp, 2 * self.cap)
        dt, dev = self.dtype, self.device
        self.h_in = torch.empty(4 * self.cap, dtype=dt, pin_memory=True)
        self.h_out = torch.empty(3 * self.cap, dtype=dt, pin_memory=True)
        self.d_in = torch.empty(4 * self.cap, dtype=dt, device=dev)
        self.d_out = torch.empty(3 * self.cap, dtype=dt, device=dev)
        self.h_in_np, self.h_out_np = self.h_in.numpy(), self.h_out.numpy()

    def workspace(self, mp: int) -> torch.Tensor:
        if self.ws is None or self.ws.numel() < COLUMNS * mp:
            self.ws = torch.empty(COLUMNS * mp, dtype=self.dtype,
                                  device=self.device)
        return self.ws


_stagings: Dict[Tuple[torch.device, torch.dtype], _Staging] = {}
_stagings_lock = threading.Lock()


def _staging(dev: torch.device, dtype: torch.dtype) -> _Staging:
    with _stagings_lock:
        st = _stagings.get((dev, dtype))
        if st is None:
            st = _stagings[(dev, dtype)] = _Staging(dev, dtype)
        return st


def _round_trip(cols, rows: Tuple[int, int], dev: torch.device,
                dtype: torch.dtype, now: float, dm, compensated: bool, take):
    """Lanes ``cols`` (u, ns, mf, rem) written into the pinned buffer, then
    one C call: one asynchronous copy of the [4, m] block to the card, the
    kernel, one asynchronous copy of rows ``rows[0]:rows[1]`` of its output
    back into pinned memory, one synchronize of the current stream; returns
    ``take`` of a numpy view of those rows ([rows, m]), called before the
    buffers are free for the next call."""
    if dev.type != "cuda":
        raise ValueError(f"contention_eta: the kernel runs on CUDA devices, "
                         f"got {dev}")
    m = len(cols[0])
    mp = col_stride(m)
    st = _staging(dev, dtype)
    with st.lock:
        st.grow(mp)
        lane_columns(*cols, dtype, out=st.h_in_np[:4 * mp].reshape(4, mp))
        inst = contention_instance(m, dtype, st.smem)
        ws = st.workspace(mp).data_ptr() if inst == "tiled" else None
        err = _lib.lib().repro_contention_eta_round_trip(
            st.h_in.data_ptr(), st.d_in.data_ptr(), st.d_out.data_ptr(),
            st.h_out.data_ptr(), ws, m, mp, rows[0], rows[1], float(now),
            float(dm.n_units), float(dm.bubble), float(dm.l2_pressure),
            int(compensated), int(ws is not None), st.code,
            _lib.stream_handle(dev))
        _lib.check(err, "contention_eta")
        _counts(dtype).launched(inst)
        r0, r1 = rows[0] * mp, rows[1] * mp
        return take(st.h_out_np[r0:r1].reshape(rows[1] - rows[0], mp)[:, :m])


def _two_rows(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return h[0].copy(), h[1].copy()


def rates(device_model, u: Sequence[float], ns: Sequence[float],
          mf: Sequence[float], *, device: DeviceLike = None,
          compensated: Optional[bool] = None) -> List[float]:
    """Bit-exact drop-in for ``ContentionModel.rates_seq`` (pre-clamp speed
    fractions). CPU takes the plain version; the card launches the
    kernel. Columns: lists, numpy arrays or CPU tensors."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return rates_plain(device_model, u, ns, mf, compensated=compensated)
    if len(u) == 0:
        return []
    return _round_trip((u, ns, mf, None), (0, 1), dev, torch.float64, 0.0,
                       device_model, _compensated(compensated),
                       lambda h: h[0].tolist())


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
    return _round_trip((u, ns, mf, rem), (1, 3), dev, torch.float64, now,
                       device_model, _compensated(compensated), _two_rows)


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
    return _round_trip((u, ns, mf, rem), (1, 3), dev, torch.float32, now,
                       device_model, False, _two_rows)


fused.counts = _lib.Counts()          # the f64 kernel, behind rates and fused
rates.counts = fused.counts
fused_f32.counts = _lib.Counts()


PROBE_MODES = {"add": 0, "chain": 1, "neumaier_select": 2}
PROBE_STEPS = (1024, 4096)     # chain lengths whose cycle counts give a slope


def chain_cycles(dtype: torch.dtype, mode: str = "add", *,
                 device: DeviceLike = None) -> float:
    """SM cycles a step of a dependent chain takes on the card, from
    ``clock64`` in one warp (``csrc/contention_eta.cu``:
    ``repro_chain_probe``): the slope between 1024 and 4096 steps, the
    least of five runs each. ``add``: one ``add_rn`` on
    registers, the latency of one add (the kernel's floor per summed lane);
    ``chain``: the kernel's plain chain, operands read ahead from shared
    memory; ``neumaier_select``: one branch-free Neumaier step (t = f + x,
    c += e) a lane in a single warp."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("chain_cycles measures the card: pass a CUDA "
                           "device")
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(PROBE_STEPS[1], generator=g, dtype=torch.float64) + 0.5
         ).to(dtype).to(dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.empty(1, dtype=dtype, device=dev)
    per = []
    for n in PROBE_STEPS:
        runs = []
        for _ in range(5):
            err = _lib.lib().repro_chain_probe(
                x.data_ptr(), cycles.data_ptr(), sink.data_ptr(), n,
                PROBE_MODES[mode], _lib.dtype_code(x, "chain_probe"),
                _lib.stream_handle(dev))
            _lib.check(err, "chain_probe")
            runs.append(int(cycles.item()))
        per.append(min(runs))
    return (per[1] - per[0]) / (PROBE_STEPS[1] - PROBE_STEPS[0])
