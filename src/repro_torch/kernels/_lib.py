"""Build, load and count the port's CUDA kernels (``kernels/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. Each source
compiles in its own ``nvcc`` process, all started together, and the library
is named by a digest of the sources and flags, so an edited source is never
served a stale build. The build lands in ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``).

Nothing here touches CUDA when the module is imported: the CPU tests import
every module of the package.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("rmsnorm.cu", "decode_attention.cu", "flash_attention.cu",
           "contention_eta.cu", "ssd_scan.cu", "stage_burst.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with csrc/common.cuh
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _D = ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    # x, r, w, out, res, M, D, eps, plus_one, x_dtype, w_dtype, tpr,
    # rows_per_cta, vpt, vec, early_w, stream
    "repro_rmsnorm": (_P, _P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _I, _I,
                      _I, _I, _I, _P),
    # q, k, v, kv_pos, q_pos, out, ws, B, H, KV, S, Dh, strides, scale,
    # window, softcap, chunk, n_split, dtype, stream
    "repro_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P, _F, _I, _F, _I, _I, _I, _P),
    # q, k, v, out, B, H, KV, S, S_kv, Dh, strides, scale, causal, window,
    # softcap, dtype, stream
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F,
                              _I, _I, _F, _I, _P),
    # the same without dtype (bf16 only)
    "repro_flash_attention_wgmma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _P, _F, _I, _I, _F, _P),
    # Dh, out [8] (int32): the tensor-core instance's plan
    "repro_flash_wgmma_plan": (_I, _P),
    # in [4, m] (rows ld_in apart), ld_in, out [3, m], ld_out, ws, m, now,
    # n_units, bubble, l2p, compensated, tiled, dtype, stream
    "repro_contention_eta": (_P, _LL, _P, _LL, _P, _LL, _D, _D, _D, _D, _I,
                             _I, _I, _P),
    # h_in, d_in, d_out, h_out, ws, m, ld, row0, row1, now, n_units,
    # bubble, l2p, compensated, tiled, dtype, stream
    "repro_contention_eta_round_trip": (_P, _P, _P, _P, _P, _LL, _LL, _I, _I,
                                        _D, _D, _D, _D, _I, _I, _I, _P),
    # (no arguments): shared memory a block may opt into, bytes
    "repro_smem_optin": (),
    # x, cycles, sink, n, mode, dtype, stream
    "repro_chain_probe": (_P, _P, _P, _I, _I, _I, _P),
    # x, dt, a_log, b, c, init_state, y, final_state, B, L, H, P, G, N,
    # chunk, dtype, stream
    "repro_ssd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                  _I, _P),
    # x, dt, a_log, b, c, init_state, y, final_state, states, B, L, H, P, G,
    # N, chunk, stream (bf16 only)
    "repro_ssd_wgmma": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _P),
    # a stage program's graph (csrc/stage_burst.cu; no kernel): stream,
    # event, node out; stream, dst, src, bytes, node out; and stream,
    # graph_exec, nodes, n_in, n_out, start, end, src_in, dst_in, src_out,
    # out_base, out_off, bytes, last, stamps
    "repro_stage_capture_event": (_P, _P, _P),
    "repro_stage_capture_copy": (_P, _P, _P, _LL, _P),
    "repro_stage_launch": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""        # nvcc's output (-Xptxas -v: registers, shared memory)
# this thread's open ``recording()`` log, if any
_recording = threading.local()


class Counts:
    """Launches of one wrapper's kernels and calls of its plain PyTorch
    version; where a wrapper chooses between instances of its kernel, or
    launches more than one, the launches of each in ``by_instance`` and,
    where the wrapper gives it, the grid of each one's last launch in
    ``grids``; where it gives the call's shape, the launches of each
    instance at each shape in ``by_shape`` (keyed ``"instance shape"``).
    Under autograd, ``backward`` counts the backward passes that recompute
    through the plain version (``backward_by_shape`` by the call's shape);
    such a recompute is not a plain call.

    Lanes run on worker threads, so every increment takes the lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches = 0
        self.plain_calls = 0
        self.plain_cuda_calls = 0     # plain version handed a CUDA tensor
        self.by_instance: Dict[str, int] = {}
        self.grids: Dict[str, Tuple[int, ...]] = {}
        self.by_shape: Dict[str, int] = {}
        self.backward = 0
        self.backward_by_shape: Dict[str, int] = {}

    def launched(self, instance: Optional[str] = None,
                 grid: Optional[Tuple[int, ...]] = None,
                 shape: Optional[str] = None) -> None:
        log = getattr(_recording, "log", None)
        if log is not None:           # a capture: counted at each replay
            log.calls.append((self, instance, grid, shape))
            return
        with self._lock:
            self.launches += 1
            if instance is not None:
                self.by_instance[instance] = \
                    self.by_instance.get(instance, 0) + 1
                if grid is not None:
                    self.grids[instance] = grid
            if shape is not None:
                key = shape if instance is None else f"{instance} {shape}"
                self.by_shape[key] = self.by_shape.get(key, 0) + 1

    def add(self, launches: int, by_instance: Dict[str, int],
            grids: Dict[str, Tuple[int, ...]],
            by_shape: Dict[str, int]) -> None:
        """``launches`` launches at once, as ``launched`` would count them
        one by one (``grids``: each instance's last)."""
        with self._lock:
            self.launches += launches
            for k, n in by_instance.items():
                self.by_instance[k] = self.by_instance.get(k, 0) + n
            self.grids.update(grids)
            for k, n in by_shape.items():
                self.by_shape[k] = self.by_shape.get(k, 0) + n

    def plain(self, t: torch.Tensor) -> None:
        with self._lock:
            self.plain_calls += 1
            if t.is_cuda:
                self.plain_cuda_calls += 1

    def recomputed(self, shape: str) -> None:
        with self._lock:
            self.backward += 1
            self.backward_by_shape[shape] = \
                self.backward_by_shape.get(shape, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.launches = self.plain_calls = self.plain_cuda_calls = 0
            self.backward = 0
            self.by_instance = {}
            self.grids = {}
            self.by_shape = {}
            self.backward_by_shape = {}


class LaunchLog:
    """The ``Counts.launched`` calls one thread made inside ``recording()``,
    kept instead of counted. A CUDA graph's replay launches the kernels
    its capture enqueued without entering the wrappers' Python code, so
    ``replay`` counts the capture's launches once more at each replay:
    summed by wrapper at the first replay (the log is complete once the
    capture ends), one ``Counts.add`` a wrapper after that."""

    def __init__(self) -> None:
        self.calls: list = []
        self._sums: Optional[list] = None

    def replay(self) -> int:
        if getattr(_recording, "log", None) is not None:
            for counts, instance, grid, shape in self.calls:
                counts.launched(instance, grid, shape)   # into the capture
            return len(self.calls)
        if self._sums is None:
            sums: Dict[int, list] = {}
            for counts, instance, grid, shape in self.calls:
                acc = sums.setdefault(id(counts), [counts, 0, {}, {}, {}])
                acc[1] += 1
                if instance is not None:
                    acc[2][instance] = acc[2].get(instance, 0) + 1
                    if grid is not None:
                        acc[3][instance] = grid
                if shape is not None:
                    key = shape if instance is None else f"{instance} {shape}"
                    acc[4][key] = acc[4].get(key, 0) + 1
            self._sums = list(sums.values())
        for counts, *sums in self._sums:
            counts.add(*sums)
        return len(self.calls)


@contextlib.contextmanager
def recording():
    """Within the block, this thread's kernel launches go to the yielded
    ``LaunchLog`` rather than to the wrappers' counts (a CUDA graph's
    capture, whose kernels run only when it is replayed)."""
    log = LaunchLog()
    outer = getattr(_recording, "log", None)
    _recording.log = log
    try:
        yield log
    finally:
        _recording.log = outer


class GraphCounts:
    """The stage programs' CUDA graphs (``serving/stage_graph.py``):
    captures and their host seconds (each with its eager warm-up call),
    the graph pools they went into (one a lane), replays, and the kernel
    launches the replays added to the wrappers' counts."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def captured(self, seconds: float, pool=None) -> None:
        with self._lock:
            self.captures += 1
            self.capture_s += seconds
            if pool is not None:
                self.pools.add(tuple(pool))

    def pool_ids(self) -> list:
        """The graph pools captured into since the last ``reset``."""
        with self._lock:
            return list(self.pools)

    def replayed(self, launches: int) -> None:
        with self._lock:
            self.replays += 1
            self.replayed_launches += launches

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"captures": self.captures, "capture_s": self.capture_s,
                    "pools": len(self.pools), "replays": self.replays,
                    "replayed_launches": self.replayed_launches}

    def reset(self) -> None:
        with self._lock:
            self.captures = self.replays = self.replayed_launches = 0
            self.capture_s = 0.0
            self.pools: set = set()


stage_graphs = GraphCounts()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                           "that builds the port's kernels")
    return found


def build() -> Tuple[Path, str]:
    """Compile the kernels (if this digest is not built yet); returns the
    library's path and nvcc's output."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    so = BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}-{threading.get_ident()}"
    jobs = []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}-{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:          # wait for every nvcc before raising
        out, _ = proc.communicate()
        log.append(f"== {src}\n{out}")
        if proc.returncode:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"tmp-{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)               # atomic: concurrent builders agree
    return so, "\n".join(log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            so, build_log = build()
            handle = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.repro_error_string.argtypes = [ctypes.c_int]
            handle.repro_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        msg = lib().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def dtype_code(t: torch.Tensor, name: str) -> int:
    code = _DTYPES.get(t.dtype)
    if code is None:
        raise TypeError(f"{name}: kernel takes float32, bfloat16 or "
                        f"float64, got {t.dtype}")
    return code


def dtype_name(t: torch.Tensor) -> str:
    """``bfloat16``, ``float32``, ...: a dtype as a launch's shape key
    names it."""
    return str(t.dtype).replace("torch.", "")


def options_key(*, s_kv=None, full: bool = False, window: int = 0,
                softcap: float = 0.0) -> str:
    """The part of an attention launch's shape key that names what it
    masks and caps: `` Skv{n}`` where the keys' length differs from the
    queries' (``s_kv`` is the pair (keys, queries)), `` full`` for a
    non-causal launch, `` window`` and `` softcap`` where set; empty for
    the plain causal launch."""
    key = ""
    if s_kv is not None and s_kv[0] != s_kv[1]:
        key += f" Skv{s_kv[0]}"
    if full:
        key += " full"
    if window > 0:
        key += " window"
    if softcap > 0.0:
        key += " softcap"
    return key


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or f64 where it already is: the plain versions compute
    "in f32" for bf16 and f32 inputs and keep f64 (``gradcheck``) in f64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on these inputs: grad mode is on and
    one of them requires grad (None entries are skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


@contextlib.contextmanager
def recompute(name: str, counts: "Counts", shape: str):
    """The frame of a Function's backward that recomputes through the plain
    version: grad mode on, one ``counts.backward`` at ``shape``, and a
    profiler range ``{name}_backward_recompute``."""
    counts.recomputed(shape)
    with torch.enable_grad(), torch.profiler.record_function(
            f"{name}_backward_recompute"):
        yield


def plain_grads(plain, inputs, grad_outputs) -> tuple:
    """``plain(*inputs)`` under autograd from detached copies of ``inputs``,
    differentiated against ``grad_outputs`` (one per output; None for an
    output with no gradient). Returns one gradient per input: None for an
    input that is None or not floating point."""
    live = [None if t is None else t.detach().requires_grad_(
        t.is_floating_point()) for t in inputs]
    out = plain(*live)
    outs = out if isinstance(out, tuple) else (out,)
    pairs = [(o, g) for o, g in zip(outs, grad_outputs)
             if g is not None and o.requires_grad]
    wrt = [t for t in live if t is not None and t.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                   [g for _, g in pairs], allow_unused=True))
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in live)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernel path takes CUDA tensors on the current device only."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    cur = torch.cuda.current_device()
    for t in tensors:
        if t.device != dev or (dev.index is not None and dev.index != cur):
            raise ValueError(f"{name}: tensors must lie on the current CUDA "
                             f"device cuda:{cur}, got {t.device}")


def stream_handle(device: torch.device) -> int:
    """The current stream, read at call time: each lane runs under its own
    stream, so a handle cached earlier would serialize the lanes."""
    return torch.cuda.current_stream(device).cuda_stream


def strides(*ts_dims) -> ctypes.Array:
    """Pack (tensor, dims) pairs' element strides for a C entry."""
    vals = [t.stride(d) for t, dims in ts_dims for d in dims]
    return (ctypes.c_longlong * len(vals))(*vals)


# ---------------------------------------------------------------------------
# Operators: each wrapper's call is one ``repro_torch::<name>`` operator
# whose CPU kernel is the plain version and whose CUDA kernel launches the
# Hopper kernel; its fake kernel gives the output shapes (fake and meta
# tensors, the dry-run) and its FLOP formula what the kernel multiplies, so
# ``FlopCounterMode`` counts the same number on the card and on fake tensors.
# ---------------------------------------------------------------------------
def define_op(name: str, schema: str, cpu, cuda, fake, flops):
    """Define (once) and return the operator ``repro_torch::name``."""
    qual = f"repro_torch::{name}"
    try:
        return getattr(torch.ops.repro_torch, name).default
    except (AttributeError, RuntimeError):
        pass
    torch.library.define(qual, schema[schema.index("("):])
    torch.library.impl(qual, "cpu", cpu)
    torch.library.impl(qual, "cuda", cuda)
    torch.library.register_fake(qual, fake)
    op = getattr(torch.ops.repro_torch, name)
    from torch.utils.flop_counter import register_flop_formula
    register_flop_formula(op)(flops)
    return op.default
