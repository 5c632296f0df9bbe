"""The compiled stage: the port's counterpart of the reference's
``jax.jit`` over each stage payload (src/repro/serving/engine.py:44, :92).

A ``StageProgram`` wraps a stage function of tensors, ``fn(*args) -> a
tree of tensors`` (dicts, lists and tuples). Its static buffers are kept a
(lane, argument signature): on the card the lane is the current stream,
which ``RealtimeBackend`` sets to the lane's own; on the CPU the calling
thread. One graph a stream: a graph launched on two streams serializes
with itself, and the lanes would lose their spatial concurrency.

Every call takes three steps under that lane's lock, so that two threads
on one stream (a watchdog's ghost worker beside a new launch) never
interleave them:

1. copy the arguments into the static inputs;
2. run: on the card replay the CUDA graph on the current stream, on the
   CPU call ``fn`` on the static inputs;
3. copy the outputs into tensors the caller owns. The next call on the
   lane overwrites the static outputs, and a stage may hand an input
   through unchanged, so no job's state may alias them.

On the card the first call on a stream runs ``fn`` once eagerly on a side
stream (cuDNN's plans, the kernels' shared-memory attributes, the
allocator's blocks) and then captures it there into a graph with a
private memory pool; the capture records the kernel launches it enqueued
(``kernels._lib.recording``) and each replay counts them again
(``kernels._lib.stage_graphs``: captures, replays, replayed launches). A
capture or replay that fails raises: there is no eager path on the card.
The CPU is asked for explicitly (``device="cpu"``), so its eager call is
not a fallback.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..kernels import _lib

__all__ = ["StageProgram"]

# one capture at a time in the process: a lane made after the run started
# captures while the others replay, and ``torch.cuda.graph`` empties the
# allocator's cache as it begins
_capture_lock = threading.Lock()


class _Eager:
    """The CPU's run: ``fn`` called on the static arguments."""

    def __init__(self, fn: Callable, args: tuple) -> None:
        self.fn, self.args = fn, args

    def run(self):
        return self.fn(*self.args)


class _Graph:
    """``fn`` on the static arguments, captured into a CUDA graph after one
    eager warm-up call (both on a side stream that waits for the current
    one); ``run`` replays it on the current stream and returns its static
    outputs."""

    def __init__(self, fn: Callable, args: tuple) -> None:
        t0 = time.perf_counter()
        with _capture_lock:
            self.out = self._capture(fn, args)
        _lib.stage_graphs.captured(time.perf_counter() - t0)

    def _capture(self, fn: Callable, args: tuple):
        cur = torch.cuda.current_stream()
        # from PyTorch's high-priority pool: the lanes' streams come from
        # the other pool, and a capture on a stream a running lane shares
        # would take in that lane's launches (a graph launched from it
        # takes the priority of the stream it is launched into)
        self.side = torch.cuda.Stream(cur.device, priority=-1)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            fn(*args)                           # warm-up, counted as launched
        cur.wait_stream(self.side)
        self.graph = torch.cuda.CUDAGraph()
        with _lib.recording() as self.log, torch.cuda.graph(
                self.graph, stream=self.side,
                capture_error_mode="thread_local"):
            return fn(*args)

    def _replay(self) -> None:
        self.graph.replay()

    def run(self):
        self._replay()
        _lib.stage_graphs.replayed(self.log.replay())
        return self.out


class _Lane:
    """One lane's static inputs, its run, and the lock that makes a call's
    copy in, run and copy out one step."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.inputs = None
        self.runner = None


class StageProgram:
    """``fn`` compiled a lane: see the module docstring. ``fn`` takes and
    returns tensors only (in dicts, lists and tuples); it must read
    nothing that changes between calls besides its arguments (parameters
    and other constants are captured)."""

    def __init__(self, fn: Callable, name: str = "") -> None:
        self.fn = fn
        self.name = name
        self._lock = threading.Lock()
        self._lanes: dict = {}

    def _runner(self, device: torch.device):
        return _Graph if device.type == "cuda" else _Eager

    def _lane_of(self, device: torch.device):
        """The current stream on the card, the calling thread on the CPU."""
        if device.type == "cuda":
            return torch.cuda.current_stream(device).cuda_stream
        return threading.get_ident()

    def __call__(self, *args):
        flat, spec = tree_flatten(args)
        if not flat or not all(isinstance(t, torch.Tensor) for t in flat):
            raise TypeError(f"stage program {self.name!r} takes tensors "
                            f"only, got {[type(t).__name__ for t in flat]}")
        dev = flat[0].device
        key = (self._lane_of(dev), str(spec),
               tuple((tuple(t.shape), t.dtype, t.device) for t in flat))
        with self._lock:
            st = self._lanes.get(key)
            if st is None:
                st = self._lanes[key] = _Lane()
        with st.lock:
            if st.runner is None:
                st.inputs = [torch.empty_like(t) for t in flat]
                for s, t in zip(st.inputs, flat):
                    s.copy_(t)
                st.runner = self._runner(dev)(
                    self.fn, tree_unflatten(st.inputs, spec))
            # again after a capture, whose warm-up call may write its inputs
            for s, t in zip(st.inputs, flat):
                s.copy_(t)
            out, out_spec = tree_flatten(st.runner.run())
            return tree_unflatten([t.clone() for t in out], out_spec)
