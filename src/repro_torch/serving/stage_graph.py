"""The compiled stage: the port's counterpart of the reference's
``jax.jit`` over each stage payload (src/repro/serving/engine.py:44, :92).

A ``StageProgram`` wraps a stage function of tensors, ``fn(*args) -> a
tree of tensors`` (dicts, lists and tuples). Its static buffers are kept a
(lane, argument signature): on the card the lane is the current stream,
which ``RealtimeBackend`` sets to the lane's own; on the CPU the calling
thread. One graph a stream: a graph launched on two streams serializes
with itself, and the lanes would lose their spatial concurrency.

The lanes are the process's (``lane``): each holds one lock, the static
inputs a signature, and on the card one CUDA-graph memory pool, all of
which every program that runs on that lane shares, as XLA plans one arena
an executable. A lane lives as long as a program keeps state on it. Every
call takes three steps under its lane's lock, so that no other call on
the lane (another program's, or a watchdog's ghost worker beside a new
launch) comes between them:

1. copy the arguments into the lane's static inputs of their signature
   (outside the pool: a job's input never lands in a graph's scratch);
2. run: on the card replay the CUDA graph on the current stream, on the
   CPU call ``fn`` on the static inputs;
3. copy the outputs into tensors the caller owns. The next call on the
   lane overwrites the static outputs, and a stage may hand an input
   through unchanged, so no job's state may alias them.

A graph captured after another into the lane's pool may keep its outputs
in what was the other's scratch, and the programs of one signature read
and write the same static inputs; the lock a lane, not a program, keeps
another's copy in and replay from being enqueued between this one's copy
in, replay and copy out. ``fn`` may write its static inputs in place (a
staged LM's cache slice, ``make_lm_stage_fns(..., in_place=True)``): they
are copied in anew at every call. ``functional`` is the stage function
``fn`` computes without writing its arguments, the one it is held to.

On the card the first call on a stream runs ``fn`` once eagerly on a side
stream (cuDNN's plans, the kernels' shared-memory attributes, the
allocator's blocks) and then captures it there into a graph in the lane's
pool; the capture records the kernel launches it enqueued
(``kernels._lib.recording``) and each replay counts them again
(``kernels._lib.stage_graphs``: captures, pools, replays, replayed
launches). A capture or replay that fails raises: there is no eager path
on the card. The CPU is asked for explicitly (``device="cpu"``), so its
eager call is not a fallback.
"""
from __future__ import annotations

import gc
import threading
import time
import weakref
from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..kernels import _lib

__all__ = ["Lane", "StageProgram", "lane", "pool_reserved_bytes"]

# one capture at a time in the process: a lane made after the run started
# captures while the others replay, and ``torch.cuda.graph`` empties the
# allocator's cache as it begins
_capture_lock = threading.Lock()


class _Inputs(list):
    """A lane's static inputs of one argument signature (a list the lane
    keeps weakly: they go with the last program that holds them)."""


class Lane:
    """One lane of the process: the lock every stage program takes for a
    call on it, the static inputs a signature its programs share, and on
    the card the graph pool their captures share and the side stream they
    are captured on (both made at the lane's first capture)."""

    def __init__(self, key) -> None:
        self.key = key
        self.lock = threading.Lock()
        self.pool = self.side = None
        self.inputs = weakref.WeakValueDictionary()   # signature -> _Inputs

    def graph_pool(self):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def side_stream(self, device):
        """From PyTorch's high-priority pool: the lanes' streams come from
        the other pool, and a capture on a stream a running lane shares
        would take in that lane's launches (a graph launched from it takes
        the priority of the stream it is launched into). One a lane, not
        one a capture: cuBLAS keeps a workspace for every (thread, stream)
        it ran on, 32 MiB each on the card."""
        if self.side is None:
            self.side = torch.cuda.Stream(device, priority=-1)
        return self.side

    def static_inputs(self, sig, like: list) -> _Inputs:
        """The static inputs of ``sig``, made like ``like`` at its first
        call on this lane."""
        inputs = self.inputs.get(sig)
        if inputs is None:
            inputs = _Inputs(torch.empty_like(t) for t in like)
            self.inputs[sig] = inputs
        return inputs


# weakly: a lane (its pool id among them) goes when no program keeps state
# on it, so a stream handle PyTorch hands out again starts a fresh pool
_lanes = weakref.WeakValueDictionary()
_lanes_lock = threading.Lock()


def lane(key) -> Lane:
    """The process's lane of ``key`` (a stream's ``cuda_stream`` with its
    device, or a thread's ident), made at its first use."""
    with _lanes_lock:
        ln = _lanes.get(key)
        if ln is None:
            ln = _lanes[key] = Lane(key)
        return ln


def pool_reserved_bytes(pools) -> int:
    """Card memory the allocator holds in the graph pools ``pools`` (its
    segments by pool id in ``torch.cuda.memory_snapshot()``)."""
    ids = {tuple(p) for p in pools}
    if not ids:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in ids)


def _signature(tree, leaves: list):
    """Append ``tree``'s leaves to ``leaves`` in ``tree_flatten``'s order
    (dicts in insertion order, None a node with none) and return a
    hashable key of its structure and of each tensor's shape, dtype and
    device, built without string work."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return tree.shape, tree.dtype, tree.device
    if isinstance(tree, dict):
        return dict, tuple(tree), tuple(_signature(v, leaves)
                                        for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return type(tree), tuple(_signature(v, leaves) for v in tree)
    if tree is not None:
        leaves.append(tree)
    return type(tree)


class _Eager:
    """The CPU's run: ``fn`` called on the static arguments; returns its
    output flattened."""

    def __init__(self, fn: Callable, args: tuple, lane: Lane) -> None:
        self.fn, self.args = fn, args

    def run(self):
        return tree_flatten(self.fn(*self.args))


class _Graph:
    """``fn`` on the static arguments, captured into a CUDA graph in the
    lane's pool after one eager warm-up call (both on a side stream that
    waits for the current one); ``run`` replays it on the current stream
    and returns its static outputs, flattened once at the capture."""

    def __init__(self, fn: Callable, args: tuple, lane: Lane) -> None:
        self.lane, self.pool = lane, None
        t0 = time.perf_counter()
        # no collection while capturing: a dead graph in cyclic garbage
        # (an earlier server's) destroyed on the capturing thread would
        # make a CUDA call the capture forbids, and invalidate it
        with _capture_lock:
            collecting = gc.isenabled()
            gc.disable()
            try:
                self.out = self._capture(fn, args)
            finally:
                if collecting:
                    gc.enable()
        self.flat = tree_flatten(self.out)
        _lib.stage_graphs.captured(time.perf_counter() - t0, self.pool)

    def _capture(self, fn: Callable, args: tuple):
        cur = torch.cuda.current_stream()
        self.side = self.lane.side_stream(cur.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            fn(*args)                           # warm-up, counted as launched
        cur.wait_stream(self.side)
        self.graph = torch.cuda.CUDAGraph()
        self.pool = self.lane.graph_pool()
        with _lib.recording() as self.log, torch.cuda.graph(
                self.graph, pool=self.pool, stream=self.side,
                capture_error_mode="thread_local"):
            return fn(*args)

    def _replay(self) -> None:
        self.graph.replay()

    def run(self):
        self._replay()
        _lib.stage_graphs.replayed(self.log.replay())
        return self.flat


class _Static:
    """One program's static inputs on one lane (the lane's, shared with
    its programs of that signature), and its run there; it keeps the lane,
    which the registry holds only weakly."""

    def __init__(self, lane: Lane, inputs: list, runner) -> None:
        self.lane, self.inputs, self.runner = lane, inputs, runner


class StageProgram:
    """``fn`` compiled a lane: see the module docstring. ``fn`` takes and
    returns tensors only (in dicts, lists and tuples); it must read
    nothing that changes between calls besides its arguments (parameters
    and other constants are captured), and may write those in place.
    ``functional`` (default ``fn``): the same stage without writes to its
    arguments, what the program computes."""

    def __init__(self, fn: Callable, name: str = "",
                 functional: Callable = None) -> None:
        self.fn = fn
        self.functional = fn if functional is None else functional
        self.name = name
        self._lock = threading.Lock()
        self._lanes: dict = {}      # (lane, signature) -> _Static

    def _runner(self, device: torch.device):
        return _Graph if device.type == "cuda" else _Eager

    def _lane_of(self, device: torch.device):
        """The current stream on the card, the calling thread on the CPU."""
        if device.type == "cuda":
            return (device.index,
                    torch.cuda.current_stream(device).cuda_stream)
        return threading.get_ident()

    def __call__(self, *args):
        flat = []
        sig = _signature(args, flat)
        if not flat or not all(isinstance(t, torch.Tensor) for t in flat):
            raise TypeError(f"stage program {self.name!r} takes tensors "
                            f"only, got {[type(t).__name__ for t in flat]}")
        dev = flat[0].device
        ln = lane(self._lane_of(dev))
        key = (ln.key, sig)
        with ln.lock:
            with self._lock:
                st = self._lanes.get(key)
            if st is None:
                leaves, spec = tree_flatten(args)
                if len(leaves) != len(flat) or any(
                        a is not b for a, b in zip(leaves, flat)):
                    raise TypeError(f"stage program {self.name!r}: its "
                                    f"arguments flatten in another order "
                                    f"than tree_flatten's")
                inputs = ln.static_inputs(sig, flat)
                for s, t in zip(inputs, flat):
                    s.copy_(t)
                st = _Static(ln, inputs, self._runner(dev)(
                    self.fn, tree_unflatten(list(inputs), spec), ln))
                with self._lock:
                    self._lanes[key] = st
            # again after a capture, whose warm-up call may write its inputs
            for s, t in zip(st.inputs, flat):
                s.copy_(t)
            out, out_spec = st.runner.run()
            return tree_unflatten([t.clone() for t in out], out_spec)
