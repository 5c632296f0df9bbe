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
an executable. A lane lives as long as a program keeps state on it. A call
is resolved first (``prepare``: its signature, its lane's static entry,
on the card the tensors its outputs land in), then issues three steps
under its lane's lock, so that no other call on the lane (another
program's, or a watchdog's ghost worker beside a new launch) comes between
them (``StageCall.issue``):

1. copy the arguments into the lane's static inputs of their signature
   (outside the pool: a job's input never lands in a graph's scratch);
2. run: on the card replay the CUDA graph on the current stream, on the
   CPU call ``fn`` on the static inputs;
3. copy the outputs into tensors the caller owns. The next call on the
   lane overwrites the static outputs, and a stage may hand an input
   through unchanged, so no job's state may alias them.

and then gives its output (``StageCall.result``: the replay's launches
counted, the output's tree built). On the card the three steps are in the
graph itself, between a start and an end event node
(``kernels/csrc/stage_burst.cu``): a call points the copy nodes at its
tensors and the event nodes at the events its caller hands it, and
launches the graph, one burst of driver calls, so the events bracket the
device's work and no host time. An argument laid out otherwise than its
static input (the same shape, other strides) is first copied by PyTorch
into one laid out alike; an output that is not one dense block (which a
copy node cannot read) is made contiguous inside the graph before its
copy, as ``clone`` would return it; an empty tensor takes no node.

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

import ctypes
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


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill ``t.nbytes`` bytes from its
    ``data_ptr()`` without gap or overlap, its dimensions in any order."""
    expect = 1
    for stride, size in sorted((st, sz) for sz, st in zip(t.shape, t.stride())
                               if sz > 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _no_step(name: str, wall=None) -> None:
    pass


class _Eager:
    """The CPU's run: ``fn`` called on the static arguments; returns its
    output flattened. Its kernels count themselves as they run."""

    burst = None

    def __init__(self, fn: Callable, args: tuple, lane: Lane,
                 inputs: list) -> None:
        self.fn, self.args = fn, args

    def run(self):
        return tree_flatten(self.fn(*self.args))

    def counted(self) -> None:
        pass


class _Graph:
    """``fn`` on the static ``inputs`` (``args``, flat), captured into a
    CUDA graph in the lane's pool after one eager warm-up call (both on a
    side stream that waits for the current one), with the call's copies
    and its events around it (``burst``, the module docstring); its static
    outputs are flattened once at the capture (``flat``)."""

    def __init__(self, fn: Callable, args: tuple, lane: Lane,
                 inputs: list) -> None:
        self.lane, self.pool, self.inputs = lane, None, inputs
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
            warm = tree_flatten(fn(*args))[0]   # counted as launched
        cur.wait_stream(self.side)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.pool = self.lane.graph_pool()
        # the copies' other ends for the capture (each call points the
        # nodes at its own tensors; an output's is laid out as ``clone``
        # lays it out), and the events its own calls take
        ends = ([torch.empty_like(t) for t in self.inputs],
                [torch.empty_like(t) for t in warm])
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for ev in events:
            ev.record()                         # makes it
        with _lib.recording() as self.log, torch.cuda.graph(
                self.graph, pool=self.pool, stream=self.side,
                capture_error_mode="thread_local"):
            side = self.side.cuda_stream
            nodes = [_capture_event(side, events[0]), None]
            nodes += [_capture_copy(side, s, t)
                      for s, t in zip(self.inputs, ends[0]) if s.nbytes]
            leaves, spec = tree_flatten(fn(*args))
            leaves = [o if _dense(o) else o.contiguous() for o in leaves]
            nodes += [_capture_copy(side, t, o)
                      for o, t in zip(leaves, ends[1]) if o.nbytes]
            nodes[1] = _capture_event(side, events[1])
        self.graph.instantiate()
        self.burst = _Burst(self.graph, nodes, events, self.inputs, leaves)
        return tree_unflatten(leaves, spec)

    def counted(self) -> None:
        """A replay's kernel launches, counted once it is enqueued."""
        _lib.stage_graphs.replayed(self.log.replay())


def _capture_event(stream: int, event) -> int:
    node = ctypes.c_void_p()
    _lib.check(_lib.lib().repro_stage_capture_event(
        stream, event.cuda_event, ctypes.byref(node)),
        "repro_stage_capture_event")
    return node.value


def _capture_copy(stream: int, dst: torch.Tensor, src: torch.Tensor) -> int:
    node = ctypes.c_void_p()
    _lib.check(_lib.lib().repro_stage_capture_copy(
        stream, dst.data_ptr(), src.data_ptr(), dst.nbytes,
        ctypes.byref(node)), "repro_stage_capture_copy")
    return node.value


class _Burst:
    """On the card: a call of a graph that holds its copies and events,
    as one C call (``repro_stage_launch``) on the lane's stream: the event
    nodes set to the call's events, the copy nodes to its tensors (an
    empty one has none), then the launch; each step stamped on the host's
    wall clock (``STEPS``)."""

    STEPS = ("nodes", "launch")

    def __init__(self, graph, nodes: list, events: list, inputs: list,
                 outs: list) -> None:
        self.run = _lib.lib().repro_stage_launch
        self.exec = graph.raw_cuda_graph_exec()
        self.events = events                  # a call handed none takes these
        self.nodes = (ctypes.c_void_p * len(nodes))(*nodes)
        self.outs = outs
        self.strides = [s.stride() for s in inputs]
        self.copied = ([i for i, s in enumerate(inputs) if s.nbytes],
                       [i for i, o in enumerate(self.outs) if o.nbytes])
        ins = [inputs[i] for i in self.copied[0]]
        outs = [self.outs[i] for i in self.copied[1]]
        self.fixed = ([s.data_ptr() for s in ins],
                      [o.data_ptr() for o in outs])
        sizes = [t.nbytes for t in (*ins, *outs)]
        self.bytes = (ctypes.c_longlong * len(sizes))(*sizes)
        self.n_in, self.n_out = len(ins), len(outs)
        self.ptrs = ctypes.c_void_p * (2 * len(sizes))
        # the launch's stamps: one call at a time a lane, under its lock
        self.stamps = (ctypes.c_double * len(self.STEPS))()

    def args(self, flat: list, inputs: list):
        """One call's pointers, the tensors its outputs land in (made here
        on the current stream) and its arguments, of which one whose
        strides differ from its static input's is first copied by PyTorch
        into one laid out alike (held by the call)."""
        held = flat
        if any(t.stride() != s for t, s in zip(flat, self.strides)):
            held = [t if t.stride() == s.stride() else torch.empty_strided(
                s.shape, s.stride(), dtype=s.dtype, device=s.device).copy_(t)
                for t, s in zip(flat, inputs)]
        outs = [torch.empty_like(o) for o in self.outs]
        (c_in, c_out), (dst_in, src_out) = self.copied, self.fixed
        return self.ptrs(*[held[i].data_ptr() for i in c_in], *dst_in,
                         *src_out, *[outs[i].data_ptr() for i in c_out]), \
            outs, held

    def issue(self, stream: int, ptrs, before, after, step) -> None:
        before, after = (before, after) if before is not None \
            else self.events
        stamps = self.stamps
        err = self.run(stream, self.exec, self.nodes, self.n_in, self.n_out,
                       before.cuda_event, after.cuda_event, ptrs,
                       self.bytes, stamps)
        for name, wall in zip(self.STEPS, stamps):
            step(name, wall)
        _lib.check(err, "repro_stage_launch")


class _Static:
    """One program's static inputs on one lane (the lane's, shared with
    its programs of that signature), and its run there; it keeps the lane,
    which the registry holds only weakly."""

    def __init__(self, lane: Lane, inputs: list, runner) -> None:
        self.lane, self.inputs, self.runner = lane, inputs, runner


class StageCall:
    """One call of a stage program, resolved (``StageProgram.prepare``):
    its static entry, its arguments flattened, on the card its burst's
    pointers, output tensors and held inputs, and ``then``, applied to its
    output."""

    __slots__ = ("static", "flat", "burst", "outs", "spec", "then")

    def __init__(self, static: _Static, flat: list, then) -> None:
        self.static, self.flat, self.then = static, flat, then
        burst = static.runner.burst
        self.burst = self.outs = self.spec = None
        if burst is not None:
            self.burst, self.outs, self.flat = burst.args(flat, static.inputs)
            self.spec = static.runner.flat[1]

    def issue(self, before=None, after=None, step=_no_step) -> None:
        """Under the lane's lock: ``before`` recorded on the current
        stream, the copies in, the run, the copies out, ``after``
        recorded; ``step(name, wall)`` after each. On the card that is
        the burst's launch (``step`` given the ``perf_counter`` readings
        it took: ``_Burst.STEPS``), on the CPU PyTorch's calls."""
        st = self.static
        runner = st.runner
        with st.lane.lock:
            if self.burst is not None:
                runner.burst.issue(st.lane.key[1], self.burst, before, after,
                                   step)
                return
            if before is not None:
                before.record()
                step("start")
            for s, t in zip(st.inputs, self.flat):
                s.copy_(t)
            step("copy_in")
            out, self.spec = runner.run()
            step("replay")
            self.outs = [t.clone() for t in out]
            step("copy_out")
            if after is not None:
                after.record()
                step("end")

    def result(self):
        """The issued call's output (its launches counted)."""
        self.static.runner.counted()
        out = (self.outs[0] if self.spec.is_leaf()
               else tree_unflatten(self.outs, self.spec))
        return out if self.then is None else self.then(out)


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
        """The current stream on the card (its device index and handle),
        the calling thread on the CPU."""
        if device.type == "cuda":
            return (device.index or 0,
                    torch.cuda.current_stream(device).cuda_stream)
        return threading.get_ident()

    def prepare(self, *args, then: Callable = None,
                lane=None) -> StageCall:
        """The call on ``args`` resolved on the current lane, or on
        ``lane`` where the caller knows it is current (the lane's static
        entry made, and on the card its graph captured, at the lane's
        first call of this signature); ``then`` is applied to its
        output."""
        flat = []
        sig = _signature(args, flat)
        if not flat or not all(isinstance(t, torch.Tensor) for t in flat):
            raise TypeError(f"stage program {self.name!r} takes tensors "
                            f"only, got {[type(t).__name__ for t in flat]}")
        dev = flat[0].device
        key = (self._lane_of(dev) if lane is None else lane, sig)
        st = self._lanes.get(key)
        if st is None:
            st = self._static(key, args, flat, dev)
        return StageCall(st, flat, then)

    def _static(self, key, args: tuple, flat: list, dev) -> _Static:
        """The lane's static entry of ``key``, made at its first call."""
        ln = lane(key[0])
        with ln.lock:
            with self._lock:
                st = self._lanes.get(key)
            if st is not None:
                return st
            leaves, spec = tree_flatten(args)
            if len(leaves) != len(flat) or any(
                    a is not b for a, b in zip(leaves, flat)):
                raise TypeError(f"stage program {self.name!r}: its "
                                f"arguments flatten in another order "
                                f"than tree_flatten's")
            inputs = ln.static_inputs(key[1], flat)
            for s, t in zip(inputs, flat):
                s.copy_(t)
            st = _Static(ln, inputs, self._runner(dev)(
                self.fn, tree_unflatten(list(inputs), spec), ln, inputs))
            with self._lock:
                self._lanes[key] = st
            return st

    def __call__(self, *args):
        call = self.prepare(*args)
        call.issue()
        return call.result()
