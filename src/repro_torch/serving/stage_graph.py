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
is resolved first, in two steps (``prepare`` takes both in turn). The
first needs no lane (``ready`` -> ``ReadyCall``): its signature, which is
its one check of its arguments, the structure and each tensor's shape,
dtype, device and strides, and on the card its output block, laid out as
every lane's entry of that signature lays it out (``_Layout``, the first
entry's). The second is the lane's (``ReadyCall.call`` -> ``StageCall``):
its lane's static entry of that signature, and a copy laid out alike of
each argument its static input is laid out otherwise than (enqueued on
the launch's stream, which must order it before the graph). With a
block, a ready call's output is known before it runs (``output``: views
of the block), so a realtime backend makes a job's calls ready as one
chain before its first stage runs, each on the output the one before
will give, under the stream of the lane it runs then, and launches each
on whatever lane its dispatch picks: the caching allocator hands a block
made under one stream out again only under that stream, and the backend
frees no block until every stage that wrote or read it has been seen
done, so the block needs no record of the stream that writes it. The
call then issues three steps
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
device's work and no host time. A non-dense argument, whose static input
is dense, is first copied by PyTorch into one laid out alike; an output
that is not one dense block (which a copy node cannot read) is made
contiguous inside the graph before its copy, as ``clone`` would return
it; an empty tensor takes no node. What repeats from call to call is laid
out once an entry (``_Burst``): the static ends of the copies, where
each output lands in the call's one output block (its outputs are views
of it, which the job's state holds), the output's tree, and what each
node of the executable graph holds, so that a call sets only the nodes
whose event or pointer moved. An argument that the calls share unchanged
(an LM stage's donor cache slice) is wrapped once in a ``Constant``,
which the signature takes by its identity: a call walks none of it.

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

__all__ = ["Constant", "Lane", "ReadyCall", "StageProgram", "lane",
           "pool_reserved_bytes"]

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


class Constant:
    """A tree of tensors that a program's calls take unchanged (an LM
    stage's donor cache slice), resolved once: its leaves flattened and
    checked against the static inputs at its first call on a lane, and
    keyed by its identity, so that no call walks it again. Its tensors
    keep their storage and layout while it lives; their values may
    change (each call copies them in anew)."""

    __slots__ = ("tree", "leaves")

    def __init__(self, tree) -> None:
        self.tree = tree
        self.leaves = tree_flatten(tree)[0]


def _signature(tree, leaves: list):
    """Append ``tree``'s leaves to ``leaves`` in ``tree_flatten``'s order
    (dicts in insertion order, None a node with none; a ``Constant``'s
    as its tree's) and return a hashable key of its structure and of each
    tensor's shape, dtype, device and strides (a ``Constant`` by its
    identity), built without string work."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return tree.shape, tree.dtype, tree.device, tree.stride()
    if type(tree) is Constant:
        leaves += tree.leaves
        return tree
    if isinstance(tree, dict):
        return dict, tuple(tree), tuple(_signature(v, leaves)
                                        for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return type(tree), tuple(_signature(v, leaves) for v in tree)
    if tree is not None:
        leaves.append(tree)
    return type(tree)


def _expand(tree):
    """``tree`` with each ``Constant`` replaced by its tree."""
    if type(tree) is Constant:
        return tree.tree
    if isinstance(tree, dict):
        return {k: _expand(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_expand(v) for v in tree)
    return tree


class _Leaf:
    """A leaf's place in a tree's skeleton (``_builder``)."""


def _builder(tree):
    """A function of an iterator over the leaves of trees shaped as
    ``tree`` (its leaves ``_Leaf``s, in ``tree_flatten``'s order) that
    returns such a tree: ``tree_unflatten`` made once a structure,
    without its checks."""
    if isinstance(tree, _Leaf):
        return next
    if tree is None:
        return lambda it: None
    if type(tree) in (tuple, list, dict):
        kids = [_builder(v) for v in (tree.values() if type(tree) is dict
                                      else tree)]
        if type(tree) is tuple:
            return lambda it: tuple([k(it) for k in kids])
        if type(tree) is list:
            return lambda it: [k(it) for k in kids]
        keys = list(tree)
        return lambda it: {key: k(it) for key, k in zip(keys, kids)}
    leaves, spec = tree_flatten(tree)
    n = len(leaves)
    return lambda it: tree_unflatten([next(it) for _ in range(n)], spec)


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
        self.burst = _Burst(_lib.lib().repro_stage_launch,
                            self.graph.raw_cuda_graph_exec(), nodes, events,
                            self.inputs, leaves, spec, ends)
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


class _Layout:
    """Where a call's outputs land in its one output block (256-byte
    aligned, in the static outputs' layouts; a single output is a tensor
    laid out as its static one) and how its output tree is built from the
    block. Every lane's entry of a signature lays its outputs out alike
    (one stage function captured on inputs laid out alike), and shares
    one ``_Layout`` where they do (``StageProgram._layouts``), so that a
    call made ready before its lane is known makes its block. It holds no
    tensor: a program's graphs may be dropped while it lives."""

    __slots__ = ("single", "total", "offsets", "device", "recipe", "dtypes",
                 "build", "key")

    def __init__(self, outs: list, spec) -> None:
        self.single = spec.is_leaf()
        self.offsets, self.total = [], 0
        for o in outs:
            self.offsets.append(self.total)
            self.total += -(-o.nbytes // 256) * 256
        self.device = outs[0].device if outs else None
        self.recipe = [(o.dtype, o.shape, o.stride(), off // o.itemsize)
                       for o, off in zip(outs, self.offsets)]
        self.dtypes = list(dict.fromkeys(o.dtype for o in outs))
        self.build = _builder(tree_unflatten(
            [_Leaf() for _ in outs], spec))
        self.key = (self.single, self.total, self.device,
                    tuple(self.recipe), spec)

    def block(self) -> torch.Tensor:
        """One call's output block, made on the current stream."""
        if self.single:
            dtype, shape, stride, _ = self.recipe[0]
            return torch.empty_strided(shape, stride, dtype=dtype,
                                       device=self.device)
        return torch.empty(self.total, dtype=torch.uint8, device=self.device)

    def outputs(self, block: torch.Tensor):
        """The call's output tree: views of its block."""
        if self.single:
            return block
        by = {dt: block.view(dt) for dt in self.dtypes}
        return self.build(iter([
            torch.as_strided(by[dt], shape, stride, at)
            for dt, shape, stride, at in self.recipe]))


class _Burst:
    """On the card: a call of a graph that holds its copies and events,
    as one C call (``repro_stage_launch``) on the lane's stream. What does
    not change from call to call is laid out once: the static inputs'
    and outputs' pointers, the copies' sizes, the call's output block
    (``layout``), and what each node of the executable graph holds now
    (``last``: the C call sets only the nodes whose event or pointer
    moved). A call writes its inputs' pointers and hands over its block;
    each step is stamped on the host's wall clock (``STEPS``)."""

    STEPS = ("nodes", "launch")

    def __init__(self, launch, graph_exec, nodes: list, events: list,
                 inputs: list, outs: list, spec, ends: tuple) -> None:
        self.run, self.exec = launch, graph_exec
        self.events = events                  # a call handed none takes these
        self.nodes = (ctypes.c_void_p * len(nodes))(*nodes)
        self.copied = [i for i, s in enumerate(inputs) if s.nbytes]
        c_out = [i for i, o in enumerate(outs) if o.nbytes]
        self.n_in, self.n_out = len(self.copied), len(c_out)

        def array(kind, vals):
            return (kind * max(len(vals), 1))(*vals)
        self.src = array(ctypes.c_void_p, [0] * self.n_in)
        self.dst = array(ctypes.c_void_p,
                         [inputs[i].data_ptr() for i in self.copied])
        self.src_out = array(ctypes.c_void_p,
                             [outs[i].data_ptr() for i in c_out])
        self.bytes = array(ctypes.c_longlong,
                           [inputs[i].nbytes for i in self.copied]
                           + [outs[i].nbytes for i in c_out])
        # the nodes' values from the capture (its events, and the other
        # ends of its copies)
        self.last = array(ctypes.c_void_p, [
            e.cuda_event for e in events]
            + [ends[0][i].data_ptr() for i in self.copied]
            + [ends[1][i].data_ptr() for i in c_out])
        self.layout = _Layout(outs, spec)
        self.out_off = array(ctypes.c_longlong, [0] if self.layout.single
                             else [self.layout.offsets[i] for i in c_out])
        # the launch's stamps: one call at a time a lane, under its lock
        self.stamps = (ctypes.c_double * len(self.STEPS))()

    def issue(self, stream: int, flat: list, block: torch.Tensor,
              before, after, step) -> None:
        before, after = (before, after) if before is not None \
            else self.events
        src = self.src
        for k, i in enumerate(self.copied):
            src[k] = flat[i].data_ptr()
        stamps = self.stamps
        err = self.run(stream, self.exec, self.nodes, self.n_in, self.n_out,
                       before.cuda_event, after.cuda_event, src, self.dst,
                       self.src_out, block.data_ptr(), self.out_off,
                       self.bytes, self.last, stamps)
        for name, wall in zip(self.STEPS, stamps):
            step(name, wall)
        _lib.check(err, "repro_stage_launch")


class _Static:
    """One program's static inputs on one lane (the lane's, shared with
    its programs of that structure), and its run there; it keeps the lane,
    which the registry holds only weakly. ``relayout``: the arguments laid
    out otherwise than their static inputs (a non-dense one), which the
    card's copy nodes cannot read as they are."""

    def __init__(self, lane: Lane, inputs: list, runner,
                 relayout: list) -> None:
        self.lane, self.inputs, self.runner = lane, inputs, runner
        self.relayout = relayout


class StageCall:
    """One call of a stage program, resolved (``StageProgram.prepare``, or
    ``ReadyCall.call``): its static entry, its arguments flattened (on the
    card with a copy laid out alike of each one ``relayout`` names, held by
    the call), on the card its output block (``block``, the ready call's
    where it was made for the entry's layout, else made here),
    ``then``, applied to its output, and ``ahead``: that output, where the
    ready call built it before the run (``ReadyCall.output``)."""

    __slots__ = ("static", "flat", "block", "outs", "spec", "then", "ahead")

    def __init__(self, static: _Static, flat: list, then,
                 layout: "_Layout" = None, block=None, ahead=None) -> None:
        self.static, self.flat, self.then = static, flat, then
        burst = static.runner.burst
        self.block = self.outs = self.spec = self.ahead = None
        if burst is not None:
            if static.relayout:
                flat = list(flat)
                for i in static.relayout:
                    s = static.inputs[i]
                    flat[i] = torch.empty_strided(
                        s.shape, s.stride(), dtype=s.dtype,
                        device=s.device).copy_(flat[i])
                self.flat = flat
            if layout is burst.layout:
                self.block, self.ahead = block, ahead
            else:
                self.block = burst.layout.block()

    def issue(self, before=None, after=None, step=_no_step) -> None:
        """Under the lane's lock: ``before`` recorded on the current
        stream, the copies in, the run, the copies out, ``after``
        recorded; ``step(name, wall)`` after each. On the card that is
        the burst's launch (``step`` given the ``perf_counter`` readings
        it took: ``_Burst.STEPS``), on the CPU PyTorch's calls."""
        st = self.static
        runner = st.runner
        with st.lane.lock:
            if self.block is not None:
                runner.burst.issue(st.lane.key[1], self.flat, self.block,
                                   before, after, step)
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
        runner = self.static.runner
        runner.counted()
        if self.ahead is not None:
            return self.ahead
        if self.block is not None:
            out = runner.burst.layout.outputs(self.block)
        else:
            out = (self.outs[0] if self.spec.is_leaf()
                   else tree_unflatten(self.outs, self.spec))
        return out if self.then is None else self.then(out)


class ReadyCall:
    """A call of a stage program made ready without a lane
    (``StageProgram.ready``): its arguments (the tree and flattened), their
    signature, ``then``, and on the card, where a lane's entry of that
    signature exists, the output block of the entry's ``layout``, made on
    the stream current then. ``call(lane)`` takes the lane's step and
    returns the ``StageCall``; a ready call is called once (its block
    becomes that call's output). With a block, its output is known before
    it runs (``output``), so the next stage's call can be made ready on it
    before this one is launched."""

    __slots__ = ("program", "sig", "flat", "args", "then", "layout",
                 "block", "out")

    def __init__(self, program: "StageProgram", sig, flat: list,
                 args: tuple, then, layout: "_Layout") -> None:
        self.program, self.sig, self.flat = program, sig, flat
        self.args, self.then, self.layout = args, then, layout
        self.block = None if layout is None else layout.block()
        self.out = None

    def output(self):
        """The call's output before it runs: views of its block that its
        run will write, ``then`` applied, the very tree its ``result``
        returns; None where only the run makes it (no block: the CPU's
        eager run, or a signature no lane has an entry of yet)."""
        if self.block is not None and self.out is None:
            out = self.layout.outputs(self.block)
            self.out = out if self.then is None else self.then(out)
        return self.out

    def call(self, lane=None, use: Callable = None) -> StageCall:
        """The lane's step, on ``lane``, else on the current lane: the
        lane's static entry of the signature (made, and on the card its
        graph captured, at the lane's first call of it) and the call on
        it. ``use``, where given, makes ``lane``'s stream current, and is
        called only where the step enqueues work or allocates (an entry
        made, a relayout copy, a block of the entry's own layout); without
        it ``lane``'s stream must be current."""
        prog = self.program
        key = (prog._lane_of(prog._device(self.flat)) if lane is None
               else lane, self.sig)
        st = prog._lanes.get(key)
        if use is not None and (st is None or st.relayout or (
                st.runner.burst is not None
                and st.runner.burst.layout is not self.layout)):
            use()
        if st is None:
            st = prog._static(key, self.args, self.flat)
        return StageCall(st, self.flat, self.then, self.layout, self.block,
                         self.out)


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
        self._layouts: dict = {}    # signature -> its first entry's _Layout

    def _runner(self, device: torch.device):
        return _Graph if device.type == "cuda" else _Eager

    def _lane_of(self, device: torch.device):
        """The current stream on the card (its device index and handle),
        the calling thread on the CPU."""
        if device.type == "cuda":
            return (device.index or 0,
                    torch.cuda.current_stream(device).cuda_stream)
        return threading.get_ident()

    def ready(self, *args, then: Callable = None) -> ReadyCall:
        """The call on ``args`` made ready for any lane; ``then`` is
        applied to its output. The signature is the call's one check of
        its arguments: one whose structure, shape, dtype, device or
        strides differ from every entry's takes an entry of its own."""
        flat = []
        sig = _signature(args, flat)
        return ReadyCall(self, sig, flat, args, then, self._layouts.get(sig))

    def prepare(self, *args, then: Callable = None,
                lane=None) -> StageCall:
        """The call on ``args`` resolved on the current lane, or on
        ``lane`` where the caller knows it is current: ``ready`` and its
        lane's step in turn."""
        return self.ready(*args, then=then).call(lane)

    def _device(self, flat: list) -> torch.device:
        """The arguments' device, once they are found to be tensors."""
        if not flat or not all(isinstance(t, torch.Tensor) for t in flat):
            raise TypeError(f"stage program {self.name!r} takes tensors "
                            f"only, got {[type(t).__name__ for t in flat]}")
        return flat[0].device

    def _static(self, key, args: tuple, flat: list) -> _Static:
        """The lane's static entry of ``key``, made at its first call:
        static inputs shared with the lane's programs of the same
        structure (a ``Constant``'s by its tree's)."""
        dev = self._device(flat)
        ln = lane(key[0])
        with ln.lock:
            with self._lock:
                st = self._lanes.get(key)
            if st is not None:
                return st
            tree = _expand(args)
            leaves, spec = tree_flatten(tree)
            if len(leaves) != len(flat) or any(
                    a is not b for a, b in zip(leaves, flat)):
                raise TypeError(f"stage program {self.name!r}: its "
                                f"arguments flatten in another order "
                                f"than tree_flatten's")
            inputs = ln.static_inputs(_signature(tree, []), flat)
            for s, t in zip(inputs, flat):
                s.copy_(t)
            st = _Static(ln, inputs, self._runner(dev)(
                self.fn, tree_unflatten(list(inputs), spec), ln, inputs),
                [i for i, (s, t) in enumerate(zip(inputs, flat))
                 if s.stride() != t.stride()])
            burst = st.runner.burst
            with self._lock:
                if burst is not None:
                    # one layout object a signature where the lanes' graphs
                    # lay their outputs out alike: a ready call's block is
                    # taken by the entry it is launched on by identity
                    first = self._layouts.setdefault(key[1], burst.layout)
                    if first.key == burst.layout.key:
                        burst.layout = first
                self._lanes[key] = st
            return st

    def __call__(self, *args):
        call = self.prepare(*args)
        call.issue()
        return call.result()
