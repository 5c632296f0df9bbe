"""ExecutionBackend protocol + the two built-in substrates.

Counterpart of src/repro/runtime/backend.py. ``SimBackend``,
``launch_values`` and ``_WorkerPool`` are the reference's (the pool also
counts the payload exceptions it survives); ``RealtimeBackend`` runs torch
payloads, each lane on its own CUDA stream, timed to the stream's
completion: on the card the engine thread enqueues a stage and polls its
end event, where the reference hands every stage to a worker thread.

A backend owns *time* and *stage execution* and nothing else; scheduling
policy lives entirely in ``EngineCore``/``DarisScheduler``. The contract:

    bind(core)               engine hands the backend its core reference
    start() / stop()         run lifecycle
    now_ms()                 current time (virtual or wall clock)
    advance(cap_ms)          -> [Completion] occurring strictly before cap,
                             else advance/block time to cap and return []
    launch(lane, inst)       begin executing a dispatched stage
    running_set_changed()    hook after dispatch/harvest (rate recompute)
    cancel_ctx(ctx)          drop in-flight work on a failed context
    on_job_done(job)         job-level cleanup (activation state, ...)
    has_inflight()           any launched-but-unharvested stage?

``SimBackend`` wraps the processor-sharing fluid simulation (versioned
finish predictions, lognormal stage noise, straggler mitigation);
``RealtimeBackend`` executes real (torch, CUDA) stage payloads on
wall-clock time. Both are driven by the same EngineCore
loop, which is what makes sim-vs-real scheduler-decision parity testable.

RNG-draw-order invariant
------------------------
The sim's RNG stream is shared between arrival phase offsets (drawn when
``EngineCore.run`` seeds the timeline) and per-launch lognormal stage
noise (drawn inside ``launch``, one draw per dispatched stage, in
dispatch order). Every metric the repo treats as reproducible — and the
golden fixtures in tests/test_engine_golden.py — depends on that order.
Any engine change (vectorization, batching, reordering of dispatch) MUST
keep the number and order of draws identical; draw noise at launch, never
earlier or later, and never draw speculatively.
"""
from __future__ import annotations

import collections
import functools
import heapq
import itertools
import math
import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Protocol

import numpy as np
import torch

from ..core.task import HP, Job, StageInstance
from ..kernels._lib import stage_graphs
from .contention import batch_cost, batched_stage_ms
from .engine_core import (ADD_CTX, FAULT, RECONFIG, Completion,
                          EngineCore)

_tie = itertools.count()

# SimBackend.running entry layout (kept as a mutable list for speed):
#   [0] inst          StageInstance
#   [1] rem           remaining work, ms of single-stream-alone time
#   [2] rate          current speed fraction
#   [3] version       stamp matching the live heap prediction
#   [4] eff_prof      effective (possibly batch-widened) StageProfile
#   [5] eta           finish time of the live heap prediction (None until
#                     the first prediction is pushed)
#   [6] smret         the instance's StageMret estimator (live ref)
#   [7] cost          batch cost b/g(b) of this stage (static per launch)
#   [8] floor         straggler kill floor, 4 x batched work (static)
#   [9] xfer          inter-GPU transfer charge folded into the work
#                     (cluster; 0.0 on a single device) — excluded from
#                     the straggler kill decision, which compares pure
#                     execution progress against MRET
#   [10] cfail        chaos-injected transient fault (repro.chaos): the
#                     stage runs to completion but the result is garbage
#                     — reported via Completion.failed. Always False
#                     with no ChaosPlan installed.
(_INST, _REM, _RATE, _VER, _EFF, _ETA, _SMRET, _COST, _FLOOR,
 _XFER, _CFAIL) = range(11)


def launch_values(core: EngineCore, lane: tuple, inst: StageInstance,
                  rng, noise_sigma: float) -> tuple:
    """The per-launch scalar pipeline shared by ``SimBackend`` and the
    array-programmed ``EpochSimBackend`` (runtime/epoch.py): noise draw,
    batched work, effective profile, straggler constants, heterogeneous
    speed scaling, transfer charge, chaos hazards. One implementation is
    what makes the two engines bit-identical by construction — and it is
    the ONLY place the shared sim rng is drawn from at launch time (see
    the draw-order invariant in the module docstring).

    Returns ``(work, eff, smret, cost, floor, xfer, cfail)``.
    """
    prof = inst.profile
    b = inst.job.n_inputs
    noise = math.exp(rng.normal(0.0, noise_sigma))
    # batched jobs carry b inputs in one dispatch: work scales by
    # b / g(b) (Table-I-calibrated curve), overhead is paid once
    alone = batched_stage_ms(prof, b)
    work = (alone + prof.overhead_ms) * noise
    # batched kernels also widen — the effective profile competes for
    # more units in the rate computation (identity object for b = 1).
    # The contention model is the LANE's device's (cluster lanes can
    # sit on heterogeneous GPUs; on one device this is sched.contention)
    con = core.sched.contention_of(lane[0])
    eff = con.batched_profile(prof, b)
    # straggler-check constants, hoisted out of the per-event loop:
    # the stage's MRET estimator, its batch cost, and its kill floor
    # are fixed for the lifetime of this launch
    smret = inst.task.mret.stages[inst.job.stage_idx]
    cost = batch_cost(prof, b)
    floor = 4.0 * (alone + prof.overhead_ms)
    spd = con.device.speed
    if spd != 1.0:
        # heterogeneous device: profiles/MRET are reference-speed, so
        # the executed work — and every wall-clock-comparable straggler
        # constant — shrinks by the device's speed factor
        work /= spd
        cost /= spd
        floor /= spd
    if inst.transfer_ms:
        # inter-GPU state migration (cluster dispatcher stamped it):
        # the transfer serializes ahead of the stage program
        work += inst.transfer_ms
    # chaos hazards draw from the plan's OWN stream (never the sim
    # rng — the draw-order invariant above stays intact): one draw
    # per configured hazard per launch, in dispatch order. A stall
    # is extra serialized work; a fault pays the full execution and
    # surfaces as Completion.failed at harvest.
    cfail = False
    ch = core._chaos
    if ch is not None:
        cfail, stall = ch.draw_launch()
        if stall:
            work += stall
    return work, eff, smret, cost, floor, inst.transfer_ms, cfail


class ExecutionBackend(Protocol):
    """Structural type for execution substrates (see module docstring)."""

    # True when the backend owns a virtual clock that only moves inside
    # advance() (the serving pump must then never advance past the next
    # actionable instant); False for wall-clock substrates
    virtual_time: bool

    def bind(self, core: EngineCore) -> None: ...
    def start(self) -> None: ...
    def stop(self) -> None: ...
    def now_ms(self) -> float: ...
    def advance(self, cap_ms: float) -> List[Completion]: ...
    def peek_eta(self) -> float: ...
    def launch(self, lane: tuple, inst: StageInstance) -> None: ...
    def running_set_changed(self) -> None: ...
    def cancel_ctx(self, ctx_idx: int) -> None: ...
    def on_job_done(self, job: Job) -> None: ...
    def has_inflight(self) -> bool: ...
    def on_reconfigure(self) -> None: ...
    # chaos layer: drop one in-flight stage (watchdog expiry). Only ever
    # called with a ChaosPlan installed.
    def kill_lane(self, lane: tuple, inst: StageInstance) -> None: ...


class SimBackend:
    """Fluid-rate discrete-event substrate (virtual time).

    Whenever the running set changes, per-lane rates are recomputed from
    the contention model — as one vectorized NumPy pass over preallocated
    per-lane arrays — and finish times re-predicted. Predictions are
    version-stamped so a rate change invalidates stale ones in O(1).
    Stage work carries seeded lognormal noise so MRET has variability to
    track (paper Fig. 9).

    Incremental re-prediction: rates are only recomputed when the running
    set actually changed (launch/harvest/cancel/straggler-kill marks the
    epoch dirty), and a lane's prediction is only re-pushed when its
    recomputed finish time moved beyond ``predict_eps`` from the one
    already in the heap. With the default ``predict_eps=0.0`` this is
    exact: the live prediction always carries the same float the full
    recompute would produce, so results are bit-identical to the historic
    push-everything engine while the heap stays near its live size
    (stale entries are compacted away once they outnumber live ones).

    ``full_repredict=True`` restores the historic behavior (recompute +
    re-push every lane on every call) — kept as the reference for the
    incremental-vs-full property test.
    """

    EPS = 1e-6   # ms; snap-to-zero tolerance
    _COMPACT_MIN = 64   # never bother compacting heaps smaller than this
    virtual_time = True

    def __init__(self, noise_sigma: float = 0.06,
                 rng: Optional[np.random.Generator] = None, *,
                 predict_eps: float = 0.0,
                 full_repredict: bool = False):
        self.noise_sigma = noise_sigma
        self.rng = rng
        self.predict_eps = predict_eps
        self.full_repredict = full_repredict
        self.core: Optional[EngineCore] = None
        self.now = 0.0
        self.running: Dict[tuple, list] = {}   # lane -> entry (layout above)
        self._heap: List[tuple] = []   # (t, seq, lane, version)
        self._rates_dirty = True

    # ----------------------------------------------------------- lifecycle
    def bind(self, core: EngineCore) -> None:
        self.core = core
        if self.rng is None:
            self.rng = core.rng   # shared stream: offsets then noise draws

    def start(self) -> None:
        self.now = 0.0

    def stop(self) -> None:
        pass

    def now_ms(self) -> float:
        return self.now

    def has_inflight(self) -> bool:
        return bool(self.running)

    # ---------------------------------------------------------------- time
    def _advance_to(self, t: float) -> None:
        dt = t - self.now
        if dt > 0:
            for entry in self.running.values():
                done = entry[_RATE] * dt
                rem = entry[_REM] - done
                entry[_REM] = rem if rem >= self.EPS else 0.0
                entry[_INST].work_done += done
        self.now = t

    def advance(self, cap_ms: float) -> List[Completion]:
        while self._heap and self._heap[0][0] < cap_ms:
            t, _, lane, ver = heapq.heappop(self._heap)
            entry = self.running.get(lane)
            if entry is None or entry[_VER] != ver:
                continue                      # stale prediction
            self._advance_to(t)
            inst = entry[_INST]
            del self.running[lane]
            self._rates_dirty = True
            return [Completion(lane, inst, t - inst.start_ms,
                               entry[_CFAIL])]
        self._advance_to(cap_ms)
        return []

    def peek_eta(self) -> float:
        """Earliest live finish prediction (inf when nothing is in
        flight). The serving pump gates ``advance`` on this so virtual
        time never runs past the next actionable instant. Stale heap
        entries encountered on the way are discarded — ``advance`` would
        skip the same ones, so pop order is untouched."""
        heap = self._heap
        while heap:
            t, _, lane, ver = heap[0]
            entry = self.running.get(lane)
            if entry is not None and entry[_VER] == ver:
                return t
            heapq.heappop(heap)
        return math.inf

    # ----------------------------------------------------------- execution
    def launch(self, lane: tuple, inst: StageInstance) -> None:
        work, eff, smret, cost, floor, xfer, cfail = launch_values(
            self.core, lane, inst, self.rng, self.noise_sigma)
        # version must be globally unique: a reset-to-0 counter lets a
        # stale FINISH from the lane's previous occupant fire early
        self.running[lane] = [inst, work, 0.0, next(_tie), eff, None,
                              smret, cost, floor, xfer, cfail]
        self._rates_dirty = True

    def cancel_ctx(self, ctx_idx: int) -> None:
        for lane in list(self.running):
            if lane[0] == ctx_idx:
                del self.running[lane]
                self._rates_dirty = True

    def on_job_done(self, job: Job) -> None:
        pass

    def kill_lane(self, lane: tuple, inst: StageInstance) -> None:
        # watchdog expiry: drop the entry; the stale heap prediction
        # self-invalidates via the version check
        if self.running.pop(lane, None) is not None:
            self._rates_dirty = True

    def on_chaos_edge(self) -> None:
        # a brownout window opened/closed: rates must be recomputed so
        # in-flight work integrates at the new factor from this instant
        self._rates_dirty = True

    def on_reconfigure(self) -> None:
        # in-flight lanes keep their (retired-context) rates, but the new
        # contexts change what the next dispatch competes against — force
        # a rate recompute at the next running-set pass
        self._rates_dirty = True

    # ------------------------------------------------------------- predict
    def _check_stragglers(self) -> None:
        """Straggler mitigation (beyond-paper, DESIGN.md §7): a stage whose
        projected completion exceeds kappa x its MRET is killed and
        re-enqueued — the Eq. 12 machinery then places it on the
        least-loaded context. Stage granularity bounds the lost work."""
        sched = self.core.sched
        kappa = sched.cfg.straggler_kappa
        if not kappa:
            return
        killed = False
        now = self.now
        for lane, entry in list(self.running.items()):
            inst = entry[_INST]
            if entry[_RATE] <= 0:
                continue
            projected = ((now - inst.start_ms)
                         + entry[_REM] / max(entry[_RATE], 1e-6))
            mret = entry[_SMRET].value() * entry[_COST]
            # the transfer charge is legitimate serialized work, not a
            # slow stage: keep it out of the kill comparison. The charge
            # sits inside rem, so the projection burns it at the
            # contention rate — the credit must scale the same way or a
            # contended transfer-charged stage gets spuriously killed
            # (and re-pays the transfer on every replay). +0.0 on a
            # single device, bit-exact.
            floor = entry[_FLOOR]
            thresh = (max(kappa * mret, floor)
                      + entry[_XFER] / max(entry[_RATE], 1e-6))
            if projected > thresh and len(self.running) > 1:
                del self.running[lane]
                self._rates_dirty = True
                sched.lanes[lane] = None
                inst.work_done = 0.0
                inst.lane = None
                # re-enqueue at the stage boundary (zero-delay): an HP
                # task's context is FIXED (Algorithm 1) — its straggler
                # replays on its own partition, never migrates. Only
                # LP jobs move, to the least-backlogged live context,
                # and each such move is a migration.
                old = inst.job.ctx
                if inst.task.fixed_ctx:
                    tgt = inst.task.ctx
                else:
                    # migration_eta == predicted_finish on one device; the
                    # cluster layer surcharges cross-GPU candidates with
                    # the inter-GPU transfer cost
                    cands = [c.index for c in sched.live_contexts()]
                    tgt = min(cands, key=lambda k:
                              sched.migration_eta(k, self.now, old,
                                                  inst.job))
                    if tgt != old:
                        sched.migrations += 1
                if inst.job in sched.active_jobs.get(old, {}):
                    del sched.active_jobs[old][inst.job]
                    sched.active_jobs[tgt][inst.job] = None
                inst.job.ctx = tgt
                sched.queues[tgt].push(inst)
                self.core.metrics.stragglers += 1
                killed = True
        if killed:
            self.core._dispatch()

    def running_set_changed(self) -> None:
        """Recompute rates (only when the running-set epoch is dirty) and
        re-push finish predictions for lanes whose predicted finish moved
        (see class docstring for the exactness argument)."""
        if not self.running:
            return
        self._check_stragglers()
        if not self.running:
            return
        sched = self.core.sched
        entries = list(self.running.items())
        if self._rates_dirty or self.full_repredict:
            # lanes on different GPUs never contend: the scheduler splits
            # the running set into per-device groups (exactly one group —
            # this whole block's historic shape — on a single device)
            for contention, contexts, group in sched.rate_groups(entries):
                ctx_active: Dict[object, int] = {}
                for lane, _ in group:
                    ctx_active[lane[0]] = ctx_active.get(lane[0], 0) + 1
                u, ns, mf = [], [], []
                for lane, e in group:
                    eff = e[_EFF]
                    u.append(contexts[lane[0]].cap
                             / max(ctx_active[lane[0]], 1))
                    ns.append(eff.n_sat)
                    mf.append(eff.mem_frac)
                rates = contention.rates_seq(u, ns, mf)
                ch = self.core._chaos
                browned = ch is not None and bool(ch.plan.brownouts)
                for (lane, entry), rate in zip(group, rates):
                    if browned:
                        # per-device brownout window (chaos layer): the
                        # whole device runs slow_factor-x slower. Cluster
                        # lane keys are ((dev, ctx), slot); single-device
                        # keys are (ctx, slot) on device 0.
                        dev = (lane[0][0] if isinstance(lane[0], tuple)
                               else 0)
                        f = ch.brownout_factor(dev, self.now)
                        if f > 1.0:
                            rate = rate / f
                    entry[_RATE] = rate if rate > 1e-6 else 1e-6
            self._rates_dirty = False
        now, eps, full = self.now, self.predict_eps, self.full_repredict
        heap = self._heap
        for lane, entry in entries:
            eta = now + entry[_REM] / entry[_RATE]
            old = entry[_ETA]
            if not full and old is not None and abs(eta - old) <= eps:
                continue        # live prediction already carries this eta
            entry[_VER] = next(_tie)
            entry[_ETA] = eta
            heapq.heappush(heap, (eta, next(_tie), lane, entry[_VER]))
        self.maybe_compact()

    def maybe_compact(self) -> None:
        """Compaction: once stale predictions outnumber live ones 2:1,
        rebuild the heap with only the live entries (pop order of
        survivors is unchanged — the seq tie-breaker is preserved).
        Runs after every prediction pass AND from the serving pump's
        pause path (EngineCore._step): an idle daemon under churny
        cancel traffic never reaches ``running_set_changed`` again, so
        without the pause-path call its stale entries accrete
        unboundedly."""
        heap = self._heap
        if (len(heap) > self._COMPACT_MIN
                and len(heap) > 2 * len(self.running)):
            running = self.running
            live = [e for e in heap
                    if (ent := running.get(e[2])) is not None
                    and ent[_VER] == e[3]]
            heapq.heapify(live)
            self._heap = live


class _ZeroInputs:
    """The default input: image-shaped zeros matching the staged-CNN payload
    convention, ``batch x n_inputs`` of them a job (a dynamically batched
    job widens the leading axis by ``n_inputs`` so the whole batch rides
    through the staged payload in one dispatch). Made once before the clock
    starts (``make``: one block on the backend's device, its fill
    synchronized, a view a leading size) and shared read-only by every job,
    as the reference's ``np.zeros`` of each job hold the same values: a
    stage program only copies its input into its static input. A job of a
    size not made raises: nothing is allocated after the clock starts."""

    def __init__(self, input_hw: int, batch: int,
                 device: torch.device) -> None:
        self.hw, self.batch, self.device = input_hw, batch, device
        self.made: Dict[int, torch.Tensor] = {}
        self.blocks = 0               # blocks made (one a ``make`` at most)

    def make(self, sizes) -> None:
        """A zero input for each leading size (``n_inputs``) in ``sizes``
        not made yet."""
        new = [n for n in sizes if n not in self.made]
        if not new:
            return
        block = torch.zeros((self.batch * max(new), self.hw, self.hw, 3),
                            dtype=torch.float32, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.blocks += 1
        for n in new:
            self.made[n] = block[:self.batch * n]

    def __call__(self, job: Job) -> torch.Tensor:
        x = self.made.get(job.n_inputs)
        if x is None:
            raise RuntimeError(
                f"no zero input of {job.n_inputs} inputs was made before "
                f"the clock started (made: {sorted(self.made)})")
        return x


def _default_input_factory(input_hw: int, batch: int,
                           device: torch.device) -> _ZeroInputs:
    """The reference's default input (``np.zeros`` a job), made before the
    clock starts (``_ZeroInputs``)."""
    return _ZeroInputs(input_hw, batch, device)


class _WorkerPool:
    """Persistent daemon-thread pool for ``RealtimeBackend``.

    The backend used to spawn one fresh thread per dispatched stage;
    thread start latency (~100-300us) landed inside every measured stage
    wall time. The pool keeps one long-lived worker per lane — sized via
    ``ensure`` so elastic scale-out grows it — and hands stages over
    through a queue, so the dispatch path is a lock-free put."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        # payload exceptions the workers survived (serving goes on; a
        # smoke run or a test fails on any)
        self._exc_lock = threading.Lock()
        self.exceptions = 0
        self.last_exception: Optional[BaseException] = None

    def ensure(self, n: int) -> None:
        while len(self._threads) < n:
            t = threading.Thread(target=self._loop, daemon=True)
            t.start()
            self._threads.append(t)

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, lane, inst = item
            try:
                fn(lane, inst)
            except Exception as e:   # noqa: BLE001 — worker must survive
                # a raising payload loses that stage (exactly what the old
                # thread-per-stage design did) but must not kill the
                # worker: a dead worker would starve every later stage
                # queued to the pool
                self.caught(e, lane, inst)

    def caught(self, e: Exception, lane: tuple,
               inst: Optional[StageInstance]) -> None:
        """Count and report a payload exception that serving survives (a
        worker's, or the engine thread's on the inline path)."""
        import sys
        with self._exc_lock:
            self.exceptions += 1
            self.last_exception = e
        # a warm-up (``_warm_streams``) runs with no stage instance
        name = getattr(getattr(inst, "task", None), "name", "warm-up")
        print(f"worker: stage {name} on lane {lane} raised {e!r}",
              file=sys.stderr)

    def submit(self, fn, lane: tuple, inst: Optional[StageInstance]) -> None:
        self._q.put((fn, lane, inst))

    def stop(self, timeout_s: float = 1.0) -> None:
        for _ in self._threads:
            self._q.put(None)
        leaked = 0
        for t in self._threads:
            t.join(timeout=timeout_s)
            if t.is_alive():
                leaked += 1
        self._threads = []
        # surface workers that outlived the join window (a wedged payload
        # — e.g. a stage blocked in device sync): callers read
        # ``leaked``, the ops log gets a line, and a sanitized run fails
        # loudly instead of carrying zombie threads into the next test
        self.leaked = leaked
        if leaked:
            import sys
            print(f"worker pool: {leaked} worker thread(s) still alive "
                  f"after stop(timeout={timeout_s}s)", file=sys.stderr)
            if os.environ.get("DARIS_SANITIZE", "") not in ("", "0"):
                raise RuntimeError(
                    f"DSAN: worker pool leaked {leaked} thread(s) — a "
                    f"stage payload never returned")


# the stages of an HP response (``RealtimeBackend.hp_response_parts``), in
# order: release to the first launch, then a stage's own
RESPONSE_PARTS = ("release_to_launch", "hand_off", "prep", "stream_wait",
                  "device", "notice", "gap")
HP_CHAINS_KEPT = 100_000        # completed HP jobs whose stamps are kept
STALL_MS = 1.0                  # an engine-thread stretch longer is a stall
# the engine thread's CPU clock is read at most this often (a read is a
# system call, and on the H100 machine the clock moves in 10 ms ticks)
CPU_EVERY_MS = 10.0
STALLS_KEPT = 10_000
EVENT_PAIRS = 4                 # a lane stream's ring of (start, end) events
# the enqueue's steps that enqueue the start event: its record (a payload
# without ``prepare``, a stage program run by PyTorch) or the launch of a
# graph that holds it (``serving/stage_graph.py``); the start event is
# recorded (``recorded``) as such a step begins
START_RECORDED = ("start", "launch")
ANCHOR_TRIES = 5                # polled events an anchor takes the best of


class _EngineClock:
    """The engine thread's wall clock (``time.perf_counter``) read at named
    instants: a launch's steps, each poll, each harvest, and ``engine``
    where the engine core hands over (its own work since the backend's
    last instant). A stretch between two instants longer than ``STALL_MS``
    is a stall, named by the instant that ends it, with the thread's CPU
    time (``time.thread_time``) over a window that holds it: near the
    window's wall time the thread ran (Python, or inside a call), near 0
    it was off the CPU (blocked in a call, or not scheduled). The CPU
    clock is a system call, so it is read at a stall's end and otherwise
    at most every ``CPU_EVERY_MS``: the window starts at most that long
    before the stall. A deliberate wait (the idle sleep, the host path's
    queue) is no stall; a sleep's overshoot is (``wake``)."""

    def __init__(self) -> None:
        # (step, start s, end s, CPU s in the window, the window's start s)
        self.stalls: list = []
        self.restart()

    def restart(self) -> None:
        self.wall = self.cpu_at = time.perf_counter()
        self.cpu = time.thread_time()

    def __call__(self, name: str, wall: Optional[float] = None) -> float:
        """The instant ``name`` (now, or the given ``perf_counter``
        reading); returns its wall time."""
        if wall is None:
            wall = time.perf_counter()
        if wall - self.wall > STALL_MS / 1000.0:
            self._stall(name, self.wall, wall)
        elif wall - self.cpu_at > CPU_EVERY_MS / 1000.0:
            self.cpu, self.cpu_at = time.thread_time(), wall
        self.wall = wall
        return wall

    def _stall(self, name: str, start: float, end: float) -> None:
        cpu = time.thread_time()
        if len(self.stalls) < STALLS_KEPT:
            self.stalls.append((name, start, end, cpu - self.cpu,
                                self.cpu_at))
        self.cpu, self.cpu_at = cpu, end

    def waited(self, until: Optional[float]) -> None:
        """After a deliberate wait meant to end at ``until`` (a
        ``perf_counter`` second; None: whenever work arrived)."""
        wall = time.perf_counter()
        if until is not None and wall - until > STALL_MS / 1000.0:
            self._stall("wake", until, wall)
        else:
            self.cpu, self.cpu_at = time.thread_time(), wall
        self.wall = wall


class _StreamUse:
    """``stream`` current for the block and the stream current before it
    restored: ``torch.cuda.stream``'s work without its device checks (the
    seam's streams are all on its one device), made once a stream, by the
    two calls into PyTorch's C module that ``current_stream`` and
    ``set_stream`` wrap (without the ``Stream`` object each builds)."""

    __slots__ = ("ids", "prev")

    def __init__(self, stream) -> None:
        self.ids = (stream.stream_id, stream.device_index,
                    stream.device_type)
        self.prev = []

    def __enter__(self):
        stream_id, index, kind = self.ids
        self.prev.append(torch._C._cuda_getCurrentStream(index))
        torch._C._cuda_setStream(stream_id=stream_id, device_index=index,
                                 device_type=kind)
        return self

    def __exit__(self, *exc) -> None:
        stream_id, index, kind = self.prev.pop()
        torch._C._cuda_setStream(stream_id=stream_id, device_index=index,
                                 device_type=kind)


class CudaSeam:
    """The card as the inline path sees it: a lane's stream, the context
    that makes a stream current, the CUDA events that time a stage and put
    it on the host's clock, and a stream's key among the stage programs'
    lanes. A CPU test hands ``RealtimeBackend`` a stand-in with the same
    calls (its ``_seam``); on the card the seam is this one, with no host
    fallback."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._uses: Dict[int, _StreamUse] = {}

    def stream(self):
        return torch.cuda.Stream(self.device)

    def use(self, stream) -> _StreamUse:
        use = self._uses.get(id(stream))
        if use is None:
            use = self._uses[id(stream)] = _StreamUse(stream)
        return use

    def lane_key(self, stream) -> tuple:
        """The stream's key among the stage programs' lanes."""
        return self.device.index or 0, stream.cuda_stream

    def event(self):
        return torch.cuda.Event(enable_timing=True)


def _stats(xs: list) -> dict:
    """Median, p99, max and sum of ``xs`` (not empty)."""
    xs = sorted(xs)
    return {"median": xs[len(xs) // 2],
            "p99": xs[min(len(xs) - 1, int(0.99 * len(xs)))],
            "max": xs[-1], "sum": sum(xs)}


def _anchor_event(events: list, clock_ms: Callable[[float], float]):
    """An event put on the host's clock: recorded on the current stream
    and polled to its completion, which lies between the host stamps
    around that (the narrowest of one try an event of ``events``).
    Returns (event, its time in ms on ``clock_ms``'s clock, half the
    window's width)."""
    best = None
    for ev in events:
        a = time.perf_counter()
        ev.record()
        while not ev.query():
            pass
        b = time.perf_counter()
        if best is None or b - a < best[2] - best[1]:
            best = (ev, a, b)
    ev, a, b = best
    return ev, clock_ms((a + b) / 2.0), (b - a) / 2.0 * 1000.0


def _stage_parts(st: dict, nxt: float) -> dict:
    """One launch's parts from its stamps (ms on the backend's clock);
    ``nxt``: the job's next launch, or its completion after its last
    stage. ``prep`` runs from the stage's start to its start event's
    record (the stage's start where nothing is recorded: the host path,
    a synthetic stage). ``enqueue`` (the stage's start to its last step
    on the engine thread) and ``sync_wake`` (the device's end to the host
    seeing it: the worker's return from the synchronize, or the poll) lie
    within ``prep`` + ``stream_wait`` + ``device`` and ``notice``;
    ``steps``: the enqueue's ms by step, which sum to it."""
    recorded = st.get("recorded", st["start"])
    return {"stage": st["stage"], "failed": st["failed"],
            "hand_off": st["start"] - st["launch"],
            "prep": recorded - st["start"],
            "stream_wait": st["dev_start"] - recorded,
            "device": st["dev_end"] - st["dev_start"],
            "notice": st["harvest"] - st["dev_end"],
            "gap": nxt - st["harvest"],
            "enqueue": st["enqueued"] - st["start"],
            "sync_wake": st["synced"] - st["dev_end"],
            "steps": st.get("steps", {})}


class _Flight:
    """One launched stage until its harvest. The inline path fills
    ``t0`` at the launch and, as it enqueues, ``start``/``end`` (its
    events, a pair of its stream's ``ring``), ``inp`` (its input, kept
    until the poll sees its end) and ``out``; ``done`` is ``(et_ms,
    output, device ms)`` once the stage is seen complete (the poll on the
    inline path, the done queue on the host path)."""

    __slots__ = ("lane", "inst", "token", "failed", "stamps", "t0",
                 "stalled", "start", "end", "ring", "inp", "out", "done")

    def __init__(self, lane: tuple, inst: StageInstance, token: int,
                 failed: bool, stamps: dict) -> None:
        self.lane, self.inst, self.token = lane, inst, token
        self.failed, self.stamps = failed, stamps
        self.t0 = 0.0
        self.stalled = False
        self.start = self.end = self.ring = self.inp = None
        self.out = self.done = None


class RealtimeBackend:
    """Wall-clock substrate: stage payloads on the engine thread (the
    card, one lane a stream) or on a worker pool (the CPU, one lane a
    worker).

    Stage payloads are arbitrary callables (torch stage functions in
    production). A stage takes one of two paths:

    - *inline* (a CUDA ``device``, where every lane owns a
      ``torch.cuda.Stream``): ``launch`` enqueues the stage on the engine
      thread, under the lane's stream, between a start and an end CUDA
      event, and returns; ``advance`` polls the in-flight stages' end
      events (``Event.query``, never a blocking synchronize) and commits
      the first one done, in launch order where several are. Every served
      stage is one CUDA-graph launch (``serving/stage_graph.py``), resolved
      before its start event: the graph holds the stage's copies and its
      start and end events, so the events bracket the device's work and
      no host time; its end event is the synchronisation point between
      stages. A lane stream's events come from its ring (``EVENT_PAIRS``,
      made with the stream), so no event is made after the clock starts.
      Nothing there blocks the host: a launch with
      a chaos stall is enqueued by the poll once the stall has passed,
      and a stage without a payload ends at the poll ``t_alone`` after it
      began.
    - *host* (``device="cpu"``): a worker of ``_WorkerPool`` sleeps the
      stall, runs the payload or sleeps a synthetic stage's ``t_alone``,
      and ships the result through the done queue, which ``advance``
      drains as it polls.

    ``et_ms``, which feeds MRET, is on both paths the wall time from the
    stage's start on the host to its completion on the stream as the host
    sees it, never the launch latency of an asynchronous payload; the
    events' device time is kept beside it per stage name
    (``stage_time_summary``). A launch keeps its input (inter-stage state
    made on another lane's stream) until the poll sees its end event, so
    the caching allocator cannot hand that memory out while the reader
    may still use it. On a CUDA device ``start`` runs each task's payloads on
    every lane's stream on the engine thread before the clock starts
    (``_warm_streams``). A stage whose
    profile has no payload is *emulated* by waiting its ``t_alone``: that
    keeps analytic task sets runnable on the real engine, which is what
    the sim-vs-real parity test exercises.

    Scheduler state AND inter-stage activation state (``_job_state``) are
    touched only on the engine thread: the inline path runs there, workers
    ship their output through the done queue, and ``advance`` commits
    either at harvest, so a ghost stage from a failed context or a
    watchdog kill can never clobber a replayed job's activations. No lock
    is needed.

    Zero-delay migration (``ctx_devices``): when a job's next stage
    dispatches on a different context than the one that produced its
    inter-stage state — scheduler migration, fail_context re-homing, or an
    online ``reconfigure`` — the stage's input (``_stage_input``) is the
    whole inter-stage tree (hidden activation + the remaining stages'
    cache slices, see ``serving/staging.slice_cache``) moved onto the
    target context's device via ``serving.staging.migrate`` before the
    stage runs. This is the
    paper's zero-delay mechanism made physical: the move happens between
    stage programs, never inside one. Keys are **live slot positions**
    (0 = lowest-indexed live context), not raw context indices: an online
    reconfigure retires contexts and creates replacements at fresh
    indices, but the physical device groups behind the slots persist —
    slot keys survive any number of reshapes, raw indices would all go
    stale at the first one. Before any fault/reshape, slot == index.
    Slots without an entry keep the state where it is (single-device
    mode: on one card nothing moves). ``resharded`` counts the migrations
    actually performed.

    Every launch carries host stamps on the backend's clock (``now_ms``):
    the engine's ``launch``, the stage's start (the engine's own on the
    inline path, before any stall; the worker's on the host path), its
    start event recorded (the inline path), the payload enqueued (on
    the card its copy in, replay and copy out; on the CPU its call), the
    host seeing the stage complete (the poll, or the worker's return from
    the end event's synchronize), and ``advance``'s harvest; on the card
    the CUDA events' device interval is put on the same clock by two
    events polled to completion between host stamps, one as the clock
    starts and one at ``stop`` (``_anchor_event``). A completed HP
    job's chain of them, with its release and the engine's completion
    stamp (``job.finish_ms``), is kept for ``hp_response_parts``.

    Lane streams are slots the run reuses (the inline path): a lane new
    to the scheduler (a reconfigure's, a scale-out's) takes the stream of
    a lane whose context was retired or failed, the first made of those
    with no stage in flight, before a new stream is made. So a run holds
    as many streams, each with its stage programs' graphs and pool, as it
    ever has lanes live at once, and a lane's first stages replay the
    graphs its stream already holds. ``start`` makes and warms that many
    for the run's own fault plan (``_planned_lanes``); a growth the plan
    did not name (an autoscale, or a scale-out past the plan) makes and
    warms the missing streams before their first launch, counted in
    ``rewarm``. A ghost still in flight on a reused stream (a failed
    context's stage) is safe: stream order runs the new lane's stage
    after it, its stage program's copy out was enqueued before the new
    copy in, and its time shows as that stage's ``stream_wait``; harvest
    stays keyed by the lane, which drops it.

    ``device`` defaults to the card and raises without one: pass
    ``device="cpu"`` to run payloads on the host (no streams, no events).
    """

    virtual_time = False

    def __init__(self, input_hw: int = 64, batch: int = 1,
                 input_factory: Optional[Callable[[Job], object]] = None,
                 ctx_devices: Optional[Dict[int, object]] = None, *,
                 device=None):
        from ..device import resolve_device
        self.device = resolve_device(device)
        # the default input, made at ``start`` (None: the caller's factory,
        # called for each job)
        self._zeros = (None if input_factory is not None
                       else _default_input_factory(input_hw, batch,
                                                   self.device))
        self.input_factory = input_factory or self._zeros
        self.ctx_devices: Dict[int, object] = dict(ctx_devices or {})
        self.resharded = 0
        self.warm_s = 0.0          # wall seconds of the lanes' warm-up
        # the stage programs' graph counts (``_lib.stage_graphs``) before
        # and after the warm-up, and payload stages run on the lanes since
        # (and of them those the worker pool ran)
        self._graphs_warm: Dict[str, Dict[str, float]] = {}
        self.stage_runs = self.pool_stage_runs = 0
        self._runs_lock = threading.Lock()
        # the inline path's streams and events: the card's (None on the
        # CPU, where every stage takes the host path)
        self._seam = CudaSeam(self.device) if self.device.type == "cuda" \
            else None
        # the lane streams in the order they were made, and lane -> the
        # stream it holds: a live lane's, or a retired lane's while a stage
        # of it is in flight (class docstring)
        self._slots: list = []
        self._streams: Dict[tuple, object] = {}
        # each lane stream's free (start, end) event pairs (by the
        # stream's id), made with the stream; the anchors' events; the
        # events made, and of them those made after the clock started
        self._rings: Dict[int, list] = {}
        # each lane stream's key among the stage programs' lanes (its
        # device index and handle, ``stage_graph.StageProgram.prepare``)
        self._lane_keys: Dict[int, tuple] = {}
        self._anchor_events: list = []
        self.events_made = self._events_at_start = 0
        # warm-ups of streams made after the clock started: how many, their
        # host seconds and the captures and replays they made
        self.rewarm = {"count": 0, "s": 0.0, "captures": 0, "replays": 0}
        # stage name -> [completions, wall ms sum, device-timed completions,
        #                device ms sum, device ms max]
        self.stage_times: Dict[str, List[float]] = {}
        self.core: Optional[EngineCore] = None
        self._done_q: "queue.Queue" = queue.Queue()
        self._job_state: Dict[int, object] = {}
        self._state_ctx: Dict[int, int] = {}   # job_id -> producing context
        # token -> launched stage until its harvest, in launch order; and
        # the inline path's (perf_counter second, stage, what it does
        # then) of a stage that waits: a chaos stall before its enqueue,
        # a synthetic stage's work
        self._flight: Dict[int, _Flight] = {}
        self._deferred: list = []
        self._cancelled_ctx: set = set()
        # lane -> token of the launch the engine still believes in; a
        # watchdog kill_lane drops the token so the un-interruptible
        # stage's eventual completion is discarded at harvest
        self._live_token: Dict[tuple, int] = {}
        self._t0 = 0.0
        self._pool = _WorkerPool()
        # job_id -> stamps of its harvested launches; then the completed HP
        # jobs' (response index, releases, completion, stamps, task)
        self._stamps: Dict[int, list] = {}
        self._hp_chains: "collections.deque" = collections.deque(
            maxlen=HP_CHAINS_KEPT)
        # events put on the backend's clock as it starts and at stop
        # (``_anchor_event``): (event, ms, half-width ms) each
        self._anchors: list = []
        # the engine thread's clocks and stalls (``engine_stalls``), and
        # the card stages' enqueues: (stage, priority, ms, ms by step, ms
        # of the output's result after it)
        self._clock = _EngineClock()
        self._enqueues: "collections.deque" = collections.deque(
            maxlen=HP_CHAINS_KEPT)

    # ----------------------------------------------------------- lifecycle
    def bind(self, core: EngineCore) -> None:
        self.core = core

    def _ensure_pool(self) -> None:
        """The host path's pool: one worker per live lane (+ stages still
        finishing on retired lanes), at the start and after a reconfigure
        adds lanes; concurrency is bounded by that count, so a bigger pool
        would only idle. By LIVE lanes: a reconfigure-heavy run accumulates
        retired lanes forever, and a worker per lane ever would leak a
        thread per dead lane."""
        sched = self.core.sched
        live = sum(c.n_streams for c in sched.live_contexts())
        draining = sum(1 for ln, i in sched.lanes.items()
                       if i is not None and not sched.contexts[ln[0]].alive)
        self._pool.ensure(live + draining)

    def start(self) -> None:
        before = stage_graphs.snapshot()
        if self._zeros is not None:
            self._zeros.make(self._input_sizes())
        if self._seam is None:
            self._ensure_pool()
        else:
            t0 = time.perf_counter()
            lanes = self._live_lanes()
            new = self._new_streams(max(len(lanes), self._planned_lanes()))
            for lane in lanes:
                self._lane_stream(lane)
            self._warm_streams(new)
            self._anchor_events = [self._event() for _ in range(
                2 * ANCHOR_TRIES)]
            self.warm_s = time.perf_counter() - t0
        self._graphs_warm = {"before": before,
                             "after": stage_graphs.snapshot()}
        self._events_at_start = self.events_made
        self._t0 = time.perf_counter()
        if self._seam is not None:
            self._anchors = [_anchor_event(
                self._anchor_events[:ANCHOR_TRIES], self._ms)]
        self._clock.stalls.clear()
        self._clock.restart()

    def _input_sizes(self) -> range:
        """The leading sizes (``n_inputs``) a job of this run can have:
        up to the batching policy's ``max_batch``, else 1."""
        policy = self.core.sched.cfg.batch_policy
        return range(1, (policy.max_batch if policy is not None else 1) + 1)

    def _planned_lanes(self) -> int:
        """The most lanes live at once under the run's own fault plan:
        from the live contexts, its context failure, scale-out and
        reconfigures within the horizon in the engine's order (time, then
        kind), each as the scheduler applies it."""
        core = self.core
        sched, fp = core.sched, core.fault_plan
        live = {c.index: c.n_streams for c in sched.live_contexts()}
        peak = sum(live.values())
        if fp is None:
            return peak
        events = [(t, RECONFIG, kw) for t, kw in fp.reconfigure_at or ()]
        if fp.fail_ctx_at:
            events.append((fp.fail_ctx_at[1], FAULT, fp.fail_ctx_at[0]))
        if fp.add_ctx_at is not None:
            events.append((fp.add_ctx_at, ADD_CTX, None))
        n_streams, made = sched.cfg.n_streams, len(sched.contexts)
        for t, kind, arg in sorted(events, key=lambda e: e[:2]):
            if t > core.horizon:
                continue
            if kind == FAULT:
                live.pop(arg, None)
                continue
            if kind == ADD_CTX:
                fresh = 1
            else:
                n_streams = arg.get("n_streams", n_streams)
                fresh = arg.get("n_contexts", len(live))
                live = {}
            live.update((made + k, n_streams) for k in range(fresh))
            made += fresh
            peak = max(peak, sum(live.values()))
        return peak

    def _new_streams(self, n: int) -> list:
        """``n`` lane streams, each with its ring of event pairs."""
        made = [self._seam.stream() for _ in range(n)]
        for stream in made:
            self._rings[id(stream)] = [(self._event(stream),
                                        self._event(stream))
                                       for _ in range(EVENT_PAIRS)]
            self._lane_keys[id(stream)] = self._seam.lane_key(stream)
        self._slots += made
        return made

    def _event(self, stream=None):
        """A new event of the seam, made (recorded once, on ``stream`` or
        the current one) now: the driver makes a CUDA event at its first
        record."""
        ev = self._seam.event()
        ev.record(stream)
        self.events_made += 1
        return ev

    def _free_streams(self) -> list:
        """The streams no live lane holds, in the order they were made,
        those with no stage in flight first. A retired lane lets go of its
        stream here once no stage of it is in flight."""
        contexts = self.core.sched.contexts
        flying = {}               # lane -> whether a stage of it still runs
        for rec in self._flight.values():
            flying[rec.lane] = flying.get(rec.lane, False) or rec.done is None
        held, busy = set(), set()
        for lane, stream in list(self._streams.items()):
            if contexts[lane[0]].alive:
                held.add(id(stream))
            elif lane not in flying:
                del self._streams[lane]
            elif flying[lane]:
                busy.add(id(stream))
        return sorted((s for s in self._slots if id(s) not in held),
                      key=lambda s: id(s) in busy)

    def _lane_stream(self, lane: tuple):
        """The lane's stream: at its first use a free one, or a new one
        warmed first where none is free (a lane no hook announced: a
        scale-out past the plan)."""
        stream = self._streams.get(lane)
        if stream is None:
            free = self._free_streams()
            if not free:
                self._rewarm(1)
                free = self._free_streams()
            stream = self._streams[lane] = free[0]
        return stream

    def _live_lanes(self) -> list:
        return sorted((c.index, s) for c in self.core.sched.live_contexts()
                      for s in range(c.n_streams))

    def _warm_tasks(self) -> list:
        """The tasks whose stages all have payloads (a synthetic stage
        is not run)."""
        return [t for t in self.core.sched.tasks
                if all(st.payload is not None for st in t.spec.stages)]

    def _warm_streams(self, new: list) -> None:
        """On the card, on the engine thread, which enqueues every stage:
        each task's payload chain runs on each stream in ``new``, then on
        every stream of the run once more. PyTorch builds cuDNN's
        execution plans once per thread and the caching allocator keeps
        its blocks per stream, so without this the first stages of each
        lane pay for both while their jobs wait and the first HP jobs of a
        served run miss their deadlines. The staged payloads' stage
        programs capture their CUDA graph for each new stream here
        (``graph_summary``: captures and their seconds). The second pass:
        a capture empties the caching allocator's cache
        (``torch.cuda.graph``), so only a pass after every stream's
        captures leaves each stream the blocks its stages' outputs take;
        without it the first served stages allocate from the driver on the
        engine thread (the first HP job of staged qwen2-moe once took
        90-219 ms on an H100). One thread: cuBLAS makes its workspace once
        a stream, not once a (thread, stream)."""
        tasks = self._warm_tasks()
        if not tasks or not new:
            return
        for stream in new + self._slots:
            try:
                with self._seam.use(stream):
                    for task in tasks:
                        x = self.input_factory(Job(task, 0.0, job_id=-1))
                        for st in task.spec.stages:
                            x = st.payload(x)
                stream.synchronize()
            except Exception as e:   # noqa: BLE001 — serving goes on
                self._pool.caught(e, ("stream", self._slots.index(stream)),
                                  None)

    def _rewarm(self, n: int) -> None:
        """``n`` more streams, made and warmed after the clock started
        (``rewarm``; every lane waits for it, through its captures)."""
        before, t0 = stage_graphs.snapshot(), time.perf_counter()
        self._warm_streams(self._new_streams(n))
        self.rewarm["count"] += 1
        self.rewarm["s"] += time.perf_counter() - t0
        after = stage_graphs.snapshot()
        for k in ("captures", "replays"):
            self.rewarm[k] += after[k] - before[k]

    def stop(self) -> None:
        self._pool.stop()
        if len(self._anchors) == 1:
            self._anchors.append(_anchor_event(
                self._anchor_events[ANCHOR_TRIES:], self._ms))

    def _ms(self, t: float) -> float:
        """A ``time.perf_counter`` reading on the backend's clock."""
        return (t - self._t0) * 1000.0

    def _device_ms(self, raw: float) -> float:
        """An event's time on the backend's clock from its device ms after
        the first anchor, scaled by the anchors' host-to-device rate where
        the run's end has its own anchor."""
        ev0, at0, _ = self._anchors[0]
        if len(self._anchors) < 2:
            return at0 + raw
        ev1, at1, _ = self._anchors[1]
        return at0 + raw * (at1 - at0) / ev0.elapsed_time(ev1)

    def graph_summary(self) -> Dict[str, float]:
        """The stage programs' CUDA graphs around this run: captures and
        their host seconds in the lanes' warm-up (within ``warm_s``),
        captures and replays since the clock started (of them, those in
        the warm-up of streams made after it: ``rewarm_captures`` and
        ``rewarm_replays``), the kernel launches those replays counted,
        the payload stages run on the lanes since (each one replay on the
        card) and how many of them the worker pool ran
        (``pool_stage_runs``: the host path's), the lane streams the run
        made (``streams``), and the graph pools (one a stream) first
        captured into in the warm-up and the run, and all
        since the counts were last reset with the card memory they hold.
        Counts are process-wide (``kernels._lib.stage_graphs``), so
        nothing else may replay a stage program meanwhile."""
        before = self._graphs_warm.get("before", {})
        after = self._graphs_warm.get("after", {})
        now = stage_graphs.snapshot()

        def since(a, b, k):
            return b.get(k, 0) - a.get(k, 0)
        from ..serving.stage_graph import pool_reserved_bytes
        return {"warm_captures": since(before, after, "captures"),
                "warm_capture_s": since(before, after, "capture_s"),
                "captures": since(after, now, "captures"),
                "rewarm_captures": self.rewarm["captures"],
                "rewarm_replays": self.rewarm["replays"],
                "replays": since(after, now, "replays"),
                "replayed_launches": since(after, now, "replayed_launches"),
                "stage_runs": self.stage_runs,
                "streams": len(self._slots),
                # CUDA events made after the clock started (a lane stream's
                # ring ran dry)
                "events_in_run": self.events_made - self._events_at_start,
                "pool_stage_runs": self.pool_stage_runs,
                # pools first captured into in the warm-up and the run: one
                # a stream; and all since the counts' reset (before the tasks
                # were built, whose calibration captured on one more lane)
                "run_pools": since(before, now, "pools"),
                "pools": now["pools"],
                "pool_gb": pool_reserved_bytes(stage_graphs.pool_ids())
                / 1e9}

    @property
    def worker_exceptions(self) -> int:
        """Payload exceptions serving survived (the worker pool's and the
        inline path's)."""
        return self._pool.exceptions

    @property
    def last_worker_exception(self) -> Optional[BaseException]:
        return self._pool.last_exception

    def stage_time_summary(self) -> Dict[str, Dict[str, float]]:
        """Per stage name: completions, mean wall ``et_ms`` (what MRET is
        fed) and mean/max CUDA-event device time (NaN where no stage of
        that name ran on a stream)."""
        out = {}
        for name, (n, wall, n_dev, dev, dev_max) in self.stage_times.items():
            out[name] = {"n": n, "mean_et_ms": wall / n,
                         "mean_device_ms": dev / n_dev if n_dev else math.nan,
                         "max_device_ms": dev_max if n_dev else math.nan}
        return out

    def now_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0

    def has_inflight(self) -> bool:
        return bool(self._flight)

    # ---------------------------------------------------------------- time
    def _poll(self) -> Optional[_Flight]:
        """The first in-flight stage, in launch order, that is done: on
        the host path the done queue drained into its stages; on the
        inline path the waits that are over acted on, then every enqueued
        stage's end event queried (``synced``, ``et_ms`` and the device
        times at the poll that first sees it)."""
        if self._seam is None:
            while True:
                try:
                    rec, *done = self._done_q.get_nowait()
                except queue.Empty:
                    break
                rec.done = done
        elif self._deferred:
            t = time.perf_counter()
            due = [d for d in self._deferred if d[0] <= t]
            if due:
                self._deferred = [d for d in self._deferred if d[0] > t]
                for _, rec, then in due:
                    then(rec)
        first = None
        for rec in self._flight.values():
            if rec.done is None and rec.end is not None and rec.end.query():
                t = time.perf_counter()
                rec.stamps["synced"] = self._ms(t)
                rec.done = ((t - rec.t0) * 1000.0, rec.out,
                            rec.start.elapsed_time(rec.end))
                rec.out = None
                # device ms after the first anchor: on the host's clock
                # later (``_device_ms``), once the run's end has its anchor
                ev0 = self._anchors[0][0]
                rec.stamps["dev_raw"] = (ev0.elapsed_time(rec.start),
                                         ev0.elapsed_time(rec.end))
                rec.ring.append((rec.start, rec.end))
                rec.start = rec.end = rec.inp = None
            if first is None and rec.done is not None:
                first = rec
        self._clock("poll")
        return first

    def _wait(self, cap_ms: float) -> None:
        """Wait for a stage to complete, at most until ``cap_ms``: sleep
        while nothing is in flight, block on the done queue while the host
        path's stages are, and on the inline path return at once (the next
        poll spins)."""
        timeout_s = max(cap_ms - self.now_ms(), 0.0) / 1000.0
        if not self._flight:
            until = time.perf_counter() + timeout_s
            time.sleep(timeout_s)
            self._clock.waited(until)
        elif self._seam is None:
            try:
                rec, *done = self._done_q.get(timeout=timeout_s)
            except queue.Empty:
                return
            finally:
                self._clock.waited(None)
            rec.done = done

    def advance(self, cap_ms: float) -> List[Completion]:
        self._clock("engine")
        while True:
            rec = self._poll()
            if rec is not None:
                c = self._harvest(rec)
                if c is not None:
                    return [c]
                continue
            if self.now_ms() >= cap_ms:
                return []
            self._wait(cap_ms)

    def _harvest(self, rec: _Flight) -> Optional[Completion]:
        """Commit a done stage on the engine thread; None for a ghost."""
        del self._flight[rec.token]
        lane, inst = rec.lane, rec.inst
        et, out, dev_ms = rec.done
        if lane[0] in self._cancelled_ctx:
            # ghost completion from a failed context: fail_context
            # already re-enqueued the instance, and dead contexts never
            # launch again, so anything arriving on them is stale —
            # drop its output along with it
            return None
        if self._live_token.get(lane) != rec.token:
            # watchdog-killed launch: the engine already re-enqueued
            # the stage; this late result is a ghost
            return None
        self._live_token.pop(lane, None)
        self._clock("harvest")
        stamps = rec.stamps
        stamps.update(harvest=self.now_ms(), failed=rec.failed)
        self._stamps.setdefault(inst.job.job_id, []).append(stamps)
        st = self.stage_times.setdefault(inst.profile.name,
                                         [0, 0.0, 0, 0.0, 0.0])
        st[0] += 1
        st[1] += et
        if not math.isnan(dev_ms):
            st[2] += 1
            st[3] += dev_ms
            st[4] = max(st[4], dev_ms)
        if not rec.failed:
            # a chaos-failed stage's output is garbage: never commit
            # it over the job's last good inter-stage state
            self._job_state[inst.job.job_id] = out
            self._state_ctx[inst.job.job_id] = lane[0]
        return Completion(lane, inst, et, rec.failed)

    def peek_eta(self) -> float:
        """Wall clock: in-flight work can complete at any instant, so the
        earliest actionable time is "now"; inf when idle (the serving
        pump then has nothing to harvest and must not spin)."""
        return self.now_ms() if self._flight else math.inf

    # ----------------------------------------------------------- execution
    def _device_for(self, ctx: int):
        """Resolve a context's target device by its live slot position
        (see class docstring); raw index is the fallback when no core is
        bound (unit-test construction)."""
        if not self.ctx_devices:
            return None
        if self.core is None:
            return self.ctx_devices.get(ctx)
        for slot, c in enumerate(self.core.sched.live_contexts()):
            if c.index == ctx:
                return self.ctx_devices.get(slot)
        return None      # retired context: never move state onto it

    def _migrate_state(self, x: object, job_id: int, ctx: int) -> object:
        """Move inter-stage state produced on another context onto this
        context's device (zero-delay: between stage programs)."""
        src = self._state_ctx.get(job_id, ctx)
        if x is None or src == ctx:
            return x
        tgt = self._device_for(ctx)
        if tgt is None:
            return x
        from ..serving.staging import migrate
        self.resharded += 1
        return migrate(x, tgt)

    def _worker(self, lane: tuple, inst: StageInstance, *, rec: _Flight,
                stall_ms: float, x) -> None:
        """The host path, on a worker: ``x`` is the stage's input, taken
        on the engine thread at ``launch``; the stage's run is its
        "device" interval."""
        prof = inst.profile
        stamps = rec.stamps
        t0 = time.perf_counter()
        stamps["start"] = self._ms(t0)
        if stall_ms:
            # chaos-injected lane stall (driver hiccup / ECC scrub): the
            # stage runs, just late — the stall serializes ahead of it
            time.sleep(stall_ms / 1000.0)
        stamps["dev_start"] = self.now_ms()
        if prof.payload is None:
            # synthetic stage: sleep the batched work (b/g(b) scaling)
            time.sleep(batched_stage_ms(prof, inst.job.n_inputs) / 1000.0)
            out = x
        else:
            out = prof.payload(x)
            self._ran_stage(pool=True)
        now = self.now_ms()
        stamps.update(dev_end=now, enqueued=now, synced=now)
        et_ms = (time.perf_counter() - t0) * 1000.0
        self._done_q.put((rec, et_ms, out, math.nan))

    def _ran_stage(self, pool: bool = False) -> None:
        with self._runs_lock:
            self.stage_runs += 1
            self.pool_stage_runs += pool

    def _stage_input(self, inst: StageInstance, lane: tuple):
        """On the engine thread: the job's inter-stage state (moved to this
        lane's context if it was produced elsewhere), or its first stage's
        input: the caller's factory's, made on the current stream (on the
        card the lane's), or the default one made before the clock."""
        x = self._job_state.get(inst.job.job_id)
        if inst.profile.payload is None:
            return x              # a synthetic stage hands its state on
        return (self.input_factory(inst.job) if x is None
                else self._migrate_state(x, inst.job.job_id, lane[0]))

    def launch(self, lane: tuple, inst: StageInstance) -> None:
        t0 = self._clock("engine")
        # chaos draws happen HERE, on the engine thread in dispatch order
        # (the deterministic stream position), never on the worker
        cfail, stall = False, 0.0
        ch = self.core._chaos
        if ch is not None:
            cfail, stall = ch.draw_launch()
        token = next(_tie)
        self._live_token[lane] = token
        rec = self._flight[token] = _Flight(
            lane, inst, token, cfail,
            {"stage": inst.job.stage_idx, "launch": self._ms(t0)})
        if self._seam is None:
            self._pool.submit(functools.partial(
                self._worker, rec=rec, stall_ms=stall,
                x=self._stage_input(inst, lane)), lane, inst)
            return
        rec.t0 = t0
        rec.stamps["start"] = self._ms(t0)
        if stall:
            # chaos-injected lane stall (driver hiccup / ECC scrub): the
            # stage runs, just late — the poll begins it after the stall
            rec.stalled = True
            self._deferred.append((rec.t0 + stall / 1000.0, rec,
                                   self._begin))
        else:
            self._begin(rec)

    def _begin(self, rec: _Flight) -> None:
        """The inline path at the stage's start (its launch, or the end of
        its stall): a payload enqueued on the lane's stream; a synthetic
        stage's batched work (b/g(b) scaling) begun, which the poll ends
        when its time has passed, handing the job's state on."""
        inst = rec.inst
        if inst.profile.payload is not None:
            self._enqueue(rec, self._lane_stream(rec.lane))
            return
        rec.stamps["dev_start"] = self.now_ms()
        rec.out = self._job_state.get(inst.job.job_id)
        work_s = batched_stage_ms(inst.profile, inst.job.n_inputs) / 1000.0
        self._deferred.append((time.perf_counter() + work_s, rec,
                               self._synthetic_done))

    def _synthetic_done(self, rec: _Flight) -> None:
        t = time.perf_counter()
        now = self._ms(t)
        rec.stamps.update(dev_end=now, enqueued=now, synced=now)
        rec.done = ((t - rec.t0) * 1000.0, rec.out, math.nan)
        rec.out = None

    def _enqueue(self, rec: _Flight, stream) -> None:
        """The inline path, on the engine thread under the lane's stream:
        the stage's input, its payload's call resolved (``prepare``: the
        program's lookup, the tensors its outputs land in), then its start
        event, its device work and its end event as one burst of driver
        calls (``StageCall.issue``): the stage is enqueued. Its output
        (``result``: the launches counted, the output's tree) comes after.
        Each step of the enqueue is stamped (``steps``: ms from the
        stage's start, or the end of its stall, to the step's end; they
        sum to ``enqueued`` - ``start``). A payload without ``prepare``
        runs whole between the events. The launch keeps its input until
        the poll sees its end event, so the caching allocator cannot hand
        its memory to another stream's work while this one may still read
        it. A payload that raises loses its stage, as on a worker."""
        seam, clock = self._seam, self._clock
        steps = rec.stamps["steps"] = {}
        last = [rec.t0]

        def step(name, wall=None) -> None:
            if name in START_RECORDED:
                rec.stamps["recorded"] = self._ms(last[0])
            t = clock(name, wall)
            steps[name] = steps.get(name, 0.0) + (t - last[0]) * 1000.0
            last[0] = t
        if rec.stalled:
            step("stall")
        payload = rec.inst.profile.payload
        prepare = getattr(payload, "prepare", None)
        rec.ring = ring = self._rings[id(stream)]
        try:
            with seam.use(stream):
                rec.inp = x = self._stage_input(rec.inst, rec.lane)
                rec.start, rec.end = (ring.pop() if ring
                                      else (self._event(), self._event()))
                step("input")
                if prepare is None:
                    rec.start.record(stream)
                    step("start")
                    rec.out = payload(x)
                    step("payload")
                    rec.end.record(stream)
                    step("end")
                else:
                    # the call holds its arguments
                    rec.inp = call = prepare(x, lane=self._lane_keys[
                        id(stream)])
                    step("resolve")
                    call.issue(rec.start, rec.end, step)
            enqueued = last[0]
            if prepare is not None:
                rec.out = call.result()
        except Exception as e:   # noqa: BLE001 — serving goes on
            del self._flight[rec.token]
            if rec.start is not None:
                ring.append((rec.start, rec.end))
            self._pool.caught(e, rec.lane, rec.inst)
            return
        rec.stamps["enqueued"] = self._ms(enqueued)
        inst = rec.inst
        self._enqueues.append((inst.job.stage_idx, inst.task.priority,
                               sum(steps.values()), steps,
                               (clock("result") - enqueued) * 1000.0))
        self._ran_stage()

    def kill_lane(self, lane: tuple, inst: StageInstance) -> None:
        # a launched stage can't be interrupted: forget the launch token
        # so the harvest discards the ghost completion when it lands (the
        # in-flight set still drains through advance)
        self._live_token.pop(lane, None)

    def cancel_ctx(self, ctx_idx: int) -> None:
        # launched stages can't be interrupted; mark the context so their
        # completions are dropped at harvest (fail_context re-enqueues the
        # instances, whose .lane is reset — that's the drop signal
        # advance() checks)
        self._cancelled_ctx.add(ctx_idx)

    def on_job_done(self, job: Job) -> None:
        self._job_state.pop(job.job_id, None)
        self._state_ctx.pop(job.job_id, None)
        chain = self._stamps.pop(job.job_id, None)
        # a completed HP job: its last stage harvested and not failed (an
        # abort follows a failed stage, a cancel sets ``cancelled``); the
        # engine appends its responses after this call
        if (chain and self.core is not None and job.task.priority == HP
                and not job.cancelled and job.finish_ms is not None
                and job.is_last_stage() and not chain[-1]["failed"]
                and chain[-1]["stage"] == job.stage_idx):
            live = [r for r in job.release_times
                    if r not in job.dropped_releases]
            self._hp_chains.append((len(self.core.metrics.response_ms[HP]),
                                    live, job.finish_ms, chain,
                                    job.task.name))

    def hp_response_parts(self, slowest: int = 3) -> dict:
        """Where each completed HP job's response went (ROADMAP C7), from
        the stamps of its harvested launches (class docstring): release ->
        first launch, then per launch ``hand_off`` (launch -> the stage's
        start: the worker's on the host path, on the inline path the
        engine's own delay), ``stream_wait`` (-> the device's start of the
        stage, on the CPU its call), ``device``, ``notice`` (-> the
        harvest: on the inline path the poll's latency and any earlier
        stage committed first) and ``gap``
        (-> the next launch, or after the last stage the engine's
        completion stamp). The parts sum to the response the engine
        recorded; ``sum_err_ms`` is the largest difference. ``by_job``:
        one row a job of [response, then each of ``RESPONSE_PARTS`` summed
        over its launches]; ``slowest``: that many of the slowest jobs with
        every launch's parts."""
        resp = self.core.metrics.response_ms[HP] if self.core else []
        for _, _, _, chain, _ in self._hp_chains:
            for st in chain:
                if "dev_raw" in st:
                    st["dev_start"], st["dev_end"] = map(self._device_ms,
                                                         st.pop("dev_raw"))
        jobs = []
        for idx, releases, finish, chain, name in self._hp_chains:
            launches = [c["launch"] for c in chain[1:]] + [finish]
            stages = [_stage_parts(st, nxt)
                      for st, nxt in zip(chain, launches)]
            for i, rel in enumerate(releases):
                if idx + i >= len(resp):
                    continue
                parts = {"release_to_launch": chain[0]["launch"] - rel}
                for k in RESPONSE_PARTS[1:]:
                    parts[k] = sum(s[k] for s in stages)
                total = sum(parts.values())
                jobs.append({"task": name, "release_ms": rel,
                             "response_ms": resp[idx + i],
                             "sum_err_ms": abs(total - resp[idx + i]),
                             "parts": parts, "stages": stages})
        by_part = {k: sum(j["parts"][k] for j in jobs)
                   for k in RESPONSE_PARTS}
        drift = None
        if len(self._anchors) == 2:
            (ev0, at0, _), (ev1, at1, _) = self._anchors
            drift = ((at1 - at0) / ev0.elapsed_time(ev1) - 1.0) * 1e6
        return {"jobs": len(jobs),
                "sum_err_ms": max((j["sum_err_ms"] for j in jobs),
                                  default=0.0),
                # the anchors' half-widths, and the host's clock against
                # the card's over the run in parts per million
                "anchor_uncertainty_ms": [a[2] for a in self._anchors],
                "clock_drift_ppm": drift,
                "parts": list(RESPONSE_PARTS), "total_ms": by_part,
                "by_job": [[j["response_ms"]]
                           + [j["parts"][k] for k in RESPONSE_PARTS]
                           for j in jobs],
                "slowest": sorted(jobs, key=lambda j: -j["response_ms"])[
                    :slowest]}

    def engine_stalls(self, collections: Optional[list] = None) -> list:
        """The engine thread's stretches over ``STALL_MS`` since the clock
        started (``_EngineClock``), on the backend's clock: the step that
        ends each, its start, its wall ms, and the thread's CPU ms in a
        window that holds it (``cpu_window_ms`` long); with
        ``collections`` ([generation, start ms, end ms] on this clock),
        the generations of those that overlap it."""
        out = []
        for name, a, b, cpu, at in self._clock.stalls:
            row = {"step": name, "start_ms": self._ms(a),
                   "wall_ms": (b - a) * 1000.0, "cpu_ms": cpu * 1000.0,
                   "cpu_window_ms": (b - at) * 1000.0}
            if collections is not None:
                lo, hi = row["start_ms"], self._ms(b)
                row["gc"] = [g for g, s, e in collections
                             if s < hi and e > lo]
            out.append(row)
        return out

    def enqueue_summary(self) -> dict:
        """The card stages' enqueues on the engine thread (the stage's
        start to its end event enqueued): how many, their ms (median, p99,
        max, sum), each step's, the ms of the output's ``result`` after
        it, the engine thread's whole ms a stage (the enqueue and the
        result) and its median by priority, the enqueue's median by stage
        index and by priority, and each step's median by stage index."""
        rows = list(self._enqueues)
        if not rows:
            return {"n": 0}
        names = []
        for *_, steps, _ in rows:
            names += [k for k in steps if k not in names]
        by: Dict[str, list] = {}
        engine: Dict[str, list] = {}
        for stage, prio, ms, _, result in rows:
            by.setdefault(f"s{stage}", []).append(ms)
            by.setdefault("hp" if prio == HP else "lp", []).append(ms)
            engine.setdefault("hp" if prio == HP else "lp", []).append(
                ms + result)
        return {"n": len(rows), "ms": _stats([r[2] for r in rows]),
                "steps": {k: _stats([r[3].get(k, 0.0) for r in rows])
                          for k in names},
                "result_ms": _stats([r[4] for r in rows]),
                "engine_ms": _stats([r[2] + r[4] for r in rows]),
                "engine_median_by": {k: _stats(v)["median"]
                                     for k, v in sorted(engine.items())},
                "median_by": {k: _stats(v)["median"]
                              for k, v in sorted(by.items())},
                "step_median_by_stage": {
                    f"s{j}": {k: _stats([r[3].get(k, 0.0) for r in rows
                                         if r[0] == j])["median"]
                              for k in names}
                    for j in sorted({r[0] for r in rows})}}

    def on_reconfigure(self) -> None:
        """New contexts mean new lanes: on the host path the pool grows to
        match; on the card each takes a free stream (the retired lanes'),
        and only the lanes beyond those get new streams, warmed on the
        engine thread before their first launch (``_rewarm``)."""
        if self._seam is None:
            self._ensure_pool()
            return
        new = [ln for ln in self._live_lanes() if ln not in self._streams]
        short = len(new) - len(self._free_streams())
        if short > 0:
            self._rewarm(short)
        for lane in new:
            self._lane_stream(lane)

    def running_set_changed(self) -> None:
        pass
