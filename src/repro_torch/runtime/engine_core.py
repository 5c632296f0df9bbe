# Copy of src/repro/runtime/engine_core.py; only this line differs (tests/test_torch_isolation.py checks it).
"""EngineCore: the one drive loop behind every DARIS deployment shape.

Historically the repo had two hand-rolled loops — the discrete-event
simulator and the wall-clock JAX executor — each re-implementing release,
dispatch, harvest, and metrics. EngineCore lifts that shared logic into a
single engine that talks to an ``ExecutionBackend`` (runtime/backend.py):
the backend owns *time* and *stage execution*, the core owns everything
the paper calls scheduling — admission (Eq. 11-12), release bookkeeping,
lane dispatch, MRET-feeding completions, fault/elastic events, metrics.

The loop is event-driven for both backends:

    t_evt = earliest pending timeline event (release / fault / scale-out)
    completions = backend.advance(min(t_evt, horizon))
    handle completions, else handle the due event
    dispatch free lanes; backend.running_set_changed()

``advance`` either returns stage completions that occur strictly before
the cap (virtual time jumps there; wall-clock time blocks until then) or
advances time to the cap and returns nothing. Construct via
``repro.api.DarisServer`` unless you are building a new backend.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..chaos.plan import BROWNOUT, EMERGENCY, NORMAL, ChaosState
from ..core.metrics import RunMetrics, empty_metrics, tenant_stats
from ..core.scheduler import DarisScheduler, Rejection
from ..core.task import HP, LP, Job, StageInstance, Task, TaskSpec
from .arrivals import ArrivalProcess

_seq = itertools.count()

# timeline event kinds; ordering at equal timestamps mirrors the historic
# simulator heap (releases before faults before scale-outs before
# repartitions before autoscaler checks). Whole-device failures sort WITH
# context faults — a fault and a reconfigure at the same instant must
# fail first, or the re-place would move tasks onto the dying device
# only to replay them one event later. Only relative order matters.
# CANCEL sits between RELEASE and FAULT: a release and its own cancel at
# the same instant must release first (the cancel then finds a live job),
# and a cancel racing a fault must unwind cleanly before the fault
# re-homes whatever survives.
# The chaos kinds (PR 8) sort after AUTOSCALE: RETRY re-dispatches a
# failed stage after its backoff, WATCHDOG audits one armed lane, CHAOS
# marks a brownout window edge (backend re-rate), DEGRADE is the
# degradation controller's periodic check.
(RELEASE, CANCEL, FAULT, FAIL_DEV, ADD_CTX, RECONFIG, AUTOSCALE,
 RETRY, WATCHDOG, CHAOS, DEGRADE) = range(11)

# kinds that never *represent* pending work: autoscale/degrade checks
# re-arm themselves forever, watchdogs are stale once their stage ends,
# brownout edges only re-rate. RETRY is NOT here — during its backoff a
# job's only token is the RETRY event, so idleness must see it.
_NON_WORK = frozenset((AUTOSCALE, WATCHDOG, CHAOS, DEGRADE))

_EPS = 1e-9


def _resolve_sanitizer(sanitize):
    """Normalize the ``sanitize`` knob to a Sanitizer instance or None.

    Accepts None (defer to the ``DARIS_SANITIZE`` environment), bools,
    an int level, or a pre-built ``analysis.Sanitizer``. The analysis
    package is imported lazily and only when enabling — a disabled
    engine never even loads it, and every hook site below is a single
    ``is not None`` test (the zero-overhead contract)."""
    if sanitize is None:
        if os.environ.get("DARIS_SANITIZE", "") in ("", "0"):
            return None
        from ..analysis.sanitizer import Sanitizer
        return Sanitizer.from_env()
    if sanitize is False or sanitize == 0:
        return None
    if sanitize is True:
        from ..analysis.sanitizer import Sanitizer
        return Sanitizer()
    if isinstance(sanitize, int):
        from ..analysis.sanitizer import Sanitizer
        return Sanitizer(level=sanitize)
    return sanitize


@dataclasses.dataclass
class FaultPlan:
    """Injectable fault / elastic events (DESIGN.md §7).

    ``reconfigure_at`` holds timed online repartitions: each entry is
    ``(t_ms, kwargs)`` where kwargs are forwarded to
    ``DarisScheduler.reconfigure`` (n_contexts / n_streams /
    oversubscription — plus n_gpus under the cluster layer; omitted
    fields keep their current value). ``fail_device_at`` kills a whole
    GPU (cluster servers only): every in-flight stage on it is
    cancelled and its tasks re-place onto surviving devices."""
    fail_ctx_at: Optional[Tuple[int, float]] = None   # (ctx, t_ms)
    add_ctx_at: Optional[float] = None
    reconfigure_at: Optional[List[Tuple[float, Dict]]] = None
    fail_device_at: Optional[Tuple[int, float]] = None   # (device, t_ms)


@dataclasses.dataclass
class AutoscalePolicy:
    """Utilization-driven elastic policy over ``scheduler.reconfigure``.

    Every ``check_every_ms`` the engine reads the Eq. 12 headroom of each
    live context — used fraction = (U_h + U_l,a) / N_s, i.e. how much of
    ``remaining_util`` the active load consumes — and averages it. Above
    ``high`` the partition grows by one context; below ``low`` it shrinks
    by one (within [min_contexts, max_contexts], at most one decision per
    ``cooldown_ms``). Each decision re-derives Eq. 9 geometry for the new
    count, so grow/shrink reshapes every context, not just the edge one.
    """
    low: float = 0.3
    high: float = 0.85
    check_every_ms: float = 250.0
    min_contexts: int = 1
    max_contexts: int = 8
    cooldown_ms: float = 500.0


@dataclasses.dataclass
class Completion:
    """One finished stage execution, reported by a backend. ``failed``
    marks a chaos-injected transient stage fault: the full execution
    time was paid but the result is garbage — the engine must retry or
    abort instead of advancing the pipeline. Always False with no
    ``ChaosPlan`` installed."""
    lane: tuple
    inst: StageInstance
    et_ms: float
    failed: bool = False


class SubmitHandle:
    """Outcome tracker for one submitted request — the job-state
    vocabulary shared by in-process callers and the serving daemon.

    Lifecycle::

        pending -> rejected                       (Eq. 11-12 said no)
                -> queued -> running -> completed (on time)
                                     -> missed    (finished late)
                -> cancelled                      (client cancel, any
                                                   pre-terminal state)
                -> aborted                        (chaos layer gave up:
                                                   retries exhausted or
                                                   deadline-aware bail)

    ``queued`` means admitted and waiting in the stage queue; ``running``
    means the job's first stage has dispatched. ``missed`` jobs still
    completed (soft real-time) — their ``response_ms`` is valid.
    ``ADMITTED`` is the historic alias for ``queued``."""

    PENDING = "pending"
    REJECTED = "rejected"
    QUEUED = "queued"
    ADMITTED = QUEUED              # pre-serving name, kept for callers
    RUNNING = "running"
    COMPLETED = "completed"
    MISSED = "missed"
    CANCELLED = "cancelled"
    ABORTED = "aborted"
    TERMINAL = frozenset((REJECTED, COMPLETED, MISSED, CANCELLED,
                          ABORTED))

    def __init__(self, task: Task, tenant: Optional[str] = None,
                 at_ms: float = 0.0):
        self.task = task
        self.tenant = tenant
        self.at_ms = at_ms              # requested release time
        self.status = self.PENDING
        self.job: Optional[Job] = None
        # actual admission timestamp — the identity the cancel machinery
        # resolves against (job.release_ms for primaries, the member's
        # extra_release_ms entry for coalesced joins)
        self.release_ms: Optional[float] = None
        self.response_ms: Optional[float] = None
        self._cancelled = False

    @property
    def done(self) -> bool:
        return self.status in self.TERMINAL

    def result(self) -> Dict:
        """Poll-friendly view (what the daemon's ``status``/``result``
        verbs serialize)."""
        return {"task": self.task.name, "tenant": self.tenant,
                "status": self.status, "at_ms": self.at_ms,
                "release_ms": self.release_ms,
                "response_ms": self.response_ms}

    def __repr__(self) -> str:
        return f"SubmitHandle({self.task.name}: {self.status})"


class EngineCore:
    """Shared release/dispatch/harvest/metrics loop over a backend."""

    def __init__(self, sched: DarisScheduler, backend, *,
                 horizon_ms: float,
                 arrivals: Optional[Dict[int, ArrivalProcess]] = None,
                 seed: int = 0,
                 fault_plan: Optional[FaultPlan] = None,
                 autoscale: Optional[AutoscalePolicy] = None,
                 record_decisions: bool = False,
                 sanitize=None, chaos=None):
        self.sched = sched
        self.backend = backend
        self.horizon = horizon_ms
        self.rng = np.random.default_rng(seed)
        self.metrics = empty_metrics(horizon_ms)
        self.fault_plan = fault_plan
        self.autoscale = autoscale
        # chaos layer (repro.chaos): ChaosPlan or pre-built ChaosState;
        # None keeps every hook below a bare is-not-None test (twin-path)
        if chaos is None or isinstance(chaos, ChaosState):
            self._chaos: Optional[ChaosState] = chaos
        else:
            self._chaos = ChaosState(chaos)
        # job_id -> (job, inst) parked between a transient stage fault
        # and its RETRY event (the job's only work token meanwhile)
        self._retry_wait: Dict[int, tuple] = {}
        self._last_scale_ms = -math.inf
        self.decisions: Optional[List[str]] = [] if record_decisions else None
        # task.index -> arrival process (tasks without one never self-release)
        self.arrivals: Dict[int, ArrivalProcess] = dict(arrivals or {})
        # job_id -> handles riding that job (primary first, then coalesced
        # members in join order); every handle ever issued, for per-tenant
        # accounting at finalize
        self._job_handles: Dict[int, List[SubmitHandle]] = {}
        self._all_handles: List[SubmitHandle] = []
        self._serving = False
        # per-device completion counters (cluster schedulers only; None
        # on a single device so the completion hot path pays one check)
        self._dev_stats: Optional[Dict[int, Dict]] = (
            {} if hasattr(sched, "workers") else None)
        self._timeline: List[tuple] = []   # (t, kind, seq, payload)
        # pending non-AUTOSCALE timeline entries: autoscale checks re-arm
        # themselves forever, so idleness must not scan the heap for them
        self._work_events = 0
        self._ran = False
        # DSAN invariant auditor (analysis/sanitizer.py); None when off —
        # the hook sites below are then a bare attribute test
        self._sanitizer = _resolve_sanitizer(sanitize)

    # ------------------------------------------------------------ plumbing
    def _push(self, t: float, kind: int, payload) -> None:
        if kind not in _NON_WORK:
            self._work_events += 1
        entry = (t, kind, next(_seq), payload)
        heapq.heappush(self._timeline, entry)
        if self._sanitizer is not None:
            self._sanitizer.note_push(t, kind, entry[2])

    def _log(self, msg: str) -> None:
        if self.decisions is not None:
            self.decisions.append(msg)

    def now_ms(self) -> float:
        return self.backend.now_ms()

    # ---------------------------------------------------------- public API
    def submit(self, spec: TaskSpec, at_ms: float = 0.0,
               tenant: Optional[str] = None) -> SubmitHandle:
        """Register a one-shot job release at ``at_ms`` (before run())."""
        if self._ran:
            raise RuntimeError("EngineCore.run() already executed")
        if at_ms > self.horizon:
            raise ValueError(
                f"submit at_ms={at_ms} is beyond the horizon "
                f"({self.horizon} ms): the release would never fire and "
                f"the handle would stay PENDING forever")
        task = self.sched.add_task(spec)
        handle = SubmitHandle(task, tenant=tenant, at_ms=at_ms)
        self._all_handles.append(handle)
        self._push(at_ms, RELEASE, (task, None, handle))
        return handle

    def submit_release(self, task: Task, at_ms: float,
                       tenant: Optional[str] = None) -> SubmitHandle:
        """Schedule one release of an EXISTING task (the serving path:
        tasks are registered once, requests arrive as releases — MRET
        history and batch coalescing accumulate across requests). Legal
        before run() and, unlike ``submit``, while serving."""
        if self._ran and not self._serving:
            raise RuntimeError("EngineCore.run() already executed")
        if at_ms > self.horizon:
            raise ValueError(
                f"submit_release at_ms={at_ms} is beyond the horizon "
                f"({self.horizon} ms)")
        handle = SubmitHandle(task, tenant=tenant, at_ms=at_ms)
        self._all_handles.append(handle)
        self._push(at_ms, RELEASE, (task, None, handle))
        return handle

    def submit_cancel(self, handle: SubmitHandle, at_ms: float) -> None:
        """Schedule a cancellation of ``handle``'s submission at
        ``at_ms`` (same clock as releases; a release and its cancel at
        the same instant release first)."""
        if self._ran and not self._serving:
            raise RuntimeError("EngineCore.run() already executed")
        self._push(at_ms, CANCEL, handle)

    def run(self, until_idle: bool = False) -> RunMetrics:
        self._begin()
        while self._step(until_idle, None):
            pass
        return self._finalize()

    # ------------------------------------------------------- serving mode
    def begin_serving(self) -> None:
        """Arm the engine for incremental driving: seed the timeline and
        start the backend, but advance nothing. Drive with ``pump``;
        close with ``end_serving``. Used by the ops daemon, where
        requests arrive while the engine runs."""
        self._serving = True
        self._begin()

    def pump(self, frontier_ms: Optional[float] = None) -> None:
        """Process everything actionable at or before ``frontier_ms``,
        then return. "Actionable" = a timeline event is due or a launched
        stage can finish; on a virtual-time backend the clock only ever
        moves to such instants, so an idle server's clock PAUSES at the
        frontier instead of slamming to the horizon. ``None`` uses the
        backend's current wall clock (realtime serving)."""
        if frontier_ms is None:
            frontier_ms = self.backend.now_ms()
        while self._step(False, frontier_ms):
            pass

    def serving_idle(self) -> bool:
        """No queued work, nothing in flight, no pending submissions."""
        return self._idle()

    def end_serving(self, until_idle: bool = True) -> RunMetrics:
        """Stop serving and finalize metrics. ``until_idle`` drains: the
        engine keeps driving (no frontier) until all accepted work
        finishes — the daemon's graceful-drain path."""
        if until_idle:
            while self._step(True, None):
                pass
        return self._finalize()

    # ---------------------------------------------------------- drive loop
    def _begin(self) -> None:
        if self._ran:
            raise RuntimeError("EngineCore.run() already executed")
        self._ran = True
        self.backend.bind(self)
        self.backend.start()
        # seed the timeline: first release per task, then injected events
        for task in self.sched.tasks:
            proc = self.arrivals.get(task.index)
            if proc is None:
                continue
            t0 = proc.start(task.spec, self.rng)
            if t0 is not None and t0 <= self.horizon:
                self._push(t0, RELEASE, (task, proc, None))
        fp = self.fault_plan
        if fp and fp.fail_ctx_at:
            self._push(fp.fail_ctx_at[1], FAULT, fp.fail_ctx_at[0])
        if fp and fp.fail_device_at:
            self._push(fp.fail_device_at[1], FAIL_DEV, fp.fail_device_at[0])
        if fp and fp.add_ctx_at is not None:
            self._push(fp.add_ctx_at, ADD_CTX, None)
        if fp and fp.reconfigure_at:
            for t_ms, kwargs in fp.reconfigure_at:
                self._push(t_ms, RECONFIG, dict(kwargs))
        if self.autoscale is not None:
            self._push(self.autoscale.check_every_ms, AUTOSCALE, None)
        if self._chaos is not None:
            for t in self._chaos.brownout_edges():
                if t <= self.horizon:
                    self._push(t, CHAOS, None)
            deg = self._chaos.plan.degradation
            if deg is not None:
                self._push(deg.check_every_ms, DEGRADE, None)

    def _step(self, until_idle: bool, frontier: Optional[float]) -> bool:
        """One drive iteration. Returns False when the loop should stop:
        idle (when asked), horizon reached, nothing can ever happen again
        — or, in serving mode, nothing is actionable at or before the
        frontier (the pump pauses; more submissions may arm it again)."""
        if until_idle and self._idle():
            return False          # before advancing time to the horizon
        t_evt = self._timeline[0][0] if self._timeline else math.inf
        if frontier is not None:
            nxt = min(t_evt, self.backend.peek_eta())
            if nxt == math.inf or nxt > frontier:
                # pause — never advance past the frontier. The pause is a
                # serving daemon's steady state, so this is also where the
                # backend gets its housekeeping window: a churny
                # cancel-heavy workload leaves stale finish predictions
                # behind, and running_set_changed (the batch-run
                # compaction site) will not run again until new work
                # arms the pump.
                compact = getattr(self.backend, "maybe_compact", None)
                if compact is not None:
                    compact()
                return False
        cap = min(t_evt, self.horizon)
        if frontier is not None and not self.backend.virtual_time:
            cap = min(cap, frontier)   # wall clock: don't block past it
        completions = self.backend.advance(cap)
        now = self.backend.now_ms()
        if completions:
            for c in completions:
                self._on_completion(c)
        elif (self._timeline and t_evt <= self.horizon
              and now >= t_evt - 1e-6):
            t, kind, seq, payload = heapq.heappop(self._timeline)
            if kind not in _NON_WORK:
                self._work_events -= 1
            if self._sanitizer is not None:
                self._sanitizer.note_pop(t, kind, seq, now)
            if kind == RELEASE:
                self._handle_release(payload[0], payload[1], t, payload[2])
            elif kind == CANCEL:
                self._handle_cancel(payload)
            elif kind == FAULT:
                self._handle_fault(payload)
            elif kind == FAIL_DEV:
                self._handle_fail_device(payload)
            elif kind == ADD_CTX:
                self.sched.add_context(now)
                self._log(f"scale-out ctx{len(self.sched.contexts) - 1}")
            elif kind == RECONFIG:
                self._handle_reconfigure(now, payload)
            elif kind == AUTOSCALE:
                self._handle_autoscale(now)
            elif kind == RETRY:
                self._handle_retry(now, payload)
            elif kind == WATCHDOG:
                self._handle_watchdog(now, payload)
            elif kind == CHAOS:
                self._handle_chaos_edge()
            elif kind == DEGRADE:
                self._handle_degrade(now)
        elif now >= self.horizon - _EPS:
            return False
        elif not self._timeline and not self.backend.has_inflight():
            return False    # nothing can ever happen again
        # tell the scheduler when this loop is guaranteed to run again
        # (lazy batch-head holds must release before then)
        self.sched.next_wake_ms = (self._timeline[0][0]
                                   if self._timeline else math.inf)
        self._dispatch()
        self.backend.running_set_changed()
        if self._sanitizer is not None:
            self._sanitizer.after_step(self)
        return True

    def _finalize(self) -> RunMetrics:
        # horizon sweep: jobs still queued/in-flight are real work the run
        # accepted — count them, and count the ones already past their
        # deadline as missed (otherwise overload DMR is understated by
        # exactly the jobs the horizon cut off)
        end_ms = self.backend.now_ms()
        for jobs in self.sched.active_jobs.values():
            for job in jobs:
                p = job.task.priority
                self.metrics.unfinished[p] += 1
                if end_ms > job.abs_deadline_ms:
                    self.metrics.missed[p] += 1
                    if self._dev_stats is not None:
                        # per-device misses must agree with the global
                        # sweep: attribute the late job to its home
                        ds = self._dev_stats.setdefault(
                            job.ctx[0], {"completed": {HP: 0, LP: 0},
                                         "missed": {HP: 0, LP: 0}})
                        ds["missed"][p] += 1
        self.metrics.migrations = self.sched.migrations
        for p, n in self.sched.rejected_counts.items():
            self.metrics.rejected[p] += n
        if self._dev_stats is not None:
            # every device appears — zeros included — so cluster
            # summaries always carry per_device/transfers even when a
            # short run completed nothing
            for d in self.sched.workers:
                self._dev_stats.setdefault(
                    d, {"completed": {HP: 0, LP: 0},
                        "missed": {HP: 0, LP: 0}})
            self.metrics.per_device = {
                d: {"completed": dict(s["completed"]),
                    "missed": dict(s["missed"])}
                for d, s in sorted(self._dev_stats.items())}
            self.metrics.transfers = getattr(self.sched, "transfers", 0)
        if any(h.tenant is not None for h in self._all_handles):
            self.metrics.per_tenant = tenant_stats(self._all_handles)
        if self._serving:
            # a serving engine's configured horizon is a far-future guard,
            # not the observation window: rate metrics (jps) divide by the
            # time actually served
            self.metrics.horizon_ms = max(end_ms, _EPS)
        if self._sanitizer is not None:
            self._sanitizer.on_finalize(self)
        self.backend.stop()
        return self.metrics

    # -------------------------------------------------------- event handlers
    def _handle_release(self, task: Task, proc: Optional[ArrivalProcess],
                        sched_t: float,
                        handle: Optional[SubmitHandle] = None) -> None:
        """``sched_t`` is when this release was *scheduled*; wall-clock
        backends may observe ``now > sched_t``, and the periodic successor
        must be anchored to the schedule, not the observation."""
        now = self.backend.now_ms()
        if handle is not None and handle._cancelled:
            # cancelled before it ever released: the submission never
            # reaches the scheduler (accounting happened at cancel time)
            self._log(f"release {task.name} skipped (cancelled)")
            return
        if (self._chaos is not None and task.priority == LP
                and self._chaos.mode != NORMAL):
            # degradation shed (BROWNOUT/EMERGENCY): LP refused at the
            # door — books it as a rejection everywhere the admission
            # path would, plus the dedicated shed counter
            self.sched.rejections.append(Rejection(task.name, now, LP))
            self.sched.rejected_counts[LP] += 1
            self.metrics.shed[LP] += 1
            self._log(f"shed {task.name} ({self._chaos.mode})")
            if handle is not None:
                handle.status = SubmitHandle.REJECTED
            if self._sanitizer is not None:
                self._sanitizer.note_release(LP, "rejected")
        else:
            pre_coalesced = self.sched.coalesced
            job = self.sched.on_release(task, now)
            if job is None:
                self._log(f"reject {task.name}")
                if handle is not None:
                    handle.status = SubmitHandle.REJECTED
            else:
                if self.sched.coalesced > pre_coalesced:
                    self._log(f"batch {task.name} -> ctx{job.ctx} "
                              f"b={job.n_inputs}")
                else:
                    self._log(f"admit {task.name} -> ctx{job.ctx}")
                if handle is not None:
                    handle.status = SubmitHandle.QUEUED
                    handle.job = job
                    # a coalesced join's member release stamp is ``now``
                    # (the value on_release appended to
                    # extra_release_ms), same as a primary's
                    # job.release_ms — either way the handle's identity
                    # for cancellation is (task.index, now)
                    handle.release_ms = now
                    if job.start_ms is not None:
                        handle.status = SubmitHandle.RUNNING
                    self._job_handles.setdefault(job.job_id,
                                                 []).append(handle)
            if self._sanitizer is not None:
                outcome = ("rejected" if job is None else
                           "coalesced"
                           if self.sched.coalesced > pre_coalesced
                           else "admitted")
                self._sanitizer.note_release(task.priority, outcome)
        if proc is not None:
            nxt, skipped = proc.next_after(sched_t, now)
            if skipped:
                self.metrics.skipped_releases += skipped
            if nxt is not None and nxt <= self.horizon:
                self._push(nxt, RELEASE, (task, proc, None))

    def _handle_cancel(self, handle: SubmitHandle) -> str:
        """CANCEL event: retire one submission. Returns the scheduler
        outcome (see ``DarisScheduler.cancel_job``) for daemon replies;
        terminal handles no-op ("absent" = already finished)."""
        now = self.backend.now_ms()
        if handle.status == SubmitHandle.CANCELLED:
            return "noop"
        if handle.done:
            return "absent"
        p = handle.task.priority
        if handle.job is None:
            # not yet released: mark it so the pending RELEASE skips
            handle._cancelled = True
            handle.status = SubmitHandle.CANCELLED
            self.metrics.cancelled[p] += 1
            self._log(f"cancel {handle.task.name} (unreleased)")
            if self._sanitizer is not None:
                self._sanitizer.note_cancel("cancelled", p, False)
            return "cancelled"
        outcome, job = self.sched.cancel_job(
            handle.task.index, handle.release_ms, now)
        if outcome in ("cancelled", "cancelling", "detached", "dropped"):
            handle._cancelled = True
            handle.status = SubmitHandle.CANCELLED
            self.metrics.cancelled[p] += 1
            if outcome == "cancelled":
                # whole job retired while queued: no completion will ever
                # arrive for it — clean backend job state now
                self.backend.on_job_done(job)
                self._job_handles.pop(job.job_id, None)
            self._log(f"cancel {handle.task.name} ({outcome})")
            if self._sanitizer is not None:
                self._sanitizer.note_cancel(outcome, p,
                                            outcome == "cancelled")
        else:
            self._log(f"cancel {handle.task.name} ({outcome})")
        return outcome

    def _handle_fault(self, ctx_idx: int) -> None:
        now = self.backend.now_ms()
        if hasattr(self.sched, "workers"):
            if ctx_idx[0] not in self.sched.live_devices():
                # cluster fail_context no-ops on a dead device; don't
                # count a fault that never happened (mirrors
                # _handle_fail_device)
                self._log(f"fault ctx{ctx_idx} (device already dead)")
                return
            if ctx_idx not in self.sched.queues:
                # a planned fault can name a context the elastic
                # machinery never minted (scale_out picks the
                # least-loaded device) — compose gracefully, like
                # faults on absent devices
                self._log(f"fault ctx{ctx_idx} skipped (no such context)")
                return
        esc = getattr(self.sched, "fault_escalates_to", None)
        dev = esc(ctx_idx) if esc is not None else None
        if dev is not None and self.sched.live_devices() == [dev]:
            # last-context fault escalating on the fleet's sole survivor
            # — skip rather than abort, like _handle_fail_device
            self._log(f"fault ctx{ctx_idx} skipped (would fail last "
                      f"live device)")
            return
        for key in self.sched.fault_cancel_keys(ctx_idx):
            self.backend.cancel_ctx(key)
        self.sched.fail_context(ctx_idx, now)
        self.metrics.faults += 1
        self._log(f"fault ctx{ctx_idx}")

    def _handle_fail_device(self, dev: int) -> None:
        """Whole-GPU failure (cluster servers): cancel every in-flight
        stage on the device, then let the cluster scheduler re-place its
        tasks HP-first onto the survivors (cross-GPU migration). A
        device the elastic machinery already retired/failed is a no-op —
        fault plans legitimately compose with autoscalers that may have
        shrunk that device away first."""
        now = self.backend.now_ms()
        live = self.sched.live_devices()
        if dev not in live:
            self._log(f"fault device{dev} (already dead)")
            return
        if live == [dev]:
            # an autoscaler/reconfigure shrink can leave the planned
            # victim as the sole survivor; losing it means no fleet at
            # all — skip the fault rather than abort the run
            self._log(f"fault device{dev} skipped (last live device)")
            return
        for key in self.sched.device_ctx_keys(dev):
            self.backend.cancel_ctx(key)
        self.sched.fail_device(dev, now)
        self.metrics.faults += 1
        self._log(f"fault device{dev}")

    def _handle_reconfigure(self, now: float, kwargs: Dict) -> None:
        info = self.sched.reconfigure(now, **kwargs)
        self.metrics.reconfigures += 1
        self._last_scale_ms = now
        hook = getattr(self.backend, "on_reconfigure", None)
        if hook is not None:
            hook()
        self._log(f"reconfigure retired={info['retired']} "
                  f"created={info['created']} rehomed={info['rehomed']} "
                  f"inflight={info['inflight']}")

    def _handle_autoscale(self, now: float) -> None:
        pol = self.autoscale
        live = self.sched.live_contexts()
        n_live = len(live)
        if n_live and now - self._last_scale_ms >= pol.cooldown_ms:
            used = [(self.sched.util_hp_total(c.index, now)
                     + self.sched.util_lp_active(c.index, now))
                    / max(c.n_streams, 1) for c in live]
            mean_used = sum(used) / n_live
            # the scale unit is scheduler-defined: contexts on one
            # device, whole GPUs under the cluster layer — min/max
            # bounds are counted in that same unit
            n_units = self.sched.scale_units()
            if mean_used > pol.high and n_units < pol.max_contexts:
                self._log(f"autoscale grow (used={mean_used:.2f})")
                self._handle_reconfigure(
                    now, self.sched.scale_kwargs(n_units + 1))
            elif mean_used < pol.low and n_units > pol.min_contexts:
                self._log(f"autoscale shrink (used={mean_used:.2f})")
                self._handle_reconfigure(
                    now, self.sched.scale_kwargs(n_units - 1))
        nxt = now + pol.check_every_ms
        if nxt <= self.horizon:
            self._push(nxt, AUTOSCALE, None)

    # ------------------------------------------------- chaos layer (PR 8)
    def _on_stage_failed(self, c: Completion, now: float) -> None:
        """A transient stage fault surfaced at completion time: the full
        execution time was paid but the result is garbage. Decide retry
        (backoff on the virtual clock, RETRY event) vs abort (attempts
        exhausted, or deadline-aware give-up). Failed stages never reach
        ``on_stage_finish`` — no MRET observation, no pipeline advance,
        no inter-stage state commit."""
        inst = c.inst
        job = inst.job
        p = job.task.priority
        self.metrics.chaos_faults += 1
        inst.attempts += 1
        pol = self._chaos.plan.retry
        delay = pol.delay_ms(inst.attempts)
        give_up = inst.attempts >= pol.max_attempts
        if not give_up and pol.deadline_aware and inst.smret is not None:
            # even an immediately-successful retry lands at now + delay +
            # predicted stage time; past the job's absolute deadline the
            # retry only burns device time a live job could use
            pred = inst.smret.value() * inst.cost_b
            spd = getattr(self.sched, "speed", 1.0)
            if spd != 1.0:
                pred /= spd
            if now + delay + pred > job.abs_deadline_ms:
                give_up = True
        if give_up:
            self._abort_job(job, now, p)
            return
        self.metrics.retries += 1
        inst.work_done = 0.0
        inst.lane = None
        inst.start_ms = None
        self._retry_wait[job.job_id] = (job, inst)
        self._push(now + delay, RETRY, job.job_id)
        self._log(f"retry {job.task.name} s{job.stage_idx} "
                  f"attempt={inst.attempts} delay={delay:.2f}")

    def _abort_job(self, job: Job, now: float, p: int) -> None:
        """Give up on a transiently-failing job: it leaves the scheduler
        immediately (unwinding the Eq. 12 charge) and every handle riding
        it goes terminal ABORTED. Neither completed nor missed nor
        cancelled — ``metrics.aborted`` is its own bucket."""
        self.sched.abort_job(job, now)
        self.backend.on_job_done(job)
        self.metrics.aborted[p] += 1
        self._log(f"abort {job.task.name} s{job.stage_idx}")
        if self._sanitizer is not None:
            self._sanitizer.note_abort(p)
        handles = self._job_handles.pop(job.job_id, None)
        if handles:
            for h in handles:
                if h._cancelled or h.done:
                    continue
                h.status = SubmitHandle.ABORTED

    def _handle_retry(self, now: float, job_id: int) -> None:
        """RETRY event: the backoff elapsed — re-enqueue the failed
        stage at the boundary (normal dispatch then re-launches it; a
        migration may re-home it exactly like any queued stage)."""
        entry = self._retry_wait.pop(job_id, None)
        if entry is None:
            return                 # aborted/cancelled away meanwhile
        job, inst = entry
        if job.cancelled:
            # the cancel landed during the backoff ("cancelling"): this
            # boundary is where the job retires — same bookkeeping as the
            # in-flight boundary retirement in _on_completion
            self.sched.abort_job(job, now)
            self.backend.on_job_done(job)
            if self._sanitizer is not None:
                self._sanitizer.note_job_done(job)
            self._job_handles.pop(job.job_id, None)
            self._log(f"retire {job.task.name} (cancelled during retry)")
            return
        self.sched.queues[job.ctx].push(inst)
        self._log(f"redispatch {job.task.name} s{job.stage_idx}")

    def _handle_watchdog(self, now: float, payload) -> None:
        """WATCHDOG event: the lane armed at dispatch time has been
        running longer than k x its predicted MRET. Kill the backend
        entry and re-dispatch the stage at the boundary via the existing
        zero-delay migration path (mirrors the sim straggler kill, but
        works on any backend — it is the engine's own timeline)."""
        lane, inst, armed_ms = payload
        if self.sched.lanes.get(lane) is not inst \
                or inst.start_ms != armed_ms:  # dsan: ignore[DSAN003] — stamp identity, not arithmetic
            return                 # stale: the stage already finished
        job = inst.job
        self.backend.kill_lane(lane, inst)
        self.sched.lanes[lane] = None
        self.metrics.watchdog_kills += 1
        inst.work_done = 0.0
        inst.lane = None
        inst.start_ms = None
        old = job.ctx
        if job.task.fixed_ctx:
            tgt = job.task.ctx
        else:
            tgt = min((c.index for c in self.sched.live_contexts()),
                      key=lambda k: self.sched.migration_eta(
                          k, now, old, job))
            if tgt != old:
                self.sched.migrations += 1
        if job in self.sched.active_jobs.get(old, {}):
            del self.sched.active_jobs[old][job]
            self.sched.active_jobs[tgt][job] = None
        job.ctx = tgt
        self.sched.queues[tgt].push(inst)
        self._log(f"watchdog kill {job.task.name} s{job.stage_idx} "
                  f"lane({lane[0]},{lane[1]}) -> ctx{tgt}")

    def _handle_chaos_edge(self) -> None:
        """CHAOS event: a brownout window opened or closed — the backend
        must recompute rates so in-flight work picks the change up."""
        hook = getattr(self.backend, "on_chaos_edge", None)
        if hook is not None:
            hook()
        self._log("brownout edge")

    def _handle_degrade(self, now: float) -> None:
        """DEGRADE event: the degradation controller's periodic check.
        Reads the same utilization signal as the autoscaler, walks the
        NORMAL/BROWNOUT/EMERGENCY hysteresis, and applies the mode's
        side effects (batch widening; EMERGENCY sheds queued LP)."""
        ch = self._chaos
        pol = ch.plan.degradation
        live = self.sched.live_contexts()
        if live:
            used = [(self.sched.util_hp_total(c.index, now)
                     + self.sched.util_lp_active(c.index, now))
                    / max(c.n_streams, 1) for c in live]
            signal = sum(used) / len(live)
            mode = ch.mode
            if mode == NORMAL:
                new = (EMERGENCY if signal >= pol.emergency_enter else
                       BROWNOUT if signal >= pol.brownout_enter else
                       NORMAL)
            elif mode == BROWNOUT:
                new = (EMERGENCY if signal >= pol.emergency_enter else
                       NORMAL if signal < pol.brownout_exit else
                       BROWNOUT)
            else:  # EMERGENCY cools off in stages: -> BROWNOUT first
                new = (BROWNOUT if signal < pol.emergency_exit else
                       EMERGENCY)
            if ch.set_mode(now, new):
                self.metrics.degrade_transitions += 1
                self.sched.batch_widen = (pol.batch_widen
                                          if new != NORMAL else 1.0)
                self._log(f"degrade {ch.transitions[-1][1]} -> {new} "
                          f"(signal={signal:.2f})")
                if new == EMERGENCY:
                    self._shed_queued_lp(now)
        nxt = now + pol.check_every_ms
        if nxt <= self.horizon:
            self._push(nxt, DEGRADE, None)

    def _shed_queued_lp(self, now: float) -> None:
        """EMERGENCY entry: cancel every queued (not yet dispatched) LP
        job through the PR 6 cancellation path — members detach first,
        then the primary retires the whole job, so admission charges
        unwind and batch heads seal exactly as client cancels do.
        In-flight LP finishes (zero-delay semantics)."""
        victims = []
        for q in self.sched.queues.values():
            for inst in q.instances():
                job = inst.job
                if job.task.priority == LP and not job.cancelled:
                    victims.append(job)
        for job in victims:
            handles = self._job_handles.get(job.job_id)
            if handles:
                # handle-carried job: cancel each submission, members
                # before the primary (the final cancel retires the job
                # and does all the accounting _handle_cancel owns)
                for h in list(handles)[::-1]:
                    self._handle_cancel(h)
            else:
                # handle-less (periodic) job: same chain straight on the
                # scheduler — detach/drop the members, retire the primary
                for idx, rel in list(zip(job.extra_member_idx,
                                         job.extra_release_ms))[::-1]:
                    self.sched.cancel_job(idx, rel, now)
                outcome, _ = self.sched.cancel_job(
                    job.task.index, job.release_ms, now)
                if outcome == "cancelled":
                    self.backend.on_job_done(job)
                    if self._sanitizer is not None:
                        # not a client cancel (no submission to count):
                        # only the job-retired ledger moves
                        self._sanitizer.note_cancel("shed", LP, True)
            self.metrics.shed[LP] += 1
            self._log(f"emergency shed {job.task.name}")

    def _on_completion(self, c: Completion) -> None:
        now = self.backend.now_ms()
        job = c.inst.job
        stage = job.stage_idx
        self.sched.lanes[c.lane] = None
        if c.failed and self._chaos is not None and not job.cancelled:
            # chaos-injected transient fault: never feeds MRET, never
            # advances the pipeline (cancelled jobs retire normally — the
            # boundary retirement outranks the failure)
            self._on_stage_failed(c, now)
            return
        done = self.sched.on_stage_finish(c.inst, now, c.et_ms)
        self._log(f"finish {job.task.name} s{stage}")
        if done is None:
            return
        self.backend.on_job_done(done)
        if self._sanitizer is not None:
            self._sanitizer.note_job_done(done)
        handles = self._job_handles.pop(done.job_id, None)
        if done.cancelled:
            # in-flight cancel retired at this stage boundary: the cancel
            # event already did the accounting; nothing completed
            self._log(f"retire {done.task.name} (cancelled)")
            return
        p = done.task.priority
        if done.dropped_releases:
            # some members were cancelled after the batch sealed: their
            # inputs rode along physically but their results are
            # discarded — throughput/response accounting covers only the
            # survivors (the job itself still completed once)
            live = [r for r in done.release_times
                    if r not in done.dropped_releases]
        else:
            live = None     # hot path: historic accounting, bit-identical
        self.metrics.completed[p] += 1
        self.metrics.completed_inputs[p] += (done.n_inputs if live is None
                                             else len(live))
        if self._dev_stats is not None:
            # attribute to the job's HOME device (job.ctx), matching the
            # horizon sweep — the only base available for unfinished
            # jobs. After a zero-delay re-home the final stage may have
            # executed on the old device's lane; the completion still
            # credits the device now responsible for the job.
            dev = done.ctx[0]
            ds = self._dev_stats.setdefault(
                dev, {"completed": {HP: 0, LP: 0},
                      "missed": {HP: 0, LP: 0}})
            ds["completed"][p] += 1
            if now > done.abs_deadline_ms:
                ds["missed"][p] += 1
        b = done.n_inputs if live is None else len(live)
        self.metrics.batch_hist[b] = self.metrics.batch_hist.get(b, 0) + 1
        # each batched input gets its own response time, measured from its
        # own release (the head's deadline governed the whole batch)
        for r_ms in (done.release_times if live is None else live):
            self.metrics.response_ms[p].append(now - r_ms)
        if now > done.abs_deadline_ms:
            self.metrics.missed[p] += 1
        if handles:
            # every handle riding this job — the primary and coalesced
            # members (which may belong to other tasks under
            # scope="model") — finishes at its own response time; a late
            # finish against the handle's OWN release+deadline is MISSED
            # (still a completion: soft real-time)
            for h in handles:
                if h._cancelled:
                    continue    # detached/dropped member: stays cancelled
                h.response_ms = now - h.release_ms
                late = now > h.release_ms + h.task.spec.deadline_ms
                h.status = (SubmitHandle.MISSED if late
                            else SubmitHandle.COMPLETED)

    def _dispatch(self) -> None:
        now = self.backend.now_ms()
        sched = self.sched
        # only contexts whose queue holds work can yield a dispatch, and
        # popping never refills another queue, so lanes of cold contexts
        # are skipped up front (their pop would return None anyway).
        # Sorting the filtered subset preserves the historic sorted-lane
        # dispatch order among the lanes that matter.
        hot = getattr(sched, "hot_queues", None)
        if hot is not None:
            if not hot:
                return
            lanes = sorted(ln for ln in sched.lanes.free_set()
                           if ln[0] in hot)
        else:                          # custom scheduler without the index
            lanes = sched.free_lanes()
        for lane in lanes:
            inst = sched.next_for_lane(lane[0], now)
            if inst is None:
                continue
            inst.start_ms = now
            inst.work_done = 0.0
            inst.lane = lane
            self.sched.lanes[lane] = inst
            if inst.job.start_ms is None:
                # first dispatch of the job: queued -> running for every
                # handle riding it
                inst.job.start_ms = now
                for h in self._job_handles.get(inst.job.job_id, ()):
                    if h.status == SubmitHandle.QUEUED:
                        h.status = SubmitHandle.RUNNING
            self._log(f"dispatch {inst.task.name} s{inst.job.stage_idx} "
                      f"lane({lane[0]},{lane[1]})")
            self.backend.launch(lane, inst)
            if (self._chaos is not None
                    and self._chaos.plan.watchdog_kappa > 0.0
                    and inst.smret is not None):
                # arm the per-stage watchdog: k x predicted MRET (plus
                # any serialized transfer charge) from this dispatch. The
                # event self-invalidates if the stage finishes first
                # (lane occupant / start stamp check in _handle_watchdog)
                pred = inst.smret.value() * inst.cost_b
                t = (now + self._chaos.plan.watchdog_kappa * pred
                     + inst.transfer_ms)
                if t <= self.horizon:
                    self._push(t, WATCHDOG, (lane, inst, now))

    def _idle(self) -> bool:
        # autoscaler check events keep the timeline populated forever;
        # they are not work, so drain() must be able to idle past them
        if self._work_events:
            return False
        if self.backend.has_inflight():
            return False
        if any(len(q) for q in self.sched.queues.values()):
            return False
        return not any(self.sched.active_jobs[k]
                       for k in self.sched.active_jobs)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> dict:
        """Introspection for programmatic clients (live or post-run)."""
        now = self.backend.now_ms() if self._ran else 0.0
        snap = {
            "now_ms": now,
            "backend": type(self.backend).__name__,
            "contexts": [{"index": c.index, "alive": c.alive,
                          "cap": c.cap, "n_streams": c.n_streams}
                         for c in self.sched.contexts],
            "queue_depth": {k: len(q) for k, q in self.sched.queues.items()},
            "lanes_busy": sum(1 for i in self.sched.lanes.values()
                              if i is not None),
            "active_jobs": {k: len(v)
                            for k, v in self.sched.active_jobs.items()},
            "completed": dict(self.metrics.completed),
            "completed_inputs": dict(self.metrics.completed_inputs),
            "batch_hist": dict(sorted(self.metrics.batch_hist.items())),
            "coalesced": self.sched.coalesced,
            "rejected": dict(self.sched.rejected_counts),
            "migrations": self.sched.migrations,
            "reconfigures": self.metrics.reconfigures,
            "skipped_releases": self.metrics.skipped_releases,
            # per-priority response-time percentiles over completions so
            # far (live monitoring reads tail latency without waiting for
            # the run summary)
            "resp_hp": self.metrics.resp_stats(HP),
            "resp_lp": self.metrics.resp_stats(LP),
            "cancelled": dict(self.metrics.cancelled),
        }
        if any(h.tenant is not None for h in self._all_handles):
            snap["tenants"] = tenant_stats(self._all_handles)
        summary = getattr(self.sched, "device_summary", None)
        if summary is not None:
            snap["devices"] = summary(now)
            snap["transfers"] = self.sched.transfers
            if self._dev_stats is not None:
                snap["device_completed"] = {
                    d: dict(s["completed"])
                    for d, s in sorted(self._dev_stats.items())}
        return snap
