# Copy of src/repro/analysis/sanitizer.py; only this line differs (tests/test_torch_isolation.py checks it).
"""DSAN runtime invariant auditor.

Every accounting identity the paper's math relies on is maintained
*incrementally* somewhere in the stack: Eq. 12 admission charges unwind
on cancel, MRET window maxima and task sums are memoized with
invalidate-on-observe, the LaneMap keeps free/busy indexes beside the
lane dict, StageQueue heaps cache per-instance estimator/cost fields,
and the cluster layer shares one lane/queue/job namespace across N
workers. The auditor recomputes all of it from scratch and cross-checks
the incremental state at a configurable cadence:

* Eq. 12 per-context utilization vs. a fresh sum over active jobs
  (including batch ``cost_b`` and cancel unwinds), recomputed from raw
  MRET windows — bypassing every memo.
* LaneMap ``_free``/``_busy_by_ctx``/``_dead`` forming an exact
  partition of the lane table, consistent with context liveness.
* StageQueue heap order, key correctness, and membership vs. the
  active-job table (every queued stage belongs to a live job on that
  context; every live job has exactly one live stage instance).
* Memoized ``StageMret._value`` / ``TaskMret._total`` /
  ``StageInstance.smret``/``cost_b`` / ``backlog_ms`` vs. recomputation.
* Virtual-clock monotonicity and timeline event-order legality
  (FAULT-before-RECONFIG, CANCEL-after-RELEASE at equal timestamps) —
  back-dated open-loop releases are *legal* (PoissonArrival pushes
  past-due successors by design), so legality is generation-qualified:
  a pop is a violation only if a larger key was popped while this event
  was already sitting in the heap.
* Cluster shared-table identity, ``_state_dev`` hygiene, per-device
  task registration, dead-device context liveness.
* Metrics conservation: admitted == completed + cancelled-retired +
  live, per priority — plus engine-vs-scheduler counter mirrors, handle
  status partition, and per-tenant submitted == completed + cancelled +
  rejected + pending.

Violations raise :class:`SanitizerViolation` carrying the divergent
values and the event cursor (step/pop counts, clock, last timeline
event); when ``DARIS_SANITIZE_REPORT_DIR`` is set each violation is
also written there as JSON (the CI artifact hook).

All checks are read-only up to idempotent memo fills (``value()`` on an
already-consistent estimator), so an audited run is bit-identical to an
unaudited one — the golden-fixture suites assert exactly that.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

from ..core.scheduler import DarisScheduler
from ..core.stage_queue import stage_level
from ..core.task import HP, LP
from ..core.metrics import tenant_stats
from ..runtime.contention import batch_cost
from ..runtime.engine_core import _NON_WORK, SubmitHandle

_KIND_NAMES = ("RELEASE", "CANCEL", "FAULT", "FAIL_DEV", "ADD_CTX",
               "RECONFIG", "AUTOSCALE", "RETRY", "WATCHDOG", "CHAOS",
               "DEGRADE")
# the engine's own never-early tolerance (engine_core._step pop condition)
_EARLY_SLACK_MS = 1e-6

_HANDLE_STATUSES = frozenset((
    SubmitHandle.PENDING, SubmitHandle.REJECTED, SubmitHandle.QUEUED,
    SubmitHandle.RUNNING, SubmitHandle.COMPLETED, SubmitHandle.MISSED,
    SubmitHandle.CANCELLED, SubmitHandle.ABORTED))


def _differs(expected: float, actual: float) -> bool:
    """Exact inequality. The sanitizer compares a memo against the very
    float expression that would refill it — same values, same operation
    order — so bit-equality is the contract, not a tolerance."""
    return expected != actual


def _fresh_stage_value(s) -> float:
    """``StageMret.value()`` recomputed from the raw window, no memo."""
    return max(s.window) if s.window else s.afet_ms


def _fresh_task_mret(m) -> float:
    """``TaskMret.task_mret()`` recomputed from raw windows, no memo."""
    return sum(_fresh_stage_value(s) for s in m.stages)


class SanitizerViolation(AssertionError):
    """A scheduler invariant failed its from-scratch recomputation.

    Carries the check name, the divergent expected/actual values, and
    the event cursor — enough to localize the drift without re-running
    under a debugger."""

    def __init__(self, check: str, message: str, *,
                 expected=None, actual=None,
                 cursor: Optional[Dict] = None):
        self.check = check
        self.expected = expected
        self.actual = actual
        self.cursor = dict(cursor or {})
        detail = f"DSAN {check}: {message}"
        if expected is not None or actual is not None:
            detail += f"\n  expected: {expected!r}\n  actual:   {actual!r}"
        if self.cursor:
            cur = ", ".join(f"{k}={v}" for k, v in
                            sorted(self.cursor.items()))
            detail += f"\n  cursor:   {cur}"
        super().__init__(detail)


class Sanitizer:
    """Runtime invariant auditor for one :class:`EngineCore` run.

    ``level=1`` audits every ``cadence`` engine steps (default 256);
    ``level>=2`` audits every step. Event hooks (push/pop/release/
    cancel/done) are O(1) and always on; the full audit is O(state).

    Environment activation (``Sanitizer.from_env``)::

        DARIS_SANITIZE=1|2          level (anything non-empty, non-0)
        DARIS_SANITIZE_CADENCE=N    audit every N steps (overrides level)
        DARIS_SANITIZE_REPORT_DIR=d write violation reports as JSON
    """

    DEFAULT_CADENCE = 256

    def __init__(self, level: int = 1, cadence: Optional[int] = None,
                 report_dir: Optional[str] = None):
        self.level = max(int(level), 1)
        if cadence is None:
            cadence = 1 if self.level >= 2 else self.DEFAULT_CADENCE
        self.cadence = max(int(cadence), 1)
        self.report_dir = report_dir
        self.steps = 0
        self.audits = 0
        self.violations = 0
        self._last_now = -math.inf
        self._last_event = None          # (t_ms, kind name) of last pop
        # event-order legality: heap-entry seq -> pop generation at push
        self._pending: Dict[int, int] = {}
        self._pops = 0
        self._max_key: Optional[tuple] = None   # largest (t, kind, seq) popped
        self._max_key_pop = 0                   # pop index that popped it
        # conservation mirrors (per priority), fed by the engine hooks
        self.admitted: Dict[int, int] = {HP: 0, LP: 0}
        self.coalesced_joins: Dict[int, int] = {HP: 0, LP: 0}
        self.rejected: Dict[int, int] = {HP: 0, LP: 0}
        self.completed: Dict[int, int] = {HP: 0, LP: 0}
        self.retired: Dict[int, int] = {HP: 0, LP: 0}   # whole-job cancels
        self.cancelled_subs: Dict[int, int] = {HP: 0, LP: 0}
        # chaos-layer give-ups (engine _abort_job): a fourth terminal
        # bucket in the job-conservation law
        self.aborted: Dict[int, int] = {HP: 0, LP: 0}

    @classmethod
    def from_env(cls) -> Optional["Sanitizer"]:
        """Build from ``DARIS_SANITIZE*`` variables; None when disabled."""
        raw = os.environ.get("DARIS_SANITIZE", "")
        if raw in ("", "0"):
            return None
        try:
            level = int(raw)
        except ValueError:
            level = 1
        cad = os.environ.get("DARIS_SANITIZE_CADENCE")
        return cls(level=level, cadence=int(cad) if cad else None,
                   report_dir=os.environ.get("DARIS_SANITIZE_REPORT_DIR"))

    # ------------------------------------------------------------- failure
    def _cursor(self, engine=None) -> Dict:
        cur = {"steps": self.steps, "pops": self._pops,
               "audits": self.audits, "level": self.level}
        if self._last_event is not None:
            cur["last_event"] = (f"{self._last_event[1]}"
                                 f"@{self._last_event[0]:.6f}ms")
        if engine is not None:
            cur["now_ms"] = engine.backend.now_ms()
        return cur

    def _fail(self, check: str, message: str, *, expected=None,
              actual=None, engine=None) -> None:
        self.violations += 1
        cursor = self._cursor(engine)
        self._write_report({"check": check, "message": message,
                            "expected": expected, "actual": actual,
                            "cursor": cursor})
        raise SanitizerViolation(check, message, expected=expected,
                                 actual=actual, cursor=cursor)

    def _write_report(self, payload: Dict) -> None:
        d = self.report_dir
        if not d:
            return
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"dsan-{os.getpid()}-{self.violations}.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=2, sort_keys=True, default=str)
        except OSError:
            pass       # reporting must never mask the violation itself

    # --------------------------------------------------------- event hooks
    def note_push(self, t: float, kind: int, seq: int) -> None:
        self._pending[seq] = self._pops

    def note_pop(self, t: float, kind: int, seq: int, now: float) -> None:
        self._pops += 1
        gen = self._pending.pop(seq, None)
        self._last_event = (t, _KIND_NAMES[kind])
        if t > now + _EARLY_SLACK_MS:
            self._fail(
                "event-never-early",
                f"{_KIND_NAMES[kind]} scheduled for t={t} fired at "
                f"now={now} — the engine dispatched an event before its "
                f"time", expected=f"now >= {t - _EARLY_SLACK_MS}",
                actual=now)
        key = (t, kind, seq)
        # legality: if a LARGER key was already popped while this entry
        # was sitting in the heap, the heap order (time, then kind:
        # RELEASE < CANCEL < FAULT < ... ) was broken. Entries pushed
        # *after* that pop (gen >= pop index) are legal — open-loop
        # Poisson successors are back-dated by design.
        if (self._max_key is not None and key < self._max_key
                and gen is not None and gen < self._max_key_pop):
            self._fail(
                "event-order",
                f"{_KIND_NAMES[kind]} (t={t}, seq={seq}) popped after "
                f"{_KIND_NAMES[self._max_key[1]]} (t={self._max_key[0]}, "
                f"seq={self._max_key[2]}) although both were queued "
                f"together — same-instant kind ordering "
                f"(RELEASE<CANCEL<FAULT<FAIL_DEV<ADD_CTX<RECONFIG) or "
                f"heap integrity is broken",
                expected=f"pop {key} before {self._max_key}",
                actual="reversed")
        if self._max_key is None or key > self._max_key:
            self._max_key = key
            self._max_key_pop = self._pops

    def note_release(self, priority: int, outcome: str) -> None:
        if outcome == "rejected":
            self.rejected[priority] += 1
        elif outcome == "coalesced":
            self.coalesced_joins[priority] += 1
        else:
            self.admitted[priority] += 1

    def note_job_done(self, job) -> None:
        p = job.task.priority
        if job.cancelled:
            self.retired[p] += 1       # in-flight cancel, boundary retire
        else:
            self.completed[p] += 1

    def note_cancel(self, outcome: str, priority: int,
                    job_retired: bool) -> None:
        # "shed" (degradation-controller emergency cancel of a handle-less
        # job) retires the job without any client submission to count
        if outcome in ("cancelled", "cancelling", "detached", "dropped"):
            self.cancelled_subs[priority] += 1
        if job_retired:
            self.retired[priority] += 1    # queued whole-job retirement

    def note_abort(self, priority: int) -> None:
        self.aborted[priority] += 1

    def after_step(self, engine) -> None:
        self.steps += 1
        now = engine.backend.now_ms()
        if now < self._last_now - 1e-9:
            self._fail("clock-monotonicity",
                       "backend clock moved backwards",
                       expected=f">= {self._last_now}", actual=now,
                       engine=engine)
        self._last_now = now
        if self.steps % self.cadence == 0:
            self.audit(engine)

    def on_finalize(self, engine) -> None:
        self.audit(engine)
        self._check_final_metrics(engine)

    # ----------------------------------------------------------- the audit
    def audit(self, engine) -> None:
        """Full from-scratch recomputation of every audited invariant."""
        self.audits += 1
        sched = engine.sched
        now = engine.backend.now_ms()
        self._check_lanes(sched, engine)
        self._check_queues(sched, engine)
        self._check_active_jobs(sched, engine)
        self._check_utilization(sched, now, engine)
        self._check_mret_memos(sched, engine)
        self._check_timeline(engine)
        self._check_backend_sync(sched, engine)
        if hasattr(sched, "workers"):
            self._check_cluster(sched, engine)
        self._check_conservation(sched, engine)
        self._check_handles(engine)

    # ---- lanes ----------------------------------------------------------
    def _check_lanes(self, sched, engine) -> None:
        lanes = sched.lanes
        free, busy_by_ctx, dead = lanes._free, lanes._busy_by_ctx, lanes._dead
        contexts = sched.contexts
        for lane, inst in lanes.items():
            ctx = lane[0]
            if ctx not in contexts:
                self._fail("lane-orphan-context",
                           f"lane {lane} references unknown context {ctx}",
                           engine=engine)
            if inst is None:
                want_free = ctx not in dead
                if (lane in free) != want_free:
                    self._fail(
                        "lanemap-free-index",
                        f"empty lane {lane} (ctx dead={ctx in dead}) "
                        f"free-index membership is wrong",
                        expected=want_free, actual=lane in free,
                        engine=engine)
                if lane in busy_by_ctx.get(ctx, {}):
                    self._fail("lanemap-busy-index",
                               f"empty lane {lane} still in busy index",
                               engine=engine)
            else:
                if lane in free:
                    self._fail("lanemap-free-index",
                               f"busy lane {lane} listed free",
                               engine=engine)
                if busy_by_ctx.get(ctx, {}).get(lane) is not inst:
                    self._fail(
                        "lanemap-busy-index",
                        f"busy lane {lane} missing or aliased in busy "
                        f"index", engine=engine)
                if inst.lane != lane:
                    self._fail(
                        "lanemap-inst-backref",
                        f"instance on lane {lane} believes it is on "
                        f"{inst.lane}", expected=lane, actual=inst.lane,
                        engine=engine)
        for ctx, busy in busy_by_ctx.items():
            for lane, inst in busy.items():
                if lanes.get(lane) is not inst:
                    self._fail("lanemap-busy-index",
                               f"busy index entry {lane} disagrees with "
                               f"lane table", engine=engine)
        for lane in free:
            if lane not in lanes or lanes[lane] is not None:
                self._fail("lanemap-free-index",
                           f"free index entry {lane} is not an empty lane",
                           engine=engine)
        for c in contexts:
            if c.alive and c.index in dead:
                self._fail("lanemap-dead-index",
                           f"live context {c.index} marked dead in "
                           f"LaneMap", engine=engine)
            if not c.alive and c.index not in dead:
                self._fail("lanemap-dead-index",
                           f"retired context {c.index} never retired in "
                           f"LaneMap", engine=engine)

    # ---- queues ---------------------------------------------------------
    def _check_queues(self, sched, engine) -> None:
        for k, q in sched.queues.items():
            heap = q._heap
            for i in range(1, len(heap)):
                if heap[i][0] < heap[(i - 1) // 2][0]:
                    self._fail(
                        "stagequeue-heap-order",
                        f"queue {k} heap property broken at index {i}",
                        expected=f">= {heap[(i - 1) // 2][0]}",
                        actual=heap[i][0], engine=engine)
            for key, inst in heap:
                job = inst.job
                level = stage_level(inst, q.qcfg)
                if key[0] != level:
                    self._fail(
                        "stagequeue-stale-level",
                        f"queued stage of {job.task.name} holds level "
                        f"{key[0]} but live state derives {level} "
                        f"(vdl_missed_prev / last-stage bit drifted "
                        f"after push)", expected=level, actual=key[0],
                        engine=engine)
                if _differs(key[1], inst.virtual_deadline_ms):
                    self._fail(
                        "stagequeue-stale-vdl",
                        f"queued stage of {job.task.name} sorted by vdl "
                        f"{key[1]} but carries {inst.virtual_deadline_ms} "
                        f"(mutated without re-push)",
                        expected=inst.virtual_deadline_ms, actual=key[1],
                        engine=engine)
                if inst.lane is not None:
                    self._fail("stagequeue-running-member",
                               f"queued stage of {job.task.name} claims "
                               f"lane {inst.lane}", engine=engine)
                if job.ctx != k:
                    self._fail(
                        "stagequeue-wrong-home",
                        f"stage of {job.task.name} queued on {k} but its "
                        f"job lives on {job.ctx}", expected=k,
                        actual=job.ctx, engine=engine)
                if job not in sched.active_jobs.get(k, {}):
                    self._fail(
                        "stagequeue-dead-member",
                        f"queued stage of {job.task.name} has no active "
                        f"job on {k} (leak or double retirement)",
                        engine=engine)
                if job.cancelled or job.finish_ms is not None:
                    self._fail(
                        "stagequeue-zombie",
                        f"finished/cancelled job of {job.task.name} "
                        f"still queued on {k}", engine=engine)
                self._check_inst_cache(inst, engine)
            self._check_backlog(q, k, engine)

    def _check_backlog(self, q, k, engine) -> None:
        fresh = 0.0
        for _, inst in q._heap:
            if inst.smret is None:
                return       # bare unit-test tasks carry no estimator
            fresh += (_fresh_stage_value(inst.smret)
                      * batch_cost(inst.profile, inst.job.n_inputs))
        actual = q.backlog_ms()
        if _differs(fresh, actual):
            self._fail(
                "backlog-memo",
                f"queue {k} backlog_ms diverges from scratch "
                f"recomputation (stale smret/cost_b cache)",
                expected=fresh, actual=actual, engine=engine)

    def _check_inst_cache(self, inst, engine) -> None:
        job = inst.job
        m = job.task.mret
        if inst.smret is None or m is None:
            return
        if inst.smret is not m.stages[job.stage_idx]:
            self._fail(
                "inst-smret-alias",
                f"stage instance of {job.task.name} caches an estimator "
                f"that is not its task's stage-{job.stage_idx} StageMret",
                engine=engine)
        expect = batch_cost(inst.profile, job.n_inputs)
        if _differs(inst.cost_b, expect):
            self._fail(
                "inst-cost-b",
                f"stage instance of {job.task.name} caches cost_b for a "
                f"different batch size than its job carries "
                f"(n_inputs={job.n_inputs}; detach/join without refresh)",
                expected=expect, actual=inst.cost_b, engine=engine)

    # ---- active jobs ----------------------------------------------------
    def _check_active_jobs(self, sched, engine) -> None:
        places: Dict[int, List] = {}
        for k, q in sched.queues.items():
            for _, inst in q._heap:
                places.setdefault(id(inst.job), []).append(("queued", k))
        for lane, inst in sched.lanes.items():
            if inst is not None:
                places.setdefault(id(inst.job), []).append(("lane", lane))
                self._check_inst_cache(inst, engine)
        active_ids = set()
        for k, jobs in sched.active_jobs.items():
            for job in jobs:
                active_ids.add(id(job))
                if job.ctx != k:
                    self._fail(
                        "active-jobs-wrong-home",
                        f"job of {job.task.name} registered under {k} "
                        f"but claims ctx {job.ctx}", expected=k,
                        actual=job.ctx, engine=engine)
                if job.finish_ms is not None:
                    self._fail(
                        "active-jobs-zombie",
                        f"finished job of {job.task.name} still active "
                        f"on {k}", engine=engine)
                where = places.get(id(job), [])
                if job.job_id in engine._retry_wait:
                    # parked between a transient stage fault and its
                    # RETRY event: the job legally has NO live instance
                    # (the pending RETRY is its work token)
                    if where:
                        self._fail(
                            "active-jobs-retry-wait",
                            f"retry-waiting job of {job.task.name} still "
                            f"has live stage instance(s) at {where}",
                            expected=0, actual=where, engine=engine)
                elif len(where) != 1:
                    self._fail(
                        "active-jobs-instance-count",
                        f"active job of {job.task.name} (stage "
                        f"{job.stage_idx}) must have exactly one live "
                        f"stage instance (queued xor on a lane)",
                        expected=1, actual=where or 0, engine=engine)
        for jid, where in places.items():
            if jid not in active_ids:
                self._fail(
                    "active-jobs-leak",
                    f"stage instance(s) at {where} belong to a job "
                    f"missing from every active set (retired without "
                    f"draining its work)", engine=engine)

    # ---- utilization (Eq. 12) ------------------------------------------
    def _worker_of(self, sched, k):
        return sched.workers[k[0]] if hasattr(sched, "workers") else sched

    def _check_utilization(self, sched, now: float, engine) -> None:
        for k in sched.active_jobs:
            w = self._worker_of(sched, k)
            u = 0.0
            computable = True
            for j in sched.active_jobs[k]:
                t = j.task
                if t.priority != LP:
                    continue
                if t.mret is None:
                    computable = False
                    break
                u += (_fresh_task_mret(t.mret) / t.spec.period_ms
                      * DarisScheduler.spec_batch_cost(t.spec, j.n_inputs))
            if computable:
                fresh = u if w.speed == 1.0 else u / w.speed
                actual = sched.util_lp_active(k, now)
                if _differs(fresh, actual):
                    self._fail(
                        "eq12-lp-utilization",
                        f"util_lp_active({k}) diverges from a fresh sum "
                        f"over active jobs (stale MRET memo or admission "
                        f"charge not unwound)", expected=fresh,
                        actual=actual, engine=engine)
            u = 0.0
            computable = True
            for t in w.tasks:
                if t.ctx == k and t.priority == HP:
                    if t.mret is None:
                        computable = False
                        break
                    u += _fresh_task_mret(t.mret) / t.spec.period_ms
            if computable:
                fresh = u if w.speed == 1.0 else u / w.speed
                actual = sched.util_hp_total(k, now)
                if _differs(fresh, actual):
                    self._fail(
                        "eq11-hp-utilization",
                        f"util_hp_total({k}) diverges from a fresh sum "
                        f"over registered tasks", expected=fresh,
                        actual=actual, engine=engine)

    # ---- MRET memos -----------------------------------------------------
    def _check_mret_memos(self, sched, engine) -> None:
        for t in sched.tasks:
            m = t.mret
            if m is None:
                continue
            for si, s in enumerate(m.stages):
                if s._value is None:
                    continue
                fresh = _fresh_stage_value(s)
                if _differs(s._value, fresh):
                    self._fail(
                        "mret-stage-memo",
                        f"{t.name} stage {si} StageMret._value diverges "
                        f"from its window (mutation without invalidate)",
                        expected=fresh, actual=s._value, engine=engine)
            if m._total is not None:
                fresh = sum(_fresh_stage_value(s) for s in m.stages)
                if _differs(m._total, fresh):
                    self._fail(
                        "mret-total-memo",
                        f"{t.name} TaskMret._total diverges from its "
                        f"stage sum (observe path skipped the "
                        f"invalidation)", expected=fresh, actual=m._total,
                        engine=engine)

    # ---- engine timeline ------------------------------------------------
    def _check_timeline(self, engine) -> None:
        tl = engine._timeline
        for i in range(1, len(tl)):
            if tl[i][:3] < tl[(i - 1) // 2][:3]:
                self._fail(
                    "timeline-heap-order",
                    f"engine timeline heap property broken at index {i}",
                    expected=f">= {tl[(i - 1) // 2][:3]}",
                    actual=tl[i][:3], engine=engine)
        n_work = sum(1 for e in tl if e[1] not in _NON_WORK)
        if n_work != engine._work_events:
            self._fail(
                "timeline-work-count",
                "engine _work_events counter diverges from the pending "
                "work-representing timeline entries (idle detection "
                "would stall or finish early)", expected=n_work,
                actual=engine._work_events, engine=engine)

    # ---- backend <-> scheduler sync ------------------------------------
    def _check_backend_sync(self, sched, engine) -> None:
        running = getattr(engine.backend, "running", None)
        if not isinstance(running, dict):
            return          # wall-clock backend: no introspectable set
        for lane, entry in running.items():
            if sched.lanes.get(lane) is not entry[0]:
                self._fail(
                    "backend-lane-sync",
                    f"backend executes an instance on {lane} that the "
                    f"LaneMap does not show there (ghost execution)",
                    engine=engine)
        for ctx, busy in sched.lanes._busy_by_ctx.items():
            for lane in busy:
                if lane not in running:
                    self._fail(
                        "backend-lane-sync",
                        f"LaneMap shows {lane} busy but the backend has "
                        f"no running entry for it (lost completion)",
                        engine=engine)

    # ---- cluster --------------------------------------------------------
    def _check_cluster(self, sched, engine) -> None:
        for d, w in sched.workers.items():
            for attr in ("lanes", "queues", "active_jobs", "rejections",
                         "rejected_counts"):
                if getattr(w, attr) is not getattr(sched, attr):
                    self._fail(
                        "cluster-shared-table",
                        f"worker {d} holds a private {attr} table — the "
                        f"shared-namespace contract is broken",
                        engine=engine)
            for t in w.tasks:
                if not isinstance(t.ctx, tuple) or t.ctx[0] != d:
                    self._fail(
                        "cluster-task-registration",
                        f"task {t.name} registered on device {d} but "
                        f"homed at ctx {t.ctx!r}", expected=d,
                        actual=t.ctx, engine=engine)
            if d in sched._dead_devs:
                alive = [c.index for c in w.contexts if c.alive]
                if alive:
                    self._fail(
                        "cluster-dead-device",
                        f"dead device {d} still has live contexts "
                        f"{alive}", engine=engine)
        worker_ids = {id(t) for w in sched.workers.values()
                      for t in w.tasks}
        global_ids = {id(t) for t in sched.tasks}
        if worker_ids != global_ids:
            self._fail(
                "cluster-task-registration",
                "union of per-worker task lists diverges from the global "
                "task list (a move lost or duplicated a registration)",
                expected=len(global_ids), actual=len(worker_ids),
                engine=engine)
        live_job_ids = {job.job_id for jobs in sched.active_jobs.values()
                        for job in jobs}
        for job_id, dev in sched._state_dev.items():
            if job_id not in live_job_ids:
                self._fail(
                    "cluster-state-dev-leak",
                    f"_state_dev holds inter-stage state for job "
                    f"{job_id} which is no longer active",
                    engine=engine)
            # a dead device is a LEGAL state home (replay re-pays the
            # transfer), but the device id must at least exist
            if dev not in sched.workers:
                self._fail(
                    "cluster-state-dev-unknown",
                    f"_state_dev points job {job_id} at device {dev} "
                    f"which was never minted", engine=engine)

    # ---- conservation ---------------------------------------------------
    def _check_conservation(self, sched, engine) -> None:
        live = {HP: 0, LP: 0}
        for jobs in sched.active_jobs.values():
            for j in jobs:
                live[j.task.priority] += 1
        m = engine.metrics
        for p, name in ((HP, "HP"), (LP, "LP")):
            want = (self.completed[p] + self.retired[p] + self.aborted[p]
                    + live[p])
            if self.admitted[p] != want:
                self._fail(
                    "job-conservation",
                    f"{name}: admitted != completed + cancelled-retired "
                    f"+ aborted + live ({self.completed[p]} + "
                    f"{self.retired[p]} + {self.aborted[p]} + {live[p]}) "
                    f"— a job leaked or retired twice",
                    expected=want, actual=self.admitted[p], engine=engine)
            if m.aborted[p] != self.aborted[p]:
                self._fail(
                    "metrics-aborted-mirror",
                    f"{name}: engine metrics.aborted diverges from the "
                    f"abort hook count", expected=self.aborted[p],
                    actual=m.aborted[p], engine=engine)
            if m.completed[p] != self.completed[p]:
                self._fail(
                    "metrics-completed-mirror",
                    f"{name}: engine metrics.completed diverges from the "
                    f"completion hook count", expected=self.completed[p],
                    actual=m.completed[p], engine=engine)
            if m.cancelled[p] != self.cancelled_subs[p]:
                self._fail(
                    "metrics-cancelled-mirror",
                    f"{name}: engine metrics.cancelled diverges from the "
                    f"cancel hook count", expected=self.cancelled_subs[p],
                    actual=m.cancelled[p], engine=engine)
            if sched.rejected_counts[p] != self.rejected[p]:
                self._fail(
                    "metrics-rejected-mirror",
                    f"{name}: scheduler rejected_counts diverges from "
                    f"the engine-side rejection count",
                    expected=self.rejected[p],
                    actual=sched.rejected_counts[p], engine=engine)
        joins = sum(self.coalesced_joins.values())
        if sched.coalesced != joins:
            self._fail(
                "metrics-coalesced-mirror",
                "scheduler coalesced counter diverges from the "
                "engine-side join count", expected=joins,
                actual=sched.coalesced, engine=engine)

    def _check_handles(self, engine) -> None:
        cancelled = {HP: 0, LP: 0}
        for h in engine._all_handles:
            if h.status not in _HANDLE_STATUSES:
                self._fail(
                    "handle-status-vocabulary",
                    f"handle for {h.task.name} carries unknown status "
                    f"{h.status!r}", engine=engine)
            if h.status == SubmitHandle.CANCELLED:
                cancelled[h.task.priority] += 1
        for p, name in ((HP, "HP"), (LP, "LP")):
            if cancelled[p] != engine.metrics.cancelled[p]:
                self._fail(
                    "handle-cancel-partition",
                    f"{name}: cancelled handle count diverges from "
                    f"metrics.cancelled (a handle changed status without "
                    f"accounting)", expected=engine.metrics.cancelled[p],
                    actual=cancelled[p], engine=engine)
        stats = tenant_stats(engine._all_handles)
        for tenant, d in stats.items():
            whole = (d["completed"] + d["cancelled"] + d["rejected"]
                     + d["aborted"] + d["pending"])
            if d["submitted"] != whole:
                self._fail(
                    "tenant-conservation",
                    f"tenant {tenant!r}: submitted != completed + "
                    f"cancelled + rejected + aborted + pending",
                    expected=whole, actual=d["submitted"], engine=engine)

    # ---- finalize-only --------------------------------------------------
    def _check_final_metrics(self, engine) -> None:
        m = engine.metrics
        live = {HP: 0, LP: 0}
        for jobs in engine.sched.active_jobs.values():
            for j in jobs:
                live[j.task.priority] += 1
        for p, name in ((HP, "HP"), (LP, "LP")):
            if m.unfinished[p] != live[p]:
                self._fail(
                    "final-unfinished-sweep",
                    f"{name}: metrics.unfinished diverges from the jobs "
                    f"still active at finalize", expected=live[p],
                    actual=m.unfinished[p], engine=engine)
            if m.rejected[p] != self.rejected[p]:
                self._fail(
                    "final-rejected",
                    f"{name}: finalized metrics.rejected diverges from "
                    f"the release-hook rejection count",
                    expected=self.rejected[p], actual=m.rejected[p],
                    engine=engine)
        if m.per_device:
            for p, name in ((HP, "HP"), (LP, "LP")):
                dev_total = sum(s["completed"][p]
                                for s in m.per_device.values())
                if dev_total != m.completed[p]:
                    self._fail(
                        "final-per-device-completed",
                        f"{name}: per-device completed sums diverge from "
                        f"the global counter", expected=m.completed[p],
                        actual=dev_total, engine=engine)
                dev_missed = sum(s["missed"][p]
                                 for s in m.per_device.values())
                if dev_missed != m.missed[p]:
                    self._fail(
                        "final-per-device-missed",
                        f"{name}: per-device missed sums diverge from "
                        f"the global counter", expected=m.missed[p],
                        actual=dev_missed, engine=engine)
