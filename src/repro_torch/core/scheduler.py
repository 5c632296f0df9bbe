# Copy of src/repro/core/scheduler.py; only this line differs (tests/test_torch_isolation.py checks it).
"""DARIS scheduler: offline phase (AFET + Algorithm 1) + online phase
(admission Eq. 11-12, migration, 8-level stage dispatch) — paper §IV.

The scheduler is engine-agnostic: the shared ``EngineCore`` loop
(runtime/engine_core.py) drives it over any ``ExecutionBackend`` — the
fluid simulator and the real JAX executor alike — through the same
callbacks:

    on_release(task, now)        periodic job release -> admission test
    on_stage_finish(inst, now)   MRET update, vdl bookkeeping, next stage
    next_for_lane(ctx, now)      dispatch decision for a free lane

Policies (paper §V): STR = 1 context x N_s streams (single global queue);
MPS = N_c x 1; MPS+STR = N_c x N_s. Oversubscription per Eq. 9.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from ..runtime.contention import ContentionModel, DeviceModel, batch_cost
from .batching import BatchCoalescer, BatchPolicy
from .mret import TaskMret
from .partition import (Context, ContextTable, CtxKey, make_contexts,
                        reconfigure as derive_contexts)
from .stage_queue import QueueConfig, StageQueue
from .task import HP, LP, Job, StageInstance, Task, TaskSpec


@dataclasses.dataclass
class SchedulerConfig:
    n_contexts: int = 4
    n_streams: int = 1
    oversubscription: float = 2.0
    mret_window: int = 5
    overload_hpa: bool = False        # admission-test HP too (paper §VI-I)
    no_staging: bool = False          # ablations (paper §VI-F)
    no_last: bool = False
    no_prior: bool = False
    no_fixed: bool = False
    straggler_kappa: float = 3.0      # beyond-paper: straggler threshold
    batch_policy: Optional[BatchPolicy] = None   # dynamic batching (off =
                                                 # pre-batching behavior)

    @property
    def queue_cfg(self) -> QueueConfig:
        return QueueConfig(no_last=self.no_last, no_prior=self.no_prior,
                           no_fixed=self.no_fixed)


@dataclasses.dataclass
class Rejection:
    task: str
    t_ms: float
    priority: int


def hp_first(tasks, now: float) -> List[Task]:
    """Algorithm 1's placement ordering: HP before LP, each class by
    descending utilization. THE ordering for every (re-)placement pass —
    offline population, fault recovery, online reconfigure, and the
    cluster layer's global passes all call this one function; a tie-break
    change here changes them all together."""
    return (sorted([t for t in tasks if t.priority == HP],
                   key=lambda t: -t.utilization(now))
            + sorted([t for t in tasks if t.priority == LP],
                     key=lambda t: -t.utilization(now)))


class LaneMap(dict):
    """Lane occupancy table ``(ctx, slot) -> StageInstance | None`` with
    free/busy indexes maintained on assignment.

    ``free_lanes``/``predicted_finish`` used to scan every lane on every
    engine iteration; the indexes make both reads O(result). Plain
    ``lanes[lane] = inst`` assignment (engine, backends, tests) keeps the
    indexes coherent because ``__setitem__`` is the single write path.
    Iteration order everywhere is sorted lane order — identical to the
    historic insertion order (contexts ascending, slots ascending), which
    the bit-exactness guarantee relies on."""

    def __init__(self):
        super().__init__()
        self._free: set = set()
        self._busy_by_ctx: Dict[int, Dict[tuple, StageInstance]] = {}
        self._dead: set = set()

    def __setitem__(self, lane: tuple, inst: Optional[StageInstance]) -> None:
        dict.__setitem__(self, lane, inst)
        ctx = lane[0]
        busy = self._busy_by_ctx.setdefault(ctx, {})
        if inst is None:
            busy.pop(lane, None)
            if ctx not in self._dead:
                self._free.add(lane)
        else:
            busy.pop(lane, None)
            busy[lane] = inst
            self._free.discard(lane)

    def retire_ctx(self, ctx: int) -> None:
        """Mark a context dead: its lanes never report free again."""
        self._dead.add(ctx)
        self._free = {ln for ln in self._free if ln[0] != ctx}

    def free_lanes(self) -> List[tuple]:
        return sorted(self._free)

    def free_set(self) -> set:
        """Live free lanes, unordered — the dispatch loop filters by
        hot context first, then sorts the (much smaller) remainder."""
        return self._free

    def busy_in_ctx(self, ctx: int) -> List[tuple]:
        """Sorted (lane, inst) pairs of occupied lanes in one context."""
        return sorted(self._busy_by_ctx.get(ctx, {}).items())


class DarisScheduler:
    """One device's DARIS scheduler.

    ``ctx_ns`` makes the scheduler *device-relative*: when set (by the
    cluster layer, repro/cluster), every context index it mints becomes a
    ``(ctx_ns, k)`` tuple instead of a bare int, so N workers can share
    one lane/queue/job namespace without collisions. Single-device
    construction (``ctx_ns=None``) keeps the historic int indices and is
    bit-identical to the pre-cluster scheduler."""

    def __init__(self, specs: List[TaskSpec], cfg: SchedulerConfig,
                 device: Optional[DeviceModel] = None, *,
                 ctx_ns: Optional[int] = None):
        self.cfg = cfg
        self.device = device or DeviceModel()
        self.speed = self.device.speed
        self.contention = ContentionModel(self.device)
        self.ctx_ns = ctx_ns
        if cfg.no_staging:
            specs = [self._merge_stages(s) for s in specs]
        self.tasks: List[Task] = [Task(spec=s, index=i)
                                  for i, s in enumerate(specs)]
        self.contexts: ContextTable = ContextTable()
        for c in make_contexts(cfg.n_contexts, cfg.n_streams,
                               cfg.oversubscription,
                               int(self.device.n_units)):
            c.index = self._key(c.index)
            self.contexts.append(c)
        # live-context cache: reconfigure-heavy runs accumulate retired
        # contexts (indices must stay addressable for draining work), so
        # hot paths that only want live ones must not rescan the full
        # history each release
        self._live_cache: Optional[List[Context]] = None
        self.queues: Dict[CtxKey, StageQueue] = {
            c.index: StageQueue(cfg.queue_cfg) for c in self.contexts}
        # dispatch index: context keys whose queue currently holds work
        # (maintained by the queues themselves — see StageQueue.register_hot)
        self.hot_queues: set = set()
        for k, q in self.queues.items():
            q.register_hot(k, self.hot_queues)
        # lane occupancy: (ctx, slot) -> StageInstance | None (indexed)
        self.lanes = LaneMap()
        for c in self.contexts:
            for s in range(c.n_streams):
                self.lanes[(c.index, s)] = None
        # per-context insertion-ordered job sets (Job hashes by identity):
        # membership tests and removals are O(1) where list.remove used to
        # walk — and value-compare — every active job
        self.active_jobs: Dict[CtxKey, Dict[Job, None]] = {
            c.index: {} for c in self.contexts}
        self.rejections: List[Rejection] = []
        self.rejected_counts: Dict[int, int] = {HP: 0, LP: 0}
        self.migrations = 0
        self.coalesced = 0            # releases absorbed into batched jobs
        self._coalescer = (BatchCoalescer(cfg.batch_policy)
                           if cfg.batch_policy is not None else None)
        # next time the drive loop is guaranteed to call dispatch again
        # (EngineCore refreshes it every iteration); inf = no pending
        # events, so batch heads must never be held back
        self.next_wake_ms: float = math.inf
        # lazy work-accounting hook (runtime/epoch.py): the epoch engine
        # integrates work_done in slot arrays and only flushes a
        # context's StageInstances right before predicted_finish reads
        # them. None (heap engine, realtime) = work_done is always live.
        self.work_sync = None
        # degradation-controller batching knob (repro.chaos): multiplies
        # the batch policy's max_wait_ms while the server is degraded, so
        # heads grow larger under brownout. 1.0 = no effect (chaos off).
        self.batch_widen: float = 1.0
        self._offline_phase()

    def _key(self, i: int) -> CtxKey:
        """Context index for the i-th context this scheduler ever mints:
        a bare int on a single device, ``(device, i)`` under a cluster."""
        return i if self.ctx_ns is None else (self.ctx_ns, i)

    # ------------------------------------------------------------- offline
    @staticmethod
    def _merge_stages(spec: TaskSpec) -> TaskSpec:
        from .task import StageProfile
        st = spec.stages
        merged = StageProfile(
            name=f"{spec.name}/whole",
            t_alone_ms=sum(s.t_alone_ms for s in st),
            n_sat=max(s.n_sat for s in st),
            mem_frac=sum(s.mem_frac * s.t_alone_ms for s in st)
            / max(sum(s.t_alone_ms for s in st), 1e-9),
            overhead_ms=st[0].overhead_ms,   # one sync instead of n_i
        )
        return dataclasses.replace(spec, stages=[merged])

    def _seed_mret(self, task: Task) -> None:
        """AFET seeding (§IV-A1): pessimistic full-load execution times
        (reference-speed units; see ``DeviceModel.speed``)."""
        n_p = self.cfg.n_contexts * self.cfg.n_streams
        cap0 = next(iter(self.contexts)).cap
        afets = [self.contention.full_load_time(
            p, cap0, self.cfg.n_streams, n_p) for p in task.spec.stages]
        task.mret = TaskMret(afets, ws=self.cfg.mret_window)

    def _offline_phase(self) -> None:
        """AFET seeding (§IV-A1) + Algorithm 1 context population."""
        for t in self.tasks:
            self._seed_mret(t)
        # Algorithm 1: HP first, then LP, each to the min-utilization context
        util = {c.index: 0.0 for c in self.contexts}
        for t in hp_first(self.tasks, 0.0):
            k = min(util, key=util.get)
            t.ctx = k
            t.fixed_ctx = t.priority == HP
            util[k] += t.utilization(0.0)

    def live_contexts(self) -> List[Context]:
        """Live contexts in ascending index order (cached; identical to
        filtering ``self.contexts`` on ``alive``)."""
        if self._live_cache is None:
            self._live_cache = [c for c in self.contexts if c.alive]
        return self._live_cache

    def _invalidate_live(self) -> None:
        self._live_cache = None

    def geometry_snapshot(self) -> Dict:
        """Static view of the live Eq. 9 geometry for offline analysis
        (repro.analysis.schedcheck): per-context capacity/streams plus the
        oversubscription interference structure (which contexts share SMs,
        worst per-unit co-residency). Pure introspection — no state change."""
        from .partition import interference_sets, max_coresidency
        live = self.live_contexts()
        inter = interference_sets(live)
        cores = max_coresidency(live)
        return {
            "kind": "device",
            "n_units": self.device.n_units,
            "speed": self.speed,
            "oversubscription": self.cfg.oversubscription,
            "total_streams": sum(c.n_streams for c in live),
            "total_cap": sum(c.cap for c in live),
            "max_coresidency": cores,
            "contexts": [
                {"ctx": str(c.index), "cap": c.cap, "n_streams": c.n_streams,
                 "shares_units_with": [str(k) for k in inter[c.index]]}
                for c in live],
            "summary": (f"{len(live)} ctx x {self.cfg.n_streams} streams, "
                        f"os={self.cfg.oversubscription:g}, "
                        f"{int(self.device.n_units)} units, "
                        f"co-residency {cores}"),
        }

    def make_task(self, spec: TaskSpec, index: int) -> Task:
        """Create (but do not place) a task: same staging/AFET treatment
        as constructor-registered tasks. The cluster layer uses this to
        seed a task against a *chosen* device before adopting it."""
        if self.cfg.no_staging:
            spec = self._merge_stages(spec)
        task = Task(spec=spec, index=index)
        self._seed_mret(task)
        return task

    def place_task(self, task: Task, now: float) -> Task:
        """Algorithm-1-style placement on the least-utilized live context
        of THIS device + registration in the task list."""
        alive = [c.index for c in self.live_contexts()]
        util = {k: self.util_hp_total(k, now) + self.util_lp_active(k, now)
                for k in alive}
        task.ctx = min(util, key=util.get)
        task.fixed_ctx = task.priority == HP
        self.tasks.append(task)
        return task

    def add_task(self, spec: TaskSpec, now: float = 0.0) -> Task:
        """Late task registration (the ``DarisServer.submit`` path)."""
        return self.place_task(self.make_task(spec, len(self.tasks)), now)

    # ----------------------------------------------------- utilization (Eq. 4-7)
    @staticmethod
    def spec_batch_cost(spec: TaskSpec, n_inputs: int) -> float:
        """Device-time multiplier of a b-input job of ``spec`` vs a single
        release: per-stage b / g(b), weighted by stage work (stages may
        carry different batch gains). Exactly 1.0 for b = 1, so the
        paper's utilization math is unchanged when batching is off."""
        if n_inputs <= 1:
            return 1.0
        tot = sum(s.t_alone_ms for s in spec.stages)
        if tot <= 0:
            return batch_cost(spec.stages[0], n_inputs)
        return sum(s.t_alone_ms * batch_cost(s, n_inputs)
                   for s in spec.stages) / tot

    @classmethod
    def job_cost(cls, job: Job) -> float:
        return cls.spec_batch_cost(job.task.spec, job.n_inputs)

    def util_hp_total(self, k: CtxKey, now: float) -> float:
        """Device-local HP utilization: reference-units sum, scaled by the
        device's speed factor (a 2x device hosts 2x the reference load in
        the same headroom). ``/1.0`` on the calibration device is exact,
        so single-GPU admission keeps its historic bits."""
        u = sum(t.utilization(now) for t in self.tasks
                if t.ctx == k and t.priority == HP)
        return u if self.speed == 1.0 else u / self.speed

    def util_lp_active(self, k: CtxKey, now: float) -> float:
        u = sum(j.task.utilization(now) * self.job_cost(j)
                for j in self.active_jobs[k] if j.task.priority == LP)
        return u if self.speed == 1.0 else u / self.speed

    def remaining_util(self, k: CtxKey, now: float) -> float:
        """Eq. 11: U_r = N_s - U_h,t."""
        ctx = self.contexts[k]
        return ctx.n_streams - self.util_hp_total(k, now)

    def admits(self, k: CtxKey, task: Task, now: float) -> bool:
        """Eq. 12: U_l,a + u_j < U_r (u_j in device-local units)."""
        if not self.contexts[k].alive:
            return False
        u_j = task.utilization(now)
        if self.speed != 1.0:
            u_j /= self.speed
        return (self.util_lp_active(k, now) + u_j
                < self.remaining_util(k, now))

    def predicted_finish(self, k: CtxKey, now: float) -> float:
        """Backlog-based earliest-finish estimate for migration targets.
        Batched stages cost b/g(b) x their normalized MRET, here and in
        ``StageQueue.backlog_ms``; faster devices drain the same backlog
        proportionally sooner."""
        if self.work_sync is not None:
            self.work_sync(k)
        ctx = self.contexts[k]
        rem = 0.0
        for _, inst in self.lanes.busy_in_ctx(k):
            # running instances always entered through StageQueue.push,
            # so their cached estimator/cost fields are populated. MRET is
            # reference-speed but work_done accrues in device-local wall
            # ms (SimBackend.launch divides work by speed), so the MRET
            # must land in device units BEFORE the subtraction
            mret = inst.smret.value() * inst.cost_b
            if self.speed != 1.0:
                mret /= self.speed
            rem += max(mret - inst.work_done, 0.0)
        backlog = self.queues[k].backlog_ms()
        if self.speed != 1.0:
            backlog /= self.speed
        rem += backlog
        return now + rem / max(ctx.n_streams, 1)

    def migration_eta(self, k: CtxKey, now: float, src: CtxKey,
                      job: Optional[Job] = None) -> float:
        """ETA the migration machinery compares when moving work from
        ``src`` to ``k``. On one device it IS ``predicted_finish``; the
        cluster layer adds the inter-GPU transfer charge for candidates
        that would have to fetch ``job``'s inter-stage state."""
        return self.predicted_finish(k, now)

    # ------------------------------------------- device-relative interface
    # (the backend talks to schedulers only through these, so one
    # SimBackend clock can drive a single device and a cluster alike)
    def contention_of(self, k: CtxKey) -> ContentionModel:
        """Contention model of the device hosting context ``k``."""
        return self.contention

    def rate_groups(self, entries):
        """Partition running-set entries ``(lane, entry)`` into per-device
        rate-computation groups ``(contention, contexts, entries)``.
        Lanes on different devices never contend with each other; a
        single device is exactly one group."""
        return ((self.contention, self.contexts, entries),)

    def scale_units(self) -> int:
        """How many units the autoscaler grows/shrinks by one: contexts
        on a single device, whole GPUs under the cluster layer."""
        return len(self.live_contexts())

    def scale_kwargs(self, n: int) -> Dict:
        """``reconfigure`` kwargs that set the autoscaler unit count."""
        return {"n_contexts": n}

    # --------------------------------------------------------------- online
    def on_release(self, task: Task, now: float) -> Optional[Job]:
        """Coalesce into an open batch head (if policy allows), else
        admission test + (possibly migrated) enqueue. None = rejected."""
        if self._coalescer is not None:
            head = self._try_coalesce(task, now)
            if head is not None:
                return head
        job = Job(task=task, release_ms=now)
        needs_test = task.priority == LP or self.cfg.overload_hpa
        k = task.ctx
        if needs_test and not self.admits(k, task, now):
            # migration candidates: every other live context (Eq. 12),
            # earliest predicted finish wins (paper §IV-B1)
            cands = [c.index for c in self.live_contexts()
                     if c.index != k and self.admits(c.index, task, now)]
            if not cands:
                self.rejections.append(Rejection(task.name, now, task.priority))
                self.rejected_counts[task.priority] += 1
                return None
            k = min(cands, key=lambda c: self.predicted_finish(c, now))
            if task.priority == LP and not task.fixed_ctx:
                task.ctx = k          # sticky migration (zero-delay: the job
                self.migrations += 1  # simply enqueues on the new partition)
        job.ctx = k
        self.active_jobs[k][job] = None
        inst = self._enqueue_stage(job, now)
        if self._coalescer is not None:
            self._coalescer.register(task, inst)
        return job

    def _try_coalesce(self, task: Task, now: float) -> Optional[Job]:
        """Join this release onto its group's open batch head if the
        policy, the head's virtual deadline, and admission (Eq. 12) all
        allow it. Returns the (grown) head job, or None to fall through
        to the normal release path."""
        pol = self._coalescer.policy
        inst = self._coalescer.head(task)
        if inst is None:
            return None
        job = inst.job
        if inst.lane is not None or job.stage_idx != 0:
            self._coalescer.close(task)          # stale head: already runs
            return None
        if job.ctx not in self.contexts:
            # cluster re-place moved the head's job to another device:
            # this worker can neither admit nor refresh it (its context
            # table has no such key) — seal the stale head. Never fires
            # on a single device (job.ctx is always a local context).
            self._coalescer.close(task)
            return None
        if task.fixed_ctx and job.ctx != task.ctx:
            # an HP task's context is fixed (Algorithm 1): its inputs may
            # only ride batches executing on its own partition — Eq. 11
            # charges HP load by task.ctx, so cross-context joins would
            # execute work the admission math attributes elsewhere
            return None
        if job.n_inputs >= pol.max_batch:
            self._coalescer.close(task)          # full: seal the batch
            return None
        if (pol.max_wait_ms is not None
                and now - job.release_ms > pol.max_wait_ms * self.batch_widen):
            self._coalescer.close(task)
            return None
        # slack bound: the enlarged batch must still be predicted to meet
        # the earliest member's stage-0 virtual deadline — unless the head
        # already cannot, in which case waiting is free (throughput mode).
        # The head's task owns the deadline, so its profile/MRET govern
        # (identical to the joiner's under scope="task"; same-model under
        # scope="model").
        prof = job.task.spec.stages[0]
        mret0 = job.task.mret.stage_mret(0)
        if self.speed != 1.0:
            mret0 /= self.speed   # wall-clock prediction on THIS device
        cost_now = batch_cost(prof, job.n_inputs)
        cost_join = batch_cost(prof, job.n_inputs + 1)
        fits = now + mret0 * cost_join <= inst.virtual_deadline_ms
        late_anyway = now + mret0 * cost_now > inst.virtual_deadline_ms
        if not fits and not late_anyway:
            return None
        # admission charges the *incremental* batched utilization (Eq. 12)
        # — job-level (work-weighted over stages), unlike the stage-0
        # costs above which predict stage-0 completion only
        if task.priority == LP or self.cfg.overload_hpa:
            du = task.utilization(now) * (
                self.spec_batch_cost(job.task.spec, job.n_inputs + 1)
                - self.spec_batch_cost(job.task.spec, job.n_inputs))
            if self.speed != 1.0:
                du /= self.speed      # device-local units, as in admits()
            k = job.ctx
            if (not self.contexts[k].alive
                    or self.util_lp_active(k, now) + du
                    >= self.remaining_util(k, now)):
                return None
        job.extra_release_ms.append(now)
        job.extra_member_idx.append(task.index)
        # the head instance is still queued: refresh its cached backlog
        # cost to the grown batch size (see StageInstance.cost_b) — and
        # tell the queue its memoized backlog total is stale
        inst.cost_b = batch_cost(inst.profile, job.n_inputs)
        self.queues[job.ctx].touch()
        self.coalesced += 1
        return job

    def _enqueue_stage(self, job: Job, now: float) -> StageInstance:
        vdls = job.task.mret.virtual_deadlines(job.task.spec.deadline_ms)
        abs_vdl = job.release_ms + sum(vdls[:job.stage_idx + 1])
        inst = StageInstance(job=job, enqueue_ms=now,
                             virtual_deadline_ms=abs_vdl)
        self.queues[job.ctx].push(inst)
        return inst

    def on_stage_finish(self, inst: StageInstance, now: float,
                        et_ms: float) -> Optional[Job]:
        """MRET update + vdl bookkeeping. Returns the job if it completed.
        Batched executions are normalized back to single-input time before
        feeding MRET — by the finished stage's own cost, matching the
        backend's per-stage work scaling — so Eq. 1-2 keep their
        per-release semantics (and the utilization/vdl math built on
        them) whatever the batch size."""
        job = inst.job
        stage_cost = batch_cost(job.stage_profile(), job.n_inputs)
        if inst.transfer_ms:
            # the inter-GPU transfer charge is migration cost, not stage
            # execution: feeding it to MRET would inflate the sliding-
            # window max (and every deadline/utilization built on it)
            # for ws releases after every cross-GPU move. The backend
            # folds the charge into the stage's work, burned at the
            # contention rate — so its wall-clock share is its fraction
            # of the executed work, not the raw charge
            xfer_wall = inst.transfer_ms
            if inst.work_done > 0:
                xfer_wall = et_ms * (inst.transfer_ms / inst.work_done)
            et_ms = max(et_ms - xfer_wall, 0.0)
        if self.speed != 1.0:
            # MRET history is kept in reference-speed units so it stays
            # meaningful when a task migrates between heterogeneous GPUs
            et_ms = et_ms * self.speed
        job.task.mret.observe(job.stage_idx, et_ms / stage_cost)
        if job.cancelled:
            # in-flight cancel lands at the stage boundary (zero-delay
            # semantics): the finished stage's observation stands, later
            # stages never run, the admission charge unwinds here
            job.finish_ms = now
            del self.active_jobs[job.ctx][job]
            return job
        missed_vdl = now > inst.virtual_deadline_ms
        if job.is_last_stage():
            job.finish_ms = now
            del self.active_jobs[job.ctx][job]
            return job
        job.stage_idx += 1
        job.vdl_missed_prev = missed_vdl     # §IV-B2 priority boost
        self._enqueue_stage(job, now)
        return None

    # -------------------------------------------------------- cancellation
    def find_job(self, task_index: int, release_ms: float):
        """Locate the live job carrying the submission released by task
        ``task_index`` at ``release_ms``. Returns ``(job, member)``:
        ``member`` is None when the submission is the job's primary
        release, else its position in ``extra_release_ms`` (a coalesced
        batch member). ``(None, None)`` = no live job carries it (it
        completed, was rejected, or was already cancelled away).
        Iteration order is dict insertion order — deterministic, so a
        journal replay resolves cancels identically to the live run."""
        for jobs in self.active_jobs.values():
            for job in jobs:
                if (job.task.index == task_index
                        # stamp identity: the cancel echoes the exact
                        # release float  # dsan: ignore[DSAN003]
                        and job.release_ms == release_ms):
                    return job, None
                for i, (idx, rel) in enumerate(zip(job.extra_member_idx,
                                                   job.extra_release_ms)):
                    # same stamp identity  # dsan: ignore[DSAN003]
                    if idx == task_index and rel == release_ms:
                        return job, i
        return None, None

    def cancel_job(self, task_index: int, release_ms: float, now: float):
        """First-class job cancellation (the engine CANCEL event).

        Outcomes (``(outcome, job)``):
          * ``"cancelled"``  — the job was queued: its stage instance left
            the ready queue, the job left ``active_jobs`` (unwinding its
            Eq. 12 admission charge, which is computed by scanning active
            jobs), and any open batch-head registration was sealed.
          * ``"cancelling"`` — the job's current stage is executing: like
            zero-delay migration, the cancel takes effect at the stage
            boundary — the running stage finishes (its MRET observation
            stands), later stages never enqueue.
          * ``"detached"``   — a member of a still-growable stage-0 batch
            left it for real: batch size, cached backlog cost, and the
            incremental admission charge all shrink. Cancelling the
            *primary* of such a head promotes the earliest surviving
            member to primary, re-anchoring release/deadline/vdl.
          * ``"dropped"``    — a member of a sealed (dispatched or
            mid-pipeline) batch: the launched work is fixed, so the input
            rides along, but its result is discarded from accounting.
          * ``"noop"``       — the submission was already cancelled.
          * ``"absent"``     — no live job carries it (e.g. completed).
        """
        job, member = self.find_job(task_index, release_ms)
        if job is None:
            return "absent", None
        return self._cancel_found(job, member, now)

    def _cancel_found(self, job: Job, member: Optional[int], now: float):
        k = job.ctx
        q = self.queues.get(k)
        inst = q.find_inst(job) if q is not None else None
        if member is not None:
            rel = job.extra_release_ms[member]
            if rel in job.dropped_releases:
                return "noop", job
            if inst is not None and job.stage_idx == 0:
                job.extra_release_ms.pop(member)
                job.extra_member_idx.pop(member)
                # in-place cost_b change of a still-queued instance:
                # invalidate the queue's memoized backlog total
                inst.cost_b = batch_cost(inst.profile, job.n_inputs)
                q.touch()
                return "detached", job
            job.dropped_releases.append(rel)
            return "dropped", job
        # primary release
        if job.cancelled or job.release_ms in job.dropped_releases:
            return "noop", job
        if inst is not None and job.stage_idx == 0 and job.extra_release_ms:
            # queued batch head losing its primary: promote the earliest
            # surviving member — batching anchors deadline and stage-0
            # vdl on the earliest member (Job docstring), so the
            # re-anchored instance must re-enter the queue under its new
            # virtual deadline
            promo = next((i for i, r in enumerate(job.extra_release_ms)
                          if r not in job.dropped_releases), None)
            if promo is not None:
                job.release_ms = job.extra_release_ms.pop(promo)
                job.extra_member_idx.pop(promo)
                q.remove(inst)
                vdls = job.task.mret.virtual_deadlines(
                    job.task.spec.deadline_ms)
                inst.virtual_deadline_ms = job.release_ms + vdls[0]
                inst.cost_b = batch_cost(inst.profile, job.n_inputs)
                q.push(inst)
                return "detached", job
        # surviving batch members own the job's remaining work: the
        # primary's cancel can only discard its own result (mid-pipeline
        # batches cannot shed members — the launched work is fixed)
        survivors = [r for r in job.extra_release_ms
                     if r not in job.dropped_releases]
        if survivors:
            job.dropped_releases.append(job.release_ms)
            return "dropped", job
        if inst is not None:
            # current stage still queued: the whole job retires now
            q.remove(inst)
            if self._coalescer is not None:
                self._coalescer.on_pop(inst)   # seal a stale open head
            del self.active_jobs[k][job]
            job.cancelled = True
            job.finish_ms = now
            return "cancelled", job
        # current stage is on a lane: zero-delay boundary retirement
        job.cancelled = True
        return "cancelling", job

    def abort_job(self, job: Job, now: float) -> None:
        """Chaos-layer give-up (RetryPolicy exhausted, or a deadline-aware
        bail-out): the job leaves ``active_jobs`` immediately, unwinding
        its Eq. 12 admission charge exactly like a queued cancel. The
        failed stage's instance is neither queued nor on a lane when this
        runs (the engine frees the lane before deciding), so there is
        nothing to remove from the ready queue."""
        del self.active_jobs[job.ctx][job]
        job.finish_ms = now

    def next_for_lane(self, ctx_idx: int, now: float) -> Optional[StageInstance]:
        if self._coalescer is None:
            return self.queues[ctx_idx].pop()
        # lazy dispatch (D-STACK-style): a growable batch head stays queued
        # until its latest start time, as long as the drive loop will wake
        # us again before that — work behind it dispatches meanwhile
        q = self.queues[ctx_idx]
        held: List[StageInstance] = []
        inst = q.pop()
        while inst is not None and self._should_hold(inst, now):
            held.append(inst)
            inst = q.pop()
        for h in held:
            q.push(h)
        if inst is not None:
            self._coalescer.on_pop(inst)     # dispatch seals the batch
        return inst

    def _should_hold(self, inst: StageInstance, now: float) -> bool:
        """Hold a growable stage-0 batch head iff the engine's next
        wake-up still leaves time to dispatch it within its virtual
        deadline (with its current batch size)."""
        job = inst.job
        pol = self._coalescer.policy
        if job.stage_idx != 0 or self._coalescer.head(job.task) is not inst:
            return False
        if job.n_inputs >= pol.max_batch:
            return False
        if (pol.max_wait_ms is not None
                and self.next_wake_ms - job.release_ms
                > pol.max_wait_ms * self.batch_widen):
            return False
        prof = job.task.spec.stages[0]
        mret0 = job.task.mret.stage_mret(0)
        if self.speed != 1.0:
            mret0 /= self.speed   # wall-clock prediction on THIS device
        latest_start = (inst.virtual_deadline_ms
                        - mret0 * batch_cost(prof, job.n_inputs))
        return self.next_wake_ms <= latest_start

    def free_lanes(self) -> List[tuple]:
        return self.lanes.free_lanes()

    # ------------------------------------------------------ fault / elastic
    def fault_cancel_keys(self, k) -> List:
        """Backend lanes a context fault must cancel BEFORE
        ``fail_context`` runs. One device: just the faulted context. The
        cluster overrides this — losing a device's last live context
        escalates to a whole-device failure, which requeues in-flight
        stages from EVERY context of the device, so their backend
        entries must die too (else a ghost completion double-executes
        the replayed stage)."""
        return [k]

    def fail_context(self, k: int, now: float) -> List[StageInstance]:
        """Partition loss: survivors inherit tasks via Algorithm 1 re-run;
        in-flight stages replay (stage granularity bounds lost work)."""
        self.contexts[k].alive = False
        self._invalidate_live()
        self.lanes.retire_ctx(k)
        orphans = self.queues[k].drain()
        for lane, inst in self.lanes.busy_in_ctx(k):
            orphans.append(inst)
            self.lanes[lane] = None
        alive = [c.index for c in self.live_contexts()]
        if not alive:
            raise RuntimeError("all contexts failed")
        util = {a: self.util_hp_total(a, now) + self.util_lp_active(a, now)
                for a in alive}
        # Algorithm 1 re-run: HP first (descending utilization), then LP —
        # an LP task must never claim the min-utilization survivor ahead
        # of an HP task (mirrors _offline_phase)
        orphaned = [t for t in self.tasks if t.ctx == k]
        for t in hp_first(orphaned, now):
            tgt = min(util, key=util.get)
            t.ctx = tgt
            util[tgt] += t.utilization(now)
        requeued = []
        for inst in orphans:
            job = inst.job
            if job in self.active_jobs[k]:
                del self.active_jobs[k][job]
                self.active_jobs[job.task.ctx][job] = None
            job.ctx = job.task.ctx
            inst.work_done = 0.0      # replay from stage start
            inst.lane = None
            self.queues[job.ctx].push(inst)
            requeued.append(inst)
        return requeued

    def add_context(self, now: float) -> Context:
        """Elastic scale-out: append one context carrying real Eq. 9
        geometry — the last wrap-around slot of the shape the device has
        *after* this scale-out (live contexts + 1). Deterministic: the
        historic path sliced an unordered set, which made scale-out runs
        depend on hash iteration order."""
        n_live = len(self.live_contexts()) + 1
        geo = derive_contexts(n_live, self.cfg.n_streams,
                              self.cfg.oversubscription,
                              int(self.device.n_units))[-1]
        ctx = Context(index=self._key(len(self.contexts)), units=geo.units,
                      n_streams=self.cfg.n_streams)
        self._install_context(ctx)
        return ctx

    def _install_context(self, ctx: Context) -> None:
        """Register a freshly created context with every per-context
        structure (queue, active-job set, lanes)."""
        self._invalidate_live()
        self.contexts.append(ctx)
        q = StageQueue(self.cfg.queue_cfg)
        q.register_hot(ctx.index, self.hot_queues)
        self.queues[ctx.index] = q
        self.active_jobs[ctx.index] = {}
        for s in range(ctx.n_streams):
            self.lanes[(ctx.index, s)] = None

    def reconfigure(self, now: float, n_contexts: Optional[int] = None,
                    n_streams: Optional[int] = None,
                    oversubscription: Optional[float] = None) -> dict:
        """Online elastic repartitioning — the paper's oversubscribed
        geometry (Eq. 9) re-derived mid-run with zero-delay migration.

        The controller never drains: old contexts are retired in place
        (their lanes keep executing), a fresh context set with the new
        ``(n_contexts, n_streams, oversubscription)`` shape is appended at
        new indices, Algorithm 1 re-places every task (HP first, as in
        ``fail_context``), queued stage instances re-home to their task's
        new context, and in-flight stages finish on their old lane and
        migrate at the next stage boundary — stage granularity is the
        paper's zero-delay mechanism, so no running stage program is ever
        interrupted (unlike ``fail_context``, nothing replays).

        Returns a summary dict: retired/created context indices, how many
        queued instances re-homed, how many in-flight jobs will migrate at
        their next boundary, and how many of those moves changed the
        physical unit set (counted into ``self.migrations``).
        """
        old_live = list(self.live_contexts())
        n_contexts = n_contexts if n_contexts is not None else len(old_live)
        n_streams = n_streams if n_streams is not None else self.cfg.n_streams
        if oversubscription is None:
            oversubscription = self.cfg.oversubscription
        if n_streams < 1:
            raise ValueError(f"reconfigure needs n_streams >= 1, got "
                             f"{n_streams}: a zero-lane context would "
                             f"strand every queued job silently")
        self.cfg.n_contexts = n_contexts
        self.cfg.n_streams = n_streams
        self.cfg.oversubscription = oversubscription
        base = len(self.contexts)
        created = derive_contexts(n_contexts, n_streams, oversubscription,
                                  int(self.device.n_units), base_index=base)
        for ctx in created:
            ctx.index = self._key(ctx.index)
        # retire the old partition *before* installing the new one: queued
        # work drains out, running lanes stay busy until their stage ends
        orphans: List[StageInstance] = []
        old_units: Dict[int, frozenset] = {}
        for c in old_live:
            c.alive = False
            old_units[c.index] = frozenset(c.units)
            self.lanes.retire_ctx(c.index)
            orphans.extend(self.queues[c.index].drain())
        self._invalidate_live()
        for ctx in created:
            self._install_context(ctx)
        # Algorithm 1 re-run over ALL tasks onto the new shape: HP first
        # (descending utilization), then LP — identical ordering to
        # _offline_phase / fail_context
        util = {c.index: 0.0 for c in created}
        for t in hp_first(self.tasks, now):
            tgt = min(util, key=util.get)
            t.ctx = tgt
            util[tgt] += t.utilization(now)
        # re-home every live job to its task's new context. Queued stage
        # instances move queues now (in old-context order, preserving
        # each queue's drain order); in-flight jobs only re-point their
        # ``job.ctx`` — the running instance finishes on the old lane and
        # the job's NEXT stage enqueues on the new context (zero-delay).
        migrated = 0
        inflight = 0
        for k in sorted(old_units):
            for job in list(self.active_jobs[k]):
                del self.active_jobs[k][job]
                self.active_jobs[job.task.ctx][job] = None
                job.ctx = job.task.ctx
                # a sticky cross-GPU migration can point the task at
                # another device: that context isn't in THIS worker's
                # table, and the move is a unit-set change by definition
                tgt_ctx = self.contexts.get(job.ctx)
                if tgt_ctx is None or old_units[k] != tgt_ctx.units:
                    migrated += 1
        for inst in orphans:
            inst.lane = None
            self.queues[inst.job.ctx].push(inst)
        for lane, inst in self.lanes.items():
            if inst is not None and lane[0] in old_units:
                inflight += 1
        self.migrations += migrated
        return {
            "retired": sorted(old_units),
            "created": [c.index for c in created],
            "rehomed": len(orphans),
            "inflight": inflight,
            "migrated": migrated,
        }
