# Copy of src/repro/cluster/scheduler.py; only this line differs (tests/test_torch_isolation.py checks it).
"""ClusterScheduler: multi-GPU DARIS with global admission and cross-GPU
zero-delay migration.

One ``DarisScheduler`` worker per GPU — each with its own ``DeviceModel``
(heterogeneous speed factors welcome), its own Eq. 9 partition geometry,
its own contention model — composed behind the exact scheduler interface
``EngineCore`` and the backends already speak. The composition trick is
the *shared namespace*: every worker is constructed with ``ctx_ns=dev``,
so its context indices are ``(device, k)`` tuples and its lane keys are
``((device, k), slot)``; the cluster then literally hands every worker
the SAME lane map / queue table / active-job table, and all of the
engine's hot paths (dispatch, harvest, straggler kill, idle detection)
work on cluster state without a single translation layer.

Division of labour:

    global  (this class)   task -> device placement (Algorithm 1 HP-first
                           by least-loaded schedulable device), cross-GPU
                           admission fallback + sticky migration, device
                           failure/retirement, whole-GPU elasticity,
                           inter-GPU transfer charging
    local   (workers)      everything the paper describes on one GPU:
                           Eq. 11-12 admission, 8-level stage dispatch,
                           MRET, batching, intra-device migration

Cross-GPU zero-delay migration reuses the stage-boundary mechanism of
PR 4: a migrating job's running stage finishes where it is, its next
stage enqueues at the new home, and the dispatcher stamps the configured
``transfer_ms`` onto the first stage executed on a device that does not
hold the job's inter-stage state (the backend adds it to the stage work,
and ``migration_eta`` adds it to candidate ETAs so the placement math
sees the same charge the execution will pay).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Union

from ..core.partition import Context, ContextTable, CtxKey
from ..core.scheduler import (DarisScheduler, LaneMap, SchedulerConfig,
                              hp_first)
from ..core.task import HP, LP, Job, StageInstance, Task, TaskSpec
from ..runtime.contention import ContentionModel, DeviceModel
from .devices import resolve_devices


class ClusterScheduler:
    """N per-GPU ``DarisScheduler`` workers behind one scheduler API."""

    def __init__(self, specs: List[TaskSpec], cfg: SchedulerConfig,
                 device: Optional[DeviceModel] = None, *,
                 n_gpus: int,
                 device_models: Optional[Sequence[Union[str, DeviceModel]]]
                 = None,
                 transfer_ms: float = 0.5):
        if n_gpus < 1:
            raise ValueError(f"cluster needs >= 1 GPU, got {n_gpus}")
        if transfer_ms < 0:
            raise ValueError(f"transfer_ms must be >= 0, got {transfer_ms}")
        self._cfg_template = cfg
        self.cfg = dataclasses.replace(cfg)   # backend reads e.g. kappa
        self.transfer_ms = float(transfer_ms)
        base = device or DeviceModel()
        self.device_models: List[DeviceModel] = (
            resolve_devices(device_models) if device_models else [base])
        # shared namespace: one table each, handed to every worker
        self.lanes = LaneMap()
        self.queues: Dict[CtxKey, object] = {}
        self.hot_queues: set = set()
        self.active_jobs: Dict[CtxKey, Dict[Job, None]] = {}
        self.rejections: list = []
        self.rejected_counts: Dict[int, int] = {HP: 0, LP: 0}
        self.workers: Dict[int, DarisScheduler] = {}
        self._dead_devs: set = set()
        self._next_dev = 0
        self._migrations = 0          # cross-GPU task moves (cluster-level)
        self.transfers = 0            # inter-GPU state payloads actually moved
        self._state_dev: Dict[int, int] = {}   # job_id -> device holding state
        self._next_wake = math.inf
        self._batch_widen = 1.0
        for _ in range(n_gpus):
            self._add_device()
        self.tasks: List[Task] = [
            self.workers[0].make_task(s, i) for i, s in enumerate(specs)]
        self._offline_place()

    # ------------------------------------------------------- construction
    def _device_model_for(self, d: int) -> DeviceModel:
        return self.device_models[d % len(self.device_models)]

    def _add_device(self) -> int:
        d = self._next_dev
        self._next_dev += 1
        # a device added mid-run inherits the fleet's CURRENT per-device
        # shape (a reconfigure may have reshaped it since construction)
        src_cfg = next((self.workers[x].cfg for x in self.live_devices()),
                       self._cfg_template)
        w = DarisScheduler([], dataclasses.replace(src_cfg),
                           self._device_model_for(d), ctx_ns=d)
        w.batch_widen = self._batch_widen   # fleet-wide degradation knob
        self.workers[d] = w
        self._absorb(w)
        return d

    def _absorb(self, w: DarisScheduler) -> None:
        """Fold a fresh worker's per-context structures into the shared
        namespace and point the worker at the shared tables (its keys are
        namespaced, so workers never collide)."""
        for lane, inst in w.lanes.items():
            self.lanes[lane] = inst
        w.lanes = self.lanes
        self.queues.update(w.queues)
        w.queues = self.queues
        # the dispatch hot-set is fleet-global too: re-point the fresh
        # worker's queues (and any it creates later) at the shared one
        # (register_hot is state-based, so re-registering is idempotent)
        for k, q in self.queues.items():
            q.register_hot(k, self.hot_queues)
        w.hot_queues = self.hot_queues
        self.active_jobs.update(w.active_jobs)
        w.active_jobs = self.active_jobs
        w.rejections = self.rejections
        w.rejected_counts = self.rejected_counts

    def _device_streams(self, d: int) -> int:
        return sum(c.n_streams for c in self.workers[d].live_contexts())

    def _place_ordered(self, ordered: List[Task], now: float,
                       loads: Dict[int, float],
                       utils: Dict[int, Dict[CtxKey, float]], *,
                       reseed: bool = False) -> int:
        """Greedy Algorithm-1 placement shared by every re-place pass:
        each task goes to the least-loaded device in ``loads``, then to
        that device's least-utilized context in ``utils``; both
        accumulators update incrementally (speed-normalized). ``reseed``
        re-derives AFET against the adopting device for never-placed
        tasks (offline construction). Returns device-change count."""
        migrated = 0
        for t in ordered:
            old_dev = t.ctx[0] if t.ctx != -1 else None
            d = min(loads, key=loads.get)
            w = self.workers[d]
            if reseed and old_dev is None and d != 0:
                w._seed_mret(t)
            util = utils[d]
            k = min(util, key=util.get)
            if old_dev != d:
                migrated += 1
            t.ctx = k
            w.tasks.append(t)
            u = t.utilization(now)
            util[k] += u / w.speed
            loads[d] += u / (w.speed * max(self._device_streams(d), 1))
        return migrated

    def _offline_place(self) -> None:
        """Global Algorithm 1: HP first (descending utilization), each
        task to the least-loaded schedulable device, then to that
        device's least-utilized context. Ordering uses worker-0 AFET
        seeds; a task adopted by another device is re-seeded against
        that device's own shape before placement."""
        ordered = hp_first(self.tasks, 0.0)
        for t in ordered:
            t.fixed_ctx = t.priority == HP
        loads = {d: 0.0 for d in self.workers}
        utils = {d: {c.index: 0.0 for c in self.workers[d].contexts}
                 for d in self.workers}
        self._place_ordered(ordered, 0.0, loads, utils, reseed=True)

    # ------------------------------------------------------------- views
    def live_devices(self) -> List[int]:
        return [d for d in self.workers if d not in self._dead_devs]

    def live_contexts(self) -> List[Context]:
        out: List[Context] = []
        for d in self.live_devices():
            out.extend(self.workers[d].live_contexts())
        return out

    @property
    def contexts(self) -> ContextTable:
        merged = ContextTable()
        for w in self.workers.values():
            merged.update(w.contexts)
        return merged

    def geometry_snapshot(self) -> Dict:
        """Fleet-wide static geometry view for offline analysis: per-device
        ``DarisScheduler.geometry_snapshot`` keyed by device id."""
        devices = {str(d): self.workers[d].geometry_snapshot()
                   for d in self.live_devices()}
        return {
            "kind": "cluster",
            "transfer_ms": self.transfer_ms,
            "devices": devices,
            "summary": f"{len(devices)} GPUs: " + "; ".join(
                f"dev{d}[{snap['summary']}]"
                for d, snap in devices.items()),
        }

    @property
    def migrations(self) -> int:
        return self._migrations + sum(w.migrations
                                      for w in self.workers.values())

    @migrations.setter
    def migrations(self, v: int) -> None:
        # the straggler path does ``sched.migrations += 1``; keep the
        # delta in the cluster-level counter
        self._migrations = v - sum(w.migrations
                                   for w in self.workers.values())

    @property
    def coalesced(self) -> int:
        return sum(w.coalesced for w in self.workers.values())

    @property
    def next_wake_ms(self) -> float:
        return self._next_wake

    @next_wake_ms.setter
    def next_wake_ms(self, v: float) -> None:
        self._next_wake = v
        for w in self.workers.values():
            w.next_wake_ms = v

    @property
    def batch_widen(self) -> float:
        return self._batch_widen

    @batch_widen.setter
    def batch_widen(self, v: float) -> None:
        # degradation-controller knob: every worker's coalescer must see
        # the same widened max-wait (same forwarding shape as next_wake)
        self._batch_widen = v
        for w in self.workers.values():
            w.batch_widen = v

    def device_load(self, d: int, now: float) -> float:
        """Placement load of a device: total utilization of every task
        homed there (Algorithm 1's offline flavor — placed load, not just
        Eq. 12's currently-active jobs), speed-normalized and divided by
        the device's stream count. Release-time admission still uses the
        workers' active-job Eq. 11-12 math."""
        w = self.workers[d]
        u = sum(t.utilization(now) for t in w.tasks)
        return u / (w.speed * max(self._device_streams(d), 1))

    def device_ctx_keys(self, d: int) -> List[CtxKey]:
        """ALL context keys of a device — including retired ones, which
        can still hold draining in-flight stages (a fault must cancel
        those too; cancelling an idle context is harmless)."""
        return [c.index for c in self.workers[d].contexts]

    def device_summary(self, now: float = 0.0) -> Dict[int, dict]:
        """Per-device snapshot block (engine ``snapshot()["devices"]``)."""
        out = {}
        for d, w in self.workers.items():
            live = w.live_contexts()
            out[d] = {
                "alive": d not in self._dead_devs,
                "model": w.device.name,
                "speed": w.device.speed,
                "live_contexts": len(live),
                "tasks": len(w.tasks),
                "queue_depth": sum(len(self.queues[c.index]) for c in live),
                "active_jobs": sum(len(self.active_jobs[c.index])
                                   for c in live),
                "load": self.device_load(d, now) if live else 0.0,
            }
        return out

    # ------------------------------------- device-relative backend interface
    def contention_of(self, k: CtxKey) -> ContentionModel:
        return self.workers[k[0]].contention

    def rate_groups(self, entries):
        by_dev: Dict[int, list] = {}
        for e in entries:
            by_dev.setdefault(e[0][0][0], []).append(e)
        return [(self.workers[d].contention, self.workers[d].contexts, grp)
                for d, grp in by_dev.items()]

    def scale_units(self) -> int:
        return len(self.live_devices())

    def scale_kwargs(self, n: int) -> Dict:
        return {"n_gpus": n}

    # ----------------------------------------------------- util delegates
    def util_hp_total(self, k: CtxKey, now: float) -> float:
        return self.workers[k[0]].util_hp_total(k, now)

    def util_lp_active(self, k: CtxKey, now: float) -> float:
        return self.workers[k[0]].util_lp_active(k, now)

    def admits(self, k: CtxKey, task: Task, now: float) -> bool:
        return self.workers[k[0]].admits(k, task, now)

    def predicted_finish(self, k: CtxKey, now: float) -> float:
        return self.workers[k[0]].predicted_finish(k, now)

    def migration_eta(self, k: CtxKey, now: float,
                      src: Optional[CtxKey], job: Optional[Job] = None
                      ) -> float:
        """Candidate ETA for moving work to ``k``: the device-local
        predicted finish, plus the inter-GPU transfer charge exactly
        when dispatch will pay it — the job holds inter-stage state
        (a stage completed somewhere, next_for_lane's rule) on a device
        other than ``k``'s. A fresh release (``job=None`` or no state
        yet) ships nothing, so remote candidates aren't penalized."""
        eta = self.workers[k[0]].predicted_finish(k, now)
        sd = self._state_dev.get(job.job_id) if job is not None else None
        if sd is not None and sd != k[0]:
            eta += self.transfer_ms
        return eta

    # --------------------------------------------------------------- online
    def add_task(self, spec: TaskSpec, now: float = 0.0) -> Task:
        """Late registration (``DarisServer.submit``): least-loaded live
        device, then that worker's own Algorithm-1-style placement."""
        live = self.live_devices()
        d = min(live, key=lambda dd: self.device_load(dd, now))
        w = self.workers[d]
        task = w.make_task(spec, len(self.tasks))
        w.place_task(task, now)
        self.tasks.append(task)
        return task

    def _move_task(self, task: Task, to_ctx: CtxKey) -> None:
        """Sticky cross-GPU migration: re-home the task (and its worker
        registration) onto ``to_ctx``'s device."""
        # Task is eq=False: remove() degrades to an identity scan, which
        # is exactly the intent here  # dsan: ignore[DSAN005]
        self.workers[task.ctx[0]].tasks.remove(task)
        task.ctx = to_ctx
        self.workers[to_ctx[0]].tasks.append(task)
        self._migrations += 1

    def on_release(self, task: Task, now: float) -> Optional[Job]:
        """Global dispatcher: the home device handles the release (its
        own Eq. 11-12 admission + intra-device migration); when the home
        device has no admitting context at all, the task migrates to the
        live device whose admitting context promises the earliest
        finish — DARIS's §IV-B1 migration rule lifted across GPUs. A
        fresh release ships no inter-stage state, so candidate ETAs are
        NOT transfer-charged here (the charge applies to in-flight
        moves: straggler kills and fault replays — ``migration_eta``).
        HP tasks keep their fixed (device, context) home."""
        home = self.workers[task.ctx[0]]
        needs_test = task.priority == LP or home.cfg.overload_hpa
        if (needs_test and not task.fixed_ctx
                and not home.admits(task.ctx, task, now)):
            # a release that joins an open batch head charges only the
            # incremental Eq. 12 utilization, so it can coalesce at home
            # even when full-task admission just failed — probe BEFORE
            # the cross-GPU fallback or it migrates needlessly. On the
            # common admit-at-home path home.on_release probes instead.
            if home._coalescer is not None:
                head = home._try_coalesce(task, now)
                if head is not None:
                    return head
            # home context is full; only if the whole home DEVICE has no
            # admitting context does the release go cross-GPU (the cheap
            # common case — home admits — pays one extra Eq. 12 test)
            if not any(home.admits(c.index, task, now)
                       for c in home.live_contexts()):
                src = task.ctx
                cands = [c.index
                         for d in self.live_devices() if d != src[0]
                         for c in self.workers[d].live_contexts()
                         if self.workers[d].admits(c.index, task, now)]
                if cands:
                    k = min(cands,
                            key=lambda c: self.migration_eta(c, now, src))
                    self._move_task(task, k)
                    home = self.workers[k[0]]
        return home.on_release(task, now)

    def on_stage_finish(self, inst: StageInstance, now: float,
                        et_ms: float) -> Optional[Job]:
        """Delegate to the worker of the device that EXECUTED the stage
        (its speed factor normalizes the MRET observation); job/queue
        bookkeeping runs on the shared tables either way."""
        dev = inst.lane[0][0] if inst.lane is not None else inst.job.ctx[0]
        done = self.workers[dev].on_stage_finish(inst, now, et_ms)
        if done is not None:
            self._state_dev.pop(done.job_id, None)
        else:
            # state location commits at COMPLETION, not dispatch: a
            # transfer-charged stage that is straggler-killed or
            # cancelled never finished moving the state, so its replay
            # must pay the charge again
            self._state_dev[inst.job.job_id] = dev
        return done

    def find_job(self, task_index: int, release_ms: float):
        # the active-job table is shared, so the single-GPU scan applies
        return DarisScheduler.find_job(self, task_index, release_ms)

    def cancel_job(self, task_index: int, release_ms: float, now: float):
        """Cancellation across the fleet: resolve against the shared job
        table, then let the worker that HOMES the job run the single-GPU
        retirement (its coalescer holds any open batch head). A queued
        whole-job cancel never reaches ``on_stage_finish``, so the
        inter-stage state pointer is released here."""
        job, member = DarisScheduler.find_job(self, task_index, release_ms)
        if job is None:
            return "absent", None
        outcome, job = self.workers[job.ctx[0]]._cancel_found(job, member, now)
        if outcome == "cancelled":
            self._state_dev.pop(job.job_id, None)
        return outcome, job

    def abort_job(self, job: Job, now: float) -> None:
        """Chaos-layer give-up on the shared tables (see the single-GPU
        version); the fleet additionally releases the job's inter-stage
        state pointer — an aborted job never finishes a stage again."""
        DarisScheduler.abort_job(self, job, now)
        self._state_dev.pop(job.job_id, None)

    def next_for_lane(self, ctx_key: CtxKey, now: float
                      ) -> Optional[StageInstance]:
        """Dispatch for one lane's context, stamping the inter-GPU
        transfer cost whenever the job's inter-stage state lives on a
        different device (the zero-delay migration made physical: state
        moves between stage programs, charged to the receiving stage)."""
        inst = self.workers[ctx_key[0]].next_for_lane(ctx_key, now)
        if inst is None:
            return None
        dev = ctx_key[0]
        # src = device holding the last COMPLETED stage's output (absent
        # for stage 0: the input materializes wherever it first runs)
        src = self._state_dev.get(inst.job.job_id)
        if src is None or src == dev:
            inst.transfer_ms = 0.0
        else:
            inst.transfer_ms = self.transfer_ms
            self.transfers += 1     # counts charged attempts (a killed
                                    # transfer stage pays again on replay)
        return inst

    def free_lanes(self) -> List[tuple]:
        return self.lanes.free_lanes()

    # ------------------------------------------------------ fault / elastic
    def fault_cancel_keys(self, key: CtxKey) -> List[CtxKey]:
        """Mirrors ``fail_context``'s escalation: when the fault will
        take the device's last live context, the whole-device failure
        requeues in-flight stages from every context (retired ones may
        still be draining), so the engine must cancel all of them."""
        dev = self.fault_escalates_to(key)
        if dev is None:
            return [key]
        return self.device_ctx_keys(dev)

    def fault_escalates_to(self, key: CtxKey) -> Optional[int]:
        """Device a context fault would escalate to (it targets the
        device's last LIVE context), or None. The engine consults this
        to skip a planned fault that would kill the fleet's last
        survivor — mirroring its FAIL_DEV handling."""
        dev = key[0]
        if dev in self._dead_devs:
            return None
        w = self.workers[dev]
        ctx = w.contexts.get(key)
        if (ctx is None or not ctx.alive
                or len(w.live_contexts()) != 1):
            return None             # incl. retired keys: no escalation
        return dev

    def fail_context(self, key: CtxKey, now: float):
        """Single-partition loss inside one device: the worker re-places
        intra-device. Losing the device's LAST live context escalates to
        a whole-device failure (surviving devices inherit)."""
        dev = key[0]
        if dev in self._dead_devs:
            return []                     # nothing left to fail
        if key not in self.queues:
            # reconfigure creates contexts at fresh indices, so bad keys
            # can only be caught here — with a diagnosable error, not
            # the KeyError the worker's table would throw mid-replace
            raise ValueError(
                f"unknown context key {key!r}; device {dev} has contexts "
                f"{[c.index for c in self.workers[dev].contexts]}")
        w = self.workers[dev]
        live = w.live_contexts()
        if not live:
            return []
        # escalation is for losing the device's LAST live context; a
        # fault on an already-retired (draining) key must not take the
        # healthy survivor down with it
        if w.contexts[key].alive and len(live) == 1:
            return self.fail_device(dev, now)
        return w.fail_context(key, now)

    def fail_device(self, dev: int, now: float) -> List[StageInstance]:
        """Whole-GPU loss: every task homed there re-places HP-first onto
        the least-loaded surviving devices (each move is a cross-GPU
        migration); in-flight stages replay from their last boundary on
        the new home — with the transfer charge, since their inter-stage
        state must be refetched (the dead device can't ship it)."""
        if dev in self._dead_devs:
            raise ValueError(f"device {dev} already dead")
        if self.live_devices() == [dev]:
            # checked BEFORE any mutation: callers get a clean error,
            # not a half-retired fleet (the engine skips this case)
            raise RuntimeError(f"cannot fail device {dev}: it is the "
                               f"last live device")
        w = self.workers[dev]
        orphans = self._retire_device(dev)
        # beyond graceful retirement: busy lanes die on EVERY context of
        # the device — stages still draining on contexts an earlier
        # reconfigure retired are just as gone as the live ones
        for c in w.contexts:
            for lane, inst in self.lanes.busy_in_ctx(c.index):
                orphans.append(inst)
                self.lanes[lane] = None
                inst.work_done = 0.0      # replay from stage start
        live = self.live_devices()   # non-empty: prechecked above
        moved, w.tasks = w.tasks, []
        ordered = hp_first(moved, now)
        # survivors keep their current load: seed the accumulators with
        # what is already placed/active there, then place incrementally
        loads = {d: self.device_load(d, now) for d in live}
        utils = {d: {c.index: (self.workers[d].util_hp_total(c.index, now)
                               + self.workers[d].util_lp_active(c.index, now))
                     for c in self.workers[d].live_contexts()}
                 for d in live}
        self._migrations += self._place_ordered(ordered, now, loads, utils)
        self._rehome_orphans(orphans)
        return orphans

    def _rehome_orphans(self, orphans: List[StageInstance]) -> None:
        """Requeue orphaned stage instances at their task's (possibly
        new) home, moving the active-job registration along."""
        for inst in orphans:
            job = inst.job
            old = job.ctx
            tgt = job.task.ctx
            jobs = self.active_jobs.get(old)
            if jobs is not None and job in jobs:
                del jobs[job]
                self.active_jobs[tgt][job] = None
            job.ctx = tgt
            inst.lane = None
            self.queues[tgt].push(inst)

    def _retire_device(self, d: int) -> List[StageInstance]:
        """Graceful (zero-delay) device retirement: queued work drains
        out for re-homing, in-flight stages FINISH on their lanes and
        migrate at the next boundary — nothing replays (contrast
        ``fail_device``)."""
        w = self.workers[d]
        self._dead_devs.add(d)
        orphans: List[StageInstance] = []
        for c in list(w.live_contexts()):
            c.alive = False
            self.lanes.retire_ctx(c.index)
            orphans.extend(self.queues[c.index].drain())
        w._invalidate_live()
        return orphans

    def _global_replace(self, now: float,
                        extra_orphans: List[StageInstance]) -> int:
        """Algorithm 1 re-run across the whole fleet (HP first), used by
        whole-GPU elasticity: every task lands on the least-loaded live
        device's least-utilized context; queued stages re-home, in-flight
        stages finish where they run and migrate at the next stage
        boundary (zero-delay). Returns the number of cross-device moves
        (each counted into ``migrations``)."""
        orphans = list(extra_orphans)
        live = self.live_devices()
        for d in live:
            for c in self.workers[d].live_contexts():
                orphans.extend(self.queues[c.index].drain())
        all_tasks: List[Task] = []
        for w in self.workers.values():
            all_tasks.extend(w.tasks)
            w.tasks = []
        loads = {d: 0.0 for d in live}
        utils = {d: {c.index: 0.0 for c in self.workers[d].live_contexts()}
                 for d in live}
        migrated = self._place_ordered(hp_first(all_tasks, now), now,
                                       loads, utils)
        # re-home live jobs to their task's new context; their running
        # stage (if any) finishes on its current lane
        for key in list(self.active_jobs):
            jobs = self.active_jobs[key]
            for job in list(jobs):
                tgt = job.task.ctx
                if tgt != key:
                    del jobs[job]
                    self.active_jobs[tgt][job] = None
                    job.ctx = tgt
        self._rehome_orphans(orphans)
        self._migrations += migrated
        return migrated

    def add_context(self, now: float) -> Context:
        """Scale-out by one context, on the least-loaded live device."""
        live = self.live_devices()
        d = min(live, key=lambda dd: self.device_load(dd, now))
        return self.workers[d].add_context(now)

    def reconfigure(self, now: float, n_gpus: Optional[int] = None,
                    n_contexts: Optional[int] = None,
                    n_streams: Optional[int] = None,
                    oversubscription: Optional[float] = None) -> dict:
        """Online cluster reshape. Per-device shape kwargs forward to
        every live worker's own Eq. 9 reconfigure; ``n_gpus`` scales by
        whole devices — growing appends fresh workers (device models
        cycle through ``device_models``), shrinking retires the
        highest-numbered live devices gracefully — followed by a global
        Algorithm 1 re-place with zero-delay migration."""
        info = {"retired": [], "created": [], "rehomed": 0, "inflight": 0,
                "migrated": 0, "devices_added": [], "devices_retired": []}
        shape = {k: v for k, v in (("n_contexts", n_contexts),
                                   ("n_streams", n_streams),
                                   ("oversubscription", oversubscription))
                 if v is not None}
        if shape and n_gpus is not None:
            # the per-device reshape and the whole-fleet resize each run
            # their own full re-place; combined they'd shuffle every
            # task twice and double-count migrations — demand two events
            raise ValueError(
                "reshape contexts/streams/oversubscription and n_gpus in "
                "separate reconfigure events (each runs one re-place)")
        if shape:
            for d in self.live_devices():
                sub = self.workers[d].reconfigure(now, **shape)
                for key in ("retired", "created"):
                    info[key] += sub[key]
                for key in ("rehomed", "inflight", "migrated"):
                    info[key] += sub[key]
        if n_gpus is not None:
            if n_gpus < 1:
                raise ValueError(f"reconfigure needs n_gpus >= 1, got "
                                 f"{n_gpus}")
            live = self.live_devices()
            orphans: Optional[List[StageInstance]] = None
            if n_gpus > len(live):
                orphans = []
                for _ in range(n_gpus - len(live)):
                    info["devices_added"].append(self._add_device())
            elif n_gpus < len(live):
                orphans = []
                for d in live[n_gpus - len(live):]:
                    orphans.extend(self._retire_device(d))
                    info["devices_retired"].append(d)
            if orphans is not None:
                info["migrated"] += self._global_replace(now, orphans)
                info["rehomed"] += len(orphans)
        return info
