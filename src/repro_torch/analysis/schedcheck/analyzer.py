# Copy of src/repro/analysis/schedcheck/analyzer.py; only this line differs (tests/test_torch_isolation.py checks it).
"""SchedCheck analyzer: static WCRT bounds for a ServerConfig timeline.

Takes an *unbuilt* ``ServerConfig`` and — without running the engine —
computes per-task worst-case response-time (WCRT) bounds and
schedulability verdicts:

* Per-stage worst-case execution bounds from the same contention model
  the simulator runs (``repro.runtime.contention``), but with every
  adversarial input independently worst-cased: the Eq. 9 lane geometry
  gives each context's SM share, the device-wide co-resident set (max
  ``n_sat`` / ``mem_frac`` over every stage that can run concurrently)
  gives interference, and a ``+6 sigma`` lognormal headroom covers the
  sim's execution-time noise.  Each step of the contention pipeline is
  monotone in its inputs, so worst-casing them independently yields a
  sound lower bound on lane speed (``_worst_speed``); the >= 1 bubble
  gain is dropped.
* Eq. 8 virtual-deadline slices and MRET seeds come from the real
  AFET seeding path (``DarisScheduler._seed_mret``), not a re-derivation.
* Per-task WCRT via a standard response-time fixed point: own cost +
  non-preemptive LP blocking per stage + one straggler/watchdog kill
  allowance per job + batch-coalescing hold + periodic interference
  from same-context tasks spread over the context's streams.
* Eq. 11/12 headroom checks at both solo (optimistic) and worst-case
  utilizations decide the verdict class; the binding constraint is
  named on every verdict (see ``model`` for the verdict contract).

The *whole configured timeline* is analyzed: ``reconfigure_at`` /
``fail_context_at`` / ``fail_device_at`` / ``scale_out_at`` and chaos
brownout edges partition the horizon into epochs.  Each event is
replayed against a real (never-run) ``DarisScheduler`` /
``ClusterScheduler`` instance — the exact Algorithm-1 re-place the
engine would perform — and each epoch's resulting placement is
re-verified.  Autoscaling adds a *hypothetical* epoch at the scale-in
floor: a plan is only as good as its worst reachable shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ...core.scheduler import DarisScheduler, SchedulerConfig
from ...core.task import HP, Task
from ...runtime.arrivals import (ManualArrival, PeriodicArrival,
                                 TraceArrival)
from ...runtime.contention import batch_speedup, batched_stage_ms
from .model import (CONDITIONAL, GUARANTEED, UNSCHEDULABLE, EpochReport,
                    Report, StageBound, TaskVerdict)

_NOISE_SIGMAS = 6.0        # lognormal headroom: bound at e^{6 sigma}
_MAX_ITER = 200            # WCRT fixed-point iteration cap
_DIVERGE_FACTOR = 10.0     # R > 10 D (+slack) => busy period diverged
_MIN_SPEED = 1e-6

PERIODIC = "periodic"
SPORADIC = "sporadic"      # min inter-release gap known, phase unknown
APERIODIC = "aperiodic"    # no inter-release lower bound (Poisson, ...)


# --------------------------------------------------------------- arrivals
@dataclasses.dataclass
class _ArrivalModel:
    kind: str
    period_ms: float           # inter-release lower bound
    note: Optional[str] = None


def _arrival_model(spec, proc, open_loop) -> _ArrivalModel:
    """Classify one task's release process for the WCRT math."""
    if proc is None and open_loop is not None:
        return _ArrivalModel(APERIODIC, spec.period_ms,
                             "open-loop Poisson arrivals")
    if proc is None:
        return _ArrivalModel(PERIODIC, spec.period_ms)
    if isinstance(proc, PeriodicArrival):
        period = proc.period_ms if proc.period_ms else spec.period_ms
        return _ArrivalModel(PERIODIC, period)
    if isinstance(proc, ManualArrival):
        return _ArrivalModel(
            SPORADIC, spec.period_ms,
            "manual arrivals analyzed at the declared rate (1/period); "
            "clients submitting faster void the verdict")
    if isinstance(proc, TraceArrival):
        times = list(proc.times)
        if len(times) < 2:
            return _ArrivalModel(SPORADIC, spec.period_ms)
        gap = min(b - a for a, b in zip(times, times[1:]))
        if gap <= 0:
            return _ArrivalModel(APERIODIC, spec.period_ms,
                                 "trace contains coincident releases")
        return _ArrivalModel(SPORADIC, gap,
                             "trace analyzed at its min inter-release gap")
    return _ArrivalModel(APERIODIC, spec.period_ms,
                         f"unknown arrival process "
                         f"{type(proc).__name__}")


# ------------------------------------------------------------------ model
@dataclasses.dataclass
class _Model:
    """Config-level inputs shared by every epoch's analysis."""

    noise_head: float                    # e^{6 sigma} (1.0 when noise off)
    max_batch: int                       # 1 when dynamic batching off
    kill_kappa: float                    # max(straggler, chaos watchdog)
    transfer_ms: float                   # cluster cross-GPU charge (else 0)
    stall_ms: float                      # chaos lane-stall charge (else 0)
    arrivals: Dict[str, _ArrivalModel]   # task name -> release model
    caps: List[Tuple[str, str]]          # config-wide (binding, note) caps
    lp_caps: List[Tuple[str, str]]       # LP-only caps (degradation)


@dataclasses.dataclass
class _TaskBounds:
    task: Task
    arrival: _ArrivalModel
    stages: List[StageBound]
    c_wc: float                # sum of stage worst cases (device wall ms)
    c_solo: float              # optimistic floor
    allow_ms: float            # one straggler/watchdog kill per job
    hold_ms: float             # batch-coalescing head-of-line hold

    @property
    def t_eff(self) -> float:
        return self.arrival.period_ms

    @property
    def deadline(self) -> float:
        return self.task.spec.deadline_ms


def _effective_nsat(prof, n_units: float, b: int) -> float:
    """Width of a b-input stage (ContentionModel.batched_profile)."""
    if b <= 1:
        return prof.n_sat
    return min(n_units, prof.n_sat * math.sqrt(batch_speedup(prof, b)))


def _worst_speed(dev, nsat: float, mf: float, share: float,
                 total_share_cap: float, m_total: int,
                 co_nsat: float, co_mf: float) -> float:
    """Sound lower bound on the contention-model rate of a stage with
    effective profile ``(nsat, mf)`` on a lane holding ``share`` units.

    Mirrors ``ContentionModel._rates_scalar`` step by step, with each
    adversarial input worst-cased independently (every step is monotone
    in the co-tenant inputs, so the composition is a lower bound):
    device-cap rescale at full subscription, unit starvation with the
    bubble-recovery gain (>= 1) dropped, bandwidth shrink against
    ``m_total - 1`` maximal co-residents, and the L2-thrash memory
    pressure denominator at maximal co-resident ``mem_frac``.
    """
    n_units = dev.n_units
    u = share
    if total_share_cap > n_units:
        u *= n_units / total_share_cap
    speed = min(1.0, min(u, nsat) / nsat)
    if m_total > 1:
        used_max = nsat + (m_total - 1) * co_nsat
        budget = n_units * (1.0 + dev.bubble * (1.0 - 1.0 / m_total))
        if used_max > budget:
            speed *= budget / used_max
        thrash = 1.0 + dev.l2_pressure * (m_total - 1)
        phi_max = thrash * (mf + (m_total - 1) * co_mf)
        if phi_max > 1.0:
            speed /= (1.0 - mf) + mf * phi_max
    return max(speed, _MIN_SPEED)


def _fixed_point(base: float, interferers: Sequence[Tuple[float, float, int]],
                 m: int, deadline: float) -> float:
    """Response-time recurrence R = base + sum_h n_h(R) C_h / m with
    n_h(R) = floor(R/T_h) + extra (extra=1 for other tasks' carry-in,
    0 for self-interference when D > T). Returns inf on divergence."""
    r = base
    limit = _DIVERGE_FACTOR * deadline + 1e4
    for _ in range(_MAX_ITER):
        interf = 0.0
        for period, cost, extra in interferers:
            interf += (math.floor(r / period) + extra) * cost
        r_new = base + interf / max(m, 1)
        if r_new <= r + 1e-9:
            return r_new
        r = r_new
        if r > limit:
            return math.inf
    return math.inf


# ------------------------------------------------------------ entry point
def analyze_config(cfg, *, label: Optional[str] = None) -> Report:
    """Statically analyze an (unbuilt) ``ServerConfig``; returns a
    ``Report``. Never runs the engine and never mutates ``cfg``."""
    cfg._validate()
    label = label or f"{cfg._backend_kind} x{len(cfg._specs)} tasks"
    assumptions: List[str] = []
    sched_cfg = dataclasses.replace(cfg._scheduler_config())

    noise_sigma = cfg._noise_sigma
    if cfg._backend_kind == "sim" and noise_sigma is None:
        noise_sigma = 0.06
    noise_head = math.exp(_NOISE_SIGMAS * (noise_sigma or 0.0))
    if noise_head > 1.0:
        assumptions.append(
            f"stage-time noise bounded at e^(6 sigma) = x{noise_head:.3f} "
            f"(sigma={noise_sigma:g}); beyond-6-sigma draws are outside "
            f"the guarantee")
    if cfg._backend_kind != "sim":
        assumptions.append(
            "realtime backend: wall-clock execution analyzed through the "
            "calibrated sim contention model")

    batch_policy = cfg._batch_policy or getattr(sched_cfg, "batch_policy",
                                                None)
    max_batch = int(getattr(batch_policy, "max_batch", 1) or 1)

    kappa_strag = (sched_cfg.straggler_kappa
                   if cfg._backend_kind == "sim" else 0.0)
    chaos = cfg._chaos_plan
    kappa_wd = float(getattr(chaos, "watchdog_kappa", 0.0) or 0.0)
    kill_kappa = max(kappa_strag or 0.0, kappa_wd)
    if kill_kappa > 0.0:
        assumptions.append(
            f"at most one straggler/watchdog kill per job "
            f"(kappa={kill_kappa:g})")

    caps: List[Tuple[str, str]] = []
    lp_caps: List[Tuple[str, str]] = []
    stall_ms = 0.0
    if chaos is not None:
        if getattr(chaos, "stage_fault_rate", 0.0) > 0.0:
            caps.append((
                "chaos-fault-rate",
                f"stage faults injected at rate "
                f"{chaos.stage_fault_rate:g}: a job can exhaust its "
                f"retry budget, so no static completion guarantee"))
        if getattr(chaos, "stall_rate", 0.0) > 0.0:
            stall_ms = float(chaos.stall_ms)
            assumptions.append(
                f"chaos lane stalls charged on every stage launch "
                f"(+{stall_ms:g}ms worst case)")
        if getattr(chaos, "degradation", None) is not None:
            lp_caps.append((
                "degradation-shedding",
                "degradation controller may shed LP admissions under "
                "overload"))
    if getattr(sched_cfg, "overload_hpa", False):
        assumptions.append(
            "overload_hpa: HP releases are admission-tested; the bound "
            "covers admitted jobs only")

    arrivals = {
        s.name: _arrival_model(s, cfg._arrivals.get(s.name), cfg._open_loop)
        for s in cfg._specs
    }
    for am in arrivals.values():
        if am.note and am.note not in assumptions:
            assumptions.append(am.note)

    transfer_ms = (float(cfg._cluster["transfer_ms"])
                   if cfg._cluster is not None else 0.0)
    if transfer_ms > 0.0:
        assumptions.append(
            f"cluster: every stage charged the worst-case cross-GPU "
            f"transfer ({transfer_ms:g}ms)")

    if cfg._sched_cls is not DarisScheduler or cfg._sched_cls_kw:
        assumptions.append(
            f"custom scheduler_cls {cfg._sched_cls.__name__} analyzed as "
            f"the base DarisScheduler placement")

    model = _Model(noise_head=noise_head, max_batch=max_batch,
                   kill_kappa=kill_kappa, transfer_ms=transfer_ms,
                   stall_ms=stall_ms, arrivals=arrivals, caps=caps,
                   lp_caps=lp_caps)

    sched = _fresh_sched(cfg, sched_cfg)
    epochs = _replay_timeline(cfg, model, sched, assumptions)
    hypothetical = _autoscale_floor(cfg, model, sched_cfg, assumptions)

    return Report(label=label, horizon_ms=cfg._horizon_ms, epochs=epochs,
                  hypothetical=hypothetical, assumptions=assumptions)


def _fresh_sched(cfg, sched_cfg: SchedulerConfig, *,
                 n_gpus: Optional[int] = None):
    """Build the analysis scheduler exactly as ``DarisServer`` would —
    Algorithm-1 placement included — but never wire it to a backend."""
    specs = list(cfg._specs)
    if cfg._cluster is not None:
        from ...cluster.scheduler import ClusterScheduler
        return ClusterScheduler(
            specs, dataclasses.replace(sched_cfg), cfg._device,
            n_gpus=n_gpus if n_gpus is not None else cfg._cluster["n_gpus"],
            device_models=cfg._cluster["device_models"],
            transfer_ms=cfg._cluster["transfer_ms"])
    return DarisScheduler(specs, dataclasses.replace(sched_cfg),
                          cfg._device)


# --------------------------------------------------------- timeline replay
def _collect_events(cfg) -> List[Tuple[float, int, str, object]]:
    """(t, kind_rank, kind, payload) — kind_rank mirrors the engine's
    same-timestamp ordering (FAULT < FAIL_DEV < ADD_CTX < RECONFIG)."""
    ev: List[Tuple[float, int, str, object]] = []
    fp = cfg._fault_plan
    if fp is not None:
        if fp.fail_ctx_at is not None:
            key, t = fp.fail_ctx_at
            ev.append((float(t), 0, "fail-context", key))
        if fp.fail_device_at is not None:
            dev, t = fp.fail_device_at
            ev.append((float(t), 1, "fail-device", dev))
        if fp.add_ctx_at is not None:
            ev.append((float(fp.add_ctx_at), 2, "scale-out", None))
        for t, kwargs in (fp.reconfigure_at or []):
            ev.append((float(t), 3, "reconfigure", dict(kwargs)))
    if cfg._chaos_plan is not None:
        for b in cfg._chaos_plan.brownouts:
            ev.append((float(b.t0_ms), 4, "brownout-start", b))
            ev.append((float(b.t1_ms), 5, "brownout-end", b))
    ev.sort(key=lambda e: (e[0], e[1]))
    return ev


def _replay_timeline(cfg, model: _Model, sched,
                     assumptions: List[str]) -> List[EpochReport]:
    horizon = cfg._horizon_ms
    events = [e for e in _collect_events(cfg) if e[0] < horizon]
    epochs: List[EpochReport] = []
    brown: List[object] = []
    carry: Dict[Optional[int], Tuple[int, float]] = {}
    t0, cause, detail = 0.0, "build", "initial Algorithm-1 placement"

    i = 0
    while True:
        t1 = events[i][0] if i < len(events) else horizon
        if t1 > t0 or not epochs:
            epochs.append(_analyze_epoch(model, sched, t0, t1, cause,
                                         detail, carry, brown))
            carry = {}
        if i >= len(events):
            return epochs
        # apply every event at this timestamp in engine order
        t0 = t1
        descs: List[str] = []
        kinds: List[str] = []
        while i < len(events) and events[i][0] == t0:
            _, _, kind, payload = events[i]
            i += 1
            try:
                desc, carry_upd = _apply_event(sched, t0, kind, payload,
                                               brown)
            except RuntimeError:
                # "all contexts failed": nothing left to schedule on
                epochs.append(_dead_epoch(sched, cfg, t0, horizon))
                return epochs
            kinds.append(kind)
            descs.append(desc)
            carry.update(carry_upd)
        if carry:
            assumptions_note = ("reconfigure: draining lanes of the "
                                "previous shape assumed to clear within "
                                "the following epoch")
            if assumptions_note not in assumptions:
                assumptions.append(assumptions_note)
        cause = "+".join(dict.fromkeys(kinds))
        detail = "; ".join(descs)
    return epochs


def _apply_event(sched, t: float, kind: str, payload, brown: List[object]
                 ) -> Tuple[str, Dict[Optional[int], Tuple[int, float]]]:
    """Replay one timeline event with the engine's skip semantics.
    Returns (description, carry-over {device: (streams, caps)})."""
    is_cluster = hasattr(sched, "workers")
    if kind == "fail-context":
        key = payload
        if is_cluster:
            if key not in sched.queues:
                return f"fault ctx {key} skipped (no such context)", {}
            esc = sched.fault_escalates_to(key)
            if esc is not None and sched.live_devices() == [esc]:
                return (f"fault ctx {key} skipped (would kill the last "
                        f"device)", {})
            sched.fail_context(key, t)
            return f"context {key} failed; survivors re-placed", {}
        if key not in sched.contexts:
            return f"fault ctx {key} skipped (no such context)", {}
        sched.fail_context(key, t)   # may raise RuntimeError (total failure)
        return f"context {key} failed; survivors re-placed", {}
    if kind == "fail-device":
        dev = payload
        if not is_cluster:
            return "fail-device skipped (single-device server)", {}
        live = sched.live_devices()
        if dev not in live:
            return f"fail device {dev} skipped (not live)", {}
        if live == [dev]:
            return f"fail device {dev} skipped (last live device)", {}
        sched.fail_device(dev, t)
        return f"device {dev} failed; fleet re-placed", {}
    if kind == "scale-out":
        ctx = sched.add_context(t)
        return f"scale-out: context {ctx.index} added", {}
    if kind == "reconfigure":
        kwargs = dict(payload)
        carry: Dict[Optional[int], Tuple[int, float]] = {}
        shape_change = any(kwargs.get(f) is not None
                           for f in ("n_contexts", "n_streams",
                                     "oversubscription"))
        if shape_change:
            # retired lanes may still be draining into the next epoch
            if is_cluster:
                for d in sched.live_devices():
                    live = sched.workers[d].live_contexts()
                    carry[d] = (sum(c.n_streams for c in live),
                                sum(c.cap for c in live))
            else:
                live = sched.live_contexts()
                carry[None] = (sum(c.n_streams for c in live),
                               sum(c.cap for c in live))
        sched.reconfigure(t, **kwargs)
        args = ", ".join(f"{k}={v}" for k, v in kwargs.items()
                         if v is not None)
        return f"reconfigure({args}); full re-place", carry
    if kind == "brownout-start":
        brown.append(payload)
        b = payload
        return (f"brownout on device {b.device} "
                f"(x{b.slow_factor:g} slowdown)", {})
    if kind == "brownout-end":
        if payload in brown:
            brown.remove(payload)
        return f"brownout on device {payload.device} cleared", {}
    raise ValueError(f"unknown timeline event kind {kind!r}")


def _dead_epoch(sched, cfg, t0: float, horizon: float) -> EpochReport:
    verdicts = [
        TaskVerdict(
            task=t.spec.name, priority="HP" if t.priority == HP else "LP",
            ctx="-", device=None, period_ms=t.spec.period_ms,
            deadline_ms=t.spec.deadline_ms, wcrt_ms=math.inf,
            wcrt_nolp_ms=math.inf, solo_ms=math.inf, util_wc=math.inf,
            util_solo=math.inf, verdict=UNSCHEDULABLE,
            binding="total-failure",
            detail="the fault plan kills every context; no capacity "
                   "remains from this point on")
        for t in sched.tasks]
    return EpochReport(t0_ms=t0, t1_ms=horizon, cause="total-failure",
                       detail="fault plan leaves zero live contexts",
                       geometry={"summary": "no live contexts"},
                       tasks=verdicts)


# ---------------------------------------------------------- epoch analysis
def _device_views(sched) -> Iterator[Tuple[Optional[int], DarisScheduler,
                                           List, List[Task]]]:
    """Yield (device, worker, live contexts, placed tasks) per device.
    Task->device mapping is derived from ctx keys (the worker task lists
    can hold stale entries across re-places)."""
    if hasattr(sched, "workers"):
        by_dev: Dict[int, List[Task]] = {}
        for t in sched.tasks:
            if t.ctx == -1:
                continue
            by_dev.setdefault(t.ctx[0], []).append(t)
        for d in sched.live_devices():
            w = sched.workers[d]
            yield d, w, w.live_contexts(), by_dev.get(d, [])
    else:
        yield (None, sched, sched.live_contexts(),
               [t for t in sched.tasks if t.ctx != -1])


def _analyze_epoch(model: _Model, sched, t0: float, t1: float, cause: str,
                   detail: str, carry: Dict[Optional[int], Tuple[int, float]],
                   brown: List[object]) -> EpochReport:
    tasks_out: List[TaskVerdict] = []
    ctx_rows: List[Dict] = []
    for dev, w, live, dev_tasks in _device_views(sched):
        dev_idx = 0 if dev is None else dev
        slow = 1.0
        for b in brown:
            if getattr(b, "device", 0) == dev_idx:
                slow = max(slow, float(b.slow_factor))
        c_streams, c_caps = carry.get(dev, (0, 0.0))
        m_total = sum(c.n_streams for c in live) + c_streams
        total_share_cap = sum(c.cap for c in live) + c_caps

        # worst co-resident stage over everything placeable on the device
        co_nsat, co_mf = 0.0, 0.0
        for t in dev_tasks:
            b_eff = model.max_batch if model.max_batch > 1 else t.spec.batch
            for prof in t.spec.stages:
                co_nsat = max(co_nsat, _effective_nsat(
                    prof, w.device.n_units, b_eff))
                co_mf = max(co_mf, prof.mem_frac)

        for c in live:
            ctx_tasks = [t for t in dev_tasks if t.ctx == c.index]
            bounds = [
                _task_bounds(model, w, c, t, m_total, total_share_cap,
                             co_nsat, co_mf, slow)
                for t in ctx_tasks]
            tasks_out.extend(
                _ctx_verdicts(model, c, bounds, dev))
            hp_b = [b for b in bounds if b.task.priority == HP]
            lp_b = [b for b in bounds if b.task.priority != HP]
            ctx_rows.append({
                "ctx": str(c.index), "device": dev,
                "cap": c.cap, "n_streams": c.n_streams,
                "hp_tasks": [b.task.spec.name for b in hp_b],
                "lp_tasks": [b.task.spec.name for b in lp_b],
                "hp_util_wc": sum(b.c_wc / b.t_eff for b in hp_b),
                "hp_util_solo": sum(b.c_solo / b.t_eff for b in hp_b),
                "lp_util_wc": sum(b.c_wc / b.t_eff for b in lp_b),
                "remaining_util_afet": w.remaining_util(c.index, 0.0),
            })
    return EpochReport(t0_ms=t0, t1_ms=t1, cause=cause, detail=detail,
                       geometry=sched.geometry_snapshot(),
                       tasks=tasks_out, contexts=ctx_rows)


def _task_bounds(model: _Model, w: DarisScheduler, ctx, task: Task,
                 m_total: int, total_share_cap: float, co_nsat: float,
                 co_mf: float, slow: float) -> _TaskBounds:
    """Per-stage worst-case/solo bounds + per-job allowances for one task."""
    spec = task.spec
    b_eff = model.max_batch if model.max_batch > 1 else spec.batch
    share = ctx.cap / max(ctx.n_streams, 1)
    vdls = task.mret.virtual_deadlines(spec.deadline_ms)
    dev = w.device
    stages: List[StageBound] = []
    max_thresh = 0.0
    for j, prof in enumerate(spec.stages):
        nsat = _effective_nsat(prof, dev.n_units, b_eff)
        alone_b = batched_stage_ms(prof, b_eff) + prof.overhead_ms
        work = alone_b * model.noise_head / w.speed
        ws = _worst_speed(dev, nsat, prof.mem_frac, share,
                          total_share_cap, m_total, co_nsat, co_mf)
        wall = (work + model.transfer_ms + model.stall_ms) / ws * slow
        solo_rate = w.contention.solo_speed(prof, ctx.cap)
        solo = alone_b / (max(solo_rate, _MIN_SPEED) * w.speed)
        stages.append(StageBound(name=prof.name, wc_ms=wall,
                                 solo_ms=solo, vdl_ms=vdls[j]))
        if model.kill_kappa > 0.0:
            # sim straggler / chaos watchdog threshold: the elapsed time
            # a doomed attempt can burn before the kill + replay
            afet_wall = (task.mret.stage_mret(j)
                         * DarisScheduler.spec_batch_cost(spec, b_eff)
                         / w.speed)
            thresh = max(model.kill_kappa * afet_wall,
                         model.kill_kappa * wall,
                         4.0 * alone_b / w.speed)
            max_thresh = max(max_thresh, thresh)
    c_wc = sum(s.wc_ms for s in stages)
    c_solo = sum(s.solo_ms for s in stages)
    hold = vdls[0] if model.max_batch > 1 else 0.0
    return _TaskBounds(task=task, arrival=model.arrivals[spec.name],
                       stages=stages, c_wc=c_wc, c_solo=c_solo,
                       allow_ms=max_thresh, hold_ms=hold)


def _ctx_verdicts(model: _Model, ctx, bounds: List[_TaskBounds],
                  dev: Optional[int]) -> List[TaskVerdict]:
    """Verdict tree for every task on one context."""
    m = ctx.n_streams
    hp_b = [b for b in bounds if b.task.priority == HP]
    lp_b = [b for b in bounds if b.task.priority != HP]
    hp_util_wc = sum(b.c_wc / b.t_eff for b in hp_b)
    hp_util_solo = sum(b.c_solo / b.t_eff for b in hp_b)
    lp_util_wc = sum(b.c_wc / b.t_eff for b in lp_b)
    blocking = max((max(s.wc_ms for s in b.stages) for b in lp_b),
                   default=0.0)
    ctx_aperiodic = any(b.arrival.kind == APERIODIC for b in bounds)

    out: List[TaskVerdict] = []
    for b in bounds:
        is_hp = b.task.priority == HP
        n_stages = len(b.stages)
        base = b.c_wc + b.allow_ms + b.hold_ms
        self_interf = ([(b.t_eff, b.c_wc, 0)]
                       if b.deadline > b.t_eff else [])
        if is_hp:
            others = [(o.t_eff, o.c_wc, 1) for o in hp_b if o is not b]
            r_nolp = _fixed_point(base, others + self_interf, m, b.deadline)
            r_full = _fixed_point(base + n_stages * blocking,
                                  others + self_interf, m, b.deadline)
        else:
            others = [(o.t_eff, o.c_wc, 1) for o in hp_b]
            others += [(o.t_eff, o.c_wc, 1) for o in lp_b if o is not b]
            r_full = _fixed_point(base, others + self_interf, m, b.deadline)
            r_nolp = r_full
        if ctx_aperiodic:
            # a co-resident open-loop task makes interference unbounded
            r_full = r_nolp = math.inf

        verdict, binding, why = _classify(
            b, is_hp, m, hp_util_wc, hp_util_solo, lp_util_wc,
            r_full, r_nolp, blocking, ctx_aperiodic)

        # config-wide caps demote GUARANTEED to CONDITIONAL
        if verdict == GUARANTEED:
            for cap_binding, cap_note in (model.caps
                                          + ([] if is_hp else model.lp_caps)):
                verdict, binding, why = CONDITIONAL, cap_binding, cap_note
                break

        out.append(TaskVerdict(
            task=b.task.spec.name, priority="HP" if is_hp else "LP",
            ctx=str(ctx.index), device=dev,
            period_ms=b.t_eff, deadline_ms=b.deadline,
            wcrt_ms=r_full, wcrt_nolp_ms=r_nolp, solo_ms=b.c_solo,
            util_wc=b.c_wc / b.t_eff, util_solo=b.c_solo / b.t_eff,
            verdict=verdict, binding=binding, detail=why,
            stages=b.stages))
    return out


def _classify(b: _TaskBounds, is_hp: bool, m: int, hp_util_wc: float,
              hp_util_solo: float, lp_util_wc: float, r_full: float,
              r_nolp: float, blocking: float, ctx_aperiodic: bool
              ) -> Tuple[str, str, str]:
    d = b.deadline
    if b.c_solo > d:
        return (UNSCHEDULABLE, "wcet-exceeds-deadline",
                f"optimistic solo cost {b.c_solo:.2f}ms already exceeds "
                f"the {d:.1f}ms deadline")
    if is_hp and hp_util_solo > m + 1e-9:
        return (UNSCHEDULABLE, "eq11-overload",
                f"HP demand {hp_util_solo:.2f} lanes at *solo* speeds "
                f"overflows the context's {m} stream(s) (Eq. 11)")
    if ctx_aperiodic:
        return (CONDITIONAL, "arrival-process",
                "an open-loop arrival process shares this context; "
                "worst-case backlog is unbounded")
    if b.arrival.kind == APERIODIC:
        return (CONDITIONAL, "arrival-process",
                b.arrival.note or "no inter-release lower bound")
    if is_hp:
        if r_full <= d and hp_util_wc <= m + 1e-9:
            return (GUARANTEED, "wcrt-within-deadline",
                    f"WCRT {r_full:.2f}ms <= D {d:.1f}ms with "
                    f"{d - r_full:.2f}ms slack; Eq. 11 holds at worst "
                    f"case ({hp_util_wc:.2f}/{m})")
        if r_nolp <= d:
            return (CONDITIONAL, "lp-blocking",
                    f"fits without LP load (WCRT {r_nolp:.2f}ms) but "
                    f"non-preemptive LP blocking (+{blocking:.2f}ms per "
                    f"stage) can overrun; depends on Eq. 12 shedding")
        if hp_util_wc > m + 1e-9:
            return (CONDITIONAL, "eq11-headroom",
                    f"worst-case HP demand {hp_util_wc:.2f} lanes "
                    f"exceeds {m} stream(s); feasible only while MRET "
                    f"tracks below the worst case")
        return (CONDITIONAL, "hp-interference",
                f"WCRT bound diverges under worst-case HP interference "
                f"(demand {hp_util_wc:.2f}/{m})")
    # LP
    robust = hp_util_wc + lp_util_wc <= m + 1e-9
    if r_full <= d and robust:
        return (GUARANTEED, "wcrt-within-deadline",
                f"WCRT {r_full:.2f}ms <= D {d:.1f}ms and Eq. 12 "
                f"admission holds at worst case "
                f"({hp_util_wc + lp_util_wc:.2f}/{m})")
    if r_full <= d:
        return (CONDITIONAL, "eq12-admission",
                f"fits when admitted (WCRT {r_full:.2f}ms) but Eq. 12 "
                f"may reject releases at worst-case load "
                f"({hp_util_wc + lp_util_wc:.2f}/{m})")
    return (CONDITIONAL, "lp-interference",
            "no static bound under worst-case co-resident load; LP "
            "completion relies on Eq. 12 admission + migration")


# ------------------------------------------------------- autoscale floor
def _autoscale_floor(cfg, model: _Model, sched_cfg: SchedulerConfig,
                     assumptions: List[str]) -> List[EpochReport]:
    auto = cfg._autoscale
    if auto is None:
        return []
    floor = int(auto.min_contexts)
    if cfg._cluster is not None:
        if floor >= cfg._cluster["n_gpus"]:
            return []
        sched = _fresh_sched(cfg, sched_cfg, n_gpus=floor)
        what = f"autoscale floor: fleet scaled in to {floor} GPU(s)"
    else:
        if floor >= sched_cfg.n_contexts:
            return []
        floor_cfg = dataclasses.replace(sched_cfg, n_contexts=floor)
        sched = DarisScheduler(list(cfg._specs), floor_cfg, cfg._device)
        what = f"autoscale floor: scaled in to {floor} context(s)"
    assumptions.append(
        "autoscale: the scale-in floor shape is verified as a what-if "
        "epoch (reachable whenever load stays below the low watermark)")
    return [_analyze_epoch(model, sched, 0.0, math.inf, "autoscale-floor",
                           what, {}, [])]
