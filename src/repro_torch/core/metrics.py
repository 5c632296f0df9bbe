# Copy of src/repro/core/metrics.py; only this line differs (tests/test_torch_isolation.py checks it).
"""JPS / DMR / response-time metrics (paper §V-VI conventions).

DMR = missed deadlines / accepted jobs, per priority class. A job that
finishes after its deadline still completes (soft real-time); rejected
jobs are counted separately (admission). Jobs still queued or in flight
when the run ends are swept into ``unfinished`` — and into ``missed`` if
already past their deadline — so overload DMR is not understated by work
the horizon cut off.

Dynamic batching (core/batching.py) makes jobs and inputs distinct units:
``completed`` counts jobs, ``completed_inputs`` counts the inputs they
carried, and ``jps_inputs`` is the throughput figure comparable to the
paper's batched baselines. ``batch_hist`` maps batch size -> number of
completed jobs of that size (all-1 when batching is off).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .task import HP, LP


@dataclasses.dataclass
class RunMetrics:
    horizon_ms: float
    completed: Dict[int, int]
    missed: Dict[int, int]
    rejected: Dict[int, int]
    response_ms: Dict[int, List[float]]
    migrations: int = 0
    stragglers: int = 0
    faults: int = 0
    # online elastic repartitions (scheduler.reconfigure invocations:
    # timed plans and autoscaler decisions alike)
    reconfigures: int = 0
    # periodic releases skipped because the drive loop stalled past whole
    # periods (wall-clock backends under load; see PeriodicArrival)
    skipped_releases: int = 0
    # jobs still queued/in-flight when the run ended (per priority)
    unfinished: Dict[int, int] = dataclasses.field(
        default_factory=lambda: {HP: 0, LP: 0})
    # inputs carried by completed jobs (== completed when batching is off)
    completed_inputs: Dict[int, int] = dataclasses.field(
        default_factory=lambda: {HP: 0, LP: 0})
    # batch size -> completed jobs of that size
    batch_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    # cluster runs: device -> {"completed"/"missed": {HP/LP: n}} (empty on
    # single-GPU servers), and the count of inter-GPU state transfers the
    # zero-delay migration machinery actually paid for
    per_device: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    transfers: int = 0
    # client-cancelled submissions per priority (scheduler.cancel_job):
    # whole jobs retired plus batch members detached/dropped. A cancelled
    # job is neither completed nor missed nor rejected.
    cancelled: Dict[int, int] = dataclasses.field(
        default_factory=lambda: {HP: 0, LP: 0})
    # tenant -> accounting dict (see tenant_stats); filled by the engine
    # when any submission carried a tenant id (the serving front-end),
    # empty for plain benchmark runs
    per_tenant: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    # ---- chaos layer (repro.chaos): all zero with no ChaosPlan ----
    # transient stage faults injected by the plan
    chaos_faults: int = 0
    # failed stages re-dispatched after backoff (RetryPolicy)
    retries: int = 0
    # jobs given up on after a transient fault (attempts exhausted, or a
    # deadline-aware bail-out); aborted jobs unwind their Eq. 12 charge
    # and are neither completed nor missed nor cancelled
    aborted: Dict[int, int] = dataclasses.field(
        default_factory=lambda: {HP: 0, LP: 0})
    # in-flight stages killed by the per-stage watchdog and re-dispatched
    # at the stage boundary (each also counts into ``migrations`` when it
    # re-homed)
    watchdog_kills: int = 0
    # LP releases shed by the degradation controller: admissions refused
    # in BROWNOUT/EMERGENCY plus queued jobs cancelled on EMERGENCY entry
    shed: Dict[int, int] = dataclasses.field(
        default_factory=lambda: {HP: 0, LP: 0})
    # NORMAL/BROWNOUT/EMERGENCY mode changes (DegradationPolicy)
    degrade_transitions: int = 0

    @property
    def jps(self) -> float:
        return sum(self.completed.values()) / (self.horizon_ms / 1000.0)

    def jps_by(self, p: int) -> float:
        return self.completed[p] / (self.horizon_ms / 1000.0)

    @property
    def jps_inputs(self) -> float:
        """Input throughput — the number comparable to batched baselines."""
        return (sum(self.completed_inputs.values())
                / (self.horizon_ms / 1000.0))

    def jps_inputs_by(self, p: int) -> float:
        return self.completed_inputs[p] / (self.horizon_ms / 1000.0)

    def dmr(self, p: int) -> float:
        acc = self.completed[p] + self.unfinished[p]
        return self.missed[p] / acc if acc else 0.0

    def mean_batch(self) -> float:
        """Mean batch size over completed jobs (1.0 when batching is off)."""
        jobs = sum(self.batch_hist.values())
        if not jobs:
            return 0.0
        return sum(b * n for b, n in self.batch_hist.items()) / jobs

    def resp_stats(self, p: int) -> Dict[str, float]:
        r = self.response_ms[p]
        if not r:
            return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                    "min": 0.0, "max": 0.0}
        a = np.asarray(r)
        return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "p99": float(np.percentile(a, 99)),
                "min": float(a.min()), "max": float(a.max())}

    def summary(self) -> Dict:
        resp_hp = self.resp_stats(HP)
        resp_lp = self.resp_stats(LP)
        out = {
            "jps": self.jps,
            "jps_hp": self.jps_by(HP), "jps_lp": self.jps_by(LP),
            "jps_inputs": self.jps_inputs,
            "jps_hp_inputs": self.jps_inputs_by(HP),
            "jps_lp_inputs": self.jps_inputs_by(LP),
            "dmr_hp": self.dmr(HP), "dmr_lp": self.dmr(LP),
            "rejected_hp": self.rejected[HP], "rejected_lp": self.rejected[LP],
            "unfinished_hp": self.unfinished[HP],
            "unfinished_lp": self.unfinished[LP],
            "resp_hp": resp_hp, "resp_lp": resp_lp,
            # flat per-priority percentiles: the tail-latency columns the
            # figure harnesses (fig4-6, fig13) read without digging into
            # the nested resp dicts
            "resp_hp_p50": resp_hp["p50"], "resp_hp_p95": resp_hp["p95"],
            "resp_hp_p99": resp_hp["p99"],
            "resp_lp_p50": resp_lp["p50"], "resp_lp_p95": resp_lp["p95"],
            "resp_lp_p99": resp_lp["p99"],
            "mean_batch": self.mean_batch(),
            "batch_hist": dict(sorted(self.batch_hist.items())),
            "migrations": self.migrations, "stragglers": self.stragglers,
            "faults": self.faults, "reconfigures": self.reconfigures,
            "skipped_releases": self.skipped_releases,
            "cancelled_hp": self.cancelled[HP],
            "cancelled_lp": self.cancelled[LP],
        }
        # chaos block only when the chaos layer actually fired: chaos-off
        # summaries stay byte-identical to the pre-chaos goldens
        if (self.chaos_faults or self.retries or self.watchdog_kills
                or self.degrade_transitions or any(self.aborted.values())
                or any(self.shed.values())):
            out["chaos_faults"] = self.chaos_faults
            out["retries"] = self.retries
            out["aborted_hp"] = self.aborted[HP]
            out["aborted_lp"] = self.aborted[LP]
            out["watchdog_kills"] = self.watchdog_kills
            out["shed_hp"] = self.shed[HP]
            out["shed_lp"] = self.shed[LP]
            out["degrade_transitions"] = self.degrade_transitions
        if self.per_device:
            out["per_device"] = {
                str(d): s for d, s in sorted(self.per_device.items())}
            out["transfers"] = self.transfers
        if self.per_tenant:
            out["per_tenant"] = dict(sorted(self.per_tenant.items()))
        return out


def tenant_stats(handles) -> Dict[str, Dict]:
    """Per-tenant accounting over submit handles (duck-typed: needs
    ``.tenant``/``.status``/``.response_ms``). Handles without a tenant
    id (plain programmatic submits) are excluded. ``completed`` counts
    every finished job including late ones (soft real-time: a missed job
    still completes); ``missed`` is the late subset. ``pending`` covers
    queued/running/unreleased submissions at observation time."""
    out: Dict[str, Dict] = {}
    resp: Dict[str, List[float]] = {}
    for h in handles:
        if h.tenant is None:
            continue
        d = out.setdefault(h.tenant, {
            "submitted": 0, "completed": 0, "missed": 0,
            "cancelled": 0, "rejected": 0, "aborted": 0, "pending": 0})
        d["submitted"] += 1
        st = h.status
        if st in ("completed", "missed"):
            d["completed"] += 1
            if st == "missed":
                d["missed"] += 1
            if h.response_ms is not None:
                resp.setdefault(h.tenant, []).append(h.response_ms)
        elif st == "cancelled":
            d["cancelled"] += 1
        elif st == "rejected":
            d["rejected"] += 1
        elif st == "aborted":
            d["aborted"] += 1
        else:
            d["pending"] += 1
    for tenant, d in out.items():
        r = resp.get(tenant)
        if r:
            a = np.asarray(r)
            d["resp"] = {"mean": float(a.mean()),
                         "p50": float(np.percentile(a, 50)),
                         "p95": float(np.percentile(a, 95)),
                         "p99": float(np.percentile(a, 99))}
        else:
            d["resp"] = {"mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
    return out


def empty_metrics(horizon_ms: float) -> RunMetrics:
    return RunMetrics(horizon_ms=horizon_ms,
                      completed={HP: 0, LP: 0}, missed={HP: 0, LP: 0},
                      rejected={HP: 0, LP: 0},
                      response_ms={HP: [], LP: []})
