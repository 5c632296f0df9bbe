# Copy of src/repro/analysis/schedcheck/model.py; only this line differs (tests/test_torch_isolation.py checks it).
"""SchedCheck report model: per-task verdicts, per-epoch reports.

Verdict semantics (the contract the CLI/CI gate on):

* ``GUARANTEED`` — the static worst-case response-time bound (WCRT,
  computed under adversarial contention, +6-sigma lognormal noise
  headroom, non-preemptive LP blocking, and one straggler-kill
  allowance per job) fits the deadline AND the Eq. 11 HP budget holds
  even at worst-case execution times. A run of this configuration is
  expected to finish with zero HP deadline misses; the differential
  oracle (schedcheck.oracle) enforces exactly that.
* ``CONDITIONAL`` — no static guarantee, but feasibility survives under
  the runtime's adaptive mechanisms (MRET tracking well below the
  worst case, Eq. 12 LP shedding, migration). The binding constraint
  names what the guarantee depends on.
* ``UNSCHEDULABLE`` — infeasible even under the most optimistic model
  (solo execution, zero co-tenant interference): the task cannot meet
  its deadline, or its context's HP set overflows Eq. 11 at solo
  speeds. Reject at build time.

Every verdict carries ``binding`` — the named constraint that decided
it (``eq11-overload``, ``wcet-exceeds-deadline``, ``lp-blocking``,
``eq11-headroom``, ``eq12-admission``, ``arrival-process``, ...).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional

GUARANTEED = "GUARANTEED"
CONDITIONAL = "CONDITIONAL"
UNSCHEDULABLE = "UNSCHEDULABLE"

_SEVERITY = {GUARANTEED: 0, CONDITIONAL: 1, UNSCHEDULABLE: 2}


def worst_verdict(verdicts: List[str]) -> str:
    """The most severe verdict of a set (GUARANTEED when empty)."""
    if not verdicts:
        return GUARANTEED
    return max(verdicts, key=lambda v: _SEVERITY[v])


def _fin(x: float) -> Optional[float]:
    """JSON-safe float: None for +/-inf (json.dumps emits bare Infinity
    otherwise, which strict parsers reject)."""
    return None if math.isinf(x) else x


@dataclasses.dataclass
class StageBound:
    """Static per-stage numbers for one task (device-local wall ms)."""

    name: str
    wc_ms: float            # worst-case single-execution bound
    solo_ms: float          # optimistic floor: alone on the context
    vdl_ms: float           # Eq. 8 virtual-deadline slice (AFET-derived)

    def to_dict(self) -> Dict:
        return {"name": self.name, "wc_ms": self.wc_ms,
                "solo_ms": self.solo_ms, "vdl_ms": self.vdl_ms}


@dataclasses.dataclass
class TaskVerdict:
    """One task's verdict within one epoch."""

    task: str
    priority: str                     # "HP" | "LP"
    ctx: str                          # context key, stringified
    device: Optional[int]             # cluster device id, None on 1 GPU
    period_ms: float
    deadline_ms: float
    wcrt_ms: float                    # full-model WCRT bound (inf = diverged)
    wcrt_nolp_ms: float               # WCRT assuming zero LP load
    solo_ms: float                    # whole-job optimistic floor
    util_wc: float                    # C_wc / T (device-local lane units)
    util_solo: float                  # C_solo / T
    verdict: str
    binding: str                      # named binding constraint
    detail: str
    stages: List[StageBound] = dataclasses.field(default_factory=list)

    @property
    def slack_ms(self) -> float:
        return self.deadline_ms - self.wcrt_ms

    def to_dict(self) -> Dict:
        return {
            "task": self.task, "priority": self.priority, "ctx": self.ctx,
            "device": self.device, "period_ms": self.period_ms,
            "deadline_ms": self.deadline_ms, "wcrt_ms": _fin(self.wcrt_ms),
            "wcrt_nolp_ms": _fin(self.wcrt_nolp_ms), "solo_ms": self.solo_ms,
            "util_wc": self.util_wc, "util_solo": self.util_solo,
            "verdict": self.verdict, "binding": self.binding,
            "detail": self.detail,
            "stages": [s.to_dict() for s in self.stages],
        }


@dataclasses.dataclass
class EpochReport:
    """Verdicts for one segment of the configured timeline.

    An epoch starts at a timeline event (build, reconfigure_at,
    fail_context_at, fail_device_at, scale_out_at, a chaos brownout
    edge) and runs to the next one; within it the partition geometry and
    the post-Algorithm-1 placement are fixed, so one WCRT analysis
    covers the whole segment."""

    t0_ms: float
    t1_ms: float
    cause: str                        # "build" | "reconfigure" | ...
    detail: str
    geometry: Dict
    tasks: List[TaskVerdict] = dataclasses.field(default_factory=list)
    contexts: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def verdict(self) -> str:
        return worst_verdict([t.verdict for t in self.tasks])

    @property
    def hp_verdict(self) -> str:
        return worst_verdict([t.verdict for t in self.tasks
                              if t.priority == "HP"])

    def to_dict(self) -> Dict:
        return {
            "t0_ms": self.t0_ms, "t1_ms": _fin(self.t1_ms),
            "cause": self.cause, "detail": self.detail,
            "geometry": self.geometry,
            "verdict": self.verdict, "hp_verdict": self.hp_verdict,
            "contexts": self.contexts,
            "tasks": [t.to_dict() for t in self.tasks],
        }


@dataclasses.dataclass
class Report:
    """The full schedulability report for one configuration."""

    label: str
    horizon_ms: float
    epochs: List[EpochReport]
    # what-if epochs that are not part of the realized timeline (the
    # autoscale floor shape); they participate in the verdict — a plan
    # is only as good as its worst reachable shape — but not in the
    # realized-bound accessors the differential oracle compares against
    hypothetical: List[EpochReport] = dataclasses.field(default_factory=list)
    assumptions: List[str] = dataclasses.field(default_factory=list)

    def _all_epochs(self) -> List[EpochReport]:
        return self.epochs + self.hypothetical

    @property
    def verdict(self) -> str:
        return worst_verdict([e.verdict for e in self._all_epochs()])

    @property
    def hp_verdict(self) -> str:
        return worst_verdict([e.hp_verdict for e in self._all_epochs()])

    def hp_bound_ms(self) -> float:
        """Static HP response-time bound over the realized timeline: the
        max WCRT bound of any HP task in any epoch (inf when any HP
        busy-period diverged) — the number the differential oracle
        compares observed HP responses against."""
        bounds = [t.wcrt_ms for e in self.epochs for t in e.tasks
                  if t.priority == "HP"]
        return max(bounds) if bounds else 0.0

    def task_verdicts(self, name: str) -> List[TaskVerdict]:
        return [t for e in self._all_epochs() for t in e.tasks
                if t.task == name]

    def to_dict(self) -> Dict:
        return {
            "label": self.label, "horizon_ms": _fin(self.horizon_ms),
            "verdict": self.verdict, "hp_verdict": self.hp_verdict,
            "hp_bound_ms": _fin(self.hp_bound_ms()),
            "assumptions": list(self.assumptions),
            "epochs": [e.to_dict() for e in self.epochs],
            "hypothetical": [e.to_dict() for e in self.hypothetical],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def render(self) -> str:
        """Human-readable multi-line report."""
        out = [f"schedcheck: {self.label}",
               f"  overall: {self.verdict}   HP: {self.hp_verdict}   "
               f"HP bound: {_fmt_ms(self.hp_bound_ms())}"]
        for e in self._all_epochs():
            hypo = "  [what-if]" if e in self.hypothetical else ""
            t1 = "end" if math.isinf(e.t1_ms) else f"{e.t1_ms:.0f}ms"
            out.append(f"  epoch [{e.t0_ms:.0f}ms, {t1}) {e.cause}"
                       f" — {e.detail}{hypo}")
            geo = e.geometry
            out.append(f"    geometry: {geo.get('summary', geo)}")
            for t in e.tasks:
                out.append(
                    f"    {t.verdict:<13} {t.task:<24} [{t.priority}] "
                    f"ctx={t.ctx} wcrt={_fmt_ms(t.wcrt_ms)} "
                    f"D={t.deadline_ms:.1f}ms  binding={t.binding}")
        if self.assumptions:
            out.append("  assumptions:")
            for a in self.assumptions:
                out.append(f"    - {a}")
        return "\n".join(out)


def _fmt_ms(x: float) -> str:
    return "unbounded" if math.isinf(x) else f"{x:.2f}ms"


class UnschedulableError(ValueError):
    """Raised by ``ServerConfig.verify()`` / the daemon gate when a
    configuration's HP workload is statically unschedulable. Carries the
    full report for diagnosis."""

    def __init__(self, report: Report):
        self.report = report
        culprits = sorted({t.task for e in report._all_epochs()
                           for t in e.tasks
                           if t.priority == "HP"
                           and t.verdict == UNSCHEDULABLE})
        super().__init__(
            f"HP workload statically unschedulable "
            f"({', '.join(culprits) or 'no HP tasks'}); "
            f"run `python -m repro.analysis.schedcheck` for the full "
            f"report\n{report.render()}")
