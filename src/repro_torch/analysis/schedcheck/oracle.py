# Copy of src/repro/analysis/schedcheck/oracle.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Differential oracle: static bound vs simulated behaviour.

For a scenario (an unbuilt ``ServerConfig``) the oracle

1. runs ``analyze_config`` to get the static report, then
2. builds and runs the server, and
3. asserts the contract the analyzer promises:

   * every observed HP response time is ``<=`` the static HP WCRT bound
     over the realized timeline (``Report.hp_bound_ms()``; an infinite
     bound — diverged busy period, open-loop arrivals — is trivially
     satisfied but reported as vacuous), and
   * a configuration whose HP verdict is ``GUARANTEED`` finishes with
     **zero** HP deadline misses.

Any violation is a bug in the analyzer or in the engine — there is no
third option — which makes this a cheap, high-yield CI gate: the two
implementations of the DARIS math (closed-form and discrete-event)
check each other on every push.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Tuple

from ...core.task import HP
from .analyzer import analyze_config
from .model import GUARANTEED, Report

_TOL_MS = 1e-6


@dataclasses.dataclass
class OracleResult:
    label: str
    verdict: str
    hp_verdict: str
    bound_ms: float              # static HP WCRT bound (realized timeline)
    observed_max_ms: float       # max simulated HP response
    dmr_hp: float                # simulated HP deadline-miss ratio
    vacuous: bool                # bound was infinite (nothing to falsify)
    violations: List[str]
    report: Report

    @property
    def ok(self) -> bool:
        return not self.violations

    def render(self) -> str:
        status = "OK" if self.ok else "VIOLATION"
        bound = ("unbounded" if math.isinf(self.bound_ms)
                 else f"{self.bound_ms:.2f}ms")
        line = (f"oracle[{status}] {self.label}: observed HP max "
                f"{self.observed_max_ms:.2f}ms vs bound {bound} "
                f"(hp={self.hp_verdict}, dmr_hp={self.dmr_hp:.4f})")
        return "\n".join([line] + [f"  !! {v}" for v in self.violations])


def differential_check(cfg, *, label: Optional[str] = None) -> OracleResult:
    """Analyze, then simulate, one scenario and compare (see module doc).
    ``cfg`` must be an unbuilt ``ServerConfig``; it is built here."""
    report = analyze_config(cfg, label=label)
    metrics = cfg.build().run()
    hp_resp = metrics.response_ms.get(HP, [])
    observed = max(hp_resp) if hp_resp else 0.0
    bound = report.hp_bound_ms()
    dmr_hp = metrics.dmr(HP)

    violations: List[str] = []
    if observed > bound + _TOL_MS:
        violations.append(
            f"observed HP response {observed:.3f}ms exceeds the static "
            f"bound {bound:.3f}ms — analyzer or engine bug")
    if report.hp_verdict == GUARANTEED and dmr_hp > 0.0:
        violations.append(
            f"HP verdict GUARANTEED but the simulation missed "
            f"{dmr_hp:.2%} of HP deadlines — analyzer or engine bug")
    return OracleResult(
        label=report.label, verdict=report.verdict,
        hp_verdict=report.hp_verdict, bound_ms=bound,
        observed_max_ms=observed, dmr_hp=dmr_hp,
        vacuous=math.isinf(bound) or not hp_resp,
        violations=violations, report=report)


def run_oracle(scenarios: Iterable[Tuple[str, object]]
               ) -> List[OracleResult]:
    """Differential-check a batch of (label, unbuilt ServerConfig)."""
    return [differential_check(cfg, label=name) for name, cfg in scenarios]
