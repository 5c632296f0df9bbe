# Copy of src/repro/runtime/arrivals.py; only this line differs (tests/test_torch_isolation.py checks it).
"""First-class arrival processes (open- and closed-loop workload shapes).

The paper's Table II workloads are strictly periodic; production traffic is
not. An ``ArrivalProcess`` decides *when* a task releases jobs, so the same
``EngineCore`` event loop serves the paper's periodic sets, Poisson
open-loop traffic (millions-of-users shapes), and recorded traces without
touching scheduler or backend code.

Contract (driven by ``EngineCore``):

    t0 = proc.start(spec, rng)               # first release (None = never)
    t1, skipped = proc.next_after(t0, now)   # successor of the release that
                                             # was *scheduled* at t0, given
                                             # the loop observed time ``now``

``next_after`` returns an absolute time (None = no more releases) plus the
number of whole periods that had to be skipped because the loop stalled
past them (only periodic processes skip; open-loop processes deliberately
return back-dated times so the backlog builds, which is what "open loop"
means).
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

from ..core.task import TaskSpec


class ArrivalProcess:
    """Base class; subclasses override ``start`` and ``next_after``."""

    def start(self, spec: TaskSpec, rng: np.random.Generator
              ) -> Optional[float]:
        raise NotImplementedError

    def next_after(self, prev_t: float, now: float
                   ) -> Tuple[Optional[float], int]:
        raise NotImplementedError


class PeriodicArrival(ArrivalProcess):
    """Strictly periodic releases (paper §III-A): one job every ``period_ms``
    starting at ``phase_ms`` (``"random"`` draws uniform in [0, T) — the
    phase-offset convention the simulator has always used).

    Release-storm protection: if the drive loop stalls past one or more
    whole periods (wall-clock backends under load), the next release is
    clamped to ``max(prev + period, now)`` instead of bursting back-dated
    releases; fully-passed periods are reported as skipped so
    ``RunMetrics.skipped_releases`` accounts for them.
    """

    def __init__(self, period_ms: Optional[float] = None,
                 phase_ms: Union[float, str] = 0.0):
        self.period_ms = period_ms
        self.phase_ms = phase_ms
        self._period = period_ms   # resolved against the spec in start()

    def start(self, spec: TaskSpec, rng: np.random.Generator
              ) -> Optional[float]:
        self._period = self.period_ms or spec.period_ms
        if self.phase_ms == "random":
            return float(rng.uniform(0, self._period))
        return float(self.phase_ms)

    def next_after(self, prev_t: float, now: float
                   ) -> Tuple[Optional[float], int]:
        nxt = prev_t + self._period
        if nxt < now:
            skipped = int((now - nxt) // self._period)
            return now, skipped
        return nxt, 0


class PoissonArrival(ArrivalProcess):
    """Open-loop Poisson arrivals at ``rate_jps`` jobs/sec.

    Gaps are exponential with their own seeded stream (independent of the
    engine's noise RNG), so the arrival sequence is identical across
    backends and across runs with the same seed. Back-dated arrivals are
    *not* skipped: open-loop traffic keeps coming whether or not the server
    keeps up — that is the overload behaviour worth measuring.
    """

    def __init__(self, rate_jps: float, seed: int = 0):
        if rate_jps <= 0:
            raise ValueError(f"rate_jps must be > 0, got {rate_jps}")
        self.rate_jps = rate_jps
        self.seed = seed
        self._rng: Optional[np.random.Generator] = None

    def _gap(self) -> float:
        return float(self._rng.exponential(1000.0 / self.rate_jps))

    def start(self, spec: TaskSpec, rng: np.random.Generator
              ) -> Optional[float]:
        self._rng = np.random.default_rng(self.seed)   # re-arm per run
        return self._gap()

    def next_after(self, prev_t: float, now: float
                   ) -> Tuple[Optional[float], int]:
        return prev_t + self._gap(), 0


class ManualArrival(ArrivalProcess):
    """No scheduled releases at all: every job arrives through an explicit
    ``submit`` (the serving daemon's path — clients drive the arrivals,
    the engine's arrival machinery stays silent). Draws nothing from the
    RNG, so adding a manual task to a server perturbs no seeded stream."""

    def start(self, spec: TaskSpec, rng: np.random.Generator
              ) -> Optional[float]:
        return None

    def next_after(self, prev_t: float, now: float
                   ) -> Tuple[Optional[float], int]:
        return None, 0


class TraceArrival(ArrivalProcess):
    """Releases at recorded absolute times (ms). Used for replaying
    captured traffic and for the one-shot ``DarisServer.submit`` path."""

    def __init__(self, times_ms: List[float]):
        self.times = sorted(float(t) for t in times_ms)
        self._idx = 0

    def start(self, spec: TaskSpec, rng: np.random.Generator
              ) -> Optional[float]:
        self._idx = 0
        if not self.times:
            return None
        self._idx = 1
        return self.times[0]

    def next_after(self, prev_t: float, now: float
                   ) -> Tuple[Optional[float], int]:
        if self._idx >= len(self.times):
            return None, 0
        t = self.times[self._idx]
        self._idx += 1
        return t, 0
