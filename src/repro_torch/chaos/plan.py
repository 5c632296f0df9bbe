# Copy of src/repro/chaos/plan.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Seeded transient-fault injection and graceful degradation (PR 8).

The chaos layer is a *plan* — a frozen, declarative description of the
hazards a run must survive — plus a tiny runtime (``ChaosState``)
holding the plan's RNG streams and the degradation-mode state machine.
Everything here is pure data + numpy; the engine/backends consume it.

Twin-path discipline (same contract as the PR 3 fast path and the PR 7
sanitizer): with no ``ChaosPlan`` installed the engine takes bit-for-bit
the same decisions as before — every chaos hook is gated on an
``is not None`` check and the simulation RNG stream is never touched.
Chaos draws come from two *independent* generators:

* ``rng`` (seed)      — one uniform draw per configured hazard per
  dispatched stage, in launch order. The stream advance is a pure
  function of the dispatch sequence, so the same seed + plan + workload
  reproduces the same faults bit-identically.
* ``io_rng`` (seed+1) — journal/checkpoint I/O errors. The serve daemon
  journals from its pump loop while the engine dispatches; a shared
  stream would let wall-clock-timed I/O perturb stage faults.

Hazard menu:

* ``stage_fault_rate`` — transient stage-execution failures (the kernel
  "ran" but the result is garbage: full execution time is paid, then the
  stage must be retried or the job aborted).
* ``stall_rate``/``stall_ms`` — temporary lane stalls (driver hiccup,
  ECC scrub): the stage completes but late.
* ``brownouts`` — timed per-device slowdowns (thermal throttle, power
  cap): every lane on the device runs ``slow_factor``x slower for the
  window.
* ``io_error_rate`` — transient ``OSError`` on journal appends and
  checkpoint writes, retried up to ``io_max_retries`` times.

Recovery knobs:

* ``RetryPolicy`` — bounded attempts with exponential backoff charged on
  the *virtual* clock; ``deadline_aware`` gives up early when even an
  immediate retry could not finish by the job's absolute deadline
  (the abort unwinds the Eq. 12 charge — see
  ``DarisScheduler.abort_job``).
* ``watchdog_kappa`` — per-stage watchdog timeout as a multiple of the
  predicted MRET; expiry kills the lane entry and re-dispatches at the
  stage boundary via the existing zero-delay migration path.
* ``DegradationPolicy`` — NORMAL / BROWNOUT / EMERGENCY controller with
  hysteresis; BROWNOUT sheds LP admissions and widens batching waits,
  EMERGENCY additionally cancels queued LP work through the PR 6
  cancellation path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple

import numpy as np

# degradation modes (journaled by the serve daemon — keep them stable)
NORMAL = "normal"
BROWNOUT = "brownout"
EMERGENCY = "emergency"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff on the virtual clock."""

    max_attempts: int = 3          # total tries, the first one included
    backoff_ms: float = 1.0        # delay after the first failure
    backoff_mult: float = 2.0
    backoff_cap_ms: float = 50.0
    deadline_aware: bool = True    # abort when a retry cannot make it

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("RetryPolicy.max_attempts must be >= 1")
        if self.backoff_ms < 0 or self.backoff_cap_ms < 0:
            raise ValueError("RetryPolicy backoff delays must be >= 0")
        if self.backoff_mult < 1.0:
            raise ValueError("RetryPolicy.backoff_mult must be >= 1")

    def delay_ms(self, attempt: int) -> float:
        """Backoff charged before re-dispatch, after the ``attempt``-th
        failure (1-based)."""
        return min(self.backoff_ms
                   * self.backoff_mult ** max(attempt - 1, 0),
                   self.backoff_cap_ms)


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """NORMAL -> BROWNOUT -> EMERGENCY hysteresis controller over the
    same utilization signal the autoscaler reads (mean of Eq. 11/12
    utilization over live contexts)."""

    check_every_ms: float = 100.0
    brownout_enter: float = 0.90   # signal >= this: NORMAL -> BROWNOUT
    brownout_exit: float = 0.70    # signal <  this: BROWNOUT -> NORMAL
    emergency_enter: float = 0.98  # signal >= this: -> EMERGENCY
    emergency_exit: float = 0.85   # signal <  this: EMERGENCY -> BROWNOUT
    batch_widen: float = 2.0       # max_wait_ms multiplier while degraded

    def __post_init__(self):
        if self.check_every_ms <= 0:
            raise ValueError("DegradationPolicy.check_every_ms must be > 0")
        if not (self.brownout_exit < self.brownout_enter):
            raise ValueError("brownout_exit must be < brownout_enter")
        if not (self.emergency_exit < self.emergency_enter):
            raise ValueError("emergency_exit must be < emergency_enter")
        if self.brownout_enter > self.emergency_enter:
            raise ValueError("brownout_enter must be <= emergency_enter")
        if self.batch_widen < 1.0:
            raise ValueError("DegradationPolicy.batch_widen must be >= 1")


@dataclasses.dataclass(frozen=True)
class Brownout:
    """Timed per-device slowdown window: every lane on ``device`` runs
    ``slow_factor``x slower for ``[t0_ms, t1_ms)``."""

    t0_ms: float
    t1_ms: float
    device: int = 0
    slow_factor: float = 2.0

    def __post_init__(self):
        if not (self.t1_ms > self.t0_ms >= 0):
            raise ValueError("Brownout window needs t1_ms > t0_ms >= 0")
        if self.slow_factor < 1.0:
            raise ValueError("Brownout.slow_factor must be >= 1")


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """The full hazard + recovery description for one run."""

    seed: int = 0
    stage_fault_rate: float = 0.0
    stall_rate: float = 0.0
    stall_ms: float = 5.0
    brownouts: Tuple[Brownout, ...] = ()
    io_error_rate: float = 0.0
    io_max_retries: int = 3
    retry: RetryPolicy = RetryPolicy()
    degradation: Optional[DegradationPolicy] = None
    watchdog_kappa: float = 0.0    # 0 disables the stage watchdog

    def __post_init__(self):
        for name in ("stage_fault_rate", "stall_rate", "io_error_rate"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"ChaosPlan.{name} must be in [0, 1]")
        if self.stall_ms < 0:
            raise ValueError("ChaosPlan.stall_ms must be >= 0")
        if self.io_max_retries < 0:
            raise ValueError("ChaosPlan.io_max_retries must be >= 0")
        if self.watchdog_kappa < 0:
            raise ValueError("ChaosPlan.watchdog_kappa must be >= 0")
        if not isinstance(self.brownouts, tuple):
            object.__setattr__(self, "brownouts", tuple(self.brownouts))


def plan_from_dict(d) -> ChaosPlan:
    """JSON-friendly coercion for serving configs: nested dicts become
    the matching dataclasses (``{"chaos": {...}}`` in serve/config)."""
    d = dict(d)
    r = d.get("retry")
    if isinstance(r, dict):
        d["retry"] = RetryPolicy(**r)
    g = d.get("degradation")
    if isinstance(g, dict):
        d["degradation"] = DegradationPolicy(**g)
    bs = d.get("brownouts")
    if bs is not None:
        d["brownouts"] = tuple(Brownout(**b) if isinstance(b, dict) else b
                               for b in bs)
    return ChaosPlan(**d)


class ChaosState:
    """Mutable per-run chaos machinery: RNG streams + degradation mode.

    ``draw_launch`` makes exactly one uniform draw per *configured*
    hazard, in a fixed order, so the stream position is a pure function
    of the static plan and the number of launches so far — adding a
    hazard to the plan changes the draws (expected), but engine-side
    control flow never does.
    """

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self.io_rng = np.random.default_rng(plan.seed + 1)
        self.mode = NORMAL
        # (t_ms, from_mode, to_mode), appended in virtual-time order; the
        # serve daemon drains this with a cursor and journals each one
        self.transitions: List[Tuple[float, str, str]] = []
        self.io_injected = 0       # transient I/O errors injected

    # ------------------------------------------------------------ draws
    def draw_launch(self) -> Tuple[bool, float]:
        """(failed, stall_ms) for the next dispatched stage."""
        p = self.plan
        failed = bool(p.stage_fault_rate
                      and self.rng.random() < p.stage_fault_rate)
        stall = 0.0
        if p.stall_rate and self.rng.random() < p.stall_rate:
            stall = p.stall_ms
        return failed, stall

    def io_fails(self) -> bool:
        p = self.plan
        if p.io_error_rate and self.io_rng.random() < p.io_error_rate:
            self.io_injected += 1
            return True
        return False

    # -------------------------------------------------------- brownouts
    def brownout_factor(self, device: int, now_ms: float) -> float:
        f = 1.0
        for b in self.plan.brownouts:
            if b.device == device and b.t0_ms <= now_ms < b.t1_ms:
                f = max(f, b.slow_factor)
        return f

    def brownout_edges(self) -> List[float]:
        """Window boundaries — the engine schedules a re-rate event at
        each so in-flight work picks the factor change up mid-stage."""
        edges: Set[float] = set()
        for b in self.plan.brownouts:
            edges.add(b.t0_ms)
            edges.add(b.t1_ms)
        return sorted(edges)

    # ------------------------------------------------------ degradation
    def set_mode(self, now_ms: float, mode: str) -> bool:
        """Record a mode transition; returns True when it changed."""
        if mode == self.mode:
            return False
        self.transitions.append((now_ms, self.mode, mode))
        self.mode = mode
        return True
