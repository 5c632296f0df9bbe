# Copy of src/repro/runtime/contention.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Processor-sharing contention model (roofline-flavoured, DESIGN.md §2).

Each stage has a profile (t_alone, n_sat, mem_frac): ``n_sat`` is the
number of device units the stage's kernels can actually occupy (narrow
DNNs like InceptionV3 saturate few; wide ones like UNet use all), and
``mem_frac`` its bandwidth-bound fraction. Rates for the running set:

  1. context shares: u_i = cap_k / n_active_k  (cap_k from Eq. 9)
  2. device cap:     sum u_i <= N  (proportional scale-down -> this is
                     where oversubscription interference lives)
  3. width:          rc_i = min(u_i, n_sat_i) / n_sat_i
  4. bubbles:        multi-tenancy fills single-stream issue gaps:
                     speed_i = min(1, rc_i * (1 - beta/m) / (1 - beta))
  5. bandwidth:      phi = sum mem_frac_j * speed_j; if phi > 1,
                     speed_i /= (1 - mf_i) + mf_i * phi   (Amdahl-style)

The hot path is ``rates_arrays``: one vectorized NumPy pass over per-lane
arrays (the sim backend keeps them preallocated). Reductions (device cap,
unit budget, bandwidth phi) are evaluated in sequential left-to-right
order, NOT with NumPy's pairwise summation — that keeps every speed
bit-identical to the historic per-lane Python loops, which is what the
golden determinism tests (tests/test_engine_golden.py) lock in.

Calibration inputs are the paper's own Table I only (min JPS -> t_alone,
batching gain -> n_sat; see serving/profiles.py). The model reproduces the
phenomena the paper measures: OS=1 strands idle capacity, full sharing
maximizes throughput at higher variance, wide DNNs gain least from
batching/colocation.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.task import StageProfile


def speedup_curve(g_inf: float, n_inputs: int) -> float:
    """g(b) = 1 + (g_inf - 1)(1 - 1/b): throughput gain of a b-input batch
    over b single-input executions, approaching the asymptote ``g_inf``.
    The ONE place the curve shape lives — the dynamic batching path and
    the static pre-batched profiles (serving/profiles.py) both call it."""
    if n_inputs <= 1:
        return 1.0
    return 1.0 + (max(g_inf, 1.0) - 1.0) * (1.0 - 1.0 / n_inputs)


def batch_speedup(prof: StageProfile, n_inputs: int) -> float:
    """Stage-level g(b): ``batch_gain`` is the stage's Table-I-calibrated
    asymptote (serving/profiles.py wires max_JPS / min_JPS through here),
    so wide DNNs — UNet, g_inf 1.08 — gain least and narrow ones —
    InceptionV3, g_inf 3.13 — gain most."""
    return speedup_curve(prof.batch_gain, n_inputs)


@functools.lru_cache(maxsize=4096)
def _batch_cost_cached(g_inf: float, n_inputs: int) -> float:
    # depends on the profile only through its batch_gain asymptote
    return n_inputs / speedup_curve(g_inf, n_inputs)


def batch_cost(prof: StageProfile, n_inputs: int) -> float:
    """Device-time multiplier of a b-input stage vs a single-input one:
    b / g(b). Exactly 1.0 for unbatched jobs (bit-identical guarantee).
    Memoized on (batch_gain, b): the sim hot path (launch, straggler
    check, backlog estimation) calls this per stage instance."""
    if n_inputs <= 1:
        return 1.0
    return _batch_cost_cached(prof.batch_gain, n_inputs)


def batched_stage_ms(prof: StageProfile, n_inputs: int) -> float:
    """Single-stream-alone execution time of a b-input stage (excludes
    the per-dispatch ``overhead_ms``, which batching amortizes: one
    dispatch regardless of b)."""
    return prof.t_alone_ms * batch_cost(prof, n_inputs)


def _seq_sum(a: np.ndarray) -> float:
    """Left-to-right float sum, bit-compatible with ``builtins.sum`` over
    the same values (NumPy's pairwise reduction associates differently)."""
    return sum(a.tolist())


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    n_units: float = 68.0        # SMs (RTX 2080 Ti) | chips (pod slice)
    bubble: float = 0.18         # single-stream issue-gap waste
    l2_pressure: float = 0.09    # cache/DRAM thrash growth per co-tenant
    name: str = "rtx2080ti-like"
    # heterogeneous clusters: scalar speed factor vs the reference device
    # the StageProfiles were calibrated on (an A100-class device at 2.0
    # runs every stage in half its profiled time). MRET/utilization stay
    # in reference units; the scheduler divides by ``speed`` wherever a
    # quantity becomes device-local (admission headroom, ETAs, executed
    # stage work). 1.0 = the calibration device itself.
    speed: float = 1.0


class ContentionModel:
    # below this running-set size the scalar path beats NumPy call
    # overhead; both paths execute the identical float-op sequence
    VECTOR_MIN = 16

    def __init__(self, device: DeviceModel):
        self.device = device
        # (id(prof), b) -> (prof, effective prof); the strong ref to prof
        # in the value keeps its id from being reused by a new object
        self._batched_prof_cache: Dict[tuple, tuple] = {}
        # preallocated per-lane columns for the vectorized kernel
        self._cap = 0
        self._bu = self._bns = self._bmf = np.empty(0)

    def rates_arrays(self, u: np.ndarray, n_sat: np.ndarray,
                     mem_frac: np.ndarray) -> np.ndarray:
        """Vectorized rate kernel. ``u`` is each lane's context share
        (cap_k / n_active_k), ``n_sat``/``mem_frac`` its effective profile
        columns. Returns speed fractions (1.0 = single-stream-alone).

        All elementwise steps are plain IEEE-754 ops and the three
        reductions run in sequential order, so the output is bit-identical
        to the scalar reference implementation in ``rates``."""
        m = u.shape[0]
        if m == 0:
            return u
        dev = self.device
        total = _seq_sum(u)
        if total > dev.n_units:
            u = u * (dev.n_units / total)
        beta = dev.bubble
        bubble_gain = (1.0 - beta / m) / (1.0 - beta)
        speeds = np.minimum(1.0, np.minimum(u, n_sat) / n_sat * bubble_gain)
        # unit conservation: total busy units can't exceed the device plus
        # the bubble-recovery headroom multi-tenancy unlocks (a stream can
        # fill a neighbour's issue gaps but can't mint new SMs)
        used = _seq_sum(speeds * n_sat)
        budget = dev.n_units * (1.0 + beta * (1.0 - 1.0 / m))
        if used > budget:
            speeds = speeds * (budget / used)
        # bandwidth demand grows superlinearly with co-tenant count: more
        # resident working sets thrash L2 so each stream's effective DRAM
        # demand rises (the knee-point mechanism SGPRS reports)
        thrash = 1.0 + dev.l2_pressure * max(m - 1, 0)
        phi = _seq_sum(mem_frac * speeds) * thrash
        if phi > 1.0:
            speeds = speeds / ((1.0 - mem_frac) + mem_frac * phi)
        return speeds

    def _rates_scalar(self, u: List[float], n_sat: List[float],
                      mem_frac: List[float]) -> List[float]:
        """Scalar reference path: the exact op sequence of
        ``rates_arrays`` on Python floats. Faster below VECTOR_MIN lanes;
        bit-identical by construction (the incremental-vs-full property
        test locks the two paths together)."""
        dev = self.device
        m = len(u)
        total = sum(u)
        if total > dev.n_units:
            scale = dev.n_units / total
            u = [x * scale for x in u]
        beta = dev.bubble
        bubble_gain = (1.0 - beta / m) / (1.0 - beta)
        speeds = [min(1.0, min(ui, ns) / ns * bubble_gain)
                  for ui, ns in zip(u, n_sat)]
        used = sum(s * ns for s, ns in zip(speeds, n_sat))
        budget = dev.n_units * (1.0 + beta * (1.0 - 1.0 / m))
        if used > budget:
            shrink = budget / used
            speeds = [s * shrink for s in speeds]
        thrash = 1.0 + dev.l2_pressure * max(m - 1, 0)
        phi = sum(mf * s for mf, s in zip(mem_frac, speeds)) * thrash
        if phi > 1.0:
            speeds = [s / ((1.0 - mf) + mf * phi)
                      for s, mf in zip(speeds, mem_frac)]
        return speeds

    def rates_seq(self, u: List[float], n_sat: List[float],
                  mem_frac: List[float]) -> List[float]:
        """Rate kernel over parallel per-lane lists — the sim backend's
        entry point. Dispatches to the scalar path for small running sets
        and to the preallocated-array NumPy kernel for large ones; both
        produce identical bits."""
        m = len(u)
        if m == 0:
            return []
        if m < self.VECTOR_MIN:
            return self._rates_scalar(u, n_sat, mem_frac)
        if m > self._cap:
            self._cap = max(m, 2 * self._cap)
            self._bu = np.empty(self._cap)
            self._bns = np.empty(self._cap)
            self._bmf = np.empty(self._cap)
        self._bu[:m] = u
        self._bns[:m] = n_sat
        self._bmf[:m] = mem_frac
        return self.rates_arrays(self._bu[:m], self._bns[:m],
                                 self._bmf[:m]).tolist()

    def rates(self, running: Sequence[Tuple[object, StageProfile, float, int]]
              ) -> List[float]:
        """running: list of (key, profile, ctx_cap, n_active_in_ctx).

        Returns speed fractions (1.0 = single-stream-alone speed). List
        front-end over the kernel for callers without per-lane columns
        (tests, offline estimates)."""
        if not running:
            return []
        return self.rates_seq(
            [cap / max(n_act, 1) for _, _, cap, n_act in running],
            [p.n_sat for _, p, _, _ in running],
            [p.mem_frac for _, p, _, _ in running])

    def batched_profile(self, prof: StageProfile, n_inputs: int
                        ) -> StageProfile:
        """Effective profile of a b-input stage for the rate computation.
        The batch converts half its log-speedup into *width* (deeper SM
        occupancy -> more units demanded) and half into *per-unit
        efficiency* (amortized launches, fuller pipelines): n_sat scales
        by sqrt(g(b)). Under unit starvation a b-batch therefore still
        outruns b singles by sqrt(g(b)) — narrow DNNs (InceptionV3) keep
        most of their Table I gain under colocation, wide ones (UNet)
        keep almost none, matching §VI-H. Returns ``prof`` for b = 1.
        Memoized per (profile, b): the dataclasses.replace + sqrt work
        used to run on every launch of a batched stage."""
        if n_inputs <= 1:
            return prof
        key = (id(prof), n_inputs)
        hit = self._batched_prof_cache.get(key)
        if hit is not None and hit[0] is prof:
            return hit[1]
        ns = min(self.device.n_units,
                 prof.n_sat * batch_speedup(prof, n_inputs) ** 0.5)
        eff = dataclasses.replace(prof, n_sat=ns)
        self._batched_prof_cache[key] = (prof, eff)
        return eff

    def solo_speed(self, prof: StageProfile, units: float) -> float:
        """Speed of a stage running alone on ``units`` units."""
        rc = min(units, prof.n_sat) / prof.n_sat
        return min(1.0, rc)   # single stream keeps its bubbles (gain = 1)

    def full_load_time(self, prof: StageProfile, cap: float,
                       n_streams_busy: int, m_total: int) -> float:
        """AFET estimate (paper §IV-A1): execution time with every stream
        busy — pessimistic offline seed for MRET."""
        u = cap / max(n_streams_busy, 1)
        total_u_scale = min(1.0, self.device.n_units / max(u * m_total, 1e-9))
        u *= total_u_scale
        rc = min(u, prof.n_sat) / prof.n_sat
        beta = self.device.bubble
        speed = min(1.0, rc * (1.0 - beta / max(m_total, 1)) / (1.0 - beta))
        # assume bandwidth at the congestion knee under full load
        speed /= (1.0 - prof.mem_frac) + prof.mem_frac * max(1.0, m_total * prof.mem_frac * speed)
        speed = max(speed, 1e-3)
        return (prof.t_alone_ms + prof.overhead_ms) / speed
