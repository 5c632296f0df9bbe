# Copy of src/repro/core/mret.py; only this line differs (tests/test_torch_isolation.py checks it).
"""MRET — Maximum Recent Execution Time (paper §III-B2, Eq. 1-2).

Per-stage sliding-window maximum over the last ``ws`` completed executions;
task MRET is the sum over stages (Eq. 2). Before any history exists the
estimator is seeded with AFET (average full-load execution time, §IV-A1),
the paper's pessimistic offline initialization.

Values are memoized: the admission test (Eq. 11-12) reads ``task_mret``
for every task on a context at every release, so recomputing the window
max / stage sum each read made admission O(tasks x stages x ws).
``observe`` invalidates; reads between observations are O(1) and return
the exact same floats the uncached code produced (same max, same
left-to-right sum order).
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence


class StageMret:
    # process-wide estimator generation: bumped whenever ANY stage
    # estimator's value may have changed. Aggregate caches over many
    # estimators (StageQueue.backlog_ms) key on it to stay O(1) without
    # tracking which queue holds which estimator.
    generation: int = 0

    def __init__(self, afet_ms: float, ws: int = 5):
        self.ws = ws
        self.window: deque = deque(maxlen=ws)
        self.afet_ms = afet_ms
        self._value: Optional[float] = afet_ms

    def observe(self, et_ms: float) -> None:
        self.window.append(et_ms)
        self._value = None
        StageMret.generation += 1

    def invalidate(self) -> None:
        """Drop the memoized max after direct ``window`` mutation
        (checkpoint restore)."""
        self._value = None
        StageMret.generation += 1

    def value(self) -> float:
        """Eq. 1: max over the recent window (AFET until history exists)."""
        if self._value is None:
            self._value = max(self.window) if self.window else self.afet_ms
        return self._value


class TaskMret:
    """Eq. 2: mret_i = sum_j mret_{i,j}; plus Eq. 8 virtual-deadline split."""

    def __init__(self, stage_afets_ms: Sequence[float], ws: int = 5):
        self.stages = [StageMret(a, ws) for a in stage_afets_ms]
        self._total: Optional[float] = None

    def observe(self, stage_idx: int, et_ms: float) -> None:
        self.stages[stage_idx].observe(et_ms)
        self._total = None

    def invalidate(self) -> None:
        """Drop all memoized values after direct window mutation."""
        for s in self.stages:
            s.invalidate()
        self._total = None

    def stage_mret(self, stage_idx: int, now_ms: float = 0.0) -> float:
        return self.stages[stage_idx].value()

    def task_mret(self, now_ms: float = 0.0) -> float:
        if self._total is None:
            self._total = sum(s.value() for s in self.stages)
        return self._total

    def virtual_deadlines(self, deadline_ms: float) -> List[float]:
        """Eq. 8: D_{i,j} = (mret_{i,j} / mret_i) * D_i  (relative slice
        widths; caller accumulates to absolute deadlines)."""
        total = self.task_mret()
        if total <= 0:
            n = len(self.stages)
            return [deadline_ms / n] * n
        return [s.value() / total * deadline_ms for s in self.stages]
