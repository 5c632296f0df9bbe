# Copy of src/repro/core/batching.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Dynamic deadline-aware batching (beyond-paper; §VI-H made real).

The paper emulates "DARIS + batching" by statically pre-scaling arrival
rates (``table2_taskset(batch=b, load_scale=1/b)``) — no batch is ever
*formed* at runtime. This subsystem closes that gap the way D-STACK
(Dhakal et al.) and Dynamic Space-Time Scheduling (Jain et al.) compose
batching with spatial partitioning: while a job of task τ is still queued
at its first stage, later releases of τ may *join* it instead of becoming
jobs of their own, bounded by

  * ``max_batch``     — the widest batch a single job may carry;
  * the earliest member's virtual deadline — a release joins only if the
    enlarged batch is still predicted to meet the head's stage-0 virtual
    deadline, or the head is already past saving (throughput mode under
    overload, where waiting costs nothing);
  * ``max_wait_ms``   — an optional hard cap on how long the head may
    keep accumulating members;
  * admission (Eq. 12) — joining charges the *incremental* batched
    utilization, so batching never sneaks load past the admission test.

``scope`` picks the coalescing unit. ``"model"`` (default, the serving
semantics) batches releases of any task with an identical stage profile,
priority, and period — Table II's N periodic streams of one DNN are one
model, and that is the population a GPU serving system batches over.
``"task"`` restricts joining to the exact same arrival stream.

The batched job executes each stage once over ``n_inputs`` inputs; the
speedup curve lives in ``runtime.contention`` (calibrated from Table I
gains via ``serving.profiles``). ``BatchCoalescer`` is pure bookkeeping:
it tracks, per coalescing group, the queued stage-0 instance that new
releases may still join. The join *decision* (deadline + admission math)
lives in ``DarisScheduler._try_coalesce``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Optional

from .task import StageInstance, Task


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Knobs for dynamic batch formation (``ServerConfig.batching``)."""
    max_batch: int = 8
    max_wait_ms: Optional[float] = None   # None = bounded by deadline only
    scope: str = "model"                  # "model" | "task"

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms is not None and self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, "
                             f"got {self.max_wait_ms}")
        if self.scope not in ("model", "task"):
            raise ValueError(f"scope must be 'model' or 'task', "
                             f"got {self.scope!r}")


class BatchCoalescer:
    """Registry of open batch heads, one per coalescing group.

    A *head* is a stage-0 ``StageInstance`` that is still sitting in a
    ready queue: releases of the same group may coalesce into its job.
    Registration is closed the moment the instance is popped for dispatch
    (``DarisScheduler.next_for_lane``) — a running stage can never grow.
    A newly enqueued stage-0 job replaces its group's head: the newest
    head has the latest release, hence the most joining slack.
    """

    def __init__(self, policy: BatchPolicy):
        self.policy = policy
        self._heads: Dict[Hashable, StageInstance] = {}
        self._keys: Dict[int, Hashable] = {}    # task.index -> group key

    def key_of(self, task: Task) -> Hashable:
        key = self._keys.get(task.index)
        if key is None:
            if self.policy.scope == "task":
                key = task.index
            else:
                # same model = same numeric profile (stage names carry the
                # stream tag, so they are deliberately excluded)
                spec = task.spec
                key = (spec.priority, spec.period_ms,
                       tuple((s.t_alone_ms, s.n_sat, s.mem_frac,
                              s.overhead_ms, s.batch_gain)
                             for s in spec.stages))
            self._keys[task.index] = key
        return key

    def register(self, task: Task, inst: StageInstance) -> None:
        self._heads[self.key_of(task)] = inst

    def head(self, task: Task) -> Optional[StageInstance]:
        return self._heads.get(self.key_of(task))

    def close(self, task: Task) -> None:
        self._heads.pop(self.key_of(task), None)

    def on_pop(self, inst: StageInstance) -> None:
        """Called for every dispatched instance: dispatch seals the batch."""
        key = self.key_of(inst.task)
        if self._heads.get(key) is inst:
            del self._heads[key]
