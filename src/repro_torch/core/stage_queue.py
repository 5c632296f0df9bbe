# Copy of src/repro/core/stage_queue.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Stage-level ready queue: 8 fixed priority levels + EDF inside each level
(paper §IV-B2).

Level bits (0 = most urgent first):
  bit2  task priority   (HP above LP)            -- ablation: no_fixed
  bit1  last stage of the task                   -- ablation: no_last
  bit0  predecessor stage missed its virtual dl  -- ablation: no_prior
EDF tie-break on the stage's absolute virtual deadline.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import List, Optional, Tuple

from ..runtime.contention import batch_cost
from .mret import StageMret
from .task import HP, StageInstance

_seq = itertools.count()


@dataclasses.dataclass
class QueueConfig:
    no_last: bool = False
    no_prior: bool = False
    no_fixed: bool = False


def stage_level(inst: StageInstance, qcfg: QueueConfig) -> int:
    hp_bit = 0 if (inst.task.priority == HP or qcfg.no_fixed) else 1
    last_bit = 0 if (inst.job.is_last_stage() and not qcfg.no_last) else 1
    prior_bit = 0 if (inst.job.vdl_missed_prev and not qcfg.no_prior) else 1
    return hp_bit * 4 + last_bit * 2 + prior_bit


class StageQueue:
    """One ready queue (per context for MPS*, global for STR)."""

    def __init__(self, qcfg: Optional[QueueConfig] = None):
        self.qcfg = qcfg or QueueConfig()
        self._heap: List[Tuple[tuple, StageInstance]] = []
        # memoized backlog_ms (see below): version counts structural
        # mutations; the cache key pairs it with the process-wide MRET
        # generation so estimator updates invalidate it too
        self._version = 0
        self._backlog_key: Tuple[int, int] = (-1, -1)
        self._backlog_total = 0.0
        # dispatch hot-set hookup (see register_hot)
        self._hot: Optional[set] = None
        self._hot_key = None

    def register_hot(self, key, hot: set) -> None:
        """Join the scheduler's dispatch index: the queue keeps ``key``
        in ``hot`` exactly while it holds work, so the engine's dispatch
        loop can skip every context with an empty queue instead of
        probing each free lane (fleet runs: hundreds of probes/event)."""
        self._hot_key = key
        self._hot = hot
        if self._heap:
            hot.add(key)
        else:
            hot.discard(key)

    def touch(self) -> None:
        """Invalidate the memoized backlog total after an in-place
        mutation the queue cannot see (a queued instance's ``cost_b``
        refresh on batch coalesce/detach)."""
        self._version += 1

    def push(self, inst: StageInstance) -> None:
        if inst.smret is None:
            job = inst.job
            mret = job.task.mret
            if mret is not None:     # bare tasks in unit tests carry none
                inst.smret = mret.stages[job.stage_idx]
                inst.cost_b = batch_cost(inst.profile, job.n_inputs)
        key = (stage_level(inst, self.qcfg), inst.virtual_deadline_ms,
               next(_seq))
        heapq.heappush(self._heap, (key, inst))
        self._version += 1
        if self._hot is not None:
            self._hot.add(self._hot_key)

    def pop(self) -> Optional[StageInstance]:
        if not self._heap:
            return None
        self._version += 1
        out = heapq.heappop(self._heap)[1]
        if not self._heap and self._hot is not None:
            self._hot.discard(self._hot_key)
        return out

    def peek(self) -> Optional[StageInstance]:
        return self._heap[0][1] if self._heap else None

    def find_inst(self, job) -> Optional[StageInstance]:
        """The queued instance of ``job``'s current stage, if any (a job
        has at most one: stages are sequential). None means the stage is
        executing on a lane (or completing this instant)."""
        for _, inst in self._heap:
            if inst.job is job:
                return inst
        return None

    def remove(self, inst: StageInstance) -> bool:
        """Remove one queued instance (cancellation path). Pop order of
        the survivors is unchanged: ordering is fully determined by the
        (level, vdl, seq) keys, which heapify preserves."""
        for i, (_, it) in enumerate(self._heap):
            if it is inst:
                last = self._heap.pop()
                if i < len(self._heap):
                    self._heap[i] = last
                    heapq.heapify(self._heap)
                self._version += 1
                if not self._heap and self._hot is not None:
                    self._hot.discard(self._hot_key)
                return True
        return False

    def __len__(self) -> int:
        return len(self._heap)

    def instances(self) -> List[StageInstance]:
        """Snapshot of queued instances (heap order, NOT pop order) —
        the degradation controller's emergency-shed enumeration."""
        return [inst for _, inst in self._heap]

    def drain(self):
        """Remove and return all queued stages (fault recovery path)."""
        items = [inst for _, inst in self._heap]
        self._heap = []
        self._version += 1
        if self._hot is not None:
            self._hot.discard(self._hot_key)
        return items

    def backlog_ms(self) -> float:
        """Sum of MRET of queued stages (migration target estimation);
        batched stages cost b/g(b) x their normalized MRET. Uses the
        per-instance cached estimator/cost (see StageInstance): same
        floats, same left-to-right order, none of the property chains.

        Memoized on (queue version, StageMret.generation): migration
        candidate scans call this once per live context per straggler
        kill, and between queue/estimator mutations the recompute would
        run the identical loop over identical floats — the cached total
        IS that loop's result, bit for bit."""
        key = (self._version, StageMret.generation)
        if key == self._backlog_key:   # dsan: ignore[DSAN003] stamp identity
            return self._backlog_total
        total = 0.0
        for _, inst in self._heap:
            total += inst.smret.value() * inst.cost_b
        self._backlog_key = key
        self._backlog_total = total
        return total
