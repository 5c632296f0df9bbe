# Copy of src/repro/core/task.py; only this line differs (tests/test_torch_isolation.py checks it).
"""DARIS task model (paper §III-A).

τ_i(T_i, D_i, mret_i(t), p_i, ctx_i(t)) — periodic task = one DNN, divided
into n_i sequential stages. Two priority levels (HP/LP). D_i = T_i.

``Job`` is one periodic release; ``StageInstance`` is one stage of one job
(the schedulable unit). Virtual deadlines (Eq. 8) split the job deadline
across stages proportionally to per-stage MRET.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from .mret import StageMret, TaskMret

HP = 0   # high priority
LP = 1   # low priority

_job_counter = itertools.count()


@dataclasses.dataclass
class StageProfile:
    """Execution profile of one stage (drives the contention model and,
    in real mode, maps to a jitted stage function)."""
    name: str
    t_alone_ms: float          # single-stream, idle-device execution time
    n_sat: float               # device units the stage can actually use
    mem_frac: float            # memory-bandwidth-bound fraction
    overhead_ms: float = 0.05  # dispatch/sync overhead (staging cost)
    payload: Optional[object] = None   # real-mode callable
    batch_gain: float = 1.0    # asymptotic batching speedup g_inf (Table I);
                               # 1.0 = batching scales work linearly


@dataclasses.dataclass
class TaskSpec:
    """Static description of a periodic task."""
    name: str
    period_ms: float
    priority: int                     # HP | LP
    stages: List[StageProfile]
    batch: int = 1

    @property
    def deadline_ms(self) -> float:   # D_i = T_i
        return self.period_ms

    @property
    def n_stages(self) -> int:
        return len(self.stages)


@dataclasses.dataclass(eq=False)
class Task:
    """Runtime task state: MRET estimates + context assignment.

    ``eq=False``: runtime objects compare by identity. Value equality
    would recurse through spec/stage dataclasses on every membership
    test, which made ``list.remove`` on job collections quadratic."""
    spec: TaskSpec
    index: int
    ctx: int = -1                     # current context (ctx_i(t))
    fixed_ctx: bool = False           # HP tasks get fixed contexts
    # paper Eq. 1-2 estimators are attached by the scheduler (core.mret)
    mret: Optional[TaskMret] = None

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def priority(self) -> int:
        return self.spec.priority

    def utilization(self, now_ms: float) -> float:
        """Eq. 3 / Eq. 10: u_i = mret_i / T_i (AFET-seeded before history)."""
        return self.mret.task_mret(now_ms) / self.spec.period_ms


@dataclasses.dataclass(eq=False)
class Job:
    """One release of a task — or, under dynamic batching, one *batched*
    release: later releases of the same task that coalesced into this job
    (core/batching.py) append their timestamps to ``extra_release_ms`` and
    the job executes each stage once over ``n_inputs`` inputs.

    ``release_ms`` is always the EARLIEST member's release: the batched
    job inherits that member's absolute deadline and virtual-deadline
    anchoring, so batching can only ever tighten, never relax, the
    deadline the scheduler works against."""
    task: Task
    release_ms: float
    job_id: int = dataclasses.field(default_factory=lambda: next(_job_counter))
    ctx: int = -1                     # context this job was admitted to
    stage_idx: int = 0
    start_ms: Optional[float] = None
    finish_ms: Optional[float] = None
    vdl_missed_prev: bool = False     # did the previous stage miss its vdl?
    extra_release_ms: List[float] = dataclasses.field(default_factory=list)
    # task.index of each extra member, in lockstep with extra_release_ms
    # (scope="model" batches span tasks; completion must reach each
    # member's own handle)
    extra_member_idx: List[int] = dataclasses.field(default_factory=list)
    # first-class cancellation (scheduler.cancel_job): a cancelled job
    # retires instead of completing — immediately while queued, at the
    # next stage boundary while in flight (zero-delay semantics)
    cancelled: bool = False
    # release timestamps of batch members cancelled after the batch
    # sealed: the input physically rides along (the launched work is
    # fixed), but its result is discarded — response/throughput
    # accounting skips these releases
    dropped_releases: List[float] = dataclasses.field(default_factory=list)

    @property
    def n_inputs(self) -> int:
        return 1 + len(self.extra_release_ms)

    @property
    def release_times(self) -> List[float]:
        """Per-input release timestamps (earliest first) — each input's
        response time is measured from its own release."""
        return [self.release_ms, *self.extra_release_ms]

    @property
    def abs_deadline_ms(self) -> float:
        return self.release_ms + self.task.spec.deadline_ms

    def stage_profile(self) -> StageProfile:
        return self.task.spec.stages[self.stage_idx]

    def is_last_stage(self) -> bool:
        return self.stage_idx == self.task.spec.n_stages - 1


@dataclasses.dataclass(eq=False)
class StageInstance:
    """The schedulable unit: stage ``job.stage_idx`` of ``job``.
    Identity equality (``eq=False``): two instances are never "the same
    stage" unless they are the same object."""
    job: Job
    enqueue_ms: float
    virtual_deadline_ms: float        # absolute (Eq. 8 slice end)
    work_done: float = 0.0            # device-seconds already executed
    lane: Optional[tuple] = None      # (ctx, slot) while running
    start_ms: Optional[float] = None
    # backlog-estimation constants, filled on first queue entry
    # (StageQueue.push): the stage's MRET estimator and its batch cost
    # b/g(b) are fixed for the instance's lifetime, and resolving them
    # through job -> task -> spec property chains per queued stage made
    # backlog_ms the hottest loop on overload runs
    smret: Optional[StageMret] = None
    cost_b: float = 1.0
    # chaos-layer retry accounting: execution attempts this stage has
    # burned (transient stage faults, see repro.chaos). Always 0 with no
    # ChaosPlan installed.
    attempts: int = 0
    # inter-GPU migration charge (cluster layer): when this stage
    # dispatches on a different device than the one holding the job's
    # inter-stage state, the dispatcher stamps the configured transfer
    # cost here and the backend adds it to the stage's work. Always 0.0
    # on a single device.
    transfer_ms: float = 0.0

    @property
    def profile(self) -> StageProfile:
        return self.job.stage_profile()

    @property
    def task(self) -> Task:
        return self.job.task
