"""repro_torch.api — the one front door to DARIS serving, on PyTorch/CUDA.

Counterpart of src/repro/api.py: the same ``ServerConfig``/``DarisServer``
over the copied scheduler and engine loop, with the heap ``SimBackend``,
the epoch engine (``engine("epoch")``, its rate-groups on the CUDA
contention kernel), the CUDA ``RealtimeBackend``, simulated multi-GPU
clusters (``ServerConfig.cluster``, on either sim engine) and the static
schedulability gate (``verify()``, SchedCheck), and scheduler-state
checkpoints (``save_state``/``load_state``) in the JAX package's file
format.

One scheduler (admission Eq. 11-12, staging, oversubscription, zero-delay
migration) serves every deployment shape; this module is the single typed
facade over it. A ``DarisServer`` is built from a fluent ``ServerConfig``
and drives the shared ``EngineCore`` loop against a pluggable
``ExecutionBackend`` — the calibrated fluid simulator or the threaded
real torch/CUDA executor — with first-class arrival processes (periodic, Poisson
open-loop, recorded trace), dynamic deadline-aware batching
(``.batching(max_batch)``), and injectable fault / scale-out events.

    from repro_torch.api import HP, ServerConfig
    from repro_torch.models import BUILDERS
    from repro_torch.serving.engine import staged_cnn_taskspec

    model = BUILDERS["resnet18"](width=64)     # on the card; device="cpu"
    server = (ServerConfig.realtime()          # opts out, on both
              .tasks([staged_cnn_taskspec(model, priority=HP, jps=30.0,
                                          input_hw=224)])
              .contexts(2).oversubscribe(2.0)
              .horizon_ms(3000)
              .realtime_io(input_hw=224)
              .build())
    metrics = server.run()

Programmatic clients submit one-shot jobs and introspect live state:

    handle = server.submit(spec, at_ms=100.0)    # admission-tested
    server.drain()                               # run until queues empty
    server.snapshot()                            # queue depths, lanes, ...

``serving.engine`` also has ``staged_lm_taskspec`` (staged LM decode). The
reference's deprecated ``SimEngine`` / ``RealtimeEngine`` shims are not
ported: servers are built here only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from .chaos.plan import (Brownout, ChaosPlan, DegradationPolicy,
                         RetryPolicy)
from .core.batching import BatchPolicy
from .core.metrics import RunMetrics
from .core.scheduler import DarisScheduler, SchedulerConfig
from .core.task import HP, LP, StageProfile, TaskSpec
from .runtime.arrivals import (ArrivalProcess, ManualArrival,
                               PeriodicArrival, PoissonArrival, TraceArrival)
from .runtime.backend import (ExecutionBackend, RealtimeBackend, SimBackend)
from .runtime.contention import DeviceModel
from .runtime.epoch import EpochSimBackend
from .runtime.epoch_cuda import CudaEpochSimBackend
from .runtime.engine_core import (AutoscalePolicy, Completion, EngineCore,
                                  FaultPlan, SubmitHandle)

__all__ = [
    "ServerConfig", "DarisServer", "FaultPlan", "AutoscalePolicy",
    "SubmitHandle",
    "ChaosPlan", "RetryPolicy", "DegradationPolicy", "Brownout",
    "ArrivalProcess", "ManualArrival", "PeriodicArrival", "PoissonArrival",
    "TraceArrival",
    "ExecutionBackend", "SimBackend", "EpochSimBackend",
    "CudaEpochSimBackend", "RealtimeBackend",
    "SchedulerConfig", "DeviceModel", "TaskSpec", "StageProfile",
    "BatchPolicy", "HP", "LP", "RunMetrics", "EngineCore", "Completion",
]

SIM, REALTIME = "sim", "realtime"


class ServerConfig:
    """Fluent builder for ``DarisServer``. Every setter returns ``self``;
    ``build()`` validates the whole configuration at once."""

    def __init__(self, backend_kind: str = SIM, torch_device=None):
        if backend_kind not in (SIM, REALTIME):
            raise ValueError(f"unknown backend {backend_kind!r}")
        self._backend_kind = backend_kind
        self._cluster: Optional[Dict[str, object]] = None
        self._torch_device = torch_device   # payloads' or epoch kernel's device
        self._engine = "heap"
        self._specs: List[TaskSpec] = []
        self._sched_cfg: Optional[SchedulerConfig] = None
        self._sched_kw: Dict[str, object] = {}
        self._sched_cls: type = DarisScheduler
        self._sched_cls_kw: Dict[str, object] = {}
        self._device: Optional[DeviceModel] = None
        self._horizon_ms = 6000.0
        self._seed = 0
        self._noise_sigma: Optional[float] = None
        self._phase_offsets = True
        self._arrivals: Dict[str, ArrivalProcess] = {}
        self._open_loop: Optional[tuple] = None   # (rate_jps, seed)
        self._fault_plan: Optional[FaultPlan] = None
        self._autoscale: Optional[AutoscalePolicy] = None
        self._batch_policy: Optional[BatchPolicy] = None
        self._record_decisions = False
        self._sanitize = None
        self._chaos_plan: Optional[ChaosPlan] = None
        self._input_hw = 64
        self._batch = 1
        self._input_factory = None
        self._ctx_devices: Optional[Dict[int, object]] = None
        self._schedcheck_report = None   # set by verify()

    # -------------------------------------------------------- entry points
    @classmethod
    def sim(cls) -> "ServerConfig":
        """Calibrated fluid-simulation backend (virtual time)."""
        return cls(SIM)

    @classmethod
    def realtime(cls, device=None) -> "ServerConfig":
        """Real execution backend (wall clock, threaded lanes, one CUDA
        stream per lane). Runs on the card; raises without one unless
        ``device`` names another (``device="cpu"``)."""
        from .device import resolve_device
        return cls(REALTIME, resolve_device(device))

    @classmethod
    def cluster(cls, n_gpus: int, *,
                device_models: Optional[List] = None,
                transfer_ms: float = 0.5) -> "ServerConfig":
        """Multi-GPU serving (``cluster``): ``n_gpus`` simulated
        devices behind one global dispatcher — per-device Eq. 11-12
        admission, HP-first placement by least-loaded device, cross-GPU
        zero-delay migration charged at ``transfer_ms`` per moved
        inter-stage payload. ``device_models`` takes DeviceModel objects
        or preset names ("a100", "v100", ...; see cluster.devices),
        cycled across devices — heterogeneous speed factors scale every
        stage cost and admission bound per device. When given, it takes
        precedence over ``.device(...)``, which then only sets the sim's
        generic device defaults for non-cluster paths; omit it and
        ``.device(...)`` becomes every GPU's model. Context/stream/
        oversubscription setters configure EACH device's partition.
        Cluster serving runs on the sim backend (one shared clock), on
        either engine: ``engine("epoch")`` sends its rate-groups to the
        contention kernel on the card."""
        cfg = cls(SIM)
        cfg._cluster = {"n_gpus": n_gpus,
                        "device_models": device_models,
                        "transfer_ms": transfer_ms}
        return cfg

    # ------------------------------------------------------------ workload
    def tasks(self, specs: List[TaskSpec]) -> "ServerConfig":
        self._specs.extend(specs)
        return self

    def task(self, spec: TaskSpec,
             arrival: Optional[ArrivalProcess] = None) -> "ServerConfig":
        self._specs.append(spec)
        if arrival is not None:
            self._arrivals[spec.name] = arrival
        return self

    def arrival(self, task_name: str, proc: ArrivalProcess) -> "ServerConfig":
        """Override the arrival process for one named task."""
        self._arrivals[task_name] = proc
        return self

    def open_loop(self, rate_jps: float, seed: int = 0) -> "ServerConfig":
        """Poisson open-loop arrivals for every task: each task gets its
        own stream seeded from ``seed`` + its index, so the whole arrival
        trace is reproducible across runs and across backends."""
        self._open_loop = (rate_jps, seed)
        return self

    def phase_offsets(self, enabled: bool) -> "ServerConfig":
        """Random phase offsets for periodic tasks (default on, matching
        the paper's unsynchronized release convention)."""
        self._phase_offsets = enabled
        return self

    # ----------------------------------------------------------- scheduler
    def contexts(self, n: int) -> "ServerConfig":
        self._sched_kw["n_contexts"] = n
        return self

    def streams(self, n: int) -> "ServerConfig":
        self._sched_kw["n_streams"] = n
        return self

    def oversubscribe(self, factor: float) -> "ServerConfig":
        self._sched_kw["oversubscription"] = factor
        return self

    def scheduler_options(self, **kw) -> "ServerConfig":
        """Extra ``SchedulerConfig`` fields (overload_hpa, ablations, ...)."""
        self._sched_kw.update(kw)
        return self

    def scheduler_config(self, cfg: SchedulerConfig) -> "ServerConfig":
        """Use a fully-built SchedulerConfig (overrides field setters)."""
        self._sched_cfg = cfg
        return self

    def scheduler_cls(self, cls: type, **kw) -> "ServerConfig":
        """Custom DarisScheduler subclass (tracing, research hooks)."""
        self._sched_cls = cls
        self._sched_cls_kw = kw
        return self

    def device(self, dm: DeviceModel) -> "ServerConfig":
        self._device = dm
        return self

    def batching(self, max_batch: int = 8,
                 max_wait_ms: Optional[float] = None,
                 scope: str = "model") -> "ServerConfig":
        """Dynamic deadline-aware batching (core/batching.py): while a job
        waits at its first stage, later releases of the same model (or the
        same task, ``scope="task"``) coalesce into it — up to ``max_batch``
        inputs, bounded by the earliest member's virtual deadline (and
        optionally ``max_wait_ms``), with admission charging the batched
        utilization. Composes with any backend/policy; leave unset for the
        paper's unbatched scheduler."""
        self._batch_policy = BatchPolicy(max_batch=max_batch,
                                         max_wait_ms=max_wait_ms,
                                         scope=scope)
        return self

    # --------------------------------------------------------------- run
    def horizon_ms(self, ms: float) -> "ServerConfig":
        self._horizon_ms = ms
        return self

    def seed(self, seed: int) -> "ServerConfig":
        self._seed = seed
        return self

    def noise(self, sigma: float) -> "ServerConfig":
        """Lognormal stage-time noise (sim backend only)."""
        self._noise_sigma = sigma
        return self

    def engine(self, kind: str, device=None) -> "ServerConfig":
        """Simulation engine selection (sim backend only):

        * ``"heap"`` (default) — the versioned prediction-heap engine
          (``SimBackend``), the bit-exact reference path;
        * ``"epoch"`` — the array-programmed epoch engine
          (``CudaEpochSimBackend``): vectorized lane-state integration,
          cohort-ordered ETA selection, and rate-groups of ``KERNEL_MIN``
          lanes or more on the contention kernel, bit-identical to the
          heap path. Its kernel runs on the card; it raises without one
          unless ``device`` names another (``device="cpu"``).
        """
        if kind not in ("heap", "epoch"):
            raise ValueError(f"unknown engine {kind!r}: expected "
                             f"'heap' or 'epoch'")
        if kind == "epoch":
            from .device import resolve_device
            self._torch_device = resolve_device(device)
        elif device is not None:
            raise ValueError("engine('heap') runs on the host: it takes no "
                             "device")
        self._engine = kind
        return self

    def record_decisions(self, enabled: bool = True) -> "ServerConfig":
        """Keep an ordered log of admit/reject/dispatch/finish decisions
        (the sim-vs-real parity contract)."""
        self._record_decisions = enabled
        return self

    def sanitize(self, level: int = 1, *,
                 cadence: Optional[int] = None) -> "ServerConfig":
        """Enable the DSAN invariant auditor (repro/analysis): level 1
        audits every ``cadence`` engine steps (default 256), level >= 2
        audits every step. Equivalent to running under
        ``DARIS_SANITIZE=<level>``; violations raise
        ``SanitizerViolation``."""
        from .analysis.sanitizer import Sanitizer
        self._sanitize = Sanitizer(level=level, cadence=cadence)
        return self

    # ------------------------------------------------------ faults/elastic
    def chaos(self, plan: Optional[ChaosPlan] = None,
              **kw) -> "ServerConfig":
        """Install seeded transient-fault injection + recovery
        (repro.chaos): pass a built ``ChaosPlan`` or its fields as
        keyword arguments —

            .chaos(seed=1, stage_fault_rate=0.01,
                   retry=RetryPolicy(max_attempts=3),
                   degradation=DegradationPolicy(),
                   watchdog_kappa=6.0)

        Chaos draws use the plan's own RNG streams, never the simulation
        stream: a server built without ``.chaos(...)`` is bit-identical
        to one that never imported the chaos layer."""
        if plan is not None and kw:
            raise ValueError("chaos(): pass a ChaosPlan OR field kwargs, "
                             "not both")
        self._chaos_plan = plan if plan is not None else ChaosPlan(**kw)
        return self

    def fault_plan(self, fp: FaultPlan) -> "ServerConfig":
        self._fault_plan = fp
        return self

    def fail_context_at(self, ctx: int, t_ms: float) -> "ServerConfig":
        fp = self._fault_plan or FaultPlan()
        self._fault_plan = dataclasses.replace(fp, fail_ctx_at=(ctx, t_ms))
        return self

    def fail_device_at(self, device: int, t_ms: float) -> "ServerConfig":
        """Kill a whole GPU mid-run (cluster servers only): its in-flight
        stages are cancelled and replay on surviving devices, and every
        task homed there re-places HP-first via cross-GPU migration."""
        fp = self._fault_plan or FaultPlan()
        self._fault_plan = dataclasses.replace(fp,
                                               fail_device_at=(device, t_ms))
        return self

    def scale_out_at(self, t_ms: float) -> "ServerConfig":
        fp = self._fault_plan or FaultPlan()
        self._fault_plan = dataclasses.replace(fp, add_ctx_at=t_ms)
        return self

    def reconfigure_at(self, t_ms: float, *, n_contexts: Optional[int] = None,
                       n_streams: Optional[int] = None,
                       oversubscription: Optional[float] = None,
                       n_gpus: Optional[int] = None
                       ) -> "ServerConfig":
        """Schedule an online repartition: at ``t_ms`` the scheduler
        re-derives Eq. 9 geometry for the new shape without draining —
        queued work re-homes immediately, in-flight stages finish where
        they run and migrate at the next stage boundary (zero-delay).
        Omitted fields keep their current value; call repeatedly to build
        a schedule (a diurnal ramp, a step plan, ...). ``n_gpus``
        (cluster servers only) scales by whole devices: growth appends
        fresh GPUs, shrink retires them gracefully, and a global HP-first
        re-place follows either way."""
        kwargs = {k: v for k, v in (("n_contexts", n_contexts),
                                    ("n_streams", n_streams),
                                    ("oversubscription", oversubscription),
                                    ("n_gpus", n_gpus))
                  if v is not None}
        if not kwargs:
            raise ValueError("reconfigure_at needs at least one of "
                             "n_contexts / n_streams / oversubscription / "
                             "n_gpus")
        fp = self._fault_plan or FaultPlan()
        sched = list(fp.reconfigure_at or [])
        sched.append((t_ms, kwargs))
        self._fault_plan = dataclasses.replace(fp, reconfigure_at=sched)
        return self

    def autoscale(self, low: float = 0.3, high: float = 0.85, *,
                  check_every_ms: float = 250.0, min_contexts: int = 1,
                  max_contexts: int = 8,
                  cooldown_ms: float = 500.0) -> "ServerConfig":
        """Utilization-driven elasticity: grow/shrink by one scale unit
        whenever the mean Eq. 12 load fraction across live contexts
        crosses ``high``/``low`` (see ``AutoscalePolicy``). The unit —
        and the ``min_contexts``/``max_contexts`` bounds — is contexts on
        a single-device server and WHOLE GPUs on a cluster server
        (``ServerConfig.cluster``).
        Composes with ``reconfigure_at`` — the autoscaler simply issues
        the same online repartitions on its own schedule."""
        self._autoscale = AutoscalePolicy(
            low=low, high=high, check_every_ms=check_every_ms,
            min_contexts=min_contexts, max_contexts=max_contexts,
            cooldown_ms=cooldown_ms)
        return self

    # ------------------------------------------------------------ realtime
    def realtime_io(self, input_hw: int = 64, batch: int = 1,
                    input_factory: Optional[Callable] = None,
                    ctx_devices: Optional[Dict[int, object]] = None
                    ) -> "ServerConfig":
        """Input tensor shape / factory for real stage payloads.

        ``ctx_devices`` maps live slot position -> torch device (slot 0
        = lowest-indexed live context; equal to the context index until
        the first fault/reshape — see ``RealtimeBackend``); when set,
        inter-stage hidden/cache state physically moves onto the
        target context's device whenever a job migrates contexts at a
        stage boundary (``serving.staging.migrate``)."""
        self._input_hw = input_hw
        self._batch = batch
        self._input_factory = input_factory
        self._ctx_devices = ctx_devices
        return self

    # --------------------------------------------------------------- build
    def _scheduler_config(self) -> SchedulerConfig:
        cfg = self._sched_cfg or SchedulerConfig(**self._sched_kw)
        if self._batch_policy is not None:
            cfg = dataclasses.replace(cfg, batch_policy=self._batch_policy)
        return cfg

    def _validate(self) -> None:
        if self._horizon_ms <= 0:
            raise ValueError(f"horizon_ms must be > 0, got {self._horizon_ms}")
        cfg = self._scheduler_config()   # TypeError on unknown options
        if cfg.n_contexts < 1 or cfg.n_streams < 1:
            raise ValueError(f"need >=1 context and stream, got "
                             f"{cfg.n_contexts}x{cfg.n_streams}")
        if cfg.oversubscription < 1.0:
            raise ValueError(f"oversubscription must be >= 1, got "
                             f"{cfg.oversubscription}")
        if self._noise_sigma is not None and self._backend_kind != SIM:
            raise ValueError("noise() applies to the sim backend only")
        if self._noise_sigma is not None and self._noise_sigma < 0:
            raise ValueError("noise sigma must be >= 0")
        if self._autoscale is not None:
            a = self._autoscale
            if not (0.0 <= a.low < a.high):
                raise ValueError(f"autoscale needs 0 <= low < high, got "
                                 f"low={a.low} high={a.high}")
            if a.min_contexts < 1 or a.max_contexts < a.min_contexts:
                raise ValueError(f"autoscale needs 1 <= min_contexts <= "
                                 f"max_contexts, got [{a.min_contexts}, "
                                 f"{a.max_contexts}]")
            if a.check_every_ms <= 0 or a.cooldown_ms < 0:
                raise ValueError(f"autoscale needs check_every_ms > 0 and "
                                 f"cooldown_ms >= 0, got "
                                 f"check_every_ms={a.check_every_ms} "
                                 f"cooldown_ms={a.cooldown_ms}")
        if self._cluster is not None:
            n_gpus = self._cluster["n_gpus"]
            if not isinstance(n_gpus, int) or n_gpus < 1:
                raise ValueError(f"cluster needs n_gpus >= 1, got {n_gpus}")
            if self._cluster["transfer_ms"] < 0:
                raise ValueError(f"cluster transfer_ms must be >= 0, got "
                                 f"{self._cluster['transfer_ms']}")
            dms = self._cluster["device_models"]
            if dms is not None and len(dms) == 0:
                raise ValueError("cluster device_models must be non-empty "
                                 "when given")
            if self._sched_cls is not DarisScheduler:
                raise ValueError("cluster servers build their own scheduler; "
                                 "scheduler_cls() is not supported")
        fp = self._fault_plan
        # a fleet can only mint NEW device ids via the autoscaler or an
        # n_gpus event exceeding the count standing at its time (a grow
        # past build size, or a regrow after a shrink — grown devices
        # get fresh monotonic ids). A monotone shrink plan can't, so it
        # must not disable the device-range/certain-death checks.
        grows = False
        if fp:
            cur = self._cluster["n_gpus"] if self._cluster else 0
            for _, kw in sorted(fp.reconfigure_at or [],
                                key=lambda e: e[0]):
                n = kw.get("n_gpus")
                if n is not None:
                    grows = grows or n > cur
                    cur = n
        may_grow = bool(fp) and (self._autoscale is not None or grows)
        if fp and fp.fail_device_at is not None:
            if self._cluster is None:
                raise ValueError("fail_device_at requires a cluster server "
                                 "(ServerConfig.cluster)")
            dev = fp.fail_device_at[0]
            # grown devices get fresh monotonic ids, so a growable fleet
            # can legitimately target ids past the build-time size (the
            # runtime no-ops on devices that never materialized)
            if not may_grow and not 0 <= dev < self._cluster["n_gpus"]:
                raise ValueError(f"fail_device_at device {dev} out of range "
                                 f"for {self._cluster['n_gpus']} GPUs")
            # without growth, a 1-GPU cluster losing its device is
            # certain death — reject at build, not RuntimeError mid-run
            if self._cluster["n_gpus"] == 1 and not may_grow:
                raise ValueError(
                    "fail_device_at on a 1-GPU cluster kills the whole "
                    "fleet; add GPUs, a reconfigure_at(n_gpus=...), or an "
                    "autoscale plan")
        if fp and fp.fail_ctx_at is not None and self._cluster is not None:
            # cluster context keys are (device, k) tuples; a bare int
            # would only blow up mid-run inside fail_context
            key = fp.fail_ctx_at[0]
            if not (isinstance(key, tuple) and len(key) == 2):
                raise ValueError(
                    f"fail_context_at on a cluster server needs a "
                    f"(device, context) tuple key, got {key!r} — or use "
                    f"fail_device_at to kill a whole GPU")
            if not may_grow and not 0 <= key[0] < self._cluster["n_gpus"]:
                raise ValueError(f"fail_context_at device {key[0]} out of "
                                 f"range for {self._cluster['n_gpus']} GPUs")
            # context indices only move past the build-time shape via a
            # planned n_contexts reshape or a scale_out_at ADD_CTX
            # (cluster autoscale adds whole GPUs, never contexts) —
            # without either, range-check statically
            reshapes = (fp.add_ctx_at is not None
                        or any("n_contexts" in kw
                               for _, kw in (fp.reconfigure_at or [])))
            nc = (self._sched_cfg.n_contexts
                  if self._sched_cfg is not None
                  else self._sched_kw.get("n_contexts",
                                          SchedulerConfig.n_contexts))
            if not reshapes and not 0 <= key[1] < nc:
                raise ValueError(f"fail_context_at context {key[1]} out of "
                                 f"range for {nc} contexts per device")
            # last-context faults escalate to whole-device failure, so a
            # 1-GPU 1-context cluster that can never grow or reshape is
            # certain death — same static rejection as fail_device_at
            if (self._cluster["n_gpus"] == 1 and nc == 1
                    and not reshapes and not may_grow):
                raise ValueError(
                    "fail_context_at on a 1-GPU, 1-context cluster kills "
                    "the whole fleet (a device's last context escalates "
                    "to device failure); add GPUs/contexts or a "
                    "reconfigure/autoscale plan")
        if fp and fp.reconfigure_at:
            seen_at: Dict[float, Dict] = {}
            for t_ms, kwargs in fp.reconfigure_at:
                prev = seen_at.get(t_ms)
                if prev is not None:
                    raise ValueError(
                        f"duplicate reconfigure_at events at t_ms={t_ms}: "
                        f"{prev} and {dict(kwargs)} would each run a full "
                        f"Algorithm-1 re-place at the same instant "
                        f"(double-counting migrations); merge them into "
                        f"one event or offset their timestamps")
                seen_at[t_ms] = dict(kwargs)
                if t_ms > self._horizon_ms:
                    raise ValueError(f"reconfigure_at t_ms={t_ms} is beyond "
                                     f"the horizon ({self._horizon_ms} ms)")
                nc = kwargs.get("n_contexts")
                if nc is not None and nc < 1:
                    raise ValueError(f"reconfigure_at needs n_contexts >= 1, "
                                     f"got {nc}")
                ns = kwargs.get("n_streams")
                if ns is not None and ns < 1:
                    raise ValueError(f"reconfigure_at needs n_streams >= 1, "
                                     f"got {ns}")
                osf = kwargs.get("oversubscription")
                if osf is not None and osf < 1.0:
                    raise ValueError(f"reconfigure_at needs oversubscription "
                                     f">= 1, got {osf}")
                ng = kwargs.get("n_gpus")
                if ng is not None and self._cluster is None:
                    raise ValueError("reconfigure_at(n_gpus=...) requires a "
                                     "cluster server (ServerConfig.cluster)")
                if ng is not None and ng < 1:
                    raise ValueError(f"reconfigure_at needs n_gpus >= 1, "
                                     f"got {ng}")
                if ng is not None and len(kwargs) > 1:
                    raise ValueError(
                        "reconfigure_at: reshape contexts/streams/"
                        "oversubscription and n_gpus in separate events "
                        "(each runs one re-place)")
        names = {s.name for s in self._specs}
        unknown = set(self._arrivals) - names
        if unknown:
            raise ValueError(f"arrival() for unknown task(s): "
                             f"{sorted(unknown)}")
        dupes = len(self._specs) - len(names)
        if dupes and self._arrivals:
            raise ValueError("per-name arrival overrides require unique "
                             "task names")

    def verify(self, *, enforce: bool = True) -> "ServerConfig":
        """Static schedulability gate (``analysis.schedcheck``):
        analyze this configuration's whole timeline without running it.
        With ``enforce=True`` (default) raises ``UnschedulableError``
        when any HP task is statically UNSCHEDULABLE in any epoch; the
        full report stays readable via ``schedcheck_report`` either way.
        Fluent — chain it right before ``build()``."""
        from .analysis.schedcheck import (UNSCHEDULABLE, UnschedulableError,
                                          analyze_config)
        report = analyze_config(self)
        self._schedcheck_report = report
        if enforce and report.hp_verdict == UNSCHEDULABLE:
            raise UnschedulableError(report)
        return self

    @property
    def schedcheck_report(self):
        """The last ``verify()`` report (None until verify() runs)."""
        return self._schedcheck_report

    def build(self) -> "DarisServer":
        self._validate()
        return DarisServer(self)


class DarisServer:
    """The serving facade: one scheduler + one engine + one backend."""

    def __init__(self, cfg: ServerConfig):
        self._cfg = cfg
        sched_cfg = cfg._scheduler_config()
        if cfg._cluster is not None:
            from .cluster import ClusterScheduler
            self.scheduler = ClusterScheduler(
                list(cfg._specs), sched_cfg, cfg._device,
                n_gpus=cfg._cluster["n_gpus"],
                device_models=cfg._cluster["device_models"],
                transfer_ms=cfg._cluster["transfer_ms"])
        else:
            self.scheduler: DarisScheduler = cfg._sched_cls(
                list(cfg._specs), sched_cfg, cfg._device,
                **cfg._sched_cls_kw)
        if cfg._backend_kind == SIM:
            noise = 0.06 if cfg._noise_sigma is None else cfg._noise_sigma
            if cfg._engine == "epoch":
                backend = CudaEpochSimBackend(noise_sigma=noise,
                                              device=cfg._torch_device)
            else:
                backend = SimBackend(noise_sigma=noise)
        else:
            backend = RealtimeBackend(input_hw=cfg._input_hw,
                                      batch=cfg._batch,
                                      input_factory=cfg._input_factory,
                                      ctx_devices=cfg._ctx_devices,
                                      device=cfg._torch_device)
        self.backend = backend
        phase = "random" if cfg._phase_offsets else 0.0
        arrivals: Dict[int, ArrivalProcess] = {}
        for t in self.scheduler.tasks:
            proc = cfg._arrivals.get(t.name)
            if proc is None and cfg._open_loop is not None:
                rate, seed = cfg._open_loop
                proc = PoissonArrival(rate, seed=seed + t.index)
            if proc is None:
                proc = PeriodicArrival(phase_ms=phase)
            arrivals[t.index] = proc
        self.core = EngineCore(
            self.scheduler, backend, horizon_ms=cfg._horizon_ms,
            seed=cfg._seed, arrivals=arrivals, fault_plan=cfg._fault_plan,
            autoscale=cfg._autoscale,
            record_decisions=cfg._record_decisions,
            sanitize=cfg._sanitize, chaos=cfg._chaos_plan)

    # ------------------------------------------------------------- serving
    def run(self) -> RunMetrics:
        """Drive the configured workload to the horizon."""
        return self.core.run()

    def drain(self) -> RunMetrics:
        """Drive until all submitted/queued work completes (or the horizon
        is reached) — the natural mode for ``submit()``/trace workloads."""
        return self.core.run(until_idle=True)

    def submit(self, spec: TaskSpec, at_ms: float = 0.0,
               tenant: Optional[str] = None) -> SubmitHandle:
        """Register a one-shot job release at ``at_ms``; it goes through
        the same admission test (Eq. 12) as periodic releases. Inspect the
        returned handle after ``run()``/``drain()``."""
        return self.core.submit(spec, at_ms, tenant=tenant)

    def task_named(self, name: str):
        """The registered runtime task with spec name ``name``."""
        for t in self.scheduler.tasks:
            if t.name == name:
                return t
        known = sorted({t.name for t in self.scheduler.tasks})
        raise KeyError(f"no task named {name!r}; registered: {known}")

    def request(self, task_name: str, at_ms: float,
                tenant: Optional[str] = None) -> SubmitHandle:
        """One release of an already-registered task (the serving path:
        tasks carry MRET history and batch heads across requests). Give
        the task a ``ManualArrival`` if clients are its only source of
        releases. Legal before ``run()`` and while serving."""
        return self.core.submit_release(self.task_named(task_name), at_ms,
                                        tenant=tenant)

    def cancel(self, handle: SubmitHandle,
               at_ms: Optional[float] = None) -> None:
        """Schedule a first-class cancellation of ``handle``'s submission
        (engine CANCEL event): a queued job retires immediately — lanes
        stay free, the Eq. 12 admission charge unwinds, batch members
        detach — and an in-flight job retires at its next stage boundary
        (zero-delay semantics). ``at_ms`` defaults to the handle's
        release time (cancel as soon as the submission exists)."""
        if at_ms is None:
            at_ms = handle.release_ms if handle.release_ms is not None \
                else handle.at_ms
        self.core.submit_cancel(handle, at_ms)

    # serving mode: incremental driving for the ops daemon (repro.serve)
    def begin_serving(self) -> None:
        self.core.begin_serving()

    def pump(self, frontier_ms: Optional[float] = None) -> None:
        self.core.pump(frontier_ms)

    def serving_idle(self) -> bool:
        return self.core.serving_idle()

    def end_serving(self, until_idle: bool = True) -> RunMetrics:
        return self.core.end_serving(until_idle=until_idle)

    def snapshot(self) -> dict:
        """Queue depths, lane occupancy, context liveness, live counters."""
        return self.core.snapshot()

    def save_state(self, path: str) -> str:
        """Checkpoint the scheduler's learned/elastic state: MRET windows,
        context assignments, migration count, and the full partition
        geometry (including retired contexts), so a restore reproduces
        the exact post-fault/post-reconfigure placement. The file is the
        one the JAX package writes for the same state."""
        if hasattr(self.scheduler, "workers"):
            raise NotImplementedError(
                "cluster checkpointing is not supported yet: checkpoint "
                "each device's state via its worker schedulers, or run "
                "single-GPU servers for save/restore workflows")
        from .checkpoint import save_scheduler_state
        return save_scheduler_state(self.scheduler, path,
                                    chaos=self.core._chaos)

    def load_state(self, path: str) -> None:
        """Restore scheduler state saved by ``save_state`` (call before
        ``run()``): placement, geometry, and MRET history all survive, so
        a restarted server skips the AFET cold-start AND lands on the
        same partition shape the saved one was using."""
        if hasattr(self.scheduler, "workers"):
            raise NotImplementedError(
                "cluster checkpointing is not supported yet: restore into "
                "a single-GPU server configured like the saved one")
        from .checkpoint import load_scheduler_state
        load_scheduler_state(self.scheduler, path)

    # ---------------------------------------------------------- inspection
    @property
    def metrics(self) -> RunMetrics:
        return self.core.metrics

    @property
    def decisions(self) -> Optional[List[str]]:
        """Ordered admit/reject/dispatch/finish log (record_decisions())."""
        return self.core.decisions


def run_and_summarize(server: DarisServer) -> dict:
    """Convenience: run a built server, return its summary dict with wall
    time attached (the shape benchmarks cache as JSON)."""
    t0 = time.time()
    m = server.run()
    s = m.summary()
    s["wall_s"] = time.time() - t0
    return s
