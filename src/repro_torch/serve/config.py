# Copy of src/repro/serve/config.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Serving config (JSON) -> ``DarisServer``, shared by daemon and replay.

The daemon and the offline journal replayer must build IDENTICAL engines
— same tasks in the same registration order, same geometry, same seed —
or a replay stops being a reproduction. This module is that single
construction path.

Config schema (all scheduler fields optional)::

    {
      "tasks": [
        {"dnn": "resnet18", "priority": "HP", "jps": 30.0,
         "count": 2, "tag": "-frontend"}
      ],
      "contexts": 4, "streams": 1, "oversubscribe": 4.0,
      "batching": {"max_batch": 8, "scope": "model"},
      "seed": 0, "noise": 0.06, "horizon_ms": 1e9
    }

``dnn`` names a calibrated profile (``serving.profiles``: resnet18, unet,
inceptionv3). Every task gets a ``ManualArrival`` — the daemon's clients
are the only release source — unless ``"jps_background": true`` marks it
as self-releasing periodic load behind the served traffic.
"""
from __future__ import annotations

import json
from typing import TYPE_CHECKING, Dict, List, Optional

from ..api import DarisServer, ManualArrival, ServerConfig

if TYPE_CHECKING:                                   # pragma: no cover
    from ..analysis.schedcheck import Report
from ..core.task import HP, LP, TaskSpec

_PRIO = {"HP": HP, "LP": LP, "hp": HP, "lp": LP}
# the daemon serves until stopped; the engine still wants a finite guard
# horizon for event validation, far past any realistic session
DEFAULT_HORIZON_MS = 1e9


def load_config(path: str) -> Dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _task_specs(cfg: Dict) -> List[Dict]:
    from ..serving.profiles import make_task
    out = []
    for t in cfg.get("tasks", []):
        prio = _PRIO[t.get("priority", "LP")]
        n = int(t.get("count", 1))
        for i in range(n):
            tag = t.get("tag", "")
            if n > 1:
                tag = f"{tag}-{i}"
            spec = make_task(t["dnn"], priority=prio,
                             jps=float(t.get("jps", 10.0)),
                             batch=int(t.get("batch", 1)), tag=tag)
            out.append({"spec": spec,
                        "background": bool(t.get("jps_background", False))})
    if not out:
        raise ValueError("serving config needs at least one task")
    return out


def server_config(cfg: Dict, *, arrivals: Optional[Dict[str, object]] = None
                  ) -> ServerConfig:
    """The (unbuilt) ``ServerConfig`` a serving config describes.
    ``arrivals`` swaps in replacement arrival processes by task name (the
    journal replayer's ``TraceArrival`` injection point); configured
    manual/background roles apply otherwise. The static analyzer
    (``repro.analysis.schedcheck``) consumes this directly — same object
    the daemon builds, so analysis and serving can never diverge."""
    sc = ServerConfig.sim()
    specs = _task_specs(cfg)
    overrides = arrivals or {}
    for entry in specs:
        spec: TaskSpec = entry["spec"]
        if spec.name in overrides:
            sc.task(spec, arrival=overrides[spec.name])
        elif entry["background"]:
            sc.task(spec)                   # default periodic self-release
        else:
            sc.task(spec, arrival=ManualArrival())
    sc.contexts(int(cfg.get("contexts", 4)))
    sc.streams(int(cfg.get("streams", 1)))
    sc.oversubscribe(float(cfg.get("oversubscribe", 4.0)))
    sc.horizon_ms(float(cfg.get("horizon_ms", DEFAULT_HORIZON_MS)))
    sc.seed(int(cfg.get("seed", 0)))
    # served traffic is aperiodic; phase offsets only apply to background
    # periodic tasks, and a daemon restart must not re-draw them — keep
    # the phase deterministic unless the config opts in
    sc.phase_offsets(bool(cfg.get("phase_offsets", False)))
    if "noise" in cfg:
        sc.noise(float(cfg["noise"]))
    b = cfg.get("batching")
    if b:
        sc.batching(max_batch=int(b.get("max_batch", 8)),
                    max_wait_ms=b.get("max_wait_ms"),
                    scope=b.get("scope", "model"))
    if "sched" in cfg:
        sc.scheduler_options(**cfg["sched"])
    c = cfg.get("chaos")
    if c:
        # {"chaos": {"seed": 0, "stage_fault_rate": 0.01, ...}} — the
        # same dict shape ChaosPlan takes; see chaos.plan.plan_from_dict
        from ..chaos.plan import plan_from_dict
        sc.chaos(plan_from_dict(c))
    s = cfg.get("sanitize")
    if s:
        # {"sanitize": 2} or {"sanitize": {"level": 1, "cadence": 64}};
        # the DARIS_SANITIZE env var still applies when the key is absent
        if isinstance(s, dict):
            sc.sanitize(level=int(s.get("level", 1)),
                        cadence=s.get("cadence"))
        else:
            sc.sanitize(level=int(s))
    return sc


def build_server(cfg: Dict, *, arrivals: Optional[Dict[str, object]] = None
                 ) -> DarisServer:
    """Build the serving engine a config describes (see
    ``server_config`` for the construction contract)."""
    return server_config(cfg, arrivals=arrivals).build()


def check_schedulability(cfg: Dict) -> Optional[Report]:
    """Opt-in startup gate: ``{"schedcheck": "warn" | "enforce"}``.

    Returns the analysis ``Report`` (or None when the key is absent /
    ``"off"``). ``"enforce"`` raises ``UnschedulableError`` when any HP
    task is statically UNSCHEDULABLE; ``"warn"`` only reports. The
    analyzer treats manual (client-driven) tasks at their declared rate,
    so the verdict is a contract on offered load, not a tautology."""
    mode = str(cfg.get("schedcheck", "off")).lower()
    if mode == "off":
        return None
    if mode not in ("warn", "enforce"):
        raise ValueError(f"schedcheck mode must be 'off', 'warn' or "
                         f"'enforce', got {mode!r}")
    from ..analysis.schedcheck import (UNSCHEDULABLE, UnschedulableError,
                                       analyze_config)
    report = analyze_config(server_config(cfg), label="serve-config")
    if mode == "enforce" and report.hp_verdict == UNSCHEDULABLE:
        raise UnschedulableError(report)
    return report
