# Copy of src/repro/analysis/schedcheck/__init__.py; only this line differs (tests/test_torch_isolation.py checks it).
"""SchedCheck: static schedulability analysis for DARIS configurations.

Three entry points:

* ``analyze_config(cfg)`` — offline WCRT analysis of an unbuilt
  ``ServerConfig`` (never runs the engine); returns a ``Report`` with
  per-epoch, per-task ``GUARANTEED``/``CONDITIONAL``/``UNSCHEDULABLE``
  verdicts and the binding constraint for each.
* ``differential_check(cfg)`` / ``run_oracle(...)`` — the bound-vs-sim
  oracle: run the scenario and assert observed HP responses never
  exceed the static bound (CI gates on this).
* ``python -m repro.analysis.schedcheck <config.json | --figure NAME>``
  — the CLI (JSON + human reports; see ``__main__``).

``ServerConfig.verify()`` and the serve-daemon ``schedcheck`` config key
wire the same analysis in at build/startup time.
"""
from .analyzer import analyze_config
from .model import (CONDITIONAL, GUARANTEED, UNSCHEDULABLE, EpochReport,
                    Report, StageBound, TaskVerdict, UnschedulableError,
                    worst_verdict)
from .oracle import OracleResult, differential_check, run_oracle

__all__ = [
    "analyze_config", "differential_check", "run_oracle",
    "GUARANTEED", "CONDITIONAL", "UNSCHEDULABLE",
    "Report", "EpochReport", "TaskVerdict", "StageBound",
    "OracleResult", "UnschedulableError", "worst_verdict",
]
