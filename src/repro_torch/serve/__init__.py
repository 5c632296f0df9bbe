# Copy of src/repro/serve/__init__.py; only this line differs (tests/test_torch_isolation.py checks it).
"""repro.serve — production serving front-end over ``DarisServer``.

The paper's engine runs batch experiments: build, run to a horizon,
read metrics. This package wraps it as a long-running service:

* ``daemon``  — ops daemon: owns one serving-mode engine, accepts client
  commands over a local unix socket, journals every accepted submission
  durably before acknowledging it, checkpoints on SIGTERM, and resumes
  from checkpoint + journal after a crash with zero acknowledged-but-lost
  jobs.
* ``client``  — thin line-JSON client (``submit`` / ``status`` /
  ``result`` / ``cancel`` / ``stats`` / ``drain`` / ``shutdown``).
* ``journal`` — append-only JSONL request journal; replayable as
  ``TraceArrival`` input so any recorded traffic (outages included)
  becomes a deterministic simulation scenario.
* ``config``  — JSON serving config -> ``DarisServer`` builder, shared by
  the live daemon and the offline replayer so both drive the same engine.

CLI: ``python -m repro.serve daemon|submit|status|result|cancel|stats|
drain|shutdown|replay|audit``.
"""
from .client import DarisClient
from .config import build_server, load_config
from .daemon import ServeDaemon
from .journal import (Journal, audit_zero_lost, read_journal,
                      to_trace_arrivals, unfinished_submits)

__all__ = [
    "DarisClient", "ServeDaemon", "Journal",
    "build_server", "load_config",
    "read_journal", "to_trace_arrivals", "unfinished_submits",
    "audit_zero_lost",
]
