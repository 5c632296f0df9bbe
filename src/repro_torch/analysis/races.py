# Copy of src/repro/analysis/races.py; only this line differs (tests/test_torch_isolation.py checks it).
"""DSAN daemon race detector.

The serving daemon's concurrency contract (repro/serve/daemon.py) is
single-owner: exactly one pump thread drives the engine — every
scheduler/engine mutation (``begin_serving``/``pump``/``submit``/
``cancel``/``drain``/...) happens on it — while client handler threads
are restricted to the command queue and read-only handle state
(``status``/``result`` snapshots of terminal fields).

Python offers no tsan, so the discipline is asserted structurally:
:class:`ThreadAffinityGuard` wraps every state-mutating method of a
:class:`~repro.api.DarisServer` with an owner-thread check. A call from
any other thread raises :class:`RaceViolation` carrying a tsan-style
report — the offending method, both threads, and the stack that bound
the owner — instead of silently corrupting heap/queue/lane state.

The guard installs per-instance wrappers (``server.__dict__`` shadows
the class methods), so uninstrumented servers pay nothing and
``uninstall()`` restores the pristine instance.
"""
from __future__ import annotations

import threading
import traceback
from typing import List, Optional

# every DarisServer entry point that reaches scheduler/engine state.
# snapshot/save_state walk live heaps and job tables mid-mutation, so
# they are owner-only too — a handler thread wanting a snapshot must ask
# the pump thread for one (the daemon's ``stats`` verb does exactly
# that).
_GUARDED = ("begin_serving", "pump", "serving_idle", "end_serving",
            "submit", "request", "cancel", "drain", "run",
            "snapshot", "save_state", "load_state")


class RaceViolation(RuntimeError):
    """A non-owner thread called a scheduler-mutating server method."""

    def __init__(self, report: str):
        self.report = report
        super().__init__(report)


class ThreadAffinityGuard:
    """Asserts the daemon's single-owner pump-thread discipline.

    Usage (what ``ServeDaemon.run`` does when sanitizing)::

        guard = ThreadAffinityGuard(server).install()   # owner = caller
        ...
        guard.uninstall()

    ``install`` binds the calling thread as owner by default; ``bind``
    re-homes ownership (e.g. after a fork or a pump-thread restart).
    Violations raise and are also kept in ``guard.violations`` so a
    supervising test can assert the clean case.
    """

    def __init__(self, server):
        self.server = server
        self.owner: Optional[threading.Thread] = None
        self._owner_stack: List[str] = []
        self.violations: List[str] = []
        self._methods = [m for m in _GUARDED
                         if callable(getattr(server, m, None))]

    def install(self, owner: Optional[threading.Thread] = None
                ) -> "ThreadAffinityGuard":
        self.bind(owner or threading.current_thread())
        for name in self._methods:
            setattr(self.server, name, self._wrap(name))
        return self

    def bind(self, thread: threading.Thread) -> None:
        self.owner = thread
        self._owner_stack = traceback.format_stack(limit=8)[:-1]

    def uninstall(self) -> None:
        for name in self._methods:
            self.server.__dict__.pop(name, None)

    def _wrap(self, name: str):
        bound = getattr(type(self.server), name).__get__(self.server)

        def checked(*args, **kwargs):
            cur = threading.current_thread()
            if cur is not self.owner:
                report = self._report(name, cur)
                self.violations.append(report)
                raise RaceViolation(report)
            return bound(*args, **kwargs)

        checked.__name__ = name
        checked.__qualname__ = f"dsan_guard.{name}"
        return checked

    def _report(self, method: str, offender: threading.Thread) -> str:
        offender_stack = "".join(
            "    " + ln for ln in traceback.format_stack(limit=8)[:-2])
        owner_stack = "".join("    " + ln for ln in self._owner_stack)
        owner = self.owner
        return (
            f"WARNING: DSAN: data race on scheduler/engine state\n"
            f"  DarisServer.{method}() called off the pump thread\n"
            f"  offending thread: {offender.name} "
            f"(ident={offender.ident})\n"
            f"{offender_stack}"
            f"  owner (pump) thread: "
            f"{owner.name if owner else '<unbound>'} "
            f"(ident={owner.ident if owner else '-'}), bound at:\n"
            f"{owner_stack}"
            f"  rule: scheduler/engine mutation is single-owner; handler "
            f"threads may only enqueue commands and read terminal handle "
            f"state (daemon.py concurrency contract)\n")
