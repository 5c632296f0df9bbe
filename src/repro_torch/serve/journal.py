# Copy of src/repro/serve/journal.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Durable request journal: append-only JSONL, one record per line.

The daemon writes a ``submit`` record — tenant id, priority, virtual
release time — BEFORE acknowledging a submission, so an acknowledged
request is always recoverable. Terminal outcomes append ``done`` records;
cancels append ``cancel`` records; a restart appends ``resubmitted``
records for journaled-but-unfinished requests it re-injects. The file is
therefore both the durability log and a complete traffic capture:
``to_trace_arrivals`` turns it into per-task ``TraceArrival`` processes,
so a recorded outage replays as a deterministic chaos scenario.

Record kinds (``rec`` field):

    meta         {"version", "created_unix", "config_sha"?}   (file open)
    submit       {"seq", "task", "tenant", "prio", "at_ms"}
    cancel       {"seq", "at_ms"}
    done         {"seq", "status", "response_ms"}             (terminal)
    resubmitted  {"seq", "at_ms"}          (restart re-injection, same seq)
    checkpoint   {"path", "at_ms"}         (SIGTERM / shutdown)
    final        {"summary"}               (graceful drain only)

``audit_zero_lost`` is the durability contract: every journaled ``seq``
must reach a terminal ``done``/``cancel`` record, possibly across
restarts (``resubmitted`` chains keep the same seq).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

JOURNAL_VERSION = 1

# submissions in these states are finished business; anything else found
# in a journal at restart must be re-injected
TERMINAL_STATUSES = ("completed", "missed", "rejected", "cancelled",
                     "aborted")


class Journal:
    """Append-only JSONL writer. ``append`` flushes every record (the
    ack-after-journal contract); ``fsync=True`` additionally fsyncs,
    trading throughput for power-loss durability. ``chaos`` (a
    ``ChaosState``) injects transient flush failures: ``append`` retries
    up to ``plan.io_max_retries`` times, then re-raises — the daemon's
    ack-after-journal contract turns an exhausted retry into a refused
    submission rather than a silently lost one."""

    def __init__(self, path: str, fsync: bool = False, chaos=None):
        self.path = str(path)
        self.fsync = fsync
        self.chaos = chaos
        fresh = not os.path.exists(self.path) \
            or os.path.getsize(self.path) == 0
        self._f = open(self.path, "a", encoding="utf-8")
        if fresh:
            self.append({"rec": "meta", "version": JOURNAL_VERSION})

    def append(self, record: Dict) -> None:
        line = json.dumps(record, sort_keys=True) + "\n"
        ch = self.chaos
        attempts = 1 + (ch.plan.io_max_retries if ch is not None else 0)
        for i in range(attempts):
            try:
                if ch is not None and ch.io_fails():
                    raise OSError("chaos: injected journal write failure")
                self._f.write(line)
                self._f.flush()
                if self.fsync:
                    os.fsync(self._f.fileno())
                return
            except OSError:
                if i + 1 >= attempts:
                    raise

    def close(self) -> None:
        self._f.close()


def read_journal(path: str) -> List[Dict]:
    """All records, in append order. A torn final line (crash mid-write)
    is dropped — it was never acknowledged, so losing it is correct."""
    out: List[Dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                break     # torn tail: everything after it is unreadable
    return out


def fsck_journal(path: str) -> Dict:
    """Classify journal damage without modifying the file.

    Returns ``{"ok", "kind", "records", "bad_line", "valid_bytes"}``:

    * ``kind="clean"`` — every line parses.
    * ``kind="torn-tail"`` — exactly one undecodable line and it is the
      LAST line: the classic crash-mid-append artifact. ``read_journal``
      already tolerates this (the torn record was never acknowledged).
    * ``kind="mid-file"`` — an undecodable line with valid JSON records
      AFTER it. That is not a torn write; it is corruption (bit rot,
      concurrent writer, manual editing) and acknowledged records after
      the damage would be silently dropped by a tolerant reader. The
      daemon refuses to start on such a journal; ``repair_journal``
      truncates to ``valid_bytes`` (the last valid prefix) after the
      operator confirms losing everything beyond it.

    ``valid_bytes`` is the byte offset of the end of the last good line
    BEFORE the first bad one — the truncation point a repair uses.
    """
    records: List[Dict] = []
    bad_line = None            # 1-based line number of first bad line
    valid_bytes = 0
    after_bad = False          # any valid JSON after the first bad line?
    offset = 0
    with open(path, "rb") as f:
        for lineno, raw in enumerate(f, 1):
            end = offset + len(raw)
            text = raw.decode("utf-8", errors="replace").strip()
            if not text:
                if bad_line is None:
                    valid_bytes = end
                offset = end
                continue
            try:
                rec = json.loads(text)
            except json.JSONDecodeError:
                if bad_line is None:
                    bad_line = lineno
                offset = end
                continue
            if bad_line is None:
                records.append(rec)
                valid_bytes = end
            else:
                after_bad = True
            offset = end
    if bad_line is None:
        kind = "clean"
    elif after_bad:
        kind = "mid-file"
    else:
        kind = "torn-tail"
    return {"ok": kind in ("clean", "torn-tail"), "kind": kind,
            "records": records, "bad_line": bad_line,
            "valid_bytes": valid_bytes}


def repair_journal(path: str) -> Dict:
    """Truncate ``path`` to its last valid prefix (``fsck_journal``'s
    ``valid_bytes``). Destructive — every record at or beyond the first
    undecodable line is lost; callers must get explicit operator
    confirmation first (``python -m repro.serve fsck --yes``)."""
    report = fsck_journal(path)
    if report["kind"] == "clean":
        return report
    with open(path, "r+b") as f:
        f.truncate(report["valid_bytes"])
    report["repaired"] = True
    return report


def submit_records(records: List[Dict]) -> List[Dict]:
    return [r for r in records if r.get("rec") == "submit"]


def unfinished_submits(records: List[Dict]) -> List[Dict]:
    """Journaled submissions with no terminal record — the restart
    re-injection set. A ``resubmitted`` record does NOT finish a seq; it
    only marks that a later run took responsibility for it again."""
    terminal = {r["seq"] for r in records if r.get("rec") == "done"}
    return [r for r in submit_records(records) if r["seq"] not in terminal]


def audit_zero_lost(records: List[Dict]) -> List[int]:
    """Seqs that were acknowledged but never reached a terminal state —
    the list a healthy drain leaves empty."""
    return sorted(r["seq"] for r in unfinished_submits(records))


def to_trace_arrivals(records: List[Dict],
                      until_ms: Optional[float] = None):
    """Per-task ``TraceArrival`` processes reproducing the journaled
    traffic: ``{task_name: TraceArrival([...])}``. Submission stamps are
    strictly monotonic per daemon run, so replay order equals the order
    the live engine processed the releases in.

    Bit-exactness caveat: the lazy-dispatch batching hold
    (``DarisScheduler._should_hold``) keys off the engine's next known
    wake-up. A trace replay knows every future arrival; the live daemon
    cannot (clients have not sent them yet), so a replay of a
    batching-enabled config may coalesce MORE than the live run did.
    Replay is bit-identical whenever no hold triggers — batching off, or
    traffic sparse enough that heads never grow."""
    from ..runtime.arrivals import TraceArrival
    times: Dict[str, List[float]] = {}
    for r in submit_records(records):
        if until_ms is not None and r["at_ms"] > until_ms:
            continue
        times.setdefault(r["task"], []).append(float(r["at_ms"]))
    return {name: TraceArrival(ts) for name, ts in times.items()}


def replay_plan(records: List[Dict]):
    """(submits, cancels) for a handle-accurate replay: submits in stamp
    order, cancels as ``(seq, at_ms)`` referencing them. Used when the
    replay must also reproduce cancellations (TraceArrival replays the
    load shape only)."""
    subs = submit_records(records)
    cancels = [(r["seq"], float(r["at_ms"]))
               for r in records if r.get("rec") == "cancel"]
    return subs, cancels
