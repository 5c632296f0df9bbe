# Copy of src/repro/serve/daemon.py; only this line differs (tests/test_torch_isolation.py checks it).
"""The ops daemon: one serving-mode DARIS engine behind a unix socket.

Architecture — single-owner engine, journaled acks, wall-paced clock:

* The **pump thread** (the thread that calls ``run()``) is the ONLY
  thread that touches the engine. Socket handler threads turn client
  requests into commands on a queue and wait for the pump's reply, so
  scheduler state needs no locks.
* Every accepted submission is **journaled before it is acknowledged**:
  an acked request survives any crash (resume re-injects it). Release
  stamps are strictly monotonic virtual times, so live processing order
  equals journal order equals replay order — the bit-exactness hook.
* The sim backend's **virtual clock is paced by the wall clock**
  (``time_scale`` virtual ms per wall ms): the pump's frontier only ever
  moves to "what wall time says should have happened by now", so an idle
  daemon's virtual clock pauses instead of slamming to the horizon.

Lifecycle: SIGTERM/SIGINT checkpoint scheduler state (atomic write) and
exit WITHOUT draining — journaled-but-unfinished requests are the
restart's responsibility. The ``drain`` verb is the graceful path: stop
accepting, finish everything in flight, journal the final summary.
"""
from __future__ import annotations

import itertools
import os
import queue
import signal
import socket
import threading
import time
from typing import Dict, Optional

from ..api import DarisServer
from .config import build_server, check_schedulability
from .journal import (Journal, TERMINAL_STATUSES, fsck_journal,
                      read_journal, unfinished_submits)

_POLL_S = 0.02          # pump period while idle
_RESULT_POLL_S = 0.005  # handler-thread wait granularity for `result`


class ServeDaemon:
    """Long-running serving front-end over one ``DarisServer``."""

    def __init__(self, cfg: Dict, *, socket_path: str, journal_path: str,
                 checkpoint_path: Optional[str] = None,
                 tick_ms: float = 0.125, time_scale: float = 1.0,
                 fsync: bool = False):
        self.cfg = cfg
        self.socket_path = str(socket_path)
        self.checkpoint_path = checkpoint_path
        self.tick_ms = float(tick_ms)
        self.time_scale = float(time_scale)
        # opt-in static schedulability gate, BEFORE any engine exists:
        # "enforce" refuses to start an HP-unschedulable config (raises
        # UnschedulableError), "warn" reports and proceeds
        self.schedcheck_report = check_schedulability(cfg)
        if self.schedcheck_report is not None:
            print(f"[daemon] schedcheck: HP "
                  f"{self.schedcheck_report.hp_verdict} "
                  f"(overall {self.schedcheck_report.verdict})")
        self.server: DarisServer = build_server(cfg)

        # ---- resume: journal first (what was promised), checkpoint
        # second (what was learned) — promises outrank learned state
        self._pending_resubmit = []
        base_t, base_seq = 0.0, 0
        if os.path.exists(journal_path) \
                and os.path.getsize(journal_path) > 0:
            fsck = fsck_journal(journal_path)
            if fsck["kind"] == "mid-file":
                # a torn TAIL is a normal crash artifact (tolerated);
                # valid records AFTER damage mean acknowledged work would
                # be silently dropped on resume — refuse, never guess
                raise RuntimeError(
                    f"journal {journal_path} is corrupt mid-file (first "
                    f"bad line {fsck['bad_line']}, valid records follow "
                    f"it): refusing to resume. Inspect and repair with "
                    f"`python -m repro.serve fsck --journal "
                    f"{journal_path}` (add --yes to truncate to the "
                    f"last valid prefix).")
            records = read_journal(journal_path)
            stamps = [r["at_ms"] for r in records if "at_ms" in r]
            seqs = [r["seq"] for r in records if "seq" in r]
            base_t = max(stamps) if stamps else 0.0
            base_seq = max(seqs) + 1 if seqs else 0
            self._pending_resubmit = unfinished_submits(records)
        if checkpoint_path and os.path.exists(checkpoint_path):
            self.server.load_state(checkpoint_path)

        self.journal = Journal(
            journal_path, fsync=fsync,
            chaos=getattr(self.server.core, "_chaos", None))
        self._degrade_seen = 0    # chaos transitions already journaled
        self._seq = itertools.count(base_seq)
        self._last_t = base_t          # latest stamped virtual instant
        self._virt0 = base_t           # virtual time at daemon start
        self._wall0 = time.monotonic()
        self._handles: Dict[int, object] = {}   # seq -> SubmitHandle
        self._open: set = set()        # seqs with no terminal journal rec
        self._cmd_q: "queue.Queue" = queue.Queue()
        self._conn_lock = threading.Lock()
        self._n_conns = 0              # handler threads mid-conversation
        self._draining = False
        self._stop = False
        self._term = False             # signal flag (checkpoint + exit)
        self._sock: Optional[socket.socket] = None
        self.final_metrics = None
        # DSAN race guard (analysis/races.py): installed by run() on the
        # pump thread when sanitizing — construction-time work above
        # (build_server/load_state) legally ran on the constructing
        # thread, which may differ
        self.race_guard = None

    # -------------------------------------------------------------- clock
    def _wall_virtual(self) -> float:
        """Virtual ms the wall clock has earned since start."""
        return (self._virt0
                + (time.monotonic() - self._wall0) * 1000.0
                * self.time_scale)

    def _stamp(self) -> float:
        """Strictly monotonic virtual stamp for the next release/cancel:
        wall-paced, but never a repeat — distinct stamps mean the replay
        heap can never reorder same-instant submissions."""
        self._last_t = max(self._wall_virtual(),
                           self._last_t + self.tick_ms)
        return self._last_t

    # ---------------------------------------------------------- lifecycle
    def run(self) -> None:
        """Serve until ``drain``/``shutdown``/SIGTERM. Blocks; call from
        the process main thread (signal handlers are installed there)."""
        if self.cfg.get("sanitize") or \
                os.environ.get("DARIS_SANITIZE", "") not in ("", "0"):
            # the caller of run() IS the pump thread: bind ownership here
            # so every scheduler-mutating server call off this thread
            # raises a tsan-style RaceViolation
            from ..analysis.races import ThreadAffinityGuard
            self.race_guard = ThreadAffinityGuard(self.server).install()
        self.server.begin_serving()
        self._resubmit_pending()
        try:
            signal.signal(signal.SIGTERM, self._on_signal)
            signal.signal(signal.SIGINT, self._on_signal)
        except ValueError:
            pass    # not the main thread (tests drive run() directly)
        self._open_socket()
        try:
            while not self._stop:
                try:
                    cmd = self._cmd_q.get(timeout=_POLL_S)
                except queue.Empty:
                    cmd = None
                if cmd is not None:
                    self._handle_cmd(*cmd)
                if self._stop:
                    break
                self.server.pump(max(self._wall_virtual(), self._last_t))
                self._harvest()
                if self._term:
                    self._checkpoint()
                    break
        finally:
            # let handler threads flush their replies (the drain/shutdown
            # ack races process exit otherwise — the client would see the
            # connection close with no reply)
            deadline = time.monotonic() + 2.0
            while self._n_conns > 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            self._close_socket()
            self.journal.close()

    def _on_signal(self, signum, frame) -> None:
        self._term = True

    def _resubmit_pending(self) -> None:
        """Re-inject journaled-but-unfinished submissions under their
        ORIGINAL seqs (the zero-lost contract: an acked seq keeps its
        identity across restarts)."""
        for rec in self._pending_resubmit:
            t = self._stamp()
            self.journal.append({"rec": "resubmitted", "seq": rec["seq"],
                                 "at_ms": t})
            try:
                h = self.server.request(rec["task"], at_ms=t,
                                        tenant=rec.get("tenant"))
            except KeyError:
                # config no longer serves this task: terminally reject so
                # the seq doesn't haunt every future restart
                self.journal.append({"rec": "done", "seq": rec["seq"],
                                     "status": "rejected",
                                     "response_ms": None})
                continue
            self._handles[rec["seq"]] = h
            self._open.add(rec["seq"])
        self._pending_resubmit = []

    def _checkpoint(self) -> None:
        if not self.checkpoint_path:
            return
        try:
            path = self.server.save_state(self.checkpoint_path)
            self.journal.append({"rec": "checkpoint", "path": path,
                                 "at_ms": self._last_t})
        except NotImplementedError:
            pass    # cluster engines: journal replay alone covers restart

    # ------------------------------------------------------------ commands
    def _handle_cmd(self, op: str, payload: Dict, reply_q) -> None:
        try:
            reply = getattr(self, f"_cmd_{op}")(payload)
        except Exception as e:   # noqa: BLE001 — daemon must survive
            reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        reply_q.put(reply)

    def _cmd_submit(self, payload: Dict) -> Dict:
        if self._draining or self._term:
            return {"ok": False, "error": "draining: not accepting work"}
        name = payload["task"]
        self.server.task_named(name)     # KeyError before any journaling
        seq = next(self._seq)
        t = self._stamp()
        # journal BEFORE ack: once the client sees this seq, a crash
        # cannot lose the request
        self.journal.append({"rec": "submit", "seq": seq, "task": name,
                             "tenant": payload.get("tenant"),
                             "prio": self.server.task_named(name).priority,
                             "at_ms": t})
        h = self.server.request(name, at_ms=t,
                                tenant=payload.get("tenant"))
        self._handles[seq] = h
        self._open.add(seq)
        # release synchronously: the reply carries the admission verdict
        self.server.pump(self._last_t)
        return {"ok": True, "seq": seq, "at_ms": t, "status": h.status}

    def _cmd_cancel(self, payload: Dict) -> Dict:
        seq = payload["seq"]
        h = self._handles.get(seq)
        if h is None:
            return {"ok": False, "error": f"unknown seq {seq}"}
        t = self._stamp()
        self.journal.append({"rec": "cancel", "seq": seq, "at_ms": t})
        self.server.cancel(h, at_ms=t)
        self.server.pump(self._last_t)   # resolve the outcome now
        self._harvest()
        return {"ok": True, "seq": seq, "status": h.status}

    def _cmd_stats(self, payload: Dict) -> Dict:
        snap = self.server.snapshot()
        return {"ok": True, "snapshot": snap,
                "submitted": len(self._handles),
                "open": len(self._open),
                "virtual_now_ms": self._last_t,
                "draining": self._draining}

    def _cmd_drain(self, payload: Dict) -> Dict:
        """Graceful end: refuse new work, finish everything accepted,
        journal the final summary."""
        self._draining = True
        m = self.server.end_serving(until_idle=True)
        self._harvest()
        self.final_metrics = m
        summary = m.summary()
        self.journal.append({"rec": "final", "summary": summary})
        self._stop = True
        return {"ok": True, "summary": summary,
                "lost": sorted(self._open)}

    def _cmd_shutdown(self, payload: Dict) -> Dict:
        """Fast stop: checkpoint, keep unfinished work journaled for the
        next start (the crash-with-manners path)."""
        self._checkpoint()
        self._stop = True
        return {"ok": True, "open": sorted(self._open)}

    # ------------------------------------------------------------- harvest
    def _harvest(self) -> None:
        """Journal terminal outcomes for every open submission, plus any
        new chaos degradation-mode transitions (ops forensics: the
        journal records WHEN the engine shed load and why)."""
        for seq in list(self._open):
            h = self._handles[seq]
            if h.status in TERMINAL_STATUSES:
                self.journal.append({"rec": "done", "seq": seq,
                                     "status": h.status,
                                     "response_ms": h.response_ms})
                self._open.discard(seq)
        ch = getattr(self.server.core, "_chaos", None)
        if ch is not None:
            while self._degrade_seen < len(ch.transitions):
                at_ms, frm, to = ch.transitions[self._degrade_seen]
                self.journal.append({"rec": "degrade", "from": frm,
                                     "to": to, "at_ms": at_ms})
                self._degrade_seen += 1

    # -------------------------------------------------------------- socket
    def _open_socket(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _close_socket(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)

    def _accept_loop(self) -> None:
        sock = self._sock     # _close_socket may null the attribute
        while not self._stop:
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return    # socket closed during shutdown
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        import json
        with self._conn_lock:
            self._n_conns += 1
        try:
            f = conn.makefile("rwb")
            line = f.readline()
            if not line:
                return
            try:
                req = json.loads(line.decode("utf-8"))
                reply = self._dispatch(req)
            except Exception as e:   # noqa: BLE001
                reply = {"ok": False,
                         "error": f"{type(e).__name__}: {e}"}
            f.write((json.dumps(reply) + "\n").encode("utf-8"))
            f.flush()
        finally:
            conn.close()
            with self._conn_lock:
                self._n_conns -= 1

    def _dispatch(self, req: Dict) -> Dict:
        """Route one client request. ``status``/``result``/``ping`` are
        read-only — handler threads answer them directly from handle
        state (only the pump mutates it). Everything else goes through
        the command queue to the pump thread."""
        op = req.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "status":
            h = self._handles.get(req["seq"])
            if h is None:
                return {"ok": False, "error": f"unknown seq {req['seq']}"}
            return {"ok": True, "seq": req["seq"], **h.result()}
        if op == "result":
            return self._wait_result(req)
        if op in ("submit", "cancel", "stats", "drain", "shutdown"):
            rq: "queue.Queue" = queue.Queue(maxsize=1)
            self._cmd_q.put((op, req, rq))
            try:
                return rq.get(timeout=float(req.get("timeout_s", 60.0)))
            except queue.Empty:
                return {"ok": False, "error": "daemon busy: no reply"}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _wait_result(self, req: Dict) -> Dict:
        h = self._handles.get(req["seq"])
        if h is None:
            return {"ok": False, "error": f"unknown seq {req['seq']}"}
        deadline = time.monotonic() + float(req.get("timeout_s", 30.0))
        while not h.done and time.monotonic() < deadline:
            time.sleep(_RESULT_POLL_S)
        out = {"ok": h.done, "seq": req["seq"], **h.result()}
        if not h.done:
            out["error"] = "timeout: submission not terminal"
        return out
