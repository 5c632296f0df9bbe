# Copy of src/repro/serve/client.py; only this line differs (tests/test_torch_isolation.py checks it).
"""Thin client for the serving daemon: line-JSON over a unix socket.

One connection per call — the protocol is a single request line and a
single reply line, so there is no connection state to manage and a
crashed daemon can never wedge a client mid-stream.

    c = DarisClient("/tmp/daris.sock")
    seq = c.submit("resnet18-hp0", tenant="teamA")["seq"]
    c.status(seq)["status"]            # queued / running / ...
    c.result(seq, timeout_s=10.0)      # blocks until terminal
    c.cancel(seq)
    c.stats()["snapshot"]["queue_depth"]
    c.drain()                          # graceful: finish all, summarize
"""
from __future__ import annotations

import json
import socket
import time
from typing import Dict, Optional


class DaemonError(RuntimeError):
    """The daemon replied ``ok: false`` (the reply is attached)."""

    def __init__(self, reply: Dict):
        super().__init__(reply.get("error", "daemon error"))
        self.reply = reply


class DarisClient:
    """``connect_retries`` transient-failure retries on connect: a daemon
    mid-restart refuses connections for a moment, and a loaded one can
    time out the accept — both retryable. Backoff doubles from
    ``retry_backoff_s`` and is capped at ``retry_backoff_cap_s``; only
    the CONNECT is retried (a request that reached the daemon may have
    been acted on, so re-sending it is not idempotent)."""

    def __init__(self, socket_path: str, timeout_s: float = 60.0,
                 connect_retries: int = 3, retry_backoff_s: float = 0.05,
                 retry_backoff_cap_s: float = 1.0):
        self.socket_path = str(socket_path)
        self.timeout_s = timeout_s
        self.connect_retries = int(connect_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)

    # ------------------------------------------------------------- plumbing
    def _connect(self) -> socket.socket:
        delay = self.retry_backoff_s
        for attempt in range(self.connect_retries + 1):
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self.timeout_s)
            try:
                s.connect(self.socket_path)
                return s
            except (ConnectionRefusedError, socket.timeout):
                s.close()
                if attempt >= self.connect_retries:
                    raise
                time.sleep(delay)
                delay = min(delay * 2.0, self.retry_backoff_cap_s)
            except BaseException:
                s.close()
                raise
        raise ConnectionRefusedError(self.socket_path)  # unreachable

    def call(self, req: Dict, check: bool = True) -> Dict:
        s = self._connect()
        try:
            f = s.makefile("rwb")
            f.write((json.dumps(req) + "\n").encode("utf-8"))
            f.flush()
            line = f.readline()
        finally:
            s.close()
        if not line:
            raise DaemonError({"error": "connection closed without reply"})
        reply = json.loads(line.decode("utf-8"))
        if check and not reply.get("ok"):
            raise DaemonError(reply)
        return reply

    def wait_up(self, timeout_s: float = 10.0) -> None:
        """Block until the daemon answers ``ping`` (startup barrier)."""
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                self.call({"op": "ping"})
                return
            except (OSError, DaemonError):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"daemon at {self.socket_path} not up after "
                        f"{timeout_s}s")
                time.sleep(0.05)

    # ----------------------------------------------------------------- verbs
    def ping(self) -> Dict:
        return self.call({"op": "ping"})

    def submit(self, task: str, tenant: Optional[str] = None) -> Dict:
        return self.call({"op": "submit", "task": task, "tenant": tenant})

    def status(self, seq: int) -> Dict:
        return self.call({"op": "status", "seq": seq})

    def result(self, seq: int, timeout_s: float = 30.0) -> Dict:
        return self.call({"op": "result", "seq": seq,
                          "timeout_s": timeout_s})

    def cancel(self, seq: int) -> Dict:
        return self.call({"op": "cancel", "seq": seq})

    def stats(self) -> Dict:
        return self.call({"op": "stats"})

    def drain(self, timeout_s: float = 300.0) -> Dict:
        return self.call({"op": "drain", "timeout_s": timeout_s})

    def shutdown(self, timeout_s: float = 60.0) -> Dict:
        return self.call({"op": "shutdown", "timeout_s": timeout_s})
