"""CLI of the port's serving front-end: ``python -m repro_torch.serve``.

The reference's CLI (src/repro/serve/__main__.py) over the port's daemon,
with the same verbs, flags, exit codes and printed JSON; its journals and
checkpoints are the JAX package's formats.

    # run the ops daemon (blocks; SIGTERM checkpoints and exits)
    python -m repro_torch.serve daemon --config serve.json \\
        --socket /tmp/daris.sock --journal /tmp/daris.jsonl \\
        --checkpoint /tmp/daris.ckpt

    # client verbs against a running daemon
    python -m repro_torch.serve submit --socket /tmp/daris.sock \\
        --task resnet18-hp0 --tenant teamA
    python -m repro_torch.serve status --socket /tmp/daris.sock --seq 3
    python -m repro_torch.serve cancel --socket /tmp/daris.sock --seq 3
    python -m repro_torch.serve stats  --socket /tmp/daris.sock
    python -m repro_torch.serve drain  --socket /tmp/daris.sock

    # offline: deterministic journal replay / durability audit / repair
    python -m repro_torch.serve replay --config serve.json \\
        --journal /tmp/daris.jsonl
    python -m repro_torch.serve audit  --journal /tmp/daris.jsonl
    python -m repro_torch.serve fsck   --journal /tmp/daris.jsonl [--yes]
"""
from __future__ import annotations

import argparse
import json
import sys

from .client import DarisClient
from .config import build_server, load_config
from .daemon import ServeDaemon
from .journal import (audit_zero_lost, fsck_journal, read_journal,
                      repair_journal, to_trace_arrivals)


def _cmd_daemon(a) -> int:
    d = ServeDaemon(load_config(a.config), socket_path=a.socket,
                    journal_path=a.journal, checkpoint_path=a.checkpoint,
                    time_scale=a.time_scale, fsync=a.fsync)
    print(f"daris daemon: socket={a.socket} journal={a.journal}",
          flush=True)
    d.run()
    return 0


def _client_verb(a) -> int:
    c = DarisClient(a.socket)
    if a.verb == "submit":
        out = c.submit(a.task, tenant=a.tenant)
    elif a.verb == "status":
        out = c.status(a.seq)
    elif a.verb == "result":
        out = c.result(a.seq, timeout_s=a.timeout_s)
    elif a.verb == "cancel":
        out = c.cancel(a.seq)
    elif a.verb == "stats":
        out = c.stats()
    elif a.verb == "drain":
        out = c.drain()
    else:
        out = c.shutdown()
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def _cmd_replay(a) -> int:
    """Deterministic replay: journaled traffic becomes TraceArrival input
    to a freshly built engine (same config, same seed). Recorded outages
    replay as plain load — chaos scenarios become regression scenarios."""
    records = read_journal(a.journal)
    arrivals = to_trace_arrivals(records, until_ms=a.until_ms)
    server = build_server(load_config(a.config), arrivals=arrivals)
    m = server.drain()
    print(json.dumps(m.summary(), indent=2, sort_keys=True))
    return 0


def _cmd_audit(a) -> int:
    lost = audit_zero_lost(read_journal(a.journal))
    if lost:
        print(f"LOST: {len(lost)} acknowledged submission(s) never "
              f"reached a terminal state: {lost}")
        return 1
    print("ok: every acknowledged submission reached a terminal state")
    return 0


def _cmd_fsck(a) -> int:
    """Classify journal damage; with ``--yes``, truncate mid-file
    corruption to the last valid prefix (destructive, hence the explicit
    confirmation — everything past the first bad line is lost)."""
    report = fsck_journal(a.journal)
    n = len(report["records"])
    if report["kind"] == "clean":
        print(f"ok: journal is clean ({n} records)")
        return 0
    if report["kind"] == "torn-tail":
        print(f"ok: torn tail at line {report['bad_line']} ({n} valid "
              f"records before it) — a normal crash artifact; readers "
              f"drop it, no repair needed")
        return 0
    print(f"CORRUPT: undecodable line {report['bad_line']} with valid "
          f"records after it; last valid prefix is "
          f"{report['valid_bytes']} bytes ({n} records)")
    if not a.yes:
        print("re-run with --yes to truncate to the last valid prefix "
              "(records at and beyond the damage are LOST)")
        return 1
    repair_journal(a.journal)
    print(f"repaired: truncated to {report['valid_bytes']} bytes "
          f"({n} records)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="repro_torch.serve",
                                description=__doc__)
    sub = p.add_subparsers(dest="verb", required=True)

    d = sub.add_parser("daemon", help="run the ops daemon (blocks)")
    d.add_argument("--config", required=True)
    d.add_argument("--socket", required=True)
    d.add_argument("--journal", required=True)
    d.add_argument("--checkpoint", default=None)
    d.add_argument("--time-scale", type=float, default=1.0,
                   help="virtual ms per wall ms (sim pacing)")
    d.add_argument("--fsync", action="store_true",
                   help="fsync the journal on every record")

    for verb in ("submit", "status", "result", "cancel", "stats",
                 "drain", "shutdown"):
        c = sub.add_parser(verb)
        c.add_argument("--socket", required=True)
        if verb == "submit":
            c.add_argument("--task", required=True)
            c.add_argument("--tenant", default=None)
        if verb in ("status", "result", "cancel"):
            c.add_argument("--seq", type=int, required=True)
        if verb == "result":
            c.add_argument("--timeout-s", type=float, default=30.0)

    r = sub.add_parser("replay", help="deterministic journal replay")
    r.add_argument("--config", required=True)
    r.add_argument("--journal", required=True)
    r.add_argument("--until-ms", type=float, default=None)

    au = sub.add_parser("audit", help="zero-lost durability audit")
    au.add_argument("--journal", required=True)

    fs = sub.add_parser("fsck", help="journal damage triage / repair")
    fs.add_argument("--journal", required=True)
    fs.add_argument("--yes", action="store_true",
                    help="truncate mid-file corruption to the last "
                         "valid prefix (destructive)")

    a = p.parse_args(argv)
    if a.verb == "daemon":
        return _cmd_daemon(a)
    if a.verb == "replay":
        return _cmd_replay(a)
    if a.verb == "audit":
        return _cmd_audit(a)
    if a.verb == "fsck":
        return _cmd_fsck(a)
    return _client_verb(a)


if __name__ == "__main__":
    sys.exit(main())
