"""Serving front-end smoke on the PyTorch/CUDA port: daemon round-trip,
SIGTERM crash-restart durability, and deterministic journal replay — out
of process. Twin of examples/serve_daemon.py over ``repro_torch.serve``.

Phase 1 starts the ops daemon (``python -m repro_torch.serve daemon``)
with virtual time nearly frozen, acknowledges a burst of submissions
(printing each one's round trip), cancels one, then kills the daemon with
SIGTERM mid-traffic: the checkpoint is written but nothing has finished.
Phase 2 restarts the daemon on the same journal + checkpoint; every
acknowledged seq must reach a terminal state under its ORIGINAL identity
(the zero-lost contract), after which the journal audit and an offline
replay both pass. The daemon serves the calibrated simulator, so this runs
with or without a GPU.

    PYTHONPATH=src python examples/serve_daemon_torch.py [--dir WORKDIR]

Run it from the repo root. Exits non-zero on any violated contract; no
daemon outlives it.
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, "src")

from repro_torch.serve import DarisClient, audit_zero_lost, read_journal

CONFIG = {
    "tasks": [
        {"dnn": "resnet18", "priority": "HP", "jps": 30.0},
        {"dnn": "unet", "priority": "LP", "jps": 10.0},
    ],
    "contexts": 2, "streams": 1, "oversubscribe": 2.0,
    "seed": 0, "noise": 0.0,
}
ENV = dict(os.environ, PYTHONPATH="src")


def spawn_daemon(cfg_path, sock, journal, ckpt, time_scale, procs):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve", "daemon",
         "--config", cfg_path, "--socket", sock, "--journal", journal,
         "--checkpoint", ckpt, "--time-scale", str(time_scale)],
        env=ENV)
    procs.append(proc)
    c = DarisClient(sock)
    c.wait_up(timeout_s=30.0)
    return proc, c


def run(work, procs):
    cfg_path = os.path.join(work, "serve.json")
    sock = os.path.join(work, "daris.sock")
    journal = os.path.join(work, "journal.jsonl")
    ckpt = os.path.join(work, "ckpt.msgpack")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(CONFIG, f)

    # ---- phase 1: acknowledge traffic, then die by SIGTERM ----------
    print("phase 1: daemon up (virtual time ~frozen), submitting...")
    proc, c = spawn_daemon(cfg_path, sock, journal, ckpt, 1e-7, procs)
    seqs, round_trip_us = [], []
    for i in range(6):
        t0 = time.perf_counter()
        r = c.submit("resnet18" if i % 2 else "unet",
                     tenant="teamA" if i % 3 else "teamB")
        round_trip_us.append((time.perf_counter() - t0) * 1e6)
        print(f"  acked seq={r['seq']} status={r['status']}")
        seqs.append(r["seq"])
    print("  submit round trip us:",
          json.dumps([round(u, 1) for u in round_trip_us]))
    cancelled_seq = seqs.pop()
    print(f"  cancel seq={cancelled_seq} ->",
          c.cancel(cancelled_seq)["status"])
    print(f"  SIGTERM pid={proc.pid} with {len(seqs)} jobs unfinished")
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 0, "daemon did not exit cleanly"

    recs = read_journal(journal)
    owed = audit_zero_lost(recs)
    assert owed == sorted(seqs), \
        f"owed-after-crash mismatch: {owed} != {sorted(seqs)}"
    assert any(r["rec"] == "checkpoint" for r in recs), "no checkpoint"
    print(f"  journal owes {owed} across the restart — as it must\n")

    # ---- phase 2: restart, finish everything, drain -----------------
    print("phase 2: restart on same journal+checkpoint, fast clock...")
    proc, c = spawn_daemon(cfg_path, sock, journal, ckpt, 500.0, procs)
    for seq in seqs:
        r = c.result(seq, timeout_s=60.0)
        print(f"  seq={seq} -> {r['status']} "
              f"(resp={r['response_ms']:.2f}ms virtual)")
        assert r["status"] in ("completed", "missed"), r
    summary = c.drain()["summary"]
    assert proc.wait(timeout=30) == 0
    print(f"  drained: jps_hp={summary['jps_hp']:.1f} "
          f"dmr_hp={summary['dmr_hp']:.4f}\n")

    # ---- audits: zero lost, deterministic replay --------------------
    for verb in (["audit", "--journal", journal],
                 ["replay", "--config", cfg_path, "--journal", journal]):
        rc = subprocess.call(
            [sys.executable, "-m", "repro_torch.serve", *verb], env=ENV,
            timeout=300)
        assert rc == 0, f"{verb[0]} failed"
    print(f"zero acknowledged-but-lost jobs; journal: {journal}")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None,
                    help="workdir (journal lands here); default: tmpdir")
    args = ap.parse_args()
    work = args.dir or tempfile.mkdtemp(prefix="daris-serve-")
    os.makedirs(work, exist_ok=True)
    procs = []
    try:
        return run(work, procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


if __name__ == "__main__":
    sys.exit(main())
