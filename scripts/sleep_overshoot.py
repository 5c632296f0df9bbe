#!/usr/bin/env python3
"""How late a short ``time.sleep`` ends on this host, and what the host
lets a process read of its CPU (the inputs of ``WAKE_MARGIN_MS`` in
``src/repro_torch/runtime/backend.py``).

    python3 scripts/sleep_overshoot.py [--n 2000] [--primitives]

For each asked sleep of 0.2, 0.5, 1 and 2 ms, ``--n`` sleeps in turn: the
overshoot (the wall time past the asked end, on ``time.perf_counter``)
as its median, p90, p99, p99.9 and max in ms, and the calling thread's
voluntary and involuntary switches and CPU seconds over them
(``getrusage(RUSAGE_THREAD)``). Then the cgroup CPU files
(``/proc/self/cgroup``; v2 ``cpu.max`` and ``cpu.stat``, v1
``cpu.cfs_quota_us``, ``cpu.cfs_period_us`` and ``cpu.stat``), whether
``/proc/self/task/<tid>/status`` counts switches, ``time.thread_time``'s
step, and the card's name and power limit as ``nvidia-smi`` prints them.
``--primitives`` adds ``select`` and ``threading.Event.wait`` beside
``time.sleep`` at more lengths, and on a card the wall from a kernel's
launch to its end seen by a blocking event's synchronize against a spin
on ``query``. One JSON line each; stdlib only but the card's part
(torch).
"""
import argparse
import json
import os
import resource
import subprocess
import sys
import threading
import time

ASKED_MS = (0.2, 0.5, 1.0, 2.0)
# ``--primitives``: each way to block the thread for a while, at more sizes
WAITS_MS = (0.1, 0.2, 0.3, 0.5, 0.7, 0.9, 1.0, 1.2, 1.5, 2.0, 3.0)


def usage():
    ru = resource.getrusage(resource.RUSAGE_THREAD)
    return ru.ru_utime + ru.ru_stime, ru.ru_nvcsw, ru.ru_nivcsw


def pct(xs, q):
    return xs[min(len(xs) - 1, int(q / 100.0 * len(xs)))]


def primitives() -> dict:
    """Ways to block the calling thread for ``s`` seconds."""
    import select
    event = threading.Event()
    return {"time.sleep": time.sleep,
            "select": lambda s: select.select([], [], [], s),
            "event.wait": event.wait}


def overshoot(asked_ms: float, n: int, wait=time.sleep) -> dict:
    late = []
    u0 = usage()
    for _ in range(n):
        a = time.perf_counter()
        wait(asked_ms / 1000.0)
        late.append((time.perf_counter() - a) * 1000.0 - asked_ms)
    u1 = usage()
    late.sort()
    return {"asked_ms": asked_ms, "n": n,
            **{f"p{q}": pct(late, q) for q in (50, 90, 99, 99.9)},
            "max": late[-1], "min": late[0],
            "cpu_s": u1[0] - u0[0], "voluntary": u1[1] - u0[1],
            "involuntary": u1[2] - u0[2]}


def read(path: str):
    try:
        with open(path) as f:
            return f.read()
    except OSError as e:
        return f"unreadable: {e!r}"


def cgroup() -> dict:
    text = read("/proc/self/cgroup")
    out = {"proc_self_cgroup": text.splitlines()}
    seen = {}
    for line in text.splitlines():
        if line.count(":") < 2:
            continue
        _, ctl, path = line.split(":", 2)
        if ctl == "":
            dirs = ["/sys/fs/cgroup" + path.rstrip("/"), "/sys/fs/cgroup"]
            files = ("cpu.max", "cpu.stat")
        elif "cpu" in ctl.split(","):
            dirs = [f"/sys/fs/cgroup/{ctl}" + path.rstrip("/"),
                    f"/sys/fs/cgroup/{ctl}", "/sys/fs/cgroup/cpu",
                    "/sys/fs/cgroup/cpu,cpuacct"]
            files = ("cpu.cfs_quota_us", "cpu.cfs_period_us", "cpu.stat")
        else:
            continue
        for d in dirs:
            for f in files:
                seen[f"{d}/{f}"] = read(f"{d}/{f}").strip()
    out["files"] = seen
    return out


def thread_clock_step() -> float:
    """The smallest nonzero step of ``time.thread_time`` seen while
    spinning (s)."""
    t0 = time.thread_time()
    end = time.perf_counter() + 0.2
    step = None
    while time.perf_counter() < end:
        t = time.thread_time()
        if t != t0:
            step = t - t0 if step is None else min(step, t - t0)
            t0 = t
    return step


def cuda_sync(n: int) -> list:
    """The card's end seen by a blocking synchronize of an event made with
    ``blocking=True`` (the thread blocks until the event) against a spin on
    ``query``: the host's wall ms from a ``torch.cuda._sleep`` kernel's
    launch to the return, and the thread's CPU seconds, at three kernel
    lengths (None without a card)."""
    try:
        import torch
    except ImportError:
        return None
    if not torch.cuda.is_available():
        return None
    rows = []
    cycles_ms = 1.98e6          # the H100's boost clock: a kernel's length
    for ms in (0.5, 1.0, 2.0):
        for how in ("spin", "blocking"):
            ev = torch.cuda.Event(blocking=how == "blocking")
            walls = []
            u0 = usage()
            for _ in range(n):
                a = time.perf_counter()
                torch.cuda._sleep(int(ms * cycles_ms))
                ev.record()
                if how == "spin":
                    while not ev.query():
                        pass
                else:
                    ev.synchronize()
                walls.append((time.perf_counter() - a) * 1000.0)
            u1 = usage()
            walls.sort()
            rows.append({"kernel_ms": ms, "wait": how, "n": n,
                         **{f"p{q}": pct(walls, q) for q in (50, 90, 99)},
                         "cpu_s": u1[0] - u0[0]})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--primitives", action="store_true",
                    help="also each way to block at WAITS_MS (n/4 each) "
                         "and a blocking CUDA event against a spin")
    args = ap.parse_args()
    for ms in ASKED_MS:
        print(json.dumps({"sleep_overshoot": overshoot(ms, args.n)}))
    if args.primitives:
        for name, wait in primitives().items():
            for ms in WAITS_MS:
                print(json.dumps({"wait_overshoot": {
                    "wait": name, **overshoot(ms, args.n // 4, wait)}}))
        print(json.dumps({"cuda_event_wait": cuda_sync(args.n // 4)}))
    print(json.dumps({"cgroup": cgroup()}))
    tid = threading.get_native_id()
    status = read(f"/proc/self/task/{tid}/status")
    print(json.dumps({"thread": {
        "rusage_thread": usage(),
        "status_switches": [ln for ln in status.splitlines()
                            if "ctxt_switches" in ln],
        "thread_time_step_s": thread_clock_step(),
        "cpus": len(os.sched_getaffinity(0))}}))
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = repr(e)
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
