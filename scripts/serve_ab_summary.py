#!/usr/bin/env python3
"""Sum up a served A/B (``scripts/serve_ab.sh``) by model and side.

    python3 scripts/serve_ab_summary.py OUT_DIR

Reads each turn's ``serving`` lines (one a run) and its ``serve_repeats``
line, and prints one JSON line a model and side: the runs; HP mean over
all runs (weighted by completions) and each run's p99 and max; a HP job's
parts (ms a job: prep, stream wait, device, notice, gap); each of these
as the least, the median and the most over the runs; the HP stages' enqueue steps by stage (the median
over the runs of each run's median, ms; over all stages, and over the
HP stages alone); HP misses, LP completions, runs and HP
jobs over SchedCheck's bound with those jobs' largest part and step; and
the gates (driver allocations and CUDA events after the start, graph
pools, the parts' largest error); on the tree also the HP stages' calls
made ready ahead (the share used, and those discarded by reason). ``host``:
what took the host away, as least / median / most over the runs of the
engine thread's CPU seconds and voluntary and involuntary switches (None
where the host does not count them), the process's CPU seconds, the
engine thread's polls and end-event queries (None in a tree without
them), its stalls and poll stalls a run, and summed over the runs the
cgroup's periods, throttled periods and throttled µs (None where not
readable) and the involuntary switches and throttled periods in the
stalls' windows; ``turns``: each turn's runs' poll stalls,
engine CPU seconds and HP jobs over the bound, to show on which side a
stalling turn falls.

For a drill A/B (``serve_ab.sh --drill``) it prints one line a model,
side and drill from the ``drill`` lines instead: HP completed and missed
a run, HP misses and the largest HP response after each event, the ready
calls' share used and those discarded by reason."""
import collections
import json
import statistics
import sys
from pathlib import Path

PARTS = ("prep", "stream_wait", "device", "notice", "gap")


def lines(path: Path, key: str) -> list:
    out = []
    for line in path.read_text().splitlines():
        if line.startswith("{") and f'"{key}"' in line[:40]:
            out.append(json.loads(line)[key])
    return out


def span(xs: list):
    """[least, median, most] of the runs' values."""
    xs = [x for x in xs if x is not None]
    return [min(xs), statistics.median(xs), max(xs)] if xs else None


def median_of(rows: list):
    """Per stage and step, the median over runs of each run's median."""
    acc = collections.defaultdict(list)
    for row in rows:
        for stage, steps in (row or {}).items():
            for step, ms in steps.items():
                acc[stage, step].append(ms)
    out = collections.defaultdict(dict)
    for (stage, step), v in sorted(acc.items()):
        out[stage][step] = statistics.median(v)
    return dict(out)


def total(xs: list):
    """The sum of ``xs``, None where any is None."""
    return None if any(x is None for x in xs) else sum(xs)


def host_summary(runs: list) -> dict:
    host = [r.get("host") or {} for r in runs]
    eng = [h.get("engine_thread") or {} for h in host]
    polls = [h.get("poll_counts") or {} for h in host]
    cg = [h.get("cgroup") for h in host]
    by_step = [(r.get("engine_stalls") or {}).get("by_step") or {}
               for r in runs]

    def stall_sum(i):
        return total([row[i] for steps in by_step for row in steps.values()
                      if len(row) > i])
    return {
        **{k: span([e.get(k) for e in eng])
           for k in ("cpu_s", "voluntary_switches", "involuntary_switches")},
        "process_cpu_s": span([h.get("cpu_user_s", 0) + h.get("cpu_sys_s", 0)
                               for h in host]),
        **{k: span([c.get(k) for c in polls]) for k in ("polls", "queries")},
        "stalls": span([sum(row[0] for row in steps.values())
                        for steps in by_step]),
        "poll_stalls": span([steps.get("poll", [0])[0]
                             for steps in by_step]),
        "stall_involuntary": stall_sum(4),
        "stall_nr_throttled": stall_sum(5),
        **{k: total([c and c[k] for c in cg])
           for k in ("nr_periods", "nr_throttled", "throttled_usec")},
        "cgroup_limit": sorted({json.dumps(c and c["limit"]) for c in cg}),
        "cgroup_reason": sorted({h.get("cgroup_reason") for h in host}
                                - {None}),
    }


def side_summary(files: list) -> dict:
    runs, repeats, turns = [], [], []
    for f in files:
        turn, summed = lines(f, "serving"), lines(f, "serve_repeats")
        runs += turn
        repeats += summed
        turns.append({
            "turn": f.stem,
            "poll_stalls": [((r.get("engine_stalls") or {}).get("by_step")
                             or {}).get("poll", [0])[0] for r in turn],
            "engine_cpu_s": [((r.get("host") or {}).get("engine_thread")
                              or {}).get("cpu_s") for r in turn],
            "hp_jobs_over_bound": sum(r["hp_jobs_over_bound"]
                                      for r in summed)})
    n = sum(r["hp_completed"] for r in repeats)
    per_job = {p: [] for p in PARTS}
    for run in runs:
        parts = run.get("hp_response_parts") or {}
        jobs = parts.get("jobs")
        for p in PARTS:
            total = (parts.get("total_ms") or {}).get(p)
            if jobs and total is not None:
                per_job[p].append(total / jobs)
    enq = [run.get("enqueue") or {} for run in runs]
    hp_steps = [e.get("hp_step_median_by_stage") for e in enq]
    ready = [run.get("ready") for run in runs]
    return {
        "runs": len(runs),
        "hp_mean_ms": (sum(r["hp_mean_ms"] * r["hp_completed"]
                           for r in repeats) / n if n else None),
        "hp_p99_ms": span([r["p99_response_ms"]["hp"] for r in runs]),
        "hp_max_ms": span([max(r["hp_response_ms"], default=None)
                           for r in runs]),
        "per_job_ms": {p: span(v) for p, v in per_job.items()},
        "hp_engine_ms": span([(e.get("engine_median_by") or {}).get("hp")
                              for e in enq]),
        "steps_by_stage": median_of([e.get("step_median_by_stage")
                                     for e in enq]),
        "hp_steps_by_stage": (median_of(hp_steps) if any(hp_steps)
                              else None),
        "hp_missed": sum(r["missed"]["hp"] for r in runs),
        "lp_completed": [r["completed"]["lp"] for r in runs],
        "runs_over_bound": sum(r["runs_over_bound"] for r in repeats),
        "hp_jobs_over_bound": sum(r["hp_jobs_over_bound"] for r in repeats),
        "hp_completed": n,
        "over_bound_by": dict(sum((collections.Counter(r["over_bound_by"])
                                   for r in repeats), collections.Counter())),
        "over_bound": [row for r in repeats for row in r["over_bound"]],
        "driver_allocs": sum(r["allocator_in_run"]["num_device_alloc"]
                             + r["allocator_in_run"]["num_alloc_retries"]
                             for r in runs),
        "events_in_run": sum((r["stage_graphs"] or {}).get(
            "events_in_run", 0) for r in runs),
        "pools": sorted({(r["stage_graphs"] or {}).get("pools")
                         for r in runs}),
        "sum_err_ms": max(((r.get("hp_response_parts") or {}).get(
            "sum_err_ms", 0.0) for r in runs), default=None),
        "ready_used_share": (span([r["used_share"] for r in ready])
                             if all(ready) and ready else None),
        "ready_discarded": (dict(sum((collections.Counter({
            k: sum(v.values()) for k, v in r["discarded"].items()})
            for r in ready), collections.Counter()))
            if all(ready) and ready else None),
        "host": host_summary(runs),
        "turns": turns,
    }


def drill_summary(files: list) -> dict:
    by = collections.defaultdict(list)
    for f in files:
        for run in lines(f, "drill"):
            by[run["drill"]].append(run)
    return {drill: {
        "runs": len(runs),
        "completed_hp": [r["completed_hp"] for r in runs],
        "missed_hp": sum(r["missed_hp"] for r in runs),
        "hp_missed_after": [[e.get("hp_missed_after") for e in r["events"]]
                            for r in runs],
        "hp_max_after_ms": [[e.get("hp_max_after_ms") for e in r["events"]]
                            for r in runs],
        "ready_used_share": span([r.get("ready_used_share") for r in runs]),
        "ready_discarded": dict(sum((collections.Counter(
            r.get("ready_discarded") or {}) for r in runs),
            collections.Counter())),
    } for drill, runs in sorted(by.items())}


def main() -> int:
    out = Path(sys.argv[1])
    by = collections.defaultdict(list)
    for f in sorted(out.glob("*.log")):
        arch, _, side = f.stem.rsplit("_", 2)
        by[arch, side].append(f)
    for (arch, side), files in sorted(by.items()):
        if any(lines(f, "drill") for f in files):
            for drill, row in drill_summary(files).items():
                print(json.dumps({"model": arch, "side": side,
                                  "drill": drill, **row}))
            continue
        print(json.dumps({"model": arch, "side": side,
                          **side_summary(files)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
