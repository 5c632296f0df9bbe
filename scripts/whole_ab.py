#!/usr/bin/env python3
"""Two whole runs of ``chip_smoke.py`` side by side (an A/B of two trees).

    python3 scripts/whole_ab.py PARENT_LOG TREE_LOG [PARENT_DRY TREE_DRY]

Each LOG is a run's standard output (one JSON object a line). Prints one
JSON line each:

* ``phase_seconds``: every phase's seconds, parent and tree (null where
  a side has no such phase), and ``script_seconds`` of both;
* ``dryrun``: for every dry-run cell the keys whose values differ between
  the two sides' ``dryrun`` lines, seconds and ``accum_run`` aside (an
  empty list where none does), and the two sides' run seconds; with the
  two dry-run directories (``build/dryrun`` of each checkout) the same
  for every artifact;
* ``serving``: for every served run of either side, by model in order,
  HP mean response, the HP stages' enqueue median ms and their
  ``launch`` step's median ms by stage (``enqueue.hp_step_median_by_
  stage``), driver allocations and CUDA events after the clock;
* ``profiler_sessions``: the tree's line (a parent from before it has
  none).
"""
import json
import sys
from pathlib import Path

TIMES = ("build_s", "run_s", "accum_run")


def lines(path):
    out = []
    for ln in Path(path).read_text().splitlines():
        if ln.startswith("{"):
            try:
                out.append(json.loads(ln))
            except ValueError:
                pass
    return out


def first(rows, key):
    return next((r[key] for r in rows if key in r), None)


def differ(a: dict, b: dict) -> list:
    return sorted(k for k in set(a) | set(b)
                  if k not in TIMES and a.get(k) != b.get(k))


def dry_cells(rows) -> dict:
    return {"/".join(str(d["dryrun"][k]) for k in ("arch", "shape", "mesh",
                                                   "tag")): d["dryrun"]
            for d in rows if "dryrun" in d}


def served(rows) -> list:
    out = []
    for d in rows:
        s = d.get("serving")
        if s is None:
            continue
        enq = s.get("enqueue") or {}
        steps = enq.get("hp_step_median_by_stage") or {}
        out.append({
            "model": s["model"],
            "hp_mean_ms": s["mean_response_ms"]["hp"],
            "hp_enqueue_median_ms": (s.get("hp_enqueue") or {}).get(
                "median"),
            "hp_launch_ms_by_stage": {k: v.get("launch")
                                      for k, v in steps.items()},
            "driver_allocs": s["allocator_in_run"]["num_device_alloc"],
            "events_in_run": (s.get("stage_graphs") or {}).get(
                "events_in_run")})
    return out


def main(argv) -> int:
    a, b = lines(argv[1]), lines(argv[2])
    pa, pb = first(a, "phase_seconds") or {}, first(b, "phase_seconds") or {}
    names = list(dict.fromkeys([*pa, *pb]))
    print(json.dumps({"phase_seconds": {
        n: [pa.get(n), pb.get(n)] for n in names},
        "script_seconds": [first(a, "script_seconds"),
                           first(b, "script_seconds")]}))
    ca, cb = dry_cells(a), dry_cells(b)
    dry = {c: {"differ": differ(ca.get(c, {}), cb.get(c, {})),
               "run_s": [ca.get(c, {}).get("run_s"),
                         cb.get(c, {}).get("run_s")],
               "accum_run": cb.get(c, {}).get("accum_run")}
           for c in dict.fromkeys([*ca, *cb])}
    arts = None
    if len(argv) > 4:
        da, db = Path(argv[3]), Path(argv[4])
        files = sorted({p.name for p in [*da.glob("*.json"),
                                         *db.glob("*.json")]})
        arts = {f: differ(json.loads((da / f).read_text())
                          if (da / f).exists() else {},
                          json.loads((db / f).read_text())
                          if (db / f).exists() else {}) for f in files}
    print(json.dumps({"dryrun": dry, "artifacts_differ": arts}))
    print(json.dumps({"serving": {"parent": served(a), "tree": served(b)}}))
    print(json.dumps({"profiler_sessions": first(b, "profiler_sessions")}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
