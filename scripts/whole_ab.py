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
  HP mean and largest response, the mean HP job's response by part
  (``hp_response_parts``: the host's parts and the device's), the HP
  stages' enqueue median ms and their ``launch`` step's median ms by
  stage (``enqueue.hp_step_median_by_stage``), driver allocations and
  CUDA events after the clock;
* ``phase_parts``: the parts of the kernel, dist and cluster phases
  (``kernel_parts``, ``dist_parts``, ``cluster_parts``), parent and tree
  (null where a side does not give them);
* ``kernel_seconds``: the kernel phase's parts (``kernel_parts``: the
  kernel rows' and the gradient rows' seconds) and each kernel and
  gradient row's ``row_s``, parent and tree (null where a side does not
  give it);
* ``coverage``: what one side emits and the other does not: line kinds,
  kernel and gradient rows, rows with a planted fault (and every row
  whose fault either side missed), the ``kernels`` line's rows and
  their launch counts side by side, and the keys of each model's
  ``decode_step_profile``;
* ``profiler_sessions``: each side's line, in short (null for a parent
  from before it): sessions, the served runs after one by kind, the
  guarded ones among them, and the LM runs after one.
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
        parts = s.get("hp_response_parts") or {}
        jobs = parts.get("jobs")
        out.append({
            "model": s["model"],
            "hp_mean_ms": s["mean_response_ms"]["hp"],
            "hp_max_ms": max(s.get("hp_response_ms") or [None],
                             key=lambda x: x or 0.0),
            "hp_part_mean_ms": {k: v / jobs for k, v in
                                parts.get("total_ms", {}).items()}
            if jobs else None,
            "hp_enqueue_median_ms": (s.get("hp_enqueue") or {}).get(
                "median"),
            "hp_launch_ms_by_stage": {k: v.get("launch")
                                      for k, v in steps.items()},
            "driver_allocs": s["allocator_in_run"]["num_device_alloc"],
            "events_in_run": (s.get("stage_graphs") or {}).get(
                "events_in_run")})
    return out


def rows_of(rows, kind) -> dict:
    """Each ``kind`` line's row (``kernel_check``, ``grad_check``) by
    "name/dtype"."""
    return {f"{d[kind]['name']}/{d[kind]['dtype']}": d[kind]
            for d in rows if kind in d}


def both(a: dict, b: dict, key) -> dict:
    return {k: [a.get(k, {}).get(key), b.get(k, {}).get(key)]
            for k in dict.fromkeys([*a, *b])}


def apart(a, b) -> dict:
    """What only one side has, of two collections of names."""
    a, b = set(a), set(b)
    return {"only_parent": sorted(a - b), "only_tree": sorted(b - a)}


def kinds(rows) -> set:
    return {next(iter(d)) for d in rows if len(d) == 1}


def faults(rows) -> dict:
    """Each row with a planted fault (a kernel row's, or a gradient row's
    cut from the graph): whether it was caught."""
    out = {}
    for kind in ("kernel_check", "grad_check"):
        for k, r in rows_of(rows, kind).items():
            if "planted_fault" in r:
                out[f"{kind} {k}"] = r["planted_fault"].get("caught")
    return out


def sessions(rows):
    p = first(rows, "profiler_sessions")
    if p is None:
        return None
    after = [r for r in p["served_runs"] if r["after_session"]]
    return {"sessions": p["sessions"],
            "session_free_kinds": p["session_free_kinds"],
            "served_after_a_session_by_kind": {
                k: sum(r["kind"] == k for r in after)
                for k in sorted({r["kind"] for r in after})},
            "session_free_after_a_session":
                p["session_free_after_a_session"],
            "lm_runs_after_a_session": p["lm_runs_after_a_session"]}


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
    print(json.dumps({"phase_parts": {
        k: [pa.get(k), pb.get(k)]
        for k in ("kernel_parts", "dist_parts", "cluster_parts")}}))
    ka, kb = rows_of(a, "kernel_check"), rows_of(b, "kernel_check")
    ga, gb = rows_of(a, "grad_check"), rows_of(b, "grad_check")
    print(json.dumps({"kernel_seconds": {
        "kernel_parts": [pa.get("kernel_parts"), pb.get("kernel_parts")],
        "kernel_rows": both(ka, kb, "row_s"),
        "grad_rows": both(ga, gb, "row_s")}}))
    fa, fb = faults(a), faults(b)
    la = {r["name"]: r for r in first(a, "kernels") or []}
    lb = {r["name"]: r for r in first(b, "kernels") or []}
    pa_, pb_ = ({d["decode_step_profile"]["model"]: sorted(
        d["decode_step_profile"]) for d in rows if "decode_step_profile" in d}
        for rows in (a, b))
    print(json.dumps({"coverage": {
        "line_kinds": apart(kinds(a), kinds(b)),
        "kernel_rows": apart(ka, kb), "grad_rows": apart(ga, gb),
        "planted_faults": apart(fa, fb),
        "faults_missed": sorted(k for k in {**fa, **fb}
                                if fa.get(k) is False or fb.get(k) is False),
        "kernels_line_rows": apart(la, lb),
        "launches": both(la, lb, "launches"),
        "decode_step_profile_models": apart(pa_, pb_),
        "decode_step_profile_keys": {
            m: apart(pa_[m], pb_[m]) for m in pa_ if m in pb_}}}))
    print(json.dumps({"profiler_sessions": {"parent": sessions(a),
                                            "tree": sessions(b)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
