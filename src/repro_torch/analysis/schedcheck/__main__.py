"""CLI: ``python -m repro_torch.analysis.schedcheck <config.json ...>``.

The reference's CLI (src/repro/analysis/schedcheck/__main__.py) over the
port: it analyzes serve-daemon JSON configs and/or named figure scenarios
(``--figure``, resolved through ``benchmarks.figure_specs_torch``, the
port's twin of ``benchmarks.figure_specs`` — run from the repo root so
``benchmarks`` is importable) and prints the human report.  ``--json``
writes the machine report; ``--oracle`` also runs each scenario in the
simulator and checks the differential contract.

Exit status: 0 when every analyzed config is free of HP
``UNSCHEDULABLE`` verdicts (and, with ``--require-hp-guaranteed``,
every HP verdict is ``GUARANTEED``; with ``--oracle``, zero bound
violations); 1 otherwise; 2 on usage errors.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from .analyzer import analyze_config
from .model import GUARANTEED, UNSCHEDULABLE, Report
from .oracle import differential_check


def _figure_registry():
    try:
        import benchmarks.figure_specs_torch as figure_specs
    except ImportError as exc:
        raise SystemExit(
            f"--figure needs the benchmarks package on sys.path (run "
            f"from the repo root): {exc}")
    return figure_specs


def _load_scenarios(args) -> List[Tuple[str, object]]:
    out: List[Tuple[str, object]] = []
    for path in args.configs:
        from ...serve.config import load_config, server_config
        out.append((path, server_config(load_config(path))))
    if args.figure:
        reg = _figure_registry()
        for name in args.figure:
            out.append((name, reg.scenario(name)))
    if args.all_figures:
        reg = _figure_registry()
        for name in reg.names():
            out.append((name, reg.scenario(name)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.schedcheck",
        description="static schedulability analysis (SchedCheck)")
    ap.add_argument("configs", nargs="*",
                    help="serve-daemon JSON config paths")
    ap.add_argument("--figure", action="append", default=[],
                    metavar="NAME",
                    help="named figure scenario (repeatable; see --list)")
    ap.add_argument("--all-figures", action="store_true",
                    help="analyze every registered figure scenario")
    ap.add_argument("--list", action="store_true",
                    help="list figure scenario names and exit")
    ap.add_argument("--json", metavar="PATH",
                    help="write the JSON report(s) to PATH")
    ap.add_argument("--oracle", action="store_true",
                    help="also run each scenario in sim and check the "
                         "bound-vs-sim differential contract")
    ap.add_argument("--require-hp-guaranteed", action="store_true",
                    help="exit 1 unless every HP verdict is GUARANTEED")
    args = ap.parse_args(argv)

    if args.list:
        for name in _figure_registry().names():
            print(name)
        return 0
    scenarios = _load_scenarios(args)
    if not scenarios:
        ap.print_usage(sys.stderr)
        print("error: nothing to analyze (give a config path, --figure, "
              "or --all-figures)", file=sys.stderr)
        return 2

    failed = False
    payload: List[Dict] = []
    for name, cfg in scenarios:
        if args.oracle:
            res = differential_check(cfg, label=name)
            report: Report = res.report
            print(res.render())
            failed |= not res.ok
            entry = report.to_dict()
            entry["oracle"] = {
                "ok": res.ok, "vacuous": res.vacuous,
                "observed_max_ms": res.observed_max_ms,
                "dmr_hp": res.dmr_hp,
                "violations": res.violations,
            }
        else:
            report = analyze_config(cfg, label=name)
            entry = report.to_dict()
        print(report.render())
        print()
        payload.append(entry)
        if report.hp_verdict == UNSCHEDULABLE:
            failed = True
        if args.require_hp_guaranteed and report.hp_verdict != GUARANTEED:
            print(f"require-hp-guaranteed: {name} is "
                  f"{report.hp_verdict}", file=sys.stderr)
            failed = True

    if args.json:
        doc = payload[0] if len(payload) == 1 else payload
        with open(args.json, "w") as fh:
            json.dump(doc, fh, indent=2)
            fh.write("\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
