#!/usr/bin/env bash
# A/B of the served models on one GPU: this tree against an older commit,
# in turns parent, tree, tree, parent for each model, each turn one process
# of `chip_smoke.py --serve ARCH --repeats N` (with --drill first, of
# `chip_smoke.py --drill ARCH --repeats N`, the elastic drills).
#
#   scripts/serve_ab.sh [--drill] PARENT_DIR OUT_DIR ARCH:N [ARCH:N ...]
#
# PARENT_DIR holds the older commit (`git archive <commit> | tar -x -C
# build/parent`; .gitignore lists build/) with this tree's chip_smoke.py
# copied in as chip_smoke_ab.py. Each turn's output goes to
# OUT_DIR/<arch>_<turn>_<side>.{log,err}; scripts/serve_ab_summary.py
# reads them. Exits 1 if any turn did not exit 0.
set -u
phase=--serve
if [ "${1:-}" = --drill ]; then
  phase=--drill
  shift
fi
parent=$(cd "$1" && pwd)
mkdir -p "$2"
out=$(cd "$2" && pwd)
shift 2
cd "$(dirname "$0")/.."
rc=0
for spec in "$@"; do
  arch=${spec%%:*}
  n=${spec##*:}
  turn=0
  for side in parent tree tree parent; do
    turn=$((turn + 1))
    base="$out/${arch}_${turn}_${side}"
    if [ "$side" = parent ]; then
      (cd "$parent" && python3 chip_smoke_ab.py "$phase" "$arch" \
        --repeats "$n") > "$base.log" 2> "$base.err" || rc=1
    else
      python3 chip_smoke.py "$phase" "$arch" --repeats "$n" \
        > "$base.log" 2> "$base.err" || rc=1
    fi
    echo "$arch turn $turn ($side): $(grep -c '"serving"' "$base.log") runs"
  done
done
exit $rc
