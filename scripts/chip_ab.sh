#!/usr/bin/env bash
# A/B of two trees on one card: `chip_smoke.py --phases PHASES` of the
# parent tree and of this one, in the order parent, change, change, parent.
# Run from the repository root, with the parent unpacked into a directory
# that .gitignore lists (git archive <commit> | tar -x -C build/parent):
#
#   scripts/chip_ab.sh build/parent reduce,hypersparse chiprun_out/ab
#
# Each run's full output goes to OUT/<n>-<side>.log and its results to
# OUT/<n>-<side>/chip_smoke.json; the lines with the card, the medians and
# the profiles are echoed.
set -euo pipefail
parent=$1
phases=$2
out=$3
root=$(pwd)
mkdir -p "$out"
i=0
for side in parent change change parent; do
  i=$((i + 1))
  dir=$root
  if [ "$side" = parent ]; then dir=$parent; fi
  echo "== run $i: $side"
  (cd "$dir" && python3 chip_smoke.py --phases "$phases" \
      --out "$root/$out/$i-$side") > "$out/$i-$side.log" 2>&1
  grep -E "^gpu:|median|profile " "$out/$i-$side.log"
done
