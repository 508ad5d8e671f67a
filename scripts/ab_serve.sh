#!/bin/bash
# llama3-8b's bf16 `serve` and `serve_kvq` phases of chip_smoke.py, run for
# two trees in the order parent, change, change, parent, so that one call
# on one card compares them. Unpack the parent commit into build/parent
# and the change into build/archive first (both gitignored), e.g.
#   git archive <parent> | tar -x -C build/parent
#   git archive $(git write-tree) | tar -x -C build/archive
# then, on the GPU machine: bash scripts/ab_serve.sh
# Each run's JSON lines go to build/ab_<tree>.out; the script prints each
# phase's ticks, decode tokens/s and ms a tick.
cd "$(dirname "$0")/.."
for t in parent change change parent; do
  if [ "$t" = parent ]; then d=build/parent; else d=build/archive; fi
  (cd "$d" && python3 -c "
import sys; sys.path.insert(0, 'src'); import chip_smoke as cs
cs.phase_build(); r = cs.phase_serve(0); cs.phase_serve_kvq(r['engine'].model, 0)
" > ../ab_$t.out 2>/dev/null; echo "$t rc=$?"; grep -h '"phase": "serve' ../ab_$t.out | python3 -c "
import sys, json
for l in sys.stdin:
    d = json.loads(l); print(' ', d['phase'], d.get('ticks'), round(d.get('decode_tok_per_s', 0), 2), round(d.get('tick_ms', 0) or 0, 1))
")
done
