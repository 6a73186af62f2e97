#!/bin/bash
# Trial runs on the card: tools/trial.sh SECONDS SEED_BASE CELL[:TRACE] ...
# Each run's output goes to $OUT/<cell>.<seed>.<trace>.{out,err} (OUT defaults
# to benchmark_out/trial); the summary (exit code, the result line's numbers)
# to standard output.
secs=$1; base=$2; shift 2
out=${OUT:-benchmark_out/trial}
mkdir -p "$out"
i=0
for spec in "$@"; do
  w=${spec%%:*}; t=${spec#*:}; [ "$t" = "$spec" ] && t=0
  seed=$((base + i)); i=$((i + 1))
  f=$out/$w.$seed.$t
  start=$(date +%s%N)
  python3 benchmark/run.py --workload "$w" --seed "$seed" --seconds "$secs" --trace "$t" > "$f.out" 2> "$f.err"
  rc=$?
  end=$(date +%s%N)
  echo "== $w seed=$seed trace=$t rc=$rc wall_ms=$(( (end - start) / 1000000 ))"
  grep -E "^(set-up|window|check|correct|call)" "$f.err" | tail -12
  tail -n 1 "$f.out" | cut -c1-1800
  if [ $rc -ne 0 ]; then tail -n 25 "$f.err"; fi
done
