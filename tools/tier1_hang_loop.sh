#!/bin/bash
# Runs one test file of the tier-1 suite N times in a row (default 30), each
# run a fresh pytest process under the tier-1 command's flags (xdist, six
# workers, one file per worker, JAX on the CPU) and its own time limit, and
# stops at the first run that hangs. A test that runs longer than
# FAULT_S seconds (default 240) gets the stacks of every thread of its
# worker dumped by pytest's faulthandler, so a hang leaves its stack in the
# log. Prints one line per run (index, exit code, seconds) and a summary.
#
#     tools/tier1_hang_loop.sh tests/test_runtime_io.py [N] [LOG]
#
# Exit code 124 of a run means its time limit (LIMIT_S, default 600) cut
# it: that run hung.
cd "$(dirname "$0")/.." || exit 2
file=$1
n=${2:-30}
log=${3:-/dev/null}
limit=${LIMIT_S:-600}
fault=${FAULT_S:-240}
pass=0
for i in $(seq 1 "$n"); do
  t0=$(date +%s)
  timeout -k 10 "$limit" env JAX_PLATFORMS=cpu ALLOW_MULTIPLE_LIBTPU_LOAD=1 \
    python -m pytest "$file" -q -m 'not slow' -p no:cacheprovider -p xdist \
    -n 6 --dist loadfile -p no:randomly -o faulthandler_timeout="$fault" \
    >> "$log" 2>&1
  rc=$?
  echo "run $i rc=$rc seconds=$(( $(date +%s) - t0 ))"
  if [ "$rc" -eq 0 ]; then
    pass=$((pass + 1))
  elif [ "$rc" -eq 124 ] || [ "$rc" -eq 137 ]; then
    echo "hang in run $i of $file"
    break
  fi
done
echo "$file: passed $pass of $i"
