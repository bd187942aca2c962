#!/bin/bash
# Runs the streaming pipeline's lifecycle tests of the port -- the two
# concurrent iterators, close() leaving no thread, process or shared-memory
# segment on either decode backend, and the abandoned iterator -- N times
# in a row (default 20), each in a fresh pytest process with its own time
# limit, and prints how many runs passed. A hang counts as a failed run.
#
#     tools/port_streaming_loop.sh [N]
cd "$(dirname "$0")/.." || exit 2
n=${1:-20}
pass=0
for i in $(seq 1 "$n"); do
  if JAX_PLATFORMS=cpu timeout 300 python -m pytest -q -p no:cacheprovider \
      tests/test_torch_streaming.py \
      -k "two_concurrent or close_is_idempotent or abandoned" > /dev/null 2>&1
  then
    pass=$((pass + 1))
  fi
done
echo "passed $pass of $n"
