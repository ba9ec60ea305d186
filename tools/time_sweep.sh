#!/usr/bin/env bash
# Size-sweep timing over the reference's fixture images — the exact
# methodology of the reference's test/time.sh: run the pipeline per
# fixture pair with writes disabled, awk field 15 of the timing line
# (src/stereo.c:324), average over runs.
#
# Usage: tools/time_sweep.sh [tier] [runs]
set -euo pipefail

REF=${REF:-/root/reference}
REPO=$(cd "$(dirname "$0")/.." && pwd)
TIER=${1:-jax}
RUNS=${2:-3}
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

for dir in "$REF"/test/imgs/*/; do
    name=$(basename "$dir")
    times=""
    for _ in $(seq "$RUNS"); do
        line=$(python -m stereomatching.cli "$dir/a.png" "$dir/b.png" \
            --tier "$TIER" --no-writes)
        times="$times $(echo "$line" | awk '{print $15}')"
    done
    avg=$(echo "$times" | awk '{s=0; for (i=1;i<=NF;i++) s+=$i; printf "%.6f", s/NF}')
    echo "$name: $avg s (tier=$TIER, avg of $RUNS)"
done
