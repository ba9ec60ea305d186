#!/usr/bin/env bash
# Cross-repository golden diff — the reference's own correctness harness
# (test/diff.sh) pointed at this framework: build the reference's serial
# debug binaries, run them AND our CLI on the same stereo pair, and
# byte-diff every dumped artifact (96 PPMs per boundary mode).
#
# Usage: tools/diff_vs_reference.sh [a.png b.png] [tier]
#   default pair: the reference's smallest fixture; default tier: oracle
#   (bit-exact to C doubles).  tier=jax is also byte-exact (C float order
#   in f64).  tier=pallas/sharded run the bit-deterministic `exact` edge
#   rule, gated by tools/knife_edge.py: every differing edge pixel must be
#   a PROVEN rational tie of the C predicate (margin <= 2^-20, count
#   bounded), and every downstream artifact must byte-match the
#   C-semantics oracle seeded with the tier's own edges.
set -euo pipefail

REF=${REF:-/root/reference}
REPO=$(cd "$(dirname "$0")/.." && pwd)
A=${1:-$REF/test/imgs/1-240x135/a.png}
B=${2:-$REF/test/imgs/1-240x135/b.png}
TIER=${3:-oracle}
BUILD=${BUILD:-/tmp/stereo_ref_build}
WORK=$(mktemp -d)

# The accelerated tiers default to the bit-deterministic edge rule; the
# byte-exact tiers default to the C float order.
case "$TIER" in
    pallas|sharded) EDGE_RULE=${EDGE_RULE:-exact} ;;
    *)              EDGE_RULE=${EDGE_RULE:-reference} ;;
esac

mkdir -p "$BUILD"
for v in "stereo.c:ref-ser:ser" "stereo-ghost.c:ref-sergh:sergh"; do
    IFS=: read -r src bin dir <<<"$v"
    [ -x "$BUILD/$bin" ] || gcc -O2 -DDEBUG -I "$REF/src" \
        "$REF/src/$src" "$REF/src/image.c" -lm -o "$BUILD/$bin"
    mkdir -p "$WORK/$dir"
done

cd "$WORK"
"$BUILD/ref-ser" "$A" "$B" >/dev/null
"$BUILD/ref-sergh" "$A" "$B" >/dev/null

export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
# The pallas/sharded tiers fuse the per-shift planes away (no --collect);
# they are gated on the 6 final artifacts the reference also dumps.
COLLECT=--collect
case "$TIER" in pallas|sharded) COLLECT= ;; esac
python -m stereomatching.cli "$A" "$B" --tier "$TIER" --mode wrap \
    --edge-rule "$EDGE_RULE" $COLLECT --outdir our_ser >/dev/null
python -m stereomatching.cli "$A" "$B" --tier "$TIER" --mode ghost \
    --edge-rule "$EDGE_RULE" $COLLECT --outdir our_sergh >/dev/null

if [ -z "$COLLECT" ] && [ "$EDGE_RULE" = exact ]; then
    # Quantified knife-edge gate (see header).
    python "$REPO/tools/knife_edge.py" ser our_ser "$A" "$B" --mode wrap
    python "$REPO/tools/knife_edge.py" sergh our_sergh "$A" "$B" --mode ghost
    echo "OK: tier=$TIER gated vs the C reference (knife-edge ties proven," \
         "downstream byte-identical conditional on edges)"
    rm -rf "$WORK"
    exit 0
fi

fail=0
n=0
for pair in "ser:our_ser" "sergh:our_sergh"; do
    IFS=: read -r ref ours <<<"$pair"
    # With --collect we must match every reference artifact; without,
    # every artifact we dump must match its reference counterpart.
    if [ -n "$COLLECT" ]; then src="$ref"; else src="$ours"; fi
    for f in "$src"/*.ppm; do
        name=$(basename "$f")
        if ! cmp -s "$ref/$name" "$ours/$name"; then
            echo "DIFF [$ref] $name"
            fail=1
        fi
        n=$((n + 1))
    done
done
[ "$n" -ge 12 ] || { echo "FAILED: only $n artifacts produced" >&2; exit 1; }
if [ "$fail" -eq 0 ]; then
    echo "OK: all $n artifacts byte-identical (tier=$TIER, edge_rule=$EDGE_RULE)"
else
    echo "FAILED: artifacts differ (dir: $WORK)" >&2
    exit 1
fi
rm -rf "$WORK"
