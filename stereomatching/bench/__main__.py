"""``python -m stereomatching.bench`` — per-phase breakdown and the
reference's size-sweep measurement (test/time.sh + make graphs), on the
current default JAX device.

Usage:
  python -m stereomatching.bench [--sizes 135x240,270x480,...]
      [--phases-size 1080x1920] [--iters 3] [--shifts 30] [--mode ghost]
      [--graphs DIR]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from stereomatching.bench.harness import (
    phase_timings,
    pixel_passes,
    size_sweep,
)
from stereomatching.config import BoundaryMode, StereoParams

# The reference's fixture resolutions (test/imgs/{1..5}-WxH).
DEFAULT_SIZES = "135x240,270x480,540x960,1080x1920,2160x3840"


def _parse_sizes(s: str):
    out = []
    for item in s.split(","):
        h, w = item.lower().split("x")
        out.append((int(h), int(w)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", default=DEFAULT_SIZES, help="HxW list, comma-separated")
    p.add_argument("--phases-size", default="1080x1920")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--shifts", type=int, default=30)
    p.add_argument("--mode", choices=["wrap", "ghost"], default="ghost")
    p.add_argument("--graphs", default=None, help="write PNG graphs to this dir")
    p.add_argument("--json", action="store_true", help="emit JSON lines")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the sweep into DIR "
                        "(view with tensorboard / xprof)")
    args = p.parse_args(argv)

    import contextlib

    import jax

    from stereomatching.utils.platform import implementation

    route = implementation("classic_match")
    trace_cm = (
        jax.profiler.trace(args.trace) if args.trace else contextlib.nullcontext()
    )

    params = StereoParams(
        num_shifts=args.shifts, mode=BoundaryMode(args.mode), edge_rule="exact"
    )
    dev = jax.devices()[0]
    print(f"# device={dev.platform} n={len(jax.devices())} "
          f"D={args.shifts} sw={params.square_width} times={params.times} "
          f"kind={dev.device_kind} mode={args.mode} match={route}",
          file=sys.stderr)

    ph, pw = _parse_sizes(args.phases_size)[0]
    rng = np.random.default_rng(0)
    left = rng.integers(0, 256, size=(ph, pw)).astype(np.float32) / 256.0
    right = rng.integers(0, 256, size=(ph, pw)).astype(np.float32) / 256.0

    print(f"== per-phase breakdown @ {pw}x{ph} ==")
    for r in phase_timings(left, right, params, args.iters):
        print(r.row())
        if args.json:
            print(json.dumps({"phase": r.name, "mean_s": r.mean_s, "min_s": r.min_s}))

    print("== size sweep (end-to-end) ==")
    with trace_cm:
        sweep = size_sweep(_parse_sizes(args.sizes), params, args.iters)
    for r in sweep:
        gpps = r.pixels_per_s / 1e9
        print(f"{r.row()}   {gpps:8.2f} Gpixel-passes/s")
        if args.json:
            print(json.dumps({"size": r.name, "mean_s": r.mean_s,
                              "gpixel_passes_per_s": gpps}))

    if args.graphs:
        import os

        from stereomatching.bench.graphs import throughput_graph, times_graph

        os.makedirs(args.graphs, exist_ok=True)
        times_graph({route: sweep}, os.path.join(args.graphs, "times.png"))
        throughput_graph(
            sweep,
            os.path.join(args.graphs, "throughput.png"),
            title=f"{route}, {pixel_passes(params)} passes/px",
        )
        print(f"graphs written to {args.graphs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
