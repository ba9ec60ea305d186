"""Time the classic pipeline's three match routes end to end on the GPU.

The routes are bit-identical; this measurement picks the one the backend
decision point (utils/platform.py) uses:

  fused       the Pallas kernel (ops/fused.py),
  xla-sat     the XLA shift scan with the summed-area-table box,
  xla-matmul  the XLA shift scan with the banded-ones matmul box.

Each route runs the whole classic pipeline (edges, match, diffusion,
contour) on distinct random batches, in the order fused, sat, matmul,
matmul, sat, fused, and the median time per pair of each is printed
with the card's name and power limit.  Fails without a GPU.

    python tools/classic_routes.py [--size 1024] [--disparities 64]
                                   [--batch 32] [--iters 5]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROUTES = ("fused", "xla-sat", "xla-matmul")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--disparities", type=int, default=64)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args()

    from stereomatching.utils.platform import (
        card_info, ensure_compile_cache, require_gpu,
    )

    card = card_info()
    import jax
    import jax.numpy as jnp

    from stereomatching.config import BoundaryMode, StereoParams
    from stereomatching.models.classic import classic_forward_batched
    from stereomatching.utils import platform

    dev = require_gpu()
    ensure_compile_cache()
    params = StereoParams(num_shifts=args.disparities, mode=BoundaryMode.GHOST,
                          edge_rule="exact")
    shape = (args.batch, args.size, args.size)
    rng = np.random.default_rng(0)

    def batch():
        return jnp.asarray(rng.integers(0, 256, shape).astype(np.float32)
                           / np.float32(256.0))

    compiled = {}
    for route in ROUTES:
        box = "matmul" if route == "xla-matmul" else "sat"
        fn = jax.jit(lambda l, r, route=route: classic_forward_batched(
            l, r, params, use_pallas=route == "fused"))
        spec = jax.ShapeDtypeStruct(shape, jnp.float32)
        t0 = time.perf_counter()
        with mock.patch.dict(platform._IMPLEMENTATIONS["box_sum"],
                             {"gpu": box}):
            compiled[route] = fn.lower(spec, spec).compile()
        mem = compiled[route].memory_analysis()
        print(f"{route}: compile {time.perf_counter() - t0:.1f} s, "
              f"temp {getattr(mem, 'temp_size_in_bytes', 'n/a')} B",
              file=sys.stderr)

    # Bit-equality of every integer artifact across the routes.
    l0, r0 = batch(), batch()
    outs = {route: jax.device_get(compiled[route](l0, r0)) for route in ROUTES}
    for route in ROUTES[1:]:
        for k, v in outs["fused"].items():
            if not np.array_equal(np.asarray(v), np.asarray(outs[route][k])):
                print(f"MISMATCH {route} {k}", file=sys.stderr)
                return 1
    del outs

    times = {route: [] for route in ROUTES}
    order = list(ROUTES) + list(reversed(ROUTES))
    for route in order:
        ins = [(batch(), batch()) for _ in range(args.iters + 1)]
        jax.block_until_ready(compiled[route](*ins[0]))
        for l, r in ins[1:]:
            t0 = time.perf_counter()
            jax.block_until_ready(compiled[route](l, r))
            times[route].append((time.perf_counter() - t0) / args.batch)
        del ins
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    print(card)
    print(json.dumps({
        "device": dev, "size": args.size, "disparities": args.disparities,
        "batch": args.batch, "peak_bytes_in_use": peak,
        "ms_per_pair": {r: statistics.median(t) * 1e3
                        for r, t in times.items()},
        "runs_ms_per_pair": {r: [x * 1e3 for x in t]
                             for r, t in times.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
