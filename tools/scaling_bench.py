#!/usr/bin/env python
"""Weak-scaling benchmark for the sharded pipeline — the BASELINE.md
">= 90% weak-scaling efficiency at N >= 2 hosts" measurement.

Sweeps row-shard counts on the available devices, keeping the work per
shard constant (image height grows with the mesh), and reports
throughput + efficiency vs the 1-shard run, on the visible devices
(the GPUs of one host, or a virtual CPU mesh, whose numbers exercise
the harness, not the hardware).  The match route on each shard is the
one the backend decision point picks.

    python tools/scaling_bench.py [--rows-per-shard 256] [--width 1024]
        [--batch 2] [--iters 3] [--max-shards 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rows-per-shard", type=int, default=256)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--max-shards", type=int, default=None)
    p.add_argument("--disparities", type=int, default=64)
    p.add_argument("--axis", choices=["rows", "cols"], default="rows",
                   help="which spatial mesh axis to sweep (cols sweeps "
                        "the 2-D tier: W grows with the shard count and "
                        "x halos ride col exchanges)")
    args = p.parse_args()

    from stereomatching.utils.platform import ensure_compile_cache

    ensure_compile_cache()

    import jax
    import jax.numpy as jnp

    from stereomatching.config import BoundaryMode, StereoParams
    from stereomatching.parallel import build_sharded_pipeline, make_mesh
    from stereomatching.utils.platform import implementation

    fused = implementation("classic_match") == "fused"

    n_dev = len(jax.devices())
    max_shards = args.max_shards or n_dev
    params = StereoParams(
        num_shifts=args.disparities, mode=BoundaryMode.GHOST, edge_rule="exact"
    )
    rng = np.random.default_rng(0)

    results = []
    shards = 1
    while shards <= max_shards and shards <= n_dev:
        if args.axis == "cols":
            h = args.rows_per_shard
            w = shards * args.width
            mesh = make_mesh(data=1, rows=1, cols=shards,
                             devices=jax.devices()[:shards])
        else:
            h = shards * args.rows_per_shard
            w = args.width
            mesh = make_mesh(data=1, rows=shards,
                             devices=jax.devices()[:shards])
        fn = build_sharded_pipeline(params, mesh, use_pallas=fused)

        def step(l, r, fn=fn):
            out = fn(l, r)
            return out["web-2"].sum() + out["output-0"].sum()

        step = jax.jit(step)
        batches = [
            (
                jnp.asarray(rng.integers(0, 256, (args.batch, h, w))
                            .astype(np.float32) / 256.0),
                jnp.asarray(rng.integers(0, 256, (args.batch, h, w))
                            .astype(np.float32) / 256.0),
            )
            for _ in range(args.iters + 1)
        ]
        jax.block_until_ready(batches)
        int(jax.device_get(step(*batches[0])))  # compile + warm
        t0 = time.perf_counter()
        acc = 0
        for i in range(1, args.iters + 1):
            acc += int(jax.device_get(step(*batches[i])))
        dt = time.perf_counter() - t0
        mpix_s = args.batch * args.iters * h * w / dt / 1e6
        results.append({"shards": shards, "height": h, "width": w,
                        "mpix_per_s": mpix_s, "checksum": acc})
        shards *= 2

    base = results[0]["mpix_per_s"]
    for r in results:
        r["weak_scaling_efficiency"] = r["mpix_per_s"] / (base * r["shards"])
    print(json.dumps({
        "device": jax.devices()[0].platform,
        "match": implementation("classic_match"),
        "axis": args.axis,
        "rows_per_shard": args.rows_per_shard,
        "results": results,
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
