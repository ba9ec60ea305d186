#!/usr/bin/env python
"""Multi-process (multi-host emulation) smoke test.

Launches N OS processes that initialize ``jax.distributed`` over a
localhost coordinator — the boot sequence of a multi-host run, on CPU
devices — then runs ONE sharded pipeline step over the global
(data=1, rows=N*devices_per_process) mesh and checks the result against
the NumPy oracle on process 0.

    python tools/multihost_smoke.py [--procs 2] [--local-devices 2]

This is the cross-process counterpart of the single-process 8-device
mesh tests (tests/test_sharded.py): it exercises the coordination path
and cross-process collectives that a multi-host run depends on.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(coord: str, procs: int, pid: int, local: int) -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={local}"
    ).strip()
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=procs, process_id=pid
    )
    import numpy as np

    from stereomatching.config import BoundaryMode, StereoParams
    from stereomatching.oracle import pipeline as oracle
    from stereomatching.parallel import build_sharded_pipeline, make_mesh
    from stereomatching.utils.imageio import to_brightness
    from stereomatching.utils.synthetic import blob_scene

    n = len(jax.devices())
    assert n == procs * local, (n, procs, local)
    params = StereoParams(
        square_width=9, times=4, lines=4, num_shifts=8,
        mode=BoundaryMode.GHOST, edge_rule="exact",
    )
    mesh = make_mesh(data=1, rows=n)
    h, w = n * 8, 64
    left_u8, right_u8, _ = blob_scene(h=h, w=w, seed=0)
    left = to_brightness(left_u8, np.float32)[None]
    right = to_brightness(right_u8, np.float32)[None]

    # Global arrays assembled shard-by-shard: every process serves the
    # global slices its local devices own (the multi-host input path).
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(None, "rows", None))
    gl = jax.make_array_from_callback(left.shape, sharding, lambda i: left[i])
    gr = jax.make_array_from_callback(right.shape, sharding, lambda i: right[i])

    out = build_sharded_pipeline(params, mesh)(gl, gr)
    web = out["web-2"]
    jax.block_until_ready(web)
    # Each process checks the shards it can address against the oracle.
    want = oracle.run_pipeline(
        to_brightness(left_u8), to_brightness(right_u8), params
    )["web-2"]
    checked = 0
    for shard in web.addressable_shards:
        idx = shard.index  # tuple of slices into the global [1, H, W]
        np.testing.assert_array_equal(np.asarray(shard.data)[0], want[idx[1]])
        checked += 1
    print(f"proc {pid}: {checked} shards bit-identical to oracle", flush=True)
    return 0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--local-devices", type=int, default=2)
    p.add_argument("--port", type=int, default=12421)
    p.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args()

    coord = f"localhost:{args.port}"
    if args.worker is not None:
        return worker(coord, args.procs, args.worker, args.local_devices)

    children = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--procs", str(args.procs), "--local-devices",
             str(args.local_devices), "--port", str(args.port),
             "--worker", str(i)],
            env={**os.environ, "PYTHONPATH": REPO},
        )
        for i in range(args.procs)
    ]
    rc = 0
    for c in children:
        rc |= c.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
