#!/usr/bin/env python
"""Serving demo: the shape-cached Matcher/ModernMatcher surface, single
device AND sharded over a device mesh.

With SERVING_DEMO_EMULATE=1 the sharded leg runs on a virtual CPU mesh
(the same emulation the test suite uses); on a machine with several
GPUs the identical code shards over the cards.  Mirrors the reference's
single-entry-surface idea (src/stereo.c:335: four binaries, one CLI
shape) for a long-lived serving process.

    python examples/serving_demo.py [--devices 4] [--batch 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=4,
                   help="mesh size for the sharded leg (CPU-emulated "
                        "when the backend has one device)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    args = p.parse_args()

    if os.environ.get("SERVING_DEMO_EMULATE"):
        # Emulated CPU mesh: must be configured BEFORE jax initializes.
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={args.devices}"
            ).strip()
    import jax

    if len(jax.devices()) < args.devices:
        print(
            f"note: backend has {len(jax.devices())} device(s); the "
            f"sharded leg uses them as-is (SERVING_DEMO_EMULATE=1 "
            f"runs it on an emulated {args.devices}-device CPU mesh)"
        )

    import numpy as np

    from stereomatching.config import ModernParams, StereoParams
    from stereomatching.parallel import make_mesh
    from stereomatching.serving import Matcher, ModernMatcher

    rng = np.random.default_rng(0)
    h = w = args.size
    lb = rng.random((args.batch, h, w)).astype(np.float32)
    rb = rng.random((args.batch, h, w)).astype(np.float32)

    # --- single-device classic serving -------------------------------
    # The default tier takes the match route the backend decision point
    # picks (utils/platform.implementation).
    m = Matcher(StereoParams(num_shifts=16))
    t0 = time.perf_counter()
    out = m(lb, rb)
    print(f"classic single-device: contour {out['output-0'].shape} in "
          f"{time.perf_counter() - t0:.2f}s (first call compiles; "
          f"repeat calls hit the shape cache)")
    t0 = time.perf_counter()
    m(lb, rb)
    print(f"  warm repeat: {time.perf_counter() - t0:.3f}s")

    # --- sharded modern serving --------------------------------------
    n = min(args.devices, len(jax.devices()))
    data = 2 if n % 2 == 0 else 1
    mesh = make_mesh(data=data, rows=n // data,
                     devices=jax.devices()[:n])
    sm = ModernMatcher(
        ModernParams(num_disparities=16, aggregation="sgm",
                     cost="census"),
        tier="sharded", mesh=mesh,
    )
    t0 = time.perf_counter()
    sout = sm((lb * 255).astype(np.int32), (rb * 255).astype(np.int32))
    print(f"modern SGM sharded over {mesh.shape}: disparity "
          f"{sout['disparity'].shape} in {time.perf_counter() - t0:.2f}s")
    # Odd global batches pad to the data axis and slice back — serve
    # a single pair through the same executable:
    one = sm((lb[:1] * 255).astype(np.int32), (rb[:1] * 255).astype(np.int32))
    print(f"  single pair via pad-and-slice: {one['disparity'].shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
