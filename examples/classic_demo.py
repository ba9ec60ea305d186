#!/usr/bin/env python
"""End-to-end classic pipeline demo.

Loads a stereo pair (or, without arguments, makes a synthetic 240x135
blob scene from a seed), runs the jitted pipeline in both boundary
modes, and writes the contour map and elevation web as PPM images.

    python examples/classic_demo.py [left.png right.png] [--outdir out]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("left", nargs="?", default=None)
    p.add_argument("right", nargs="?", default=None)
    p.add_argument("--outdir", default="demo_out")
    args = p.parse_args()

    import numpy as np

    from stereomatching import BoundaryMode, StereoParams
    from stereomatching.serving import Matcher
    from stereomatching.utils.imageio import (
        artifact_ppm_type,
        read_png_gray,
        write_ppm,
    )

    if (args.left is None) != (args.right is None):
        p.error("give both images or neither")
    if args.left is None:
        from stereomatching.utils.synthetic import blob_scene

        left, right, _ = blob_scene(135, 240, seed=0)
    else:
        left = read_png_gray(args.left)
        right = read_png_gray(args.right)
    print(f"pair: {left.shape[1]}x{left.shape[0]}")

    os.makedirs(args.outdir, exist_ok=True)
    for mode in (BoundaryMode.WRAP, BoundaryMode.GHOST):
        params = StereoParams(mode=mode, edge_rule="exact")
        matcher = Matcher(params)
        t0 = time.monotonic()
        arts = matcher(left, right)
        dt = time.monotonic() - t0
        for name in ("output-0", "web-2", "edges-1"):
            path = os.path.join(args.outdir, f"{mode.value}-{name}.ppm")
            write_ppm(path, np.asarray(arts[name]), artifact_ppm_type(name))
        print(
            f"{mode.value}: elevations [{int(arts['min_elevation'])}, "
            f"{int(arts['max_elevation'])}], first call {dt:.2f}s "
            f"(includes compile); artifacts in {args.outdir}/"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
