#!/usr/bin/env python
"""Real-image quality evaluation on the reference's own stereo pairs.

The reference ships 5 real rendered stereo pairs (one scene, 240x135 ->
3840x2160, /root/reference/test/imgs/) but only ever bit-diffs the
classic pipeline on them; no ground-truth disparity exists.  This tool
closes the BASELINE.md "bad-pixel rate on real images" loop with the
strongest available proxy: CROSS-ALGORITHM agreement.  The classic
pipeline's post-argmax winner web (binary edge matching + 21x21 window
voting, bit-identical to the serial C reference) is an independent
algorithm from the modern census/SGM pipeline — systematic agreement
between the two on confident pixels is evidence both recover the
scene's true structure; divergence localizes to whichever is weaker.

Geometry: the classic pipeline matches a[x] == b[x+i] (src/stereo.c:120)
— i.e. with b as the LEFT image and a as the RIGHT, shift i is a
standard positive disparity d = i = winner - 1.  The modern pipeline is
therefore run with (left=b, right=a) and compared to the classic web on
pixels where BOTH are confident:

* classic confidence: score_best >= conf_frac * square_width^2 (the
  window vote at the winning shift; weak votes mean no edge structure —
  agreement tightens monotonically in this threshold, 0.25 -> 0.9 gives
  EPE 1.78 -> 1.29 on pair 1, the signature of two algorithms seeing
  the same structure at different smoothing scales);
* modern confidence: the LR-consistency valid mask (+ optional
  uniqueness ratio).

Metrics are Middlebury-style EPE / bad-1 / bad-2 over that mask, plus
coverage fractions.  Usage:

    python tools/eval_reference_pairs.py [--pairs 1 2 3] [--disparities 32]
        [--sgm-directions 8] [--conf-frac 0.25] [--dump-dir DIR] [--json]

Writes (with --dump-dir) the modern disparity and the classic web as
normalized PPMs for visual inspection; prints one JSON line per pair.
A committed-threshold regression gate runs pair 1 in
tests/test_quality_gate.py::test_reference_pair_cross_algorithm_agreement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_IMGS = "/root/reference/test/imgs"


def evaluate_pair(
    a_path: str,
    b_path: str,
    disparities: int = 32,
    window: int = 9,
    sgm_directions: int = 8,
    conf_frac: float = 0.7,
    square_width: int = 21,
    num_shifts: int = 30,
    scale: int = 1,
    downsample: int = 1,
    uniqueness_min: float | None = None,
    median: bool = True,
) -> dict:
    """Cross-algorithm agreement metrics for one stereo pair.

    ``scale``: the render scale relative to the 240x135 base (the 5
    fixtures are ONE scene at 1x..16x).  True pixel disparities grow
    with the render, so the classic search geometry is scaled to keep
    the SAME angular scale — num_shifts*scale shifts, an odd
    ~square_width*scale window — and the agreement metrics are reported
    both raw and in scale-normalized units (|err| > 1*scale / 2*scale,
    EPE/scale).  Measured: the normalized corridor is resolution-
    invariant (bad1 0.40/0.37, bad2 0.23/0.24 at 1x/4x), i.e. the two
    algorithms agree equally well at every render once both resolve the
    scene; with UNSCALED classic geometry the corridor collapses by 4x
    (EPE 8.8 at 960x540) because the classic pipeline under-resolves —
    a property of its fixed-range design, not of this framework."""
    import jax

    from stereomatching.config import ModernParams, StereoParams
    from stereomatching.models.classic import build_classic_pipeline
    from stereomatching.models.modern import build_modern_pipeline
    from stereomatching.utils.imageio import read_png_gray, to_brightness
    from stereomatching.utils.metrics import disparity_report

    a = read_png_gray(a_path)
    b = read_png_gray(b_path)
    while downsample > 1:
        # 2x2 box mean: evaluate a large render at a coarser sampling
        # (at downsample=2 pair 5's programs are pair 4's, already
        # compiled).  The caller passes the correspondingly halved
        # ``scale``.
        a = a[: a.shape[0] // 2 * 2, : a.shape[1] // 2 * 2]
        b = b[: b.shape[0] // 2 * 2, : b.shape[1] // 2 * 2]
        a = (a[0::2, 0::2].astype(np.int32) + a[1::2, 0::2]
             + a[0::2, 1::2] + a[1::2, 1::2]) // 4
        b = (b[0::2, 0::2].astype(np.int32) + b[1::2, 0::2]
             + b[0::2, 1::2] + b[1::2, 1::2]) // 4
        a, b = a.astype(np.uint8), b.astype(np.uint8)
        downsample //= 2

    sw = square_width * scale
    sw += 1 - sw % 2  # odd
    cparams = StereoParams(
        square_width=sw, edge_rule="exact", num_shifts=num_shifts * scale
    )
    print(f"  [classic: shifts={cparams.num_shifts} sw={sw}]",
          file=sys.stderr, flush=True)
    classic = jax.device_get(
        build_classic_pipeline(cparams)(
            to_brightness(a, np.float32), to_brightness(b, np.float32)
        )
    )
    web = np.asarray(classic["web-1"]).astype(np.float64) - 1.0
    conf = np.asarray(classic["score_best"]) >= conf_frac * sw**2

    mparams = ModernParams(
        num_disparities=disparities, window=window, cost="census",
        aggregation="sgm", sgm_directions=sgm_directions,
        fill_mode="background", median_filter=median,
        uniqueness=uniqueness_min is not None,
    )
    print(f"  [modern: D={disparities}]", file=sys.stderr, flush=True)
    modern = jax.device_get(
        build_modern_pipeline(mparams)(
            b.astype(np.int32), a.astype(np.int32)  # left=b: d == shift
        )
    )
    valid = np.asarray(modern["valid"]).astype(bool)
    if uniqueness_min is not None:
        valid &= np.asarray(modern["uniqueness"]) >= uniqueness_min

    mask = conf & valid
    h, w = web.shape
    sub = np.asarray(modern["subpixel"]).astype(np.float64)
    report = disparity_report(sub, web, mask)
    err = np.abs(sub - web)[mask]
    normalized = {
        "bad1": float((err > 1.0 * scale).mean()) if err.size else 0.0,
        "bad2": float((err > 2.0 * scale).mean()) if err.size else 0.0,
        "epe": float(err.mean() / scale) if err.size else 0.0,
    }
    return {
        "pair": os.path.basename(os.path.dirname(a_path)),
        "size": f"{w}x{h}",
        "scale": scale,
        "classic_conf_frac": float(conf.mean()),
        "modern_valid_frac": float(valid.mean()),
        "joint_mask_frac": float(mask.mean()),
        "agreement": report,
        "agreement_scale_normalized": normalized,
        "modern_disparity": np.asarray(modern["filled"]),
        "classic_web": np.asarray(classic["web-1"]),
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", nargs="*", type=int, default=[1, 2, 3, 4, 5])
    p.add_argument("--disparities", type=int, default=32)
    p.add_argument("--window", type=int, default=9)
    p.add_argument("--sgm-directions", type=int, default=8, choices=[4, 8])
    p.add_argument("--conf-frac", type=float, default=0.7)
    p.add_argument("--uniqueness-min", type=float, default=None)
    p.add_argument("--dump-dir", default=None)
    p.add_argument("--downsample", type=int, default=1,
                   help="2x2-box-downsample the pair this many times "
                        "before evaluating (scale shrinks to match); "
                        "--pairs 5 --downsample 2 evaluates the 4K pair "
                        "at pair 4's cached program geometry")
    p.add_argument("--max-scale", type=int, default=8,
                   help="cap the per-pair render scale used to size the "
                        "search ranges: pair 5's native 16x would need "
                        "D=512 at 3840x2160 — a multi-GB volume whose "
                        "remote compile is impractical; at the cap the "
                        "deepest few percent of the scene saturates "
                        "(reported in the mask fraction)")
    args = p.parse_args()

    from stereomatching.utils.platform import ensure_compile_cache

    ensure_compile_cache()
    from stereomatching.utils.imageio import artifact_ppm_type, write_ppm

    dirs = sorted(os.listdir(REF_IMGS))
    for n in args.pairs:
        match = [d for d in dirs if d.startswith(f"{n}-")]
        if not match:
            print(f"skip pair {n}: not in {REF_IMGS}", file=sys.stderr)
            continue
        d = os.path.join(REF_IMGS, match[0])
        # Render scale relative to the 240x135 base fixture; the modern
        # disparity range scales with it (power-of-2 for int8 storage).
        scale = min(max(1, 2 ** (n - 1) // args.downsample),
                    args.max_scale)
        res = evaluate_pair(
            os.path.join(d, "a.png"), os.path.join(d, "b.png"),
            disparities=args.disparities * scale, window=args.window,
            sgm_directions=args.sgm_directions, conf_frac=args.conf_frac,
            scale=scale, downsample=args.downsample,
            uniqueness_min=args.uniqueness_min,
        )
        disp = res.pop("modern_disparity")
        web = res.pop("classic_web")
        if args.dump_dir:
            os.makedirs(args.dump_dir, exist_ok=True)
            base = os.path.join(args.dump_dir, res["pair"])
            write_ppm(f"{base}-sgm.ppm", np.round(disp).astype(np.int64),
                      artifact_ppm_type("web-1"))
            write_ppm(f"{base}-classic.ppm", web.astype(np.int64),
                      artifact_ppm_type("web-1"))
        print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
