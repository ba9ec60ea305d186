"""Command-line pipeline driver — the reference's program surface.

Replaces all four reference binaries with one command:

    python -m stereomatching.cli IMG1 IMG2 [threshold] [square_width]
        [times] [lines] [--mode wrap|ghost] [--tier jax|oracle|sharded] ...

Positional arguments, validation messages, artifact dumps, and the final
timing line (``width = %d, height = %d, t1 = %f, t2 = %f, elapsed = %f``,
src/stereo.c:324 — field 15 is what the reference's test/time.sh awk
script extracts) are kept compatible with the reference CLI
(src/stereo.c:335-392) so its measurement harness works unmodified.

Tier selection replaces the reference's four separate binaries:
  oracle  — pure NumPy serial oracle (the role of ``stereomatch``)
  jax     — single-device jitted pipeline (the role of ``stereopar``),
            its match route chosen by the backend decision point
            (utils/platform.implementation)
  pallas  — the same with the fused GPU match kernel forced (classic)
  sharded — shard_map over every visible device with ppermute halo
            exchange (the scaled-out ghost-area programs)
Boundary mode is ``--mode`` (wrap == stereomatch/stereopar semantics,
ghost == the -ghost programs).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np

from stereomatching.config import BoundaryMode, StereoParams
from stereomatching.utils.imageio import (
    artifact_ppm_type,
    read_png_gray,
    to_brightness,
    write_ppm,
)
from stereomatching.utils.platform import ensure_compile_cache


def _parse(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="stereomatch",
        description="Stereo matching / contour mapping pipeline (JAX)",
    )
    p.add_argument("image1")
    p.add_argument("image2")
    p.add_argument("threshold", nargs="?", type=float, default=None)
    p.add_argument("square_width", nargs="?", type=int, default=None)
    p.add_argument("times", nargs="?", type=int, default=None)
    p.add_argument("lines", nargs="?", type=int, default=None)
    p.add_argument("--mode", choices=["wrap", "ghost"], default="wrap")
    p.add_argument(
        "--tier", choices=["jax", "oracle", "sharded", "pallas"], default="jax"
    )
    p.add_argument(
        "--pipeline",
        choices=["classic", "modern"],
        default="classic",
        help="classic = the reference's edge-matching contour pipeline; "
        "modern = SAD cost volume + LR consistency + sub-pixel refine "
        "(positional threshold is ignored; square_width maps to the SAD "
        "window, --shifts to num_disparities)",
    )
    p.add_argument("--scales", type=int, default=1, choices=[1, 2],
                   help="modern pipeline: multi-scale cost fusion levels")
    p.add_argument("--cost", choices=["sad", "census"], default="sad",
                   help="modern pipeline: matching cost")
    p.add_argument("--aggregation", choices=["box", "sgm"], default="box",
                   help="modern pipeline: windowed box sum or "
                        "Semi-Global Matching")
    p.add_argument("--sgm-directions", type=int, default=4, choices=[4, 8],
                   help="SGM path count: 4 (axes) or 8 (+diagonals)")
    p.add_argument("--fill-mode", choices=["diffusion", "background"],
                   default="diffusion",
                   help="modern pipeline: hole filling for LR-invalid "
                        "pixels (valid-aware Jacobi diffusion, or "
                        "scanline background extension)")
    p.add_argument("--uniqueness", action="store_true",
                   help="modern SGM: also emit the c2/c1 uniqueness "
                        "confidence plane")
    p.add_argument("--median", action="store_true",
                   help="modern pipeline: 3x3 median speckle filter")
    p.add_argument("--edge-rule", choices=["reference", "exact"], default="reference")
    p.add_argument("--shifts", type=int, default=None, help="number of disparities")
    p.add_argument("--outdir", default=".", help="artifact output directory")
    p.add_argument(
        "--save-artifacts",
        metavar="PATH",
        help="classic pipeline: also checkpoint every artifact (exact "
        "values + params) as one compressed .npz — the reference's "
        "phase dumps as restartable state (src/stereo.c:302-320)",
    )
    p.add_argument(
        "--resume",
        metavar="PATH",
        help="classic pipeline: skip matching and resume the finishing "
        "phases (diffusion, contour) from a --save-artifacts "
        "checkpoint's post-argmax web; bit-identical to the "
        "uninterrupted run (times/lines may differ from the saved run; "
        "upstream params must match)",
    )
    p.add_argument(
        "--no-writes",
        action="store_true",
        help="skip all image writes (the reference's -DNO_WRITES timing build)",
    )
    p.add_argument(
        "--collect",
        action="store_true",
        help="also dump per-shift matches/score_all/scores planes "
        "(the reference's DEBUG build dumps)",
    )
    return p.parse_args(argv)


def _build_params(args: argparse.Namespace) -> StereoParams:
    kw = {"mode": BoundaryMode(args.mode), "edge_rule": args.edge_rule}
    if args.threshold is not None:
        kw["threshold"] = args.threshold
    if args.square_width is not None:
        kw["square_width"] = args.square_width
    if args.times is not None:
        kw["times"] = args.times
    if args.lines is not None:
        kw["lines"] = args.lines
    if args.shifts is not None:
        kw["num_shifts"] = args.shifts
    return StereoParams(**kw)


def _run_oracle(left, right, params, collect):
    from stereomatching.oracle import pipeline as oracle

    return oracle.run_pipeline(
        left.astype(np.float64), right.astype(np.float64), params, collect=collect
    )


def _use_fused() -> bool:
    from stereomatching.utils.platform import implementation

    return implementation("classic_match") == "fused"


def _run_jax(left, right, params, collect):
    ensure_compile_cache()
    import jax

    from stereomatching.models.classic import (
        build_classic_collect_pipeline,
        build_classic_pipeline,
    )

    # The per-shift planes of --collect exist only on the XLA route.
    fn = (
        build_classic_collect_pipeline(params)
        if collect
        else build_classic_pipeline(params, use_pallas=_use_fused())
    )
    out = jax.device_get(fn(left, right))
    arts = dict(out)
    if collect:
        for key in ("matches", "score_all", "scores"):
            planes = arts.pop(key)
            for i in range(planes.shape[0]):
                arts[f"{key}-{i}"] = planes[i]
    return arts


def _run_pallas(left, right, params, collect):
    ensure_compile_cache()
    import jax

    from stereomatching.models.classic import build_classic_pipeline

    if collect:
        # The fused kernel never materializes per-shift planes; the jax
        # tier produces the identical planes for debugging.
        print(
            "warning: --collect is unavailable on the pallas tier "
            "(per-shift planes are fused away); use --tier jax on the CPU",
            file=sys.stderr,
        )
    fn = build_classic_pipeline(params, use_pallas=True)
    return dict(jax.device_get(fn(left, right)))


def _run_sharded(left, right, params, collect):
    ensure_compile_cache()
    import jax

    from stereomatching.parallel import build_sharded_pipeline, make_mesh

    n = len(jax.devices())
    h = left.shape[0]
    rows = n
    while rows > 1 and (h % rows != 0 or h // rows < max(params.half, 1)):
        rows -= 1
    mesh = make_mesh(data=1, rows=rows, devices=jax.devices()[:rows])
    fn = build_sharded_pipeline(params, mesh, use_pallas=_use_fused())
    out = jax.device_get(fn(left[None], right[None]))
    return {k: np.asarray(v)[0] for k, v in out.items()}


_TIERS = {
    "oracle": _run_oracle,
    "jax": _run_jax,
    "sharded": _run_sharded,
    "pallas": _run_pallas,
}

# StereoParams fields that determine the post-argmax winner web; a resume
# checkpoint is only valid for a run with the same values (times/lines
# shape only the finishing phases and MAY differ — that is the point).
_UPSTREAM_FIELDS = (
    "threshold", "square_width", "num_shifts", "mode", "edge_rule",
)


def _run_resume(path: str, tier: str, params: StereoParams):
    """Resume the finishing phases from a --save-artifacts checkpoint."""
    import json

    from stereomatching.utils.artifacts import load_artifacts

    ck = load_artifacts(path)
    if "web-1" not in ck:
        raise ValueError(f"{path}: not a classic checkpoint (no web-1)")
    if "params" in ck:
        saved = json.loads(str(ck["params"]))
        cur = json.loads(params.to_json())
        bad = [f for f in _UPSTREAM_FIELDS if saved.get(f) != cur[f]]
        if bad:
            raise ValueError(
                f"{path}: checkpoint params differ in {bad} — the saved "
                f"web is not valid for this run"
            )
    winner = np.asarray(ck["web-1"]).astype(np.int32)
    if tier == "oracle":
        from stereomatching.oracle import pipeline as oracle

        web = oracle.fill_web_holes(winner, params.times)
        out, min_e, max_e = oracle.draw_contour(web, params.lines)
        fin = {"web-2": web, "output-0": out}
    else:
        ensure_compile_cache()
        import jax

        from stereomatching.models.classic import (
            build_classic_finish_pipeline,
        )

        fn = build_classic_finish_pipeline(params)
        fin = dict(jax.device_get(fn(winner)))
        fin.pop("min_elevation", None)
        fin.pop("max_elevation", None)
    arts = {
        k: np.asarray(v)
        for k, v in ck.items()
        if k in ("edges-1", "edges-2", "score_best", "web-1")
    }
    arts.update(fin)
    return arts


def _dump(arts: Dict[str, np.ndarray], outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    for name, data in arts.items():
        if name in ("min_elevation", "max_elevation"):
            continue
        # The reference suffixes score_best with -0 (src/stereo.c:314).
        fname = "score_best-0" if name == "score_best" else name
        write_ppm(
            os.path.join(outdir, f"{fname}.ppm"),
            np.asarray(data),
            artifact_ppm_type(fname),
        )


def _run_modern(args, img1, img2) -> Dict[str, np.ndarray]:
    ensure_compile_cache()
    import jax

    from stereomatching.config import ModernParams
    from stereomatching.models.modern import build_modern_pipeline

    kw = {"scales": args.scales, "cost": args.cost,
          "aggregation": args.aggregation, "median_filter": args.median,
          "sgm_directions": args.sgm_directions,
          "fill_mode": args.fill_mode, "uniqueness": args.uniqueness}
    if args.shifts is not None:
        kw["num_disparities"] = args.shifts
    if args.square_width is not None:
        kw["window"] = args.square_width
    params = ModernParams(**kw)
    if args.tier == "sharded":
        from stereomatching.parallel import (
            build_sharded_modern_pipeline,
            make_mesh,
        )

        n = len(jax.devices())
        h = img1.shape[0]
        reach = max(params.window // 2
                    + (params.census_window // 2
                       if params.cost == "census" else 0), 1)
        rows = n
        while rows > 1 and (h % rows != 0 or h // rows < reach):
            rows -= 1
        mesh = make_mesh(data=1, rows=rows, devices=jax.devices()[:rows])
        fn = build_sharded_modern_pipeline(params, mesh)
        out = jax.device_get(
            fn(img1.astype(np.int32)[None], img2.astype(np.int32)[None])
        )
        return {k: np.asarray(v)[0] for k, v in out.items()}
    if args.tier != "jax":
        raise ValueError(
            f"--tier {args.tier} is not available for --pipeline modern"
        )
    fn = build_modern_pipeline(params)
    return jax.device_get(fn(img1.astype(np.int32), img2.astype(np.int32)))


def _dump_modern(out: Dict[str, np.ndarray], outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    np.savez_compressed(
        os.path.join(outdir, "disparity.npz"),
        **{k: np.asarray(v) for k, v in out.items()},
    )
    write_ppm(
        os.path.join(outdir, "disparity.ppm"),
        np.asarray(out["disparity"]),
        artifact_ppm_type("web-1"),  # GRAY_INT normalization
    )
    write_ppm(
        os.path.join(outdir, "valid.ppm"),
        np.asarray(out["valid"]).astype(np.int64) ^ 1,  # invalid -> black
        artifact_ppm_type("output-0"),
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])

    try:
        img1 = read_png_gray(args.image1)
        img2 = read_png_gray(args.image2)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if img1.shape != img2.shape:
        # Same message as the reference (src/stereo.c:350).
        print(
            "error: the two images must have equal width and height",
            file=sys.stderr,
        )
        return 1
    if args.pipeline == "modern":
        if args.resume or args.save_artifacts:
            print(
                "error: --save-artifacts/--resume are classic-pipeline "
                "flags (the modern pipeline dumps disparity.npz)",
                file=sys.stderr,
            )
            return 1
        t1 = time.monotonic()
        try:
            out = _run_modern(args, img1, img2)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if not args.no_writes:
            _dump_modern(out, args.outdir)
        t2 = time.monotonic()
        h, w = img1.shape
        print(
            f"width = {w}, height = {h}, t1 = {t1:f}, t2 = {t2:f}, "
            f"elapsed = {t2 - t1:f}"
        )
        return 0

    try:
        params = _build_params(args)
        params.validate_for_image(img1.shape[1], img1.shape[0])
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    dtype = np.float64 if args.tier == "oracle" else np.float32
    left = to_brightness(img1, dtype)
    right = to_brightness(img2, dtype)

    # Timing mirrors the reference: excludes image load, includes artifact
    # writes unless --no-writes (src/stereo.c:297-324, Makefile:23).
    t1 = time.monotonic()
    try:
        if args.resume:
            arts = _run_resume(args.resume, args.tier, params)
        else:
            arts = _TIERS[args.tier](left, right, params, args.collect)
            if args.save_artifacts:
                from stereomatching.utils.artifacts import save_artifacts

                save_artifacts(
                    args.save_artifacts,
                    {
                        **{k: np.asarray(v) for k, v in arts.items()},
                        "params": np.asarray(params.to_json()),
                    },
                )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not args.no_writes:
        _dump(arts, args.outdir)
    t2 = time.monotonic()

    h, w = img1.shape
    print(
        f"width = {w}, height = {h}, t1 = {t1:f}, t2 = {t2:f}, "
        f"elapsed = {t2 - t1:f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
