"""Headline benchmark: stereo pairs/sec/card at 1 MP, 64 disparities.

Prints the classic-pipeline headline as the FIRST JSON line on stdout,
then — by default — a second JSON line for the modern SGM route, so the
quality-stack path is tracked in the same run (the reference's time.sh
measures every binary, not just the fastest: test/time.sh:1-15).

  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform", "kind", "count"}, "card": "<name>, <limit> W",
   "batch": B, "peak_bytes_in_use": N}

The match route of the classic pipeline is the one the backend decision
point picks (utils/platform.implementation).  Each timed step consumes a
different input batch and is waited for with ``block_until_ready``.
The benchmark needs a GPU: without one it fails.

Baseline derivation (BASELINE.md): the reference's best configuration
(CUDA + ghost areas) runs a 1920x1080 pair in 0.2328 s (report/data.txt:4).
Rescaled to this benchmark's workload with the thesis's own pixel-pass
throughput model (test/make_graph.py:50-51: passes = 4*2 edge ops + D
matches + sw^2 box adds + 2D score/argmax + 1 winner + times diffusion +
3 finishing), i.e. from (2 073 600 px, D=30) to (1 048 576 px, D=64):

  t_base = 0.2328 * (1048576/2073600) * (677/575) = 0.13862 s
  baseline_fps = 7.214 pairs/s/GPU

Usage: python bench.py [--size 1024] [--disparities 64] [--batch B]
                       [--iters 3] [--mode ghost]
                       [--pipeline classic|sgm] [--no-sgm-line]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# Default batches per pipeline at 1024x1024, D=64.  The XLA SGM route
# keeps an int32 [H, W, D] volume plus one per direction alive (about
# 2.2 GB of device memory per pair at this size), so 16 pairs stay well
# inside the ~60 GB a JAX process takes of an 80 GB card; the classic
# pipeline's working set is a few planes per pair.  Peaks in PERF.md.
DEFAULT_BATCH = {"classic": 64, "sgm": 16}


def pixel_passes(d: int, sw: int, times: int) -> int:
    """The reference's per-pixel workload model (test/make_graph.py:51)."""
    return 4 * 2 + d + sw * sw + 2 * d + 1 + times + 3


def bench_pipeline(args, pipeline: str, batch: int, dev: dict,
                   card: str) -> dict:
    """Build, run, and time one pipeline; returns the metric JSON dict.
    All device buffers are scoped here so the next bench starts with a
    clean device memory footprint."""
    import jax
    import jax.numpy as jnp

    from stereomatching.config import BoundaryMode, ModernParams, StereoParams
    from stereomatching.models.classic import classic_forward_batched
    from stereomatching.models.modern import modern_forward
    from stereomatching.utils.platform import implementation

    params = StereoParams(
        num_shifts=args.disparities,
        mode=BoundaryMode(args.mode),
        edge_rule="exact",
    )
    h = w = args.size

    if pipeline == "sgm":
        mparams = ModernParams(
            num_disparities=args.disparities, aggregation="sgm",
            cost="census", sgm_directions=args.sgm_directions,
        )
        step = jax.jit(jax.vmap(lambda l, r: modern_forward(l, r, mparams)))
    else:
        fused = implementation("classic_match") == "fused"
        step = jax.jit(lambda l, r: classic_forward_batched(
            l, r, params, use_pallas=fused))

    # Distinct device-resident batches per timed iteration.
    rng = np.random.default_rng(0)
    n_batches = args.warmup + args.iters

    def make():
        pix = rng.integers(0, 256, (batch, h, w))
        if pipeline == "sgm":  # the modern pipeline takes pixels 0..255
            return jnp.asarray(pix.astype(np.int32))
        return jnp.asarray(pix.astype(np.float32) / np.float32(256.0))

    inputs = [(make(), make()) for _ in range(n_batches)]
    jax.block_until_ready(inputs)

    for left, right in inputs[: args.warmup]:
        jax.block_until_ready(step(left, right))
    t0 = time.perf_counter()
    for left, right in inputs[args.warmup :]:
        jax.block_until_ready(step(left, right))
    t1 = time.perf_counter()
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")

    pairs = batch * args.iters
    fps = pairs / (t1 - t0)
    base_t = (
        0.2328
        * ((h * w) / (1920 * 1080))
        * (
            pixel_passes(args.disparities, params.square_width, params.times)
            / pixel_passes(30, 21, 32)
        )
    )
    baseline_fps = 1.0 / base_t

    print(
        f"pipeline={pipeline} size={h}x{w} D={args.disparities} "
        f"batch={batch} iters={args.iters} "
        f"time/pair={(t1 - t0) / pairs * 1e3:.4f}ms "
        f"peak_bytes_in_use={peak} baseline={baseline_fps:.3f}fps",
        file=sys.stderr,
    )
    return {
        "metric": (
            f"stereo_pairs_per_sec_per_chip_{h}x{w}_"
            f"{args.disparities}d"
            + ("_sgm" if pipeline == "sgm" else "")
            + ("_8dir" if pipeline == "sgm"
               and args.sgm_directions == 8 else "")
        ),
        "value": fps,
        "unit": "pairs/s",
        "vs_baseline": fps / baseline_fps,
        "device": dev,
        "card": card,
        "batch": batch,
        "peak_bytes_in_use": peak,
    }


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--disparities", type=int, default=64)
    p.add_argument("--batch", type=int, default=None,
                   help=f"pairs per step (default {DEFAULT_BATCH})")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--mode", choices=["wrap", "ghost"], default="ghost")
    p.add_argument("--sgm-directions", type=int, default=4, choices=[4, 8],
                   help="sgm pipeline: aggregation path count")
    p.add_argument("--pipeline", choices=["classic", "sgm"], default="classic",
                   help="sgm benches the modern pipeline's Semi-Global "
                        "Matching route (census cost)")
    p.add_argument("--sgm-line", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="with --pipeline classic: also run the SGM route "
                        "and print its metric as a SECOND JSON line")
    args = p.parse_args()

    from stereomatching.utils.platform import (
        card_info,
        ensure_compile_cache,
        require_gpu,
    )

    card = card_info()
    dev = require_gpu()
    ensure_compile_cache()

    def batch_of(pipeline: str) -> int:
        return args.batch if args.batch is not None else DEFAULT_BATCH[pipeline]

    lines = [bench_pipeline(args, args.pipeline, batch_of(args.pipeline),
                            dev, card)]
    if args.pipeline == "classic" and args.sgm_line:
        lines.append(bench_pipeline(args, "sgm", batch_of("sgm"), dev, card))
    for line in lines:
        print(json.dumps(line))


if __name__ == "__main__":
    sys.exit(main())
