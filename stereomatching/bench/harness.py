"""Timing harness.

Reference analogues:
  * ``time_jitted`` — the reference's self-timed ``algorithm()`` body
    (src/stereo.c:297-324), with warmup so compile time never pollutes
    the measurement (the reference has no JIT so it never needed this).
  * ``phase_timings`` — per-phase breakdown; the reference's debug
    builds imply phase costs only indirectly via artifact dumps.
  * ``size_sweep`` — test/time.sh:3-12's loop over the fixture sizes.
  * ``pixel_passes`` — the thesis throughput model
    (test/make_graph.py:50-51): per-pixel algorithmic workload, used to
    report "billion pixel-passes per second" comparable across sizes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from stereomatching.config import StereoParams


@dataclasses.dataclass
class BenchResult:
    name: str
    mean_s: float
    min_s: float
    std_s: float
    iters: int
    pixels: int = 0
    extra: Optional[Dict[str, float]] = None

    @property
    def pixels_per_s(self) -> float:
        return self.pixels / self.mean_s if self.pixels else 0.0

    def row(self) -> str:
        return (
            f"{self.name:<28} {self.mean_s * 1e3:9.3f} ms  "
            f"(min {self.min_s * 1e3:9.3f}, std {self.std_s * 1e3:7.3f})"
        )


def pixel_passes(params: StereoParams) -> int:
    """Per-pixel workload of one pipeline run (test/make_graph.py:51):
    4 edge ops x 2 images + D matches + sw^2 box adds + 2D score/argmax
    passes + 1 winner + `times` diffusion sweeps + 3 finishing passes."""
    return (
        4 * 2
        + params.num_shifts
        + params.square_width**2
        + params.num_shifts * 2
        + 1
        + params.times
        + 3
    )


def time_jitted(
    fn: Callable,
    args: Tuple,
    iters: int = 5,
    warmup: int = 2,
    name: str = "fn",
    pixels: int = 0,
) -> BenchResult:
    """Time a jitted callable with device-synchronized boundaries."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    arr = np.asarray(samples)
    return BenchResult(
        name=name,
        mean_s=float(arr.mean()),
        min_s=float(arr.min()),
        std_s=float(arr.std()),
        iters=iters,
        pixels=pixels,
    )


def phase_timings(
    left: np.ndarray,
    right: np.ndarray,
    params: StereoParams,
    iters: int = 5,
) -> List[BenchResult]:
    """Per-phase breakdown of the classic pipeline on one pair [H, W]
    of brightness planes, with the match route the backend decision
    point picks.  Each phase is jitted separately (so inter-phase
    fusion is intentionally disabled — the end-to-end time from
    ``time_jitted`` on the full pipeline will be faster)."""
    import jax
    import jax.numpy as jnp

    from stereomatching.models.classic import classic_forward
    from stereomatching.ops.argmax import match_and_score
    from stereomatching.ops.contour import draw_contour
    from stereomatching.ops.diffusion import fill_web_holes
    from stereomatching.ops.edges import find_edges
    from stereomatching.utils.platform import implementation

    use_pallas = implementation("classic_match") == "fused"
    h, w = left.shape
    px = h * w
    lb = jnp.asarray(left)
    rb = jnp.asarray(right)

    edges_fn = jax.jit(
        lambda a: find_edges(a, params.threshold, params.mode, params.edge_rule)
    )
    results = [time_jitted(edges_fn, (lb,), iters, name="edges (per image)", pixels=px)]

    el = edges_fn(lb)
    er = edges_fn(rb)
    if use_pallas:
        from stereomatching.ops.fused import match_and_score_fused

        ms_fn = jax.jit(lambda a, b: match_and_score_fused(a, b, params))
        ms_name = "match+box+argmax (fused)"
    else:
        ms_fn = jax.jit(lambda a, b: match_and_score(a, b, params))
        ms_name = "match+box+argmax (xla)"
    results.append(
        time_jitted(ms_fn, (el, er), iters, name=ms_name,
                    pixels=px * params.num_shifts)
    )

    _, winner = ms_fn(el, er)
    diff_fn = jax.jit(lambda wb: fill_web_holes(wb, params.times))
    results.append(
        time_jitted(diff_fn, (winner,), iters, name="diffusion",
                    pixels=px * max(params.times - 1, 0))
    )

    web = diff_fn(winner)
    cont_fn = jax.jit(lambda wb: draw_contour(wb, params.lines))
    results.append(time_jitted(cont_fn, (web,), iters, name="contour", pixels=px))

    e2e = jax.jit(
        lambda a, b: classic_forward(a, b, params, use_pallas=use_pallas)
    )
    results.append(
        time_jitted(e2e, (lb, rb), iters, name="end-to-end (fused)",
                    pixels=px * pixel_passes(params))
    )
    return results


def size_sweep(
    sizes: Sequence[Tuple[int, int]],
    params: StereoParams,
    iters: int = 3,
    seed: int = 0,
) -> List[BenchResult]:
    """The reference's size-sweep measurement (test/time.sh over
    test/imgs/{1..5}-WxH) on synthetic pairs of the given (H, W) sizes.
    Reports the thesis throughput model per size."""
    import jax
    import jax.numpy as jnp

    from stereomatching.models.classic import classic_forward
    from stereomatching.utils.platform import implementation

    use_pallas = implementation("classic_match") == "fused"
    rng = np.random.default_rng(seed)
    out = []
    for h, w in sizes:
        left = rng.integers(0, 256, size=(h, w)).astype(np.float32) / 256.0
        right = rng.integers(0, 256, size=(h, w)).astype(np.float32) / 256.0
        fn = jax.jit(lambda a, b: classic_forward(a, b, params, use_pallas=use_pallas))
        r = time_jitted(
            fn,
            (jnp.asarray(left), jnp.asarray(right)),
            iters,
            name=f"{w}x{h}",
            pixels=h * w * pixel_passes(params),
        )
        out.append(r)
    return out
