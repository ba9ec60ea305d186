"""The modern stereo pipeline: windowed SAD + LR consistency + sub-pixel
refine + optional multi-scale cost fusion.

The BASELINE.md north-star extension of the classic binary edge matcher:
same structure (one fused scan over disparities, no [D, H, W] volume in
device memory; see ops/costvolume.py), but matching 8-bit intensities
instead of binary edges, producing float sub-pixel disparity maps with a
validity channel.

All costs are exact int32 (absolute differences of integer pixel values,
integer box sums, integer pyramid weights), so integer disparities are
bit-identical on every backend/tier; only the final parabola offset and
the hole-filling diffusion are float32.

Multi-scale (scales=2) fuses a half-resolution cost pyramid: the cost of
disparity d adds ``coarse_weight`` x the upsampled aggregated cost of
disparity d//2 computed on 2x2-block-summed images — a static-shape
cost-volume-pyramid fusion (no data-dependent gathers, unlike classic
coarse-to-fine warping, so it maps cleanly onto XLA).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import jax
import jax.numpy as jnp

from stereomatching.config import ModernParams
from stereomatching.ops.costvolume import (
    DisparityResult,
    _aggregate,
    _extend_left,
    _extend_right,
    argmin_subpixel_scan,
    fill_invalid,
    lr_consistency,
)


def _downsample2(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 block sum (exact integer downsample); odd edges replicate."""
    h, w = img.shape
    img = jnp.pad(img, ((0, h % 2), (0, w % 2)), mode="edge")
    return (
        img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2] + img[1::2, 1::2]
    )


def _upsample2(img: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    return jnp.repeat(jnp.repeat(img, 2, axis=0), 2, axis=1)[:h, :w]


def _pixel_cost(params: ModernParams):
    """Per-pixel dissimilarity: SAD (|a-b| on intensities) or census
    Hamming distance (popcount of XORed census codes) — both exact
    int32."""
    if params.cost == "census":
        from stereomatching.ops.costvolume import popcount32

        return lambda a, b: popcount32(a ^ b)
    return lambda a, b: jnp.abs(a - b)


def _maybe_census(img: jnp.ndarray, params: ModernParams) -> jnp.ndarray:
    if params.cost == "census":
        from stereomatching.ops.costvolume import census_transform

        return census_transform(img, params.census_window)
    return img


def _cost_fn(
    ref: jnp.ndarray,
    other: jnp.ndarray,
    params: ModernParams,
    reference: str,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Build the per-disparity aggregated-cost callback for the scan."""
    h, w = ref.shape
    half = params.window // 2
    d_count = params.num_disparities
    extend = _extend_left if reference == "left" else _extend_right
    pcost = _pixel_cost(params)
    ref_t = _maybe_census(ref, params)
    other_ext = extend(_maybe_census(other, params), d_count)

    def window_at(ext, d, shape, count):
        offset = (count - d) if reference == "left" else d
        return jax.lax.dynamic_slice(
            ext, (jnp.zeros((), d.dtype), offset), shape
        )

    if params.scales == 1:
        def cost_at(d):
            win = window_at(other_ext, d, (h, w), d_count)
            return _aggregate(pcost(ref_t, win), half)

        return cost_at

    # scales == 2: half-res pyramid level, fused by integer weight.
    # The coarse level transforms (census) the downsampled intensities.
    ref_c = _maybe_census(_downsample2(ref), params)
    other_c = _maybe_census(_downsample2(other), params)
    hc, wc = ref_c.shape
    dc_count = -(-d_count // 2)
    other_c_ext = extend(other_c, dc_count)
    weight = jnp.int32(params.coarse_weight)

    def cost_at(d):
        win = window_at(other_ext, d, (h, w), d_count)
        fine = _aggregate(pcost(ref_t, win), half)
        win_c = window_at(other_c_ext, d // 2, (hc, wc), dc_count)
        coarse = _aggregate(pcost(ref_c, win_c), half)
        return fine + weight * _upsample2(coarse, h, w)

    return cost_at


def disparity_one_view(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: ModernParams,
    reference: str = "left",
) -> DisparityResult:
    """Fused disparity for one reference view; pixel planes are integer
    intensities 0..255, [H, W].  Left reference matches L(x) vs R(x-d);
    right reference matches R(x) vs L(x+d)."""
    if reference == "left":
        ref, other = left, right
    elif reference == "right":
        ref, other = right, left
    else:
        raise ValueError(reference)
    ref = ref.astype(jnp.int32)
    other = other.astype(jnp.int32)
    cost_at = _cost_fn(ref, other, params, reference)
    return argmin_subpixel_scan(cost_at, params.num_disparities, ref.shape)


def _sgm_volume(
    left: jnp.ndarray, right: jnp.ndarray, params: ModernParams
) -> jnp.ndarray:
    """Per-pixel cost volume for the SGM path -> int32 [H, W, D]."""
    ref = _maybe_census(left.astype(jnp.int32), params)
    other = _maybe_census(right.astype(jnp.int32), params)
    h, w = ref.shape
    d_count = params.num_disparities
    other_ext = _extend_left(other, d_count)
    pcost = _pixel_cost(params)

    coarse_arr = None
    if params.scales == 2:
        # Multi-scale fusion on the SGM route (SURVEY §7 step 6): add
        # coarse_weight x the upsampled HALF-RES per-pixel cost at d//2
        # — per-pixel (not window-aggregated like the box route's
        # pyramid) because SGM's own path aggregation supplies the
        # spatial support; the coarse level contributes a 2x2-pooled
        # matching prior that penalizes candidates inconsistent at the
        # coarser scale.  d-pairs share a coarse plane, so only
        # ceil(D/2) coarse planes are built.
        ref_c = _maybe_census(_downsample2(left.astype(jnp.int32)), params)
        other_c = _maybe_census(_downsample2(right.astype(jnp.int32)), params)
        hc, wc = ref_c.shape
        dc_count = -(-d_count // 2)
        oc_ext = _extend_left(other_c, dc_count)
        weight = jnp.int32(params.coarse_weight)
        coarse_arr = jnp.stack([
            weight * _upsample2(
                pcost(ref_c, oc_ext[:, dc_count - di : dc_count - di + wc]),
                h, w,
            )
            for di in range(dc_count)
        ])

    def cost_at(d):
        win = jax.lax.dynamic_slice(
            other_ext, (jnp.zeros((), d.dtype), d_count - d), (h, w)
        )
        c = pcost(ref, win)
        if coarse_arr is not None:
            c = c + coarse_arr[d // 2]
        return c

    vol = jax.vmap(cost_at)(jnp.arange(d_count, dtype=jnp.int32))  # [D, H, W]
    return jnp.moveaxis(vol, 0, -1)  # [H, W, D]


def _uniqueness_ratio(c2, c1):
    """Uniqueness confidence c2 / max(c1, 1) — the margin by which the
    winner beats its best out-of-neighborhood competitor (>= 1; higher
    is more confident; OpenCV SGBM thresholds this at ~1.1-1.15)."""
    return c2.astype(jnp.float32) / jnp.maximum(c1.astype(jnp.float32), 1.0)


def _fill(sub, valid, params: ModernParams):
    """Hole filling for LR-invalidated pixels, per params.fill_mode:
    diffusion (fill_invalid) or scanline background extension
    (ops/costvolume.fill_background — one associative_scan)."""
    if params.fill_mode == "background":
        from stereomatching.ops.costvolume import fill_background

        return fill_background(sub, valid)
    return fill_invalid(sub, valid, params.fill_iterations)


def _sgm_tail(agg: jnp.ndarray, params: ModernParams) -> Dict[str, jnp.ndarray]:
    """Aggregated volume [H, W, D] -> the SGM result dict (argmin +
    sub-pixel, right-view re-projection, LR validity, hole fill)."""
    from stereomatching.ops.costvolume import median3x3
    from stereomatching.ops.sgm import (
        right_disparity_from_left_volume,
        second_best_outside_neighborhood,
        volume_argmin_subpixel,
    )

    disp, sub, cost = volume_argmin_subpixel(agg)
    dr = right_disparity_from_left_volume(agg)
    uniq = None
    if params.uniqueness:
        uniq = _uniqueness_ratio(
            second_best_outside_neighborhood(agg, disp), cost
        )
    if params.median_filter:
        # 3x3 median on the left disparity/sub-pixel planes and the
        # re-projected right view BEFORE LR consistency (the box
        # route's hook).
        disp, sub, dr = median3x3(disp), median3x3(sub), median3x3(dr)
    valid = lr_consistency(disp, dr, params.lr_max_diff, params.num_disparities)
    out = {
        "disparity": disp,
        "subpixel": sub,
        "disparity_right": dr,
        "valid": valid,
        "filled": _fill(sub, valid, params),
        "cost": cost,
    }
    if uniq is not None:
        out["uniqueness"] = uniq
    return out


def _sgm_forward(
    left: jnp.ndarray, right: jnp.ndarray, params: ModernParams
) -> Dict[str, jnp.ndarray]:
    """SGM path: per-pixel costs (no window), materialized [H, W, D]
    volume, 4- or 8-direction semi-global aggregation, volume argmin +
    sub-pixel, right disparity via the standard volume re-projection."""
    from stereomatching.ops.sgm import sgm_aggregate

    vol = _sgm_volume(left, right, params)
    agg = sgm_aggregate(vol, params.sgm_p1, params.sgm_p2,
                        directions=params.sgm_directions)
    return _sgm_tail(agg, params)


def modern_forward(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: ModernParams,
) -> Dict[str, jnp.ndarray]:
    """Full modern pipeline on one pair of integer intensity planes
    [H, W] (uint8 pixel values; pass ``pixels`` not brightness).

    Returns: disparity (int32), subpixel (f32), disparity_right (int32),
    valid (bool, LR-consistent), filled (f32: subpixel with invalid
    pixels diffused from valid neighbors), cost (int32 at the winner).
    """
    if params.aggregation == "sgm":
        return _sgm_forward(left, right, params)
    dl = disparity_one_view(left, right, params, "left")
    dr = disparity_one_view(left, right, params, "right")
    if params.median_filter:
        from stereomatching.ops.costvolume import median3x3

        dl = dl._replace(disparity=median3x3(dl.disparity),
                         subpixel=median3x3(dl.subpixel))
        dr = dr._replace(disparity=median3x3(dr.disparity))
    valid = lr_consistency(dl.disparity, dr.disparity, params.lr_max_diff,
                           params.num_disparities)
    return {
        "disparity": dl.disparity,
        "subpixel": dl.subpixel,
        "disparity_right": dr.disparity,
        "valid": valid,
        "filled": _fill(dl.subpixel, valid, params),
        "cost": dl.cost,
    }


def build_modern_pipeline(
    params: ModernParams, batched: bool = False
) -> Callable[[jnp.ndarray, jnp.ndarray], Dict[str, jnp.ndarray]]:
    """Jitted pipeline for fixed params; ``batched`` maps it over a
    leading pairs axis [B, H, W]."""
    fn = functools.partial(modern_forward, params=params)
    if batched:
        fn = jax.vmap(fn)
    return jax.jit(fn)
