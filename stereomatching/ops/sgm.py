"""Semi-Global Matching cost aggregation (Hirschmüller 2005/2008), the
standard classical stereo aggregation, as XLA scans.

Each direction r accumulates

    L_r(p, d) = C(p, d) - min_d' L_r(p-r, d')
              + min( L_r(p-r, d),
                     L_r(p-r, d±1) + P1,
                     min_d' L_r(p-r, d') + P2 )

This is an inherently sequential recurrence along the scan direction but
fully parallel across the perpendicular axis AND the disparity axis, so
each direction is one ``lax.scan`` whose step does vector ops on an
[perp, D] plane — the compiler-friendly shape (no data-dependent
control flow, static shapes).  The default sums four directions (two
horizontal, two vertical) — the common embedded/GPU simplification.
``directions=8`` adds Hirschmüller's four diagonal paths: a diagonal is
the SAME row-wise scan as a vertical pass with the carry shifted one
column per row; cells with no in-image predecessor degenerate to
L = C, realized by shifting in an all-_BIG carry column (m = best =
_BIG makes the recurrence collapse to C exactly).

All arithmetic is int32 and exact; for the usual census costs
(<= 24 per pixel) the summed aggregate stays far below overflow.

Unlike the rest of the framework's fused scans, SGM *materializes* the
[H, W, D] cost volume (the recurrence needs random access along two
axes): at 1 MP x 64 disparities int32 that is 256 MB per volume, and
the route keeps one per direction besides — about 2.2 GB of device
memory per pair at that size (PERF.md), so size D and the batch
accordingly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_BIG = 2**28


def _directional(vol: jnp.ndarray, p1: int, p2: int) -> jnp.ndarray:
    """One left-to-right pass along axis 1.  vol [H, W, D] -> L [H, W, D]."""

    def step(carry, c_x):
        # carry, c_x: [H, D]
        m = carry.min(axis=-1, keepdims=True)
        up = jnp.pad(carry[:, 1:], ((0, 0), (0, 1)), constant_values=_BIG)
        dn = jnp.pad(carry[:, :-1], ((0, 0), (1, 0)), constant_values=_BIG)
        best = jnp.minimum(
            jnp.minimum(carry, jnp.minimum(up, dn) + p1), m + p2
        )
        out = c_x + best - m
        return out, out

    x_major = jnp.moveaxis(vol, 1, 0)  # [W, H, D]
    init = x_major[0]
    _, rest = jax.lax.scan(step, init, x_major[1:])
    out = jnp.concatenate([init[None], rest], axis=0)
    return jnp.moveaxis(out, 0, 1)


def _directional_diag(vol: jnp.ndarray, p1: int, p2: int, dx: int) -> jnp.ndarray:
    """One diagonal top-to-bottom pass with predecessor (y-1, x-dx).
    vol [H, W, D] -> L [H, W, D].  Identical step math to
    ``_directional``; the carry (the previous ROW's L, [W, D]) shifts
    by ``dx`` columns per row, and columns whose predecessor falls
    outside the image get an all-_BIG carry (m = best = _BIG collapses
    the step to L = C, the path-start value)."""

    def step(carry, c_row):
        # carry, c_row: [W, D]
        if dx == 1:
            shifted = jnp.pad(carry[:-1], ((1, 0), (0, 0)),
                              constant_values=_BIG)
        else:
            shifted = jnp.pad(carry[1:], ((0, 1), (0, 0)),
                              constant_values=_BIG)
        m = shifted.min(axis=-1, keepdims=True)
        up = jnp.pad(shifted[:, 1:], ((0, 0), (0, 1)), constant_values=_BIG)
        dn = jnp.pad(shifted[:, :-1], ((0, 0), (1, 0)), constant_values=_BIG)
        best = jnp.minimum(
            jnp.minimum(shifted, jnp.minimum(up, dn) + p1), m + p2
        )
        out = c_row + best - m
        return out, out

    init = vol[0]
    _, rest = jax.lax.scan(step, init, vol[1:])
    return jnp.concatenate([init[None], rest], axis=0)


def sgm_aggregate(
    vol: jnp.ndarray, p1: int = 8, p2: int = 96, directions: int = 4
) -> jnp.ndarray:
    """SGM aggregation of an int32 cost volume [H, W, D] -> int32, same
    shape.  ``directions``: 4 (left→right, right→left, top→bottom,
    bottom→top — the default) or 8 (adds the four diagonal paths).
    P1 penalizes ±1 disparity changes along a path, P2 larger jumps."""
    if p1 < 0 or p2 < p1:
        raise ValueError("need 0 <= p1 <= p2")
    if directions not in (4, 8):
        raise ValueError("directions must be 4 or 8")
    vol = vol.astype(jnp.int32)
    lr = _directional(vol, p1, p2)
    rl = jnp.flip(_directional(jnp.flip(vol, axis=1), p1, p2), axis=1)
    vol_t = jnp.swapaxes(vol, 0, 1)
    tb = jnp.swapaxes(_directional(vol_t, p1, p2), 0, 1)
    bt = jnp.swapaxes(
        jnp.flip(_directional(jnp.flip(vol_t, axis=1), p1, p2), axis=1), 0, 1
    )
    out = lr + rl + tb + bt
    if directions == 8:
        flip_y = lambda v: jnp.flip(v, axis=0)  # noqa: E731
        d1 = _directional_diag(vol, p1, p2, dx=1)  # r = (1, 1)
        d2 = _directional_diag(vol, p1, p2, dx=-1)  # r = (1, -1)
        # r = (-1, -1) / (-1, 1): bottom-to-top diagonals run as the
        # same top-to-bottom pass on the y-flipped volume.  r=(-1,-1)'s
        # predecessor (y+1, x+1) lands at (y'-1, x+1) after the flip,
        # i.e. dx=-1; r=(-1,1)'s (y+1, x-1) lands at (y'-1, x-1) = dx=1.
        d3 = flip_y(_directional_diag(flip_y(vol), p1, p2, dx=-1))
        d4 = flip_y(_directional_diag(flip_y(vol), p1, p2, dx=1))
        out = out + d1 + d2 + d3 + d4
    return out


def volume_argmin_subpixel(
    vol: jnp.ndarray, layout: str = "hwd", unroll: bool = False
):
    """First-minimum argmin over the disparity axis + parabola
    sub-pixel refine on the neighbors (the materialized-volume
    counterpart of ops/costvolume.argmin_subpixel_scan — and
    implemented BY it: a D-step scan of static channel slices).
    -> (disparity int32, subpixel f32, cost int32), each [H, W].

    ``layout``: "hwd" takes [H, W, D]; "dhw" takes the disparity-major
    [D, H, W], whose per-step slices are contiguous [H, W] planes
    (the last-axis slices of the hwd layout read at stride D).  Results
    are bit-identical.

    ``unroll``: static Python loop over D instead of a lax.scan — the
    scan round-trips six [H, W] carry planes through memory per step,
    the unrolled form fuses with on-chip carries (see
    ops/costvolume.argmin_subpixel_scan)."""
    from stereomatching.ops.costvolume import argmin_subpixel_scan

    if layout == "dhw":
        d_count, h, w = vol.shape

        def cost_at(d):
            return jax.lax.dynamic_index_in_dim(vol, d, axis=0,
                                                keepdims=False)
    else:
        h, w, d_count = vol.shape

        def cost_at(d):
            return jax.lax.dynamic_index_in_dim(vol, d, axis=-1,
                                                keepdims=False)

    res = argmin_subpixel_scan(cost_at, d_count, (h, w), unroll=unroll)
    return res.disparity, res.subpixel, res.cost


def second_best_outside_neighborhood(
    vol: jnp.ndarray, disp: jnp.ndarray, layout: str = "hwd"
) -> jnp.ndarray:
    """min over d with |d - disp| > 1 of the aggregated cost — the
    numerator of the uniqueness confidence c2 / c1 (OpenCV SGBM's
    uniquenessRatio test, neighborhood-excluded so the sub-pixel lobe
    around the winner does not count as a competitor).  A D-step
    unrolled pass of static slices (the volume-tail pattern of
    volume_argmin_subpixel); pixels where every disparity is excluded
    (D <= 3) keep the _BIG sentinel.  -> int32 [H, W]."""
    if layout == "dhw":
        d_count = vol.shape[0]
        slice_at = lambda d: vol[d]  # noqa: E731
    else:
        d_count = vol.shape[-1]
        slice_at = lambda d: vol[..., d]  # noqa: E731
    c2 = jnp.full(disp.shape, _BIG, jnp.int32)
    for d in range(d_count):
        c = slice_at(d).astype(jnp.int32)
        c2 = jnp.minimum(c2, jnp.where(jnp.abs(disp - d) <= 1, _BIG, c))
    return c2


def right_disparity_from_left_volume(
    vol: jnp.ndarray, layout: str = "hwd", unroll: bool = False
) -> jnp.ndarray:
    """Right-view disparity from the LEFT-referenced volume via the
    standard re-projection cost_R(x, d) = cost_L(x + d, d) (clamped) —
    avoids a second aggregation pass; used for LR consistency.
    Evaluated as a D-step scan (one static-size slice per disparity),
    not a gather.  -> int32 [H, W].  ``layout``/``unroll`` as in
    volume_argmin_subpixel."""
    if layout == "dhw":
        d_count, h, w = vol.shape
        ext = jnp.concatenate(
            [vol, jnp.repeat(vol[:, :, -1:], d_count, axis=2)], axis=2
        )

        def slice_at(d, zero):
            return jax.lax.dynamic_slice(ext, (d, zero, d), (1, h, w))[0]
    else:
        h, w, d_count = vol.shape
        # Edge-replicate x so x + d clamps to the last column.
        ext = jnp.concatenate(
            [vol, jnp.repeat(vol[:, -1:, :], d_count, axis=1)], axis=1
        )

        def slice_at(d, zero):
            return jax.lax.dynamic_slice(ext, (zero, d, d), (h, w, 1))[..., 0]

    def step(carry, d):
        best, best_d = carry
        # d is a Python int when unrolled (static slices) or a traced
        # int32 in the scan; the zero index must match d's dtype —
        # a literal 0 weak-types to int64 under JAX_ENABLE_X64 and
        # dynamic_slice rejects the mix.
        zero = 0 if isinstance(d, int) else jnp.zeros((), d.dtype)
        c = slice_at(d, zero)
        is_new = c < best
        return (jnp.where(is_new, c, best), jnp.where(is_new, d, best_d)), None

    init = (
        jnp.full((h, w), _BIG, vol.dtype),
        jnp.zeros((h, w), jnp.int32),
    )
    if unroll:
        carry = init
        for d in range(d_count):
            carry, _ = step(carry, d)
        return carry[1]
    (best, best_d), _ = jax.lax.scan(
        step, init, jnp.arange(d_count, dtype=jnp.int32)
    )
    del best
    return best_d
