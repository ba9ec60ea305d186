"""The modern pipeline (SAD/census + LR + sub-pixel + hole fill) sharded
over a (data, rows) mesh — the scaled-out tier of models/modern.py.

Same decomposition as the classic sharded tier (parallel/pipeline.py):
batches shard over "data", image rows over "rows", every y dependency is
one ppermute halo exchange of exactly its reach (the reference's
halo-width rule, src/stereo-ghost.c:11-12), and every x dependency (the
disparity slide, the box window's x reach, LR consistency — which only
looks along scanlines) stays intra-shard because W is unsharded.

  phase                       y-reach           exchange
  census transform            census_window//2  fused into the pixel
  cost box filter             window//2         exchange (reach = sum)
  LR consistency              0 (x-only)        none
  median filter (optional)    1 row             once, on 3 planes
  hole-fill diffusion         1 row             per Jacobi step

Boundary semantics are baked into the exchanged blocks so the per-shard
compute is position-independent:

  * census reads edge-REPLICATED pixels at the global y boundary
    (ops/costvolume.census_transform pads mode="edge"), so boundary
    shards overwrite their outer pixel halo with their edge row;
  * cost contributions from out-of-global rows are ZERO (the zero-padded
    aggregation of ops/costvolume._aggregate), realized by zeroing the
    out-of-global rows of the cost-input blocks AFTER the census
    transform: SAD |0-0| and census popcount(0^0) vanish identically,
    so the per-shard scan needs no validity mask.

Bit-identical to the single-chip tier for every mesh shape (tests/
test_sharded_modern.py).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from stereomatching.config import ModernParams
from stereomatching.ops.costvolume import (
    _aggregate,
    _extend_left,
    _extend_right,
    argmin_subpixel_scan,
)
from stereomatching.parallel.halo import (
    exchange_col_halo,
    with_col_halo,
    with_row_halo,
)
from stereomatching.parallel.mesh import (
    COLS_AXIS,
    DATA_AXIS,
    ROWS_AXIS,
    mesh_cols,
)


def _cost_reach(params: ModernParams) -> int:
    """y halo needed by the cost phase: box window half plus the census
    neighborhood half (0 for SAD)."""
    ch = params.census_window // 2 if params.cost == "census" else 0
    return params.window // 2 + ch


def _prepare_cost_blocks(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: ModernParams,
    n_rows: int,
):
    """Exchange pixel halos and produce the two cost-input blocks
    [bl, hs + 2*half, W] (census codes or raw intensities) with the
    global boundary semantics baked in (edge-replicated census inputs,
    zeroed out-of-global rows).  Runs inside shard_map."""
    bl, hs, w = left.shape
    half = params.window // 2
    ch = params.census_window // 2 if params.cost == "census" else 0
    reach = half + ch
    ax = ROWS_AXIS

    if reach == 0:
        lx, rx = left, right
    else:
        lx = with_row_halo(left, reach, ax, n_rows, circular=False)
        rx = with_row_halo(right, reach, ax, n_rows, circular=False)

    # Global row index of every block row; boundary shards replicate
    # their edge row into out-of-global halo rows (census edge padding).
    idx = jax.lax.axis_index(ax)
    g = idx * hs + jnp.arange(-reach, hs + reach)
    g_col = g[None, :, None]
    h_global = n_rows * hs
    if ch > 0:
        first = lambda x: x[:, reach : reach + 1, :]  # noqa: E731
        last = lambda x: x[:, reach + hs - 1 : reach + hs, :]  # noqa: E731
        lx = jnp.where(g_col < 0, first(lx), lx)
        lx = jnp.where(g_col >= h_global, last(lx), lx)
        rx = jnp.where(g_col < 0, first(rx), rx)
        rx = jnp.where(g_col >= h_global, last(rx), rx)

    if params.cost == "census":
        from stereomatching.ops.costvolume import census_transform

        tf = jax.vmap(lambda x: census_transform(x, params.census_window))
        lx, rx = tf(lx), tf(rx)
        if ch > 0:  # trim the census-neighborhood margin
            lx = lx[:, ch : ch + hs + 2 * half, :]
            rx = rx[:, ch : ch + hs + 2 * half, :]
            g_col = g_col[:, ch : ch + hs + 2 * half, :]

    # Out-of-global rows contribute zero cost: zero them (both views).
    in_frame = (g_col >= 0) & (g_col < h_global)
    lx = jnp.where(in_frame, lx, 0)
    rx = jnp.where(in_frame, rx, 0)
    return lx, rx


def _prepare_cost_blocks_2d(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: ModernParams,
    n_rows: int,
    n_cols: int,
):
    """2-D twin of _prepare_cost_blocks: pixel halos in BOTH axes.

    x halo = num_disparities + window//2 (the slide's reach plus the
    box window — the reference's x-ghost rule scaled to the modern
    pipeline), y halo = window//2; the census margin rides on top of
    both.  Boundary semantics, matching the single-chip ops exactly:
      * out-of-global raw pixels replicate the global edge (the
        census_transform mode="edge" pad), rows first then cols so
        corners replicate the corner pixel;
      * out-of-global CODE columns are then overwritten with the
        global edge code column — the _extend_left/_extend_right
        clamp operates on census CODES, which is NOT the same as the
        code computed at a replicated-pixel position;
      * cost positions outside the global image contribute ZERO to the
        box sums (the _aggregate zero pad), enforced by the returned
        position-validity mask (the 2-D route masks the cost plane
        explicitly instead of the rows-only route's zero-input trick,
        because the slide misaligns input zeros across the x
        boundary).
    -> (lx, rx, valid) with blocks [bl, hs + 2*yh, ws + 2*xh] and
    ``valid`` a [1, hs + 2*yh, ws + 2*xh] bool position mask."""
    bl, hs, ws = left.shape
    half = params.window // 2
    ch = params.census_window // 2 if params.cost == "census" else 0
    yh = half
    xh = half + params.num_disparities
    rax, cax = ROWS_AXIS, COLS_AXIS

    def ext2d(x, ry, rx_):
        x = with_col_halo(x, rx_, cax, n_cols, circular=False)
        return with_row_halo(x, ry, rax, n_rows, circular=False)

    lx = ext2d(left, yh + ch, xh + ch)
    rx = ext2d(right, yh + ch, xh + ch)

    ridx = jax.lax.axis_index(rax)
    cidx = jax.lax.axis_index(cax)
    g_r = (ridx * hs + jnp.arange(-yh - ch, hs + yh + ch))[None, :, None]
    g_c = (cidx * ws + jnp.arange(-xh - ch, ws + xh + ch))[None, None, :]
    h_g, w_g = n_rows * hs, n_cols * ws

    def edge_replicate(x):
        first_r = x[:, yh + ch : yh + ch + 1, :]
        last_r = x[:, yh + ch + hs - 1 : yh + ch + hs, :]
        x = jnp.where(g_r < 0, first_r, x)
        x = jnp.where(g_r >= h_g, last_r, x)
        first_c = x[:, :, xh + ch : xh + ch + 1]
        last_c = x[:, :, xh + ch + ws - 1 : xh + ch + ws]
        x = jnp.where(g_c < 0, first_c, x)
        x = jnp.where(g_c >= w_g, last_c, x)
        return x

    if ch > 0:
        lx, rx = edge_replicate(lx), edge_replicate(rx)
        from stereomatching.ops.costvolume import census_transform

        tf = jax.vmap(lambda p: census_transform(p, params.census_window))
        lx, rx = tf(lx), tf(rx)
        lx = lx[:, ch:-ch, ch:-ch]
        rx = rx[:, ch:-ch, ch:-ch]
        g_r = g_r[:, ch:-ch, :]
        g_c = g_c[:, :, ch:-ch]

    # Code-level clamp at the global x boundary (the extend semantics).
    first_c = lambda x: x[:, :, xh : xh + 1]  # noqa: E731
    last_c = lambda x: x[:, :, xh + ws - 1 : xh + ws]  # noqa: E731
    lx = jnp.where(g_c < 0, first_c(lx), lx)
    lx = jnp.where(g_c >= w_g, last_c(lx), lx)
    rx = jnp.where(g_c < 0, first_c(rx), rx)
    rx = jnp.where(g_c >= w_g, last_c(rx), rx)

    valid = (g_r >= 0) & (g_r < h_g) & (g_c >= 0) & (g_c < w_g)
    return lx, rx, valid


def _disparity_block_xla_2d(
    ref: jnp.ndarray,
    oth: jnp.ndarray,
    valid: jnp.ndarray,
    params: ModernParams,
    reference: str,
    hs: int,
    ws: int,
):
    """One-view fused disparity scan on 2-D halo blocks
    [hs + 2*half, ws + 2*xh] -> DisparityResult on the [hs, ws] core
    (the column-sharded form of _disparity_block_xla: the slide reads
    the x halo instead of a local extend, and out-of-global cost
    positions are masked to zero — the _aggregate pad)."""
    from stereomatching.models.modern import _pixel_cost

    half = params.window // 2
    d_count = params.num_disparities
    xh = half + d_count
    h_blk = ref.shape[0]
    wc = ws + 2 * half
    p0 = xh - half
    pcost = _pixel_cost(params)
    ref_c = jax.lax.slice_in_dim(ref, p0, p0 + wc, axis=-1)
    valid_c = jax.lax.slice_in_dim(valid, p0, p0 + wc, axis=-1)

    def cost_at(d):
        off = p0 + d if reference == "right" else p0 - d
        win = jax.lax.dynamic_slice(
            oth, (jnp.zeros((), d.dtype), off), (h_blk, wc)
        )
        cost = jnp.where(valid_c, pcost(ref_c, win), 0)
        agg = _aggregate(cost, half)
        return jax.lax.slice_in_dim(
            jax.lax.slice_in_dim(agg, half, half + hs, axis=0),
            half, half + ws, axis=1,
        )

    return argmin_subpixel_scan(cost_at, d_count, (hs, ws))


def _lr_sharded_cols(dl, dr, params: ModernParams, n_cols: int):
    """lr_consistency with the right-view lookup's x reach (dL(x) <=
    num_disparities) satisfied by a LEFT column halo; the global-left
    boundary holds the single-chip out-of-frame sentinel (2^20 — never
    within max_diff)."""
    big = 2**20
    d_count = params.num_disparities
    halo, _ = exchange_col_halo(dr, d_count, COLS_AXIS, n_cols,
                                circular=False, fill=big)
    dr_ext = jnp.concatenate([halo, dr], axis=-1)
    ws = dl.shape[-1]
    valid = jnp.zeros(dl.shape, bool)
    for d in range(d_count):
        dr_shift = dr_ext[..., d_count - d : d_count - d + ws]
        valid = valid | (
            (dl == d) & (jnp.abs(dr_shift - d) <= params.lr_max_diff)
        )
    return valid


def _disparity_block_xla(
    ref: jnp.ndarray,
    oth: jnp.ndarray,
    params: ModernParams,
    reference: str,
    hs: int,
):
    """One-view fused disparity scan on one [hs + 2*half, W] cost-input
    block -> DisparityResult on the [hs, W] core rows (the per-shard
    form of models/modern._cost_fn + argmin_subpixel_scan)."""
    from stereomatching.models.modern import _pixel_cost

    h_blk, w = ref.shape
    half = params.window // 2
    d_count = params.num_disparities
    extend = _extend_left if reference == "left" else _extend_right
    oth_ext = extend(oth, d_count)
    pcost = _pixel_cost(params)

    def cost_at(d):
        offset = (d_count - d) if reference == "left" else d
        win = jax.lax.dynamic_slice(
            oth_ext, (jnp.zeros((), d.dtype), offset), (h_blk, w)
        )
        agg = _aggregate(pcost(ref, win), half)
        return jax.lax.slice_in_dim(agg, half, half + hs, axis=0)

    return argmin_subpixel_scan(cost_at, d_count, (hs, w))


def _median_sharded(plane: jnp.ndarray, n_rows: int,
                    n_cols: int = 1, has_cols: bool = False) -> jnp.ndarray:
    """3x3 median with a 1-px exchange per sharded spatial axis; global
    boundaries replicate (median3x3 pads mode="edge")."""
    from stereomatching.ops.costvolume import median3x3

    bl, hs, w = plane.shape
    ext = with_row_halo(plane, 1, ROWS_AXIS, n_rows, circular=False)
    idx = jax.lax.axis_index(ROWS_AXIS)
    top = jnp.where(idx == 0, ext[:, 1:2, :], ext[:, 0:1, :])
    bot = jnp.where(
        idx == n_rows - 1, ext[:, hs : hs + 1, :], ext[:, hs + 1 : hs + 2, :]
    )
    ext = jnp.concatenate([top, plane, bot], axis=1)
    if has_cols:
        cext = with_col_halo(ext, 1, COLS_AXIS, n_cols, circular=False)
        cidx = jax.lax.axis_index(COLS_AXIS)
        lcol = jnp.where(cidx == 0, cext[:, :, 1:2], cext[:, :, 0:1])
        rcol = jnp.where(
            cidx == n_cols - 1, cext[:, :, w : w + 1],
            cext[:, :, w + 1 : w + 2],
        )
        ext = jnp.concatenate([lcol, ext, rcol], axis=-1)
        out = jax.vmap(median3x3)(ext)
        return out[:, 1 : 1 + hs, 1 : 1 + w]
    # median3x3 pads x edge-replicated (W whole) and y edge-replicated —
    # the y pad duplicates our halo rows, whose windows are sliced away.
    out = jax.vmap(median3x3)(ext)
    return out[:, 1 : 1 + hs, :]


def _fill_sharded(sub, valid, params, n_rows, n_cols=1, has_cols=False):
    """fill_mode dispatch for the sharded routes: background extension
    is x-only (intra-shard — one vmapped associative_scan, no exchange;
    requires cols=1, enforced at entry); diffusion runs the per-step
    1-px halo exchange on each sharded spatial axis."""
    if params.fill_mode == "background":
        from stereomatching.ops.costvolume import fill_background

        return jax.vmap(fill_background)(sub, valid)
    return _fill_invalid_sharded(sub, valid, params.fill_iterations,
                                 n_rows, n_cols, has_cols)


def _fill_invalid_sharded(
    disparity: jnp.ndarray,
    valid: jnp.ndarray,
    iterations: int,
    n_rows: int,
    n_cols: int = 1,
    has_cols: bool = False,
) -> jnp.ndarray:
    """ops/costvolume.fill_invalid with a per-step 1-px halo exchange
    per sharded spatial axis (zero fill at the global boundary == the
    single-chip zero pad)."""
    d = disparity.astype(jnp.float32)
    v = valid.astype(jnp.float32)
    bl, hs, w = d.shape

    def one(state, _):
        d, v = state
        dv = d * v
        # One exchange per step per axis: stack the two planes, ship
        # one strip.
        both = jnp.stack([dv, v])  # [2, bl, hs, W]
        ext = with_row_halo(both, 1, ROWS_AXIS, n_rows, circular=False)
        if has_cols:
            ext = with_col_halo(ext, 1, COLS_AXIS, n_cols,
                                circular=False)
            dv_e, v_e = ext[0], ext[1]  # [bl, hs+2, W+2]

            def neigh(x_e):
                return (
                    x_e[:, 1:-1, 2:]
                    + x_e[:, 1:-1, :-2]
                    + x_e[:, 2:, 1:-1]
                    + x_e[:, :-2, 1:-1]
                )

            num = neigh(dv_e)
            den = neigh(v_e)
        else:
            dv_e, v_e = ext[0], ext[1]  # [bl, hs+2, W]

            def neigh(x_e, x):
                return (
                    jnp.pad(x[:, :, 1:], ((0, 0), (0, 0), (0, 1)))
                    + jnp.pad(x[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
                    + x_e[:, 2:, :]
                    + x_e[:, :-2, :]
                )

            num = neigh(dv_e, dv)
            den = neigh(v_e, v)
        avg = num / jnp.maximum(den, 1.0)
        newly = (v == 0) & (den > 0)
        return (jnp.where(newly, avg, d), jnp.where(newly, 1.0, v)), None

    (d, _), _ = jax.lax.scan(one, (d, v), None, length=iterations)
    return d


def _sgm_step(carry, c, p1: int, p2: int):
    """One SGM recurrence step on [..., D] planes — the same operations
    in the same order as ops/sgm._directional's scan body, so a sharded
    scan seeded with the previous shard's carry is bit-identical to the
    single-chip scan."""
    big = 2**28  # ops/sgm._BIG
    pad0 = [(0, 0)] * (carry.ndim - 1)
    m = carry.min(axis=-1, keepdims=True)
    up = jnp.pad(carry[..., 1:], pad0 + [(0, 1)], constant_values=big)
    dn = jnp.pad(carry[..., :-1], pad0 + [(1, 0)], constant_values=big)
    best = jnp.minimum(jnp.minimum(carry, jnp.minimum(up, dn) + p1), m + p2)
    return c + best - m


def _shift_x(carry, dx: int):
    """Shift a [..., W, D] carry by ``dx`` columns (diagonal paths:
    predecessor (y-1, x-dx)); columns whose predecessor falls outside
    the image take an all-_BIG plane, collapsing the step to L = C —
    exactly ops/sgm._directional_diag's padding."""
    big = 2**28
    pad0 = [(0, 0)] * (carry.ndim - 2)
    if dx == 1:
        return jnp.pad(carry[..., :-1, :], pad0 + [(1, 0), (0, 0)],
                       constant_values=big)
    return jnp.pad(carry[..., 1:, :], pad0 + [(0, 1), (0, 0)],
                   constant_values=big)


def _sgm_local_pass(rows, seed, seeded: bool, p1: int, p2: int, dx: int = 0):
    """Directional SGM over this shard's rows [hs, ...inner..., D] in
    processing order.  ``seeded``: continue from the previous shard's
    carry (``seed``); else the first row initializes the recurrence
    (ops/sgm._directional's init).  ``dx``: diagonal paths shift the
    carry (including the cross-shard seed) one column per row.
    -> (L rows, final carry; the carry is UNSHIFTED — the consumer
    shifts at consumption, so shard hand-off is position-agnostic)."""
    first = rows[0]
    shift = (lambda c: _shift_x(c, dx)) if dx else (lambda c: c)
    init = _sgm_step(shift(seed), first, p1, p2) if seeded else first
    if rows.shape[0] > 1:
        def step(carry, c):
            out = _sgm_step(shift(carry), c, p1, p2)
            return out, out

        _, rest = jax.lax.scan(step, init, rows[1:])
        out = jnp.concatenate([init[None], rest], axis=0)
    else:
        out = init[None]
    return out, out[-1]


def _sgm_vertical_sharded(vol, p1: int, p2: int, n_rows: int,
                          dx_tb: int = 0, dx_bt: int = 0):
    """Both y-crossing SGM passes over a row-sharded volume.  ``vol``:
    local [bl, hs, W, D] block.  -> (top_down, bottom_up), same shape,
    bit-identical to the unsharded scans.  ``dx_tb``/``dx_bt``: carry
    column shift per row for DIAGONAL paths (0 = the vertical pair);
    the shift is intra-shard, so diagonals shard exactly like
    verticals.

    The y recurrence crosses shard boundaries, so the passes run as
    ``n_rows`` phases with a [bl, W, D] carry handed to the next shard
    by ppermute: in phase j, shard j runs its top->bottom strip while
    shard n-1-j runs bottom->up — the two directions overlap on distinct
    shards, so both together cost about ONE global-height scan of
    wall-clock (plus (n-1) carry hops), regardless of n.  This is the
    honest scaling of an inherently sequential recurrence; the
    horizontal passes and the rest of the pipeline scale ~n x."""
    rows_tb = jnp.moveaxis(vol, 1, 0)  # [hs, bl, W, D]
    rows_bt = rows_tb[::-1]
    my = jax.lax.axis_index(ROWS_AXIS)

    zero_carry = jnp.zeros_like(rows_tb[0])
    out_tb = jnp.zeros_like(rows_tb)
    out_bt = jnp.zeros_like(rows_tb)
    carry_tb = seed_tb = zero_carry
    carry_bt = seed_bt = zero_carry
    for j in range(n_rows):
        seeded = j > 0

        def run_tb(out, carry, seed):
            del out, carry
            return _sgm_local_pass(rows_tb, seed, seeded, p1, p2, dx=dx_tb)

        def run_bt(out, carry, seed):
            del out, carry
            return _sgm_local_pass(rows_bt, seed, seeded, p1, p2, dx=dx_bt)

        keep = lambda out, carry, seed: (out, carry)  # noqa: E731
        out_tb, carry_tb = jax.lax.cond(
            my == j, run_tb, keep, out_tb, carry_tb, seed_tb
        )
        out_bt, carry_bt = jax.lax.cond(
            my == n_rows - 1 - j, run_bt, keep, out_bt, carry_bt, seed_bt
        )
        if j < n_rows - 1:
            down = [(i, i + 1) for i in range(n_rows - 1)]
            up = [(i, i - 1) for i in range(1, n_rows)]
            seed_tb = jax.lax.ppermute(carry_tb, ROWS_AXIS, down)
            seed_bt = jax.lax.ppermute(carry_bt, ROWS_AXIS, up)

    tb = jnp.moveaxis(out_tb, 0, 1)
    bt = jnp.moveaxis(out_bt[::-1], 0, 1)
    return tb, bt


def _census_blocks_sgm(left, right, params: ModernParams, n_rows: int):
    """Cost-input planes for the sharded SGM path: census codes (with a
    census-window halo exchange and edge-replicated global boundaries,
    matching the single-chip census_transform's mode="edge" pad) or the
    raw intensities for SAD.  -> two [bl, hs, W] int32 blocks."""
    if params.cost != "census":
        return left, right
    from stereomatching.ops.costvolume import census_transform

    bl, hs, w = left.shape
    ch = params.census_window // 2
    ax = ROWS_AXIS
    idx = jax.lax.axis_index(ax)
    g_col = (idx * hs + jnp.arange(-ch, hs + ch))[None, :, None]
    h_global = n_rows * hs

    def prep(x):
        ext = with_row_halo(x, ch, ax, n_rows, circular=False)
        ext = jnp.where(g_col < 0, ext[:, ch : ch + 1, :], ext)
        ext = jnp.where(g_col >= h_global, ext[:, ch + hs - 1 : ch + hs, :], ext)
        tf = jax.vmap(lambda p: census_transform(p, params.census_window))
        return tf(ext)[:, ch : ch + hs, :]

    return prep(left), prep(right)


def _sgm_shard_forward(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: ModernParams,
    n_rows: int,
) -> Dict[str, jnp.ndarray]:
    """Per-shard SGM path (models/modern._sgm_forward sharded over rows).
    The horizontal recurrences, the volume argmin, the right-view
    re-projection, and LR consistency are all x-only and stay
    intra-shard; the vertical recurrences run as a phased carry chain
    (_sgm_vertical_sharded)."""
    from stereomatching.models.modern import _pixel_cost
    from stereomatching.ops.costvolume import lr_consistency
    from stereomatching.ops.sgm import (
        _directional,
        right_disparity_from_left_volume,
        volume_argmin_subpixel,
    )

    bl, hs, w = left.shape
    d_count = params.num_disparities
    p1, p2 = params.sgm_p1, params.sgm_p2
    ref, other = _census_blocks_sgm(
        left.astype(jnp.int32), right.astype(jnp.int32), params, n_rows
    )
    pcost = _pixel_cost(params)
    other_ext = jax.vmap(lambda o: _extend_left(o, d_count))(other)

    def cost_at(d):
        zero = jnp.zeros((), d.dtype)
        win = jax.lax.dynamic_slice(
            other_ext, (zero, zero, d_count - d), (bl, hs, w)
        )
        return pcost(ref, win)

    vol = jax.vmap(cost_at)(jnp.arange(d_count, dtype=jnp.int32))
    vol = jnp.moveaxis(vol, 0, -1)  # [bl, hs, W, D]

    lr_pass = jax.vmap(lambda v: _directional(v, p1, p2))(vol)
    rl_pass = jnp.flip(
        jax.vmap(lambda v: _directional(v, p1, p2))(jnp.flip(vol, axis=2)),
        axis=2,
    )
    tb_pass, bt_pass = _sgm_vertical_sharded(vol, p1, p2, n_rows)
    agg = lr_pass + rl_pass + tb_pass + bt_pass
    if params.sgm_directions == 8:
        # Diagonal paths: the carry shift is x-only (intra-shard), so
        # each diagonal pair runs the same phased chain as the
        # verticals.  dx pairs mirror ops/sgm.sgm_aggregate: r=(1,1)
        # with r=(-1,-1) (tb dx=1 / bt dx=-1), r=(1,-1) with r=(-1,1).
        d1, d3 = _sgm_vertical_sharded(vol, p1, p2, n_rows,
                                       dx_tb=1, dx_bt=-1)
        d2, d4 = _sgm_vertical_sharded(vol, p1, p2, n_rows,
                                       dx_tb=-1, dx_bt=1)
        agg = agg + d1 + d2 + d3 + d4

    disp, sub, cost = jax.vmap(volume_argmin_subpixel)(agg)
    dr = jax.vmap(right_disparity_from_left_volume)(agg)
    uniq = None
    if params.uniqueness:
        # x/D-only like the argmin: intra-shard, no exchange.
        from stereomatching.models.modern import _uniqueness_ratio
        from stereomatching.ops.sgm import (
            second_best_outside_neighborhood,
        )

        uniq = _uniqueness_ratio(
            jax.vmap(second_best_outside_neighborhood)(agg, disp), cost
        )
    if params.median_filter:
        # The single-chip SGM routes' median hook
        # (models/modern._maybe_median), with the 1-row halo exchange.
        disp = _median_sharded(disp, n_rows)
        sub = _median_sharded(sub, n_rows)
        dr = _median_sharded(dr, n_rows)
    valid = jax.vmap(
        functools.partial(
            lr_consistency,
            max_diff=params.lr_max_diff,
            num_disparities=d_count,
        )
    )(disp, dr)
    filled = _fill_sharded(sub, valid, params, n_rows)
    out = {
        "disparity": disp,
        "subpixel": sub,
        "disparity_right": dr,
        "valid": valid,
        "filled": filled,
        "cost": cost,
    }
    if uniq is not None:
        out["uniqueness"] = uniq
    return out


def _modern_shard_forward_2d(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: ModernParams,
    n_rows: int,
    n_cols: int,
) -> Dict[str, jnp.ndarray]:
    """Per-shard body for 2-D (rows x cols) spatial meshes — box
    aggregation on a masked cost (the rows-only route's zero-input
    boundary trick does not survive the slide's x-boundary
    misalignment).  Bit-identical to the single-chip tier
    (tests/test_sharded_modern.py)."""
    bl, hs, ws = left.shape
    lx, rx, valid = _prepare_cost_blocks_2d(
        left.astype(jnp.int32), right.astype(jnp.int32), params,
        n_rows, n_cols,
    )
    vmask = valid[0]
    fl = jax.vmap(
        lambda a, b: _disparity_block_xla_2d(a, b, vmask, params,
                                             "left", hs, ws)
    )
    fr = jax.vmap(
        lambda a, b: _disparity_block_xla_2d(b, a, vmask, params,
                                             "right", hs, ws)
    )
    dl = fl(lx, rx)
    dr = fr(lx, rx)

    if params.median_filter:
        med = functools.partial(_median_sharded, n_rows=n_rows,
                                n_cols=n_cols, has_cols=True)
        dl = dl._replace(disparity=med(dl.disparity),
                         subpixel=med(dl.subpixel))
        dr = dr._replace(disparity=med(dr.disparity))

    valid_lr = _lr_sharded_cols(dl.disparity, dr.disparity, params,
                                n_cols)
    filled = _fill_sharded(dl.subpixel, valid_lr, params, n_rows,
                           n_cols, has_cols=True)
    return {
        "disparity": dl.disparity,
        "subpixel": dl.subpixel,
        "disparity_right": dr.disparity,
        "valid": valid_lr,
        "filled": filled,
        "cost": dl.cost,
    }


def _modern_shard_forward(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: ModernParams,
    n_rows: int,
) -> Dict[str, jnp.ndarray]:
    """Per-shard body.  left/right: [bl, hs, W] int32 pixel blocks."""
    from stereomatching.ops.costvolume import lr_consistency

    bl, hs, w = left.shape
    lx, rx = _prepare_cost_blocks(
        left.astype(jnp.int32), right.astype(jnp.int32), params, n_rows
    )

    fl = jax.vmap(
        lambda a, b: _disparity_block_xla(a, b, params, "left", hs)
    )
    fr = jax.vmap(
        lambda a, b: _disparity_block_xla(b, a, params, "right", hs)
    )
    dl = fl(lx, rx)
    dr = fr(lx, rx)

    if params.median_filter:
        med = functools.partial(_median_sharded, n_rows=n_rows)
        dl = dl._replace(disparity=med(dl.disparity), subpixel=med(dl.subpixel))
        dr = dr._replace(disparity=med(dr.disparity))

    valid = jax.vmap(
        functools.partial(
            lr_consistency,
            max_diff=params.lr_max_diff,
            num_disparities=params.num_disparities,
        )
    )(dl.disparity, dr.disparity)
    filled = _fill_sharded(dl.subpixel, valid, params, n_rows)
    return {
        "disparity": dl.disparity,
        "subpixel": dl.subpixel,
        "disparity_right": dr.disparity,
        "valid": valid,
        "filled": filled,
        "cost": dl.cost,
    }


def sharded_modern_forward(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: ModernParams,
    mesh: Mesh,
) -> Dict[str, jnp.ndarray]:
    """Modern pipeline on a global batch [B, H, W] of int32 pixel planes
    sharded over ``mesh``.  B must divide by the data axis, H by the
    rows axis; shard height must cover the cost phase's y reach
    (window//2 + census_window//2 for box aggregation, the census
    neighborhood alone for SGM, whose vertical recurrences instead run
    as a phased carry chain across the row shards).  Restriction:
    scales=1 (the half-resolution pyramid does not row-shard evenly;
    round 5 added SGM cost fusion on the single-chip XLA tier, so the
    sharded tier must REJECT scales!=1 rather than silently compute
    the single-scale volume)."""
    if params.scales != 1:
        raise ValueError(
            "sharded modern tier supports scales=1 (the half-resolution "
            "pyramid does not row-shard evenly)"
        )
    n_rows = mesh.shape[ROWS_AXIS]
    has_cols = COLS_AXIS in mesh.axis_names
    n_cols = mesh_cols(mesh)
    h = left.shape[1]
    hs = h // n_rows
    if params.aggregation == "sgm":
        reach = params.census_window // 2 if params.cost == "census" else 0
    else:
        reach = _cost_reach(params)
    if h % n_rows or hs < max(reach, 1):
        raise ValueError(
            f"height {h} must split into >= {max(reach, 1)}-row shards "
            f"across {n_rows} row shards (halo reach {reach})"
        )
    if has_cols:
        if params.aggregation == "sgm" and n_cols > 1:
            raise ValueError(
                "sharded modern SGM supports rows-only spatial meshes "
                "(the horizontal recurrence crosses col shards); use "
                "cols=1 or box aggregation"
            )
        if params.fill_mode == "background" and n_cols > 1:
            raise ValueError(
                "fill_mode='background' is a global x scanline scan — "
                "it does not col-shard; use cols=1 or diffusion fill"
            )
        w = left.shape[2]
        wsz = w // n_cols
        ch = params.census_window // 2 if params.cost == "census" else 0
        x_reach = params.num_disparities + params.window // 2 + ch
        if w % n_cols or wsz < max(x_reach, 1):
            raise ValueError(
                f"width {w} must split into >= {max(x_reach, 1)}-column "
                f"shards across {n_cols} col shards (x halo reach "
                f"{x_reach} = num_disparities + window//2 + census "
                "margin)"
            )
        plane = P(DATA_AXIS, ROWS_AXIS, COLS_AXIS)
    else:
        plane = P(DATA_AXIS, ROWS_AXIS, None)
    out_specs = {
        "disparity": plane,
        "subpixel": plane,
        "disparity_right": plane,
        "valid": plane,
        "filled": plane,
        "cost": plane,
    }
    if params.uniqueness and params.aggregation == "sgm":
        out_specs["uniqueness"] = plane
    if params.aggregation == "sgm":
        f = functools.partial(
            _sgm_shard_forward, params=params, n_rows=n_rows,
        )
    elif has_cols and n_cols > 1:
        f = functools.partial(
            _modern_shard_forward_2d, params=params, n_rows=n_rows,
            n_cols=n_cols,
        )
    else:
        f = functools.partial(
            _modern_shard_forward, params=params, n_rows=n_rows,
        )
    return jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(plane, plane),
        out_specs=out_specs,
        check_vma=False,
    )(left, right)


def build_sharded_modern_pipeline(
    params: ModernParams, mesh: Mesh
) -> Callable[[jnp.ndarray, jnp.ndarray], Dict[str, jnp.ndarray]]:
    """Jitted sharded modern pipeline: global [B, H, W] int32 pixel
    batches -> the artifact dict of models/modern.modern_forward."""
    fn = functools.partial(
        sharded_modern_forward, params=params, mesh=mesh
    )
    return jax.jit(fn)
