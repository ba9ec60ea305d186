"""The classic pipeline sharded over a (data, rows) mesh with shard_map.

Distributed re-design of the reference's ghost-area programs
(``src/stereo-ghost.c`` / ``.cu``): batches of stereo pairs are sharded
[B over "data", H over "rows"]; every y-direction dependency is satisfied
by a ppermute halo exchange of exactly the dependency reach (the
reference's halo-width rule, src/stereo-ghost.c:11-12):

  phase                      y-reach   exchange
  edges (3x3 stencil)        1 row     once, on x-padded brightness
  box filter (sw x sw)       sw//2     once, on the edge maps — the
                                       match planes for the halo rows are
                                       recomputed locally (compute is
                                       cheaper than a per-shift exchange)
  diffusion (4-neighbor)     1 row     per Jacobi step, on the web
  contour min/max            global    jax.lax.pmax/pmin over "rows"

x-direction dependencies (the num_shifts slide, the box filter's x reach)
stay intra-shard because W is unsharded — the reason row sharding is the
right decomposition for this pipeline (SURVEY.md §5).

Both boundary modes are exact: wrap mode uses circular permutes (the
distributed form of src/util.h:42-47's modulo indexing), ghost mode fills
open boundaries with the reference's constants (128.0 brightness halo,
src/stereo-ghost.c:384-385; zero match halo, src/stereo-ghost.c:93-97).
Output is bit-identical to the serial oracle for any mesh shape.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from stereomatching.config import (
    BoundaryMode,
    GHOST_BRIGHTNESS_FILL,
    StereoParams,
)
from stereomatching.ops.aggregate import box_sum_padded_auto
from stereomatching.ops.edges import find_edges_padded
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


def _pad_x(x: jnp.ndarray, pad: int, mode: BoundaryMode, fill=0) -> jnp.ndarray:
    """Pad the unsharded x axis locally: wrap == global wrap since W is
    whole on every shard; ghost == constant fill."""
    spec = [(0, 0)] * (x.ndim - 1) + [(pad, pad)]
    if mode == BoundaryMode.WRAP:
        return jnp.pad(x, spec, mode="wrap")
    return jnp.pad(x, spec, mode="constant", constant_values=fill)


def _extend_right_x(r: jnp.ndarray, num_shifts: int, mode: BoundaryMode) -> jnp.ndarray:
    """[..., H, W] -> [..., H, W + num_shifts]: wrap-around columns or the
    ghost edge halo's zeros (src/stereo-ghost.c:119-121, fill 0)."""
    w = r.shape[-1]
    if mode == BoundaryMode.WRAP:
        reps = -(-num_shifts // w) + 1
        tiled = jnp.tile(r, (1,) * (r.ndim - 1) + (reps,))
        return tiled[..., : w + num_shifts]
    return jnp.pad(r, [(0, 0)] * (r.ndim - 1) + [(0, num_shifts)])


def _shard_forward(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: StereoParams,
    n_rows: int,
    use_pallas: bool = False,
    n_cols: int = 1,
    has_cols: bool = False,
    interpret: bool = False,
) -> Dict[str, jnp.ndarray]:
    """Per-shard body.  left/right: [bl, hs, Ws] local brightness blocks.
    Runs inside shard_map with ROWS_AXIS/DATA_AXIS (and, for 2-D
    spatial meshes, COLS_AXIS) bound.  With ``has_cols`` every x
    dependency is satisfied by a COLUMN halo exchange sized to its
    reach — the distributed form of the reference's x ghost zones
    (src/ghost.h:54-55: `IGX` pads both axes; widths
    src/stereo-ghost.c:11-12) — instead of local padding."""
    bl, hs, w = left.shape
    mode = params.mode
    circ = mode == BoundaryMode.WRAP
    half = params.half
    d = params.num_shifts
    ax = ROWS_AXIS
    cax = COLS_AXIS

    # --- Step 1: edges.  1-px halo in x (locally when W is whole, via
    # col exchange on a 2-D spatial mesh), in y via exchange; the rows
    # are exchanged AFTER the x extension so stencil corners arrive
    # from the diagonal neighbor through the row neighbor's block.
    def edges_of(img: jnp.ndarray) -> jnp.ndarray:
        if has_cols:
            xp = with_col_halo(img, 1, cax, n_cols, circ,
                               GHOST_BRIGHTNESS_FILL)
        else:
            xp = _pad_x(img, 1, mode, GHOST_BRIGHTNESS_FILL)
        padded = with_row_halo(xp, 1, ax, n_rows, circ, GHOST_BRIGHTNESS_FILL)
        return jax.vmap(
            lambda p: find_edges_padded(p, params.threshold, params.edge_rule)
        )(padded)

    edges_l = edges_of(left)
    edges_r = edges_of(right)

    # --- Steps 2a-2c fused over shifts.  Exchange the edge maps once
    # with a halo of each axis's dependency reach; match planes for
    # halo rows/cols are recomputed locally from the exchanged edges.
    # x reach is asymmetric: the box window needs +-half, the shift
    # slide reads a further num_shifts to the RIGHT only.
    if has_cols:
        edges_l_x = with_col_halo(edges_l, half, cax, n_cols, circ)
        edges_r_x = with_col_halo(edges_r, half, cax, n_cols, circ,
                                  right_halo=half + d)
    else:
        edges_l_x, edges_r_x = edges_l, _extend_right_x(edges_r, d, mode)
    l_ext = with_row_halo(edges_l_x, half, ax, n_rows, circ)
    r_ext = with_row_halo(edges_r_x, half, ax, n_rows, circ)
    wl = edges_l_x.shape[-1]  # ws (+ 2*half with cols)
    x_off = half if has_cols else 0

    if mode == BoundaryMode.GHOST:
        # Ghost mode's match halo is zero-filled (src/stereo-ghost.c:93-97):
        # pixels outside the global image must contribute zero matches, but
        # locally recomputed halo matches would be (0 == 0) == 1.  Mask by
        # global row (and, 2-D, column) validity.
        row_idx = jax.lax.axis_index(ax)
        g = row_idx * hs + jnp.arange(hs + 2 * half) - half
        valid = ((g >= 0) & (g < n_rows * hs))[None, :, None]
        if has_cols:
            col_idx = jax.lax.axis_index(cax)
            gx = col_idx * w + jnp.arange(wl) - x_off
            valid = valid & ((gx >= 0) & (gx < n_cols * w))[None, None, :]
        valid = valid.astype(jnp.int32)
    else:
        valid = None

    if use_pallas:
        # The fused kernel (ops/fused.py) on each shard's halo-exchanged
        # edge maps.  Out-of-global ghost pixels carry a non-edge
        # sentinel so their matches vanish in-kernel; x-halo columns of
        # the output are sliced away.
        from stereomatching.ops.fused import match_and_score_fused_prehalo

        l_in = l_ext if valid is None else jnp.where(valid == 1, l_ext, 2)
        best, winner = match_and_score_fused_prehalo(
            l_in, r_ext, params, halo=half, pre_extended=has_cols,
            interpret=interpret,
        )
        if has_cols:
            best = best[:, :, x_off : x_off + w]
            winner = winner[:, :, x_off : x_off + w]
    else:

        def step(carry, i):
            best, winner = carry
            r_i = jax.lax.dynamic_slice_in_dim(r_ext, i, wl, axis=-1)
            match_ext = (l_ext == r_i).astype(jnp.int32)
            if valid is not None:
                match_ext = match_ext * valid
            if has_cols:
                # The x halo IS the box filter's x padding.
                sums = box_sum_padded_auto(match_ext, half)
                match = match_ext[:, half : half + hs,
                                  x_off : x_off + w]
            else:
                sums = box_sum_padded_auto(
                    _pad_x(match_ext, half, mode), half
                )
                match = match_ext[:, half : half + hs, :]
            score = jnp.where(match == 1, sums, 0)
            # Last-wins tie rule (src/stereo.c:211-219) via >= running max.
            winner = jnp.where(score >= best, i + 1, winner)
            best = jnp.maximum(best, score)
            return (best, winner), None

        init = (
            jnp.zeros((bl, hs, w), jnp.int32),
            jnp.zeros((bl, hs, w), jnp.int32),
        )
        (best, winner), _ = jax.lax.scan(
            step, init, jnp.arange(d, dtype=jnp.int32)
        )

    # --- Step 3a: diffusion.  One 1-row exchange per Jacobi step — the
    # reference's flat-index neighbors (p±1, p±w with no wrapping,
    # src/stereo.c:237-243) never wrap, so the exchange is open-boundary
    # with zero fill in BOTH modes (out-of-buffer reads are defined as 0,
    # see oracle/pipeline.py).  p±1 at x boundaries crosses into the
    # adjacent row, which the halo rows supply at shard seams.
    steps = max(params.times - 1, 0)
    web = winner
    if steps > 0 and not has_cols:

        def one_step(state, _):
            prev, cur = state
            ext = with_row_halo(cur, 1, ax, n_rows, circular=False)  # [bl, hs+2, W]
            f = ext.reshape(bl, -1)
            right_n = jnp.pad(f[:, 1:], ((0, 0), (0, 1)))
            down_n = jnp.pad(f[:, w:], ((0, 0), (0, w)))
            left_n = jnp.pad(f[:, :-1], ((0, 0), (1, 0)))
            up_n = jnp.pad(f[:, :-w], ((0, 0), (w, 0)))
            avg = (right_n + down_n + left_n + up_n) // 4
            avg = avg.reshape(bl, hs + 2, w)[:, 1:-1, :]
            nxt = jnp.where(cur == 0, avg, prev)
            return (cur, nxt), None

        (_, web), _ = jax.lax.scan(one_step, (winner, winner), None, length=steps)
    elif steps > 0:
        # 2-D spatial variant: the reference's FLAT-index neighbors
        # (p+-1, p+-w, src/stereo.c:237-243) cross a row at the global
        # x boundary — (y, 0)'s left neighbor is (y-1, W-1).  A 1-px
        # circular col exchange on the row-extended block delivers the
        # neighbor columns WITH the +-1 rows present, and the global
        # boundary shards row-shift their received column to realize
        # the flat wrap; everything else is a plain 2-D shift.
        col_idx = jax.lax.axis_index(cax)

        def one_step(state, _):
            prev, cur = state
            ext = with_row_halo(cur, 1, ax, n_rows, circular=False)
            lcol, rcol = exchange_col_halo(ext, 1, cax, n_cols,
                                           circular=True)
            if n_cols == 1:
                lshift = jnp.concatenate(
                    [jnp.zeros_like(lcol[:, :1]), lcol[:, :-1]], axis=1)
                rshift = jnp.concatenate(
                    [rcol[:, 1:], jnp.zeros_like(rcol[:, :1])], axis=1)
                lcol, rcol = lshift, rshift
            else:
                lshift = jnp.concatenate(
                    [jnp.zeros_like(lcol[:, :1]), lcol[:, :-1]], axis=1)
                rshift = jnp.concatenate(
                    [rcol[:, 1:], jnp.zeros_like(rcol[:, :1])], axis=1)
                lcol = jnp.where(col_idx == 0, lshift, lcol)
                rcol = jnp.where(col_idx == n_cols - 1, rshift, rcol)
            ext2 = jnp.concatenate([lcol, ext, rcol], axis=-1)
            right_n = ext2[:, 1:-1, 2:]
            left_n = ext2[:, 1:-1, :-2]
            up_n = ext2[:, :-2, 1:-1]
            down_n = ext2[:, 2:, 1:-1]
            avg = (right_n + down_n + left_n + up_n) // 4
            nxt = jnp.where(cur == 0, avg, prev)
            return (cur, nxt), None

        (_, web), _ = jax.lax.scan(one_step, (winner, winner), None, length=steps)

    # --- Step 3b: contour.  Per-image global min/max over the spatial
    # axes (the reference's device-wide tree reduction,
    # src/util.cu:15-45, becomes a collective across the cards).
    sp_axes = (ax, cax) if has_cols else ax
    max_e = jax.lax.pmax(web.max(axis=(-2, -1)), sp_axes)  # [bl]
    min_e = jax.lax.pmin(web.min(axis=(-2, -1)), sp_axes)  # [bl]
    interval = jnp.maximum((max_e - min_e) // params.lines, 1)
    # Division-free banding, robust to +-1 quotient misrounding (see
    # ops/contour.py for the exactness argument).
    x = web - min_e[:, None, None]
    iv = interval[:, None, None]
    q = jnp.floor(x.astype(jnp.float32) / iv.astype(jnp.float32))
    r = x - q.astype(jnp.int32) * iv
    out = ((r == 0) | (r == iv) | (r == -iv)).astype(jnp.int32)

    return {
        "edges-1": edges_l,
        "edges-2": edges_r,
        "score_best": best,
        "web-1": winner,
        "web-2": web,
        "output-0": out,
        "min_elevation": min_e,
        "max_elevation": max_e,
    }


def sharded_classic_forward(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: StereoParams,
    mesh: Mesh,
    use_pallas: bool = False,
    interpret: bool = False,
) -> Dict[str, jnp.ndarray]:
    """Full pipeline on a global batch [B, H, W] sharded over ``mesh``.
    B must divide by the data axis, H by the rows axis; shard height must
    be >= the halo reach max(1, square_width // 2).  ``use_pallas``
    routes each shard's match phase through the fused kernel
    (``interpret``: in the Pallas interpreter, for tests).

    A 3-axis (data, rows, cols) mesh additionally shards W: shard width
    must cover the x reach — num_shifts + square_width//2 on the right
    (the shift slide + box window, the reference's widest ghost zone,
    src/stereo-ghost.c:11-12) — each satisfied by one col halo
    exchange.  Bit-identical to the single-chip tier either way."""
    n_rows = mesh.shape[ROWS_AXIS]
    has_cols = COLS_AXIS in mesh.axis_names
    n_cols = mesh_cols(mesh)
    if has_cols:
        w = left.shape[-1]
        ws = w // n_cols
        reach = params.num_shifts + params.half
        if w % n_cols or ws < max(reach, 1):
            raise ValueError(
                f"width {w} must split into >= {max(reach, 1)}-column "
                f"shards across {n_cols} col shards (x halo reach "
                f"{reach} = num_shifts + square_width//2, "
                "src/stereo-ghost.c:11-12)"
            )
        plane = P(DATA_AXIS, ROWS_AXIS, COLS_AXIS)
    else:
        plane = P(DATA_AXIS, ROWS_AXIS, None)
    scalar = P(DATA_AXIS)
    out_specs = {
        "edges-1": plane,
        "edges-2": plane,
        "score_best": plane,
        "web-1": plane,
        "web-2": plane,
        "output-0": plane,
        "min_elevation": scalar,
        "max_elevation": scalar,
    }
    f = functools.partial(
        _shard_forward, params=params, n_rows=n_rows, use_pallas=use_pallas,
        n_cols=n_cols, has_cols=has_cols, interpret=interpret,
    )
    return jax.shard_map(
        f,
        mesh=mesh,
        in_specs=(plane, plane),
        out_specs=out_specs,
        check_vma=False,
    )(left, right)


def build_sharded_pipeline(
    params: StereoParams, mesh: Mesh, use_pallas: bool = False,
    interpret: bool = False,
) -> Callable[[jnp.ndarray, jnp.ndarray], Dict[str, jnp.ndarray]]:
    """Jitted sharded pipeline for fixed params and mesh.  Takes global
    [B, H, W] brightness batches (any placement; jit moves them to the
    mesh sharding) and returns the artifact dict of the single-chip tier."""
    fn = functools.partial(
        sharded_classic_forward, params=params, mesh=mesh,
        use_pallas=use_pallas, interpret=interpret,
    )
    return jax.jit(fn)
