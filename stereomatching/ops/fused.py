"""Fused shift-match + box-filter + disparity argmax (Pallas, Triton route).

The hot phase of the classic pipeline (reference ``fillup_matches`` +
``fillup_scores`` + ``find_highest_scoring_shifts``, src/stereo.c:113-220)
as one GPU kernel.  The XLA route (ops/argmax.match_and_score) writes a
match plane and its window sums to device memory and reads them back for
every shift; here one program per (pair, row tile, column tile):

  * loads its left edge tile with the box filter's halo once,
  * loops over all shifts inside the kernel: one masked load of the
    shifted right tile, the match plane, the square_width² box sum as two
    banded-ones ``pl.dot``s on the tensor cores, the score and the running
    (best, winner) argmax with the last-wins tie rule,
  * stores only the result planes.

The box sum is exact: the match plane's entries are 0/1 and the column
sums are at most square_width (<= 255, exact in fp16), and the window
sums at most square_width² < 2^24 (exact in the fp32 accumulator).

Tiles are ``bh`` x ``bw`` input blocks (powers of two, as Triton needs);
each yields a (bh - 2*half) x (bw - 2*half) block of outputs, stored
under a mask.  Boundary semantics are baked into the padded inputs by
``_pad_edges``, so the kernel itself is mode-agnostic:

  * wrap mode — x and y wrap-padding reproduces the modulo indexing of
    src/util.h:42-47;
  * ghost mode — the left map's halo holds the sentinel 2 (edges are
    {0, 1}, so no halo cell matches: the reference's zero-filled match
    halo, src/stereo-ghost.c:93-97), while the right map's x extension
    keeps the reference's real zero fill for the shift reads
    (src/stereo-ghost.c:119-121).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from stereomatching.config import BoundaryMode, StereoParams

_LEFT_SENTINEL = 2  # never equal to an edge value {0, 1}


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def tile_shape(half: int) -> Tuple[int, int]:
    """Input block (bh, bw) for a box half-width ``half``: powers of two
    leaving at least 16 output rows and 64 output columns per program
    (at the default 21x21 window: 64 x 128 blocks, 44 x 108 outputs)."""
    return _next_pow2(2 * half + 16), _next_pow2(2 * half + 64)


def _geometry(h: int, w: int, half: int, d: int):
    """-> (bh, bw, th, tw, n_ty, n_tx, hl, wl, wr): block and output
    tile sizes, the grid, and the padded extents every block load stays
    inside (rows hl, left columns wl, right columns wr)."""
    bh, bw = tile_shape(half)
    th, tw = bh - 2 * half, bw - 2 * half
    n_ty, n_tx = -(-h // th), -(-w // tw)
    # The halo block starts at the tile origin, the centre block half a
    # window further in; both are bh x bw.
    hl = (n_ty - 1) * th + bh + half
    wl = (n_tx - 1) * tw + bw + half
    return bh, bw, th, tw, n_ty, n_tx, hl, wl, wl + d


def _pad_edges(left, right, mode: BoundaryMode, half: int, hl: int,
               wl: int, wr: int):
    """Edge maps [B, H, W] / right [B, H, W'] -> padded int8 planes
    [B, hl, wl] / [B, hl, wr]: image pixel (y, x) lands at (y + half,
    x + half).  Wrap mode wraps both axes; ghost mode pads the left map
    with the sentinel and the right with zeros."""
    h, w = left.shape[-2:]
    left, right = left.astype(jnp.int8), right.astype(jnp.int8)
    if mode == BoundaryMode.WRAP:
        ys = jnp.arange(-half, hl - half) % h
        left = left[:, ys][..., jnp.arange(-half, wl - half) % w]
        right = right[:, ys][..., jnp.arange(-half, wr - half) % w]
        return left, right
    rows = ((0, 0), (half, hl - h - half))
    left = jnp.pad(left, rows + ((half, wl - w - half),),
                   constant_values=_LEFT_SENTINEL)
    right = jnp.pad(right, rows + ((half, wr - right.shape[-1] - half),))
    return left, right


def _kernel(l_ref, r_ref, *out_refs, bh, bw, th, tw, half, num_shifts,
            subpixel):
    b = pl.program_id(0)
    y0 = pl.program_id(1) * th
    x0 = pl.program_id(2) * tw
    k = 2 * half + 1

    def block(ref, dy, dx):
        return plgpu.load(ref.at[b, pl.ds(y0 + dy, bh), pl.ds(x0 + dx, bw)])

    l_halo = block(l_ref, 0, 0)
    l_mid = block(l_ref, half, half)
    # Banded ones: col_band[i, r] sums rows i..i+2h, row_band[c, j]
    # columns j..j+2h, so out[i, j] is the window centred on block
    # cell (i + half, j + half).
    ii = jax.lax.broadcasted_iota(jnp.int32, (bh, bh), 0)
    rr = jax.lax.broadcasted_iota(jnp.int32, (bh, bh), 1)
    col_band = ((rr - ii >= 0) & (rr - ii < k)).astype(jnp.float16)
    cc = jax.lax.broadcasted_iota(jnp.int32, (bw, bw), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (bw, bw), 1)
    row_band = ((cc - jj >= 0) & (cc - jj < k)).astype(jnp.float16)

    def score_of(i):
        match = (l_halo == block(r_ref, 0, i)).astype(jnp.float16)
        cols = pl.dot(col_band, match)
        sums = pl.dot(cols.astype(jnp.float16), row_band).astype(jnp.int32)
        # Keep the sum only where the centre pixel matched (record_score,
        # src/stereo.c:172-182).
        return jnp.where(l_mid == block(r_ref, half, half + i), sums, 0)

    zeros = jnp.zeros((bh, bw), jnp.int32)
    missing = jnp.full((bh, bw), -1, jnp.int32)  # scores are >= 0
    if subpixel:
        # The neighbour-score carries of ops/argmax.match_and_score_subpixel.
        def step(i, acc):
            best, winner, s_left, s_right, s_prev, was_new = acc
            score = score_of(i)
            s_right = jnp.where(was_new == 1, score, s_right)
            is_new = score >= best
            return (
                jnp.maximum(best, score),
                jnp.where(is_new, i + 1, winner),
                jnp.where(is_new, s_prev, s_left),
                jnp.where(is_new, missing, s_right),
                score,
                is_new.astype(jnp.int32),
            )

        init = (zeros, zeros, missing, missing, missing, zeros)
    else:
        def step(i, acc):
            best, winner = acc
            score = score_of(i)
            # Last-wins tie rule (src/stereo.c:211-219) via >= running max.
            return jnp.maximum(best, score), jnp.where(score >= best, i + 1,
                                                       winner)

        init = (zeros, zeros)
    out = jax.lax.fori_loop(0, num_shifts, step, init)
    keep = (
        (jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0) < th)
        & (jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1) < tw)
    )
    for ref, val in zip(out_refs, out):
        plgpu.store(ref.at[b, pl.ds(y0, bh), pl.ds(x0, bw)], val, mask=keep)


def _fused_call(l_pad, r_pad, h: int, w: int, half: int, num_shifts: int,
                subpixel: bool, interpret: bool):
    """Run the kernel on padded planes from ``_pad_edges`` -> int32
    [B, h, w] planes: (best, winner), plus (s_left, s_right) with
    ``subpixel``."""
    bsz = l_pad.shape[0]
    bh, bw, th, tw, n_ty, n_tx, hl, wl, wr = _geometry(h, w, half, num_shifts)
    if l_pad.shape[1:] != (hl, wl) or r_pad.shape[1:] != (hl, wr):
        raise ValueError(
            f"padded planes {l_pad.shape}/{r_pad.shape} do not match the "
            f"tile geometry ({hl}, {wl})/({hl}, {wr})"
        )
    n_out = 4 if subpixel else 2
    out_shape = jax.ShapeDtypeStruct(
        (bsz, (n_ty - 1) * th + bh, (n_tx - 1) * tw + bw), jnp.int32
    )
    kernel = functools.partial(
        _kernel, bh=bh, bw=bw, th=th, tw=tw, half=half,
        num_shifts=num_shifts, subpixel=subpixel,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(bsz, n_ty, n_tx),
        out_shape=[out_shape] * n_out,
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        name="classic_match_score",
    )(l_pad, r_pad)
    return tuple(o[:, :h, :w] for o in outs)


def _parabola_refine(best, winner, s_left, s_right):
    """winner + parabola offset from the neighbour scores; offset 0
    where a neighbour is missing (-1 sentinel) or the triple is not
    strictly concave (ops/argmax.match_and_score_subpixel)."""
    sl = s_left.astype(jnp.float32)
    sm = best.astype(jnp.float32)
    sr = s_right.astype(jnp.float32)
    denom = sl - 2.0 * sm + sr
    valid = (s_left >= 0) & (s_right >= 0) & (denom < 0)
    offset = jnp.where(
        valid, (sl - sr) / jnp.where(valid, 2.0 * denom, 1.0), 0.0
    )
    offset = jnp.clip(offset, -0.5, 0.5)
    return winner.astype(jnp.float32) + offset


def _check_window(params: StereoParams) -> None:
    if params.square_width > 255:
        # Column sums reach square_width; beyond 255 fp16 loses exactness.
        # The XLA route's summed-area table has no such bound.
        raise ValueError(
            "the fused kernel requires square_width <= 255 (use the XLA "
            "route for larger windows)"
        )


def match_and_score_fused(
    left_edges: jnp.ndarray,
    right_edges: jnp.ndarray,
    params: StereoParams,
    subpixel: bool = False,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, ...]:
    """Fused phases 2a-2c -> (best_scores, winning_shifts), int32 with
    the input's shape ([H, W] or batched [B, H, W]; the batch is a grid
    dimension).  Bit-identical to ops/argmax.match_and_score in both
    boundary modes.  ``subpixel`` appends the parabola-refined float32
    plane of ops/argmax.match_and_score_subpixel.  ``interpret`` runs the
    kernel in the Pallas interpreter (tests on the CPU)."""
    _check_window(params)
    squeeze = left_edges.ndim == 2
    if squeeze:
        left_edges, right_edges = left_edges[None], right_edges[None]
    h, w = left_edges.shape[-2:]
    half, d = params.half, params.num_shifts
    *_, hl, wl, wr = _geometry(h, w, half, d)
    if params.mode == BoundaryMode.WRAP:
        # The right map's x extension wraps too (ops/matching.extend).
        r_src = right_edges
    else:
        r_src = jnp.pad(right_edges, ((0, 0), (0, 0), (0, d)))
    l_pad, r_pad = _pad_edges(left_edges, r_src, params.mode, half, hl, wl,
                              wr)
    outs = _fused_call(l_pad, r_pad, h, w, half, d, subpixel, interpret)
    if subpixel:
        best, winner, s_left, s_right = outs
        outs = (best, winner, _parabola_refine(best, winner, s_left, s_right))
    if squeeze:
        outs = tuple(o[0] for o in outs)
    return outs


def match_and_score_fused_prehalo(
    l_halo: jnp.ndarray,
    r_halo: jnp.ndarray,
    params: StereoParams,
    halo: int,
    pre_extended: bool = False,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Kernel entry for row shards whose y-halo rows were already
    exchanged from neighbour shards (parallel/pipeline.py).

    ``l_halo`` [B, hs + 2*halo, W] is the left edge map with ``halo``
    neighbour rows on each side; in ghost mode the caller has
    overwritten rows outside the GLOBAL image with a non-edge sentinel
    (e.g. 2) so their matches vanish.  ``r_halo`` [B, hs + 2*halo,
    W + num_shifts] is the right map extended in x per the boundary mode
    (ops/matching.extend_right_edges), with the same y-halo.
    -> (best, winner) int32 [B, hs, W].

    ``pre_extended``: the caller already built the x extension into the
    maps (2-D col-sharded tier: the x halos arrived by col exchange, so
    wrap values are real neighbour columns, not a local modulo) — the
    maps are then padded ghost-style, and the out-of-block x pads only
    reach outputs the caller discards."""
    _check_window(params)
    half, d = params.half, params.num_shifts
    if halo < half:
        raise ValueError(f"halo {halo} < square_width//2 {half}")
    rows_in, w = l_halo.shape[-2:]
    hs = rows_in - 2 * halo
    *_, hl, wl, wr = _geometry(hs, w, half, d)
    # Exactly ``half`` halo rows per side, then grow the bottom to hl;
    # the fill rows lie beyond every kept output's window.
    trim = slice(halo - half, rows_in - (halo - half))
    l_mid = jnp.pad(l_halo[:, trim].astype(jnp.int8),
                    ((0, 0), (0, hl - hs - 2 * half), (0, 0)),
                    constant_values=_LEFT_SENTINEL)
    r_mid = jnp.pad(r_halo[:, trim].astype(jnp.int8),
                    ((0, 0), (0, hl - hs - 2 * half), (0, 0)))
    wrap = params.mode == BoundaryMode.WRAP and not pre_extended
    if wrap:
        l_pad = l_mid[..., jnp.arange(-half, wl - half) % w]
        r_pad = r_mid[..., jnp.arange(-half, wr - half) % w]
    else:
        l_pad = jnp.pad(l_mid, ((0, 0), (0, 0), (half, wl - w - half)),
                        constant_values=_LEFT_SENTINEL)
        r_pad = jnp.pad(r_mid, ((0, 0), (0, 0), (half, wr - (w + d) - half)))
    return _fused_call(l_pad, r_pad, hs, w, half, d, False, interpret)
