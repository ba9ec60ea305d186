"""Cost-volume build + disparity argmax, fused over shifts.

Covers reference phases 2a-2c (``fillup_matches`` + ``fillup_scores`` +
``find_highest_scoring_shifts``, src/stereo.c:113-220) in ONE scan over
shifts that never materializes the [D, H, W] cost volume in HBM: the
carry is just (best_score, winning_shift).

The single-pass update preserves the reference's two-pass last-wins tie
rule exactly: the reference records winner = i+1 for the LAST i whose
score equals the global best (src/stereo.c:211-219).  In a single pass,
updating the winner on ``score >= best`` triggers at exactly that last i
(when it arrives, the running best already equals the global best), and
never afterwards.  All scores are >= 0 and best starts at 0, matching the
reference's zeroed buffer (src/stereo.c:311) — in the all-zero-scores case
every shift triggers and the winner ends at num_shifts, exactly as the
reference's loop does.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from stereomatching.config import BoundaryMode, StereoParams
from stereomatching.ops.aggregate import box_sum_padded_auto, pad_plane
from stereomatching.ops.matching import extend_right_edges, match_plane


def _score_for_shift(
    left_edges: jnp.ndarray,
    right_ext: jnp.ndarray,
    shift: jnp.ndarray,
    half: int,
    mode: BoundaryMode,
) -> jnp.ndarray:
    match = match_plane(left_edges, right_ext, shift)
    sums = box_sum_padded_auto(pad_plane(match, half, mode), half)
    # Keep the sum only where a match occurred (record_score,
    # src/stereo.c:172-182); elsewhere 0.
    score = jnp.where(match == 1, sums, 0)
    return match, sums, score


def match_and_score(
    left_edges: jnp.ndarray,
    right_edges: jnp.ndarray,
    params: StereoParams,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """-> (best_scores, winning_shifts), both int32 [H, W]."""
    h, w = left_edges.shape
    right_ext = extend_right_edges(right_edges, params.num_shifts, params.mode)
    half = params.half
    mode = params.mode

    def step(carry, i):
        best, winner = carry
        _, _, score = _score_for_shift(left_edges, right_ext, i, half, mode)
        winner = jnp.where(score >= best, i + 1, winner)
        best = jnp.maximum(best, score)
        return (best, winner), None

    init = (jnp.zeros((h, w), jnp.int32), jnp.zeros((h, w), jnp.int32))
    (best, winner), _ = jax.lax.scan(
        step, init, jnp.arange(params.num_shifts, dtype=jnp.int32)
    )
    return best, winner.astype(jnp.int32)


def match_and_score_subpixel(
    left_edges: jnp.ndarray,
    right_edges: jnp.ndarray,
    params: StereoParams,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Opt-in extension beyond the reference: the classic argmax plus a
    parabola refine on the scores around the winner (the maximizing
    analogue of the modern pipeline's sub-pixel refine,
    ops/costvolume.argmin_subpixel_scan).

    -> (best_scores int32, winning_shifts int32, subpixel float32) with
    subpixel == winner + offset, offset in [-0.5, 0.5] and 0 wherever a
    neighbor score is missing (winner at either end) or the triple is
    not strictly concave.  winner is bit-identical to match_and_score
    (same last-wins carry)."""
    h, w = left_edges.shape
    right_ext = extend_right_edges(right_edges, params.num_shifts, params.mode)
    half = params.half
    mode = params.mode
    missing = jnp.full((h, w), -1, jnp.int32)  # scores are >= 0

    def step(carry, i):
        best, winner, s_left, s_right, s_prev, was_new = carry
        _, _, score = _score_for_shift(left_edges, right_ext, i, half, mode)
        # The step after a (re-)selection supplies its right neighbor.
        s_right = jnp.where(was_new == 1, score, s_right)
        is_new = score >= best
        return (
            jnp.maximum(best, score),
            jnp.where(is_new, i + 1, winner),
            jnp.where(is_new, s_prev, s_left),
            jnp.where(is_new, missing, s_right),
            score,
            is_new.astype(jnp.int32),
        ), None

    zeros = jnp.zeros((h, w), jnp.int32)
    init = (zeros, zeros, missing, missing, missing, zeros)
    (best, winner, s_left, s_right, _, _), _ = jax.lax.scan(
        step, init, jnp.arange(params.num_shifts, dtype=jnp.int32)
    )
    sl = s_left.astype(jnp.float32)
    sm = best.astype(jnp.float32)
    sr = s_right.astype(jnp.float32)
    denom = sl - 2.0 * sm + sr
    valid = (s_left >= 0) & (s_right >= 0) & (denom < 0)
    offset = jnp.where(valid, (sl - sr) / jnp.where(valid, 2.0 * denom, 1.0), 0.0)
    offset = jnp.clip(offset, -0.5, 0.5)
    return best, winner, winner.astype(jnp.float32) + offset


def match_and_score_collect(
    left_edges: jnp.ndarray,
    right_edges: jnp.ndarray,
    params: StereoParams,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Artifact-collecting variant for golden/differential tests: also
    stacks the per-shift planes the reference dumps in debug builds
    (matches-i, score_all-i, scores-i; src/stereo.c:302-313).
    -> (matches [D,H,W], sums [D,H,W], scores [D,H,W], best, winner)."""
    h, w = left_edges.shape
    right_ext = extend_right_edges(right_edges, params.num_shifts, params.mode)
    half = params.half
    mode = params.mode

    def step(carry, i):
        best, winner = carry
        match, sums, score = _score_for_shift(left_edges, right_ext, i, half, mode)
        winner = jnp.where(score >= best, i + 1, winner)
        best = jnp.maximum(best, score)
        return (best, winner), (match, sums, score)

    init = (jnp.zeros((h, w), jnp.int32), jnp.zeros((h, w), jnp.int32))
    (best, winner), (matches, sums, scores) = jax.lax.scan(
        step, init, jnp.arange(params.num_shifts, dtype=jnp.int32)
    )
    return matches, sums, scores, best, winner
