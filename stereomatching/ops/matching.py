"""Shift matching (reference ``fillup_matches``, src/stereo.c:113-127).

``matches[i][y, x] = (left[y, x] == right[y, x+i])`` — the x+i read wraps
modulo width in wrap mode (src/stereo.c:120) or reads the zero-filled
``num_shifts``-wide edge halo in ghost mode (src/stereo-ghost.c:119-121).

Instead of a per-shift wrapped gather, the right edge map is extended once
to width W + num_shifts (a cheap concat/pad); each shift is then a static-
size dynamic slice — a gather-free form of the reference's sliding
access pattern.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from stereomatching.config import BoundaryMode


def extend_right_edges(
    right_edges: jnp.ndarray, num_shifts: int, mode: BoundaryMode
) -> jnp.ndarray:
    """[H, W] -> [H, W + num_shifts] with wrap-around columns or the
    ghost halo's zeros appended."""
    w = right_edges.shape[-1]
    if mode == BoundaryMode.WRAP:
        reps = -(-num_shifts // w) + 1  # ceil, supports num_shifts > W
        tiled = jnp.tile(right_edges, (1, reps))
        return tiled[:, : w + num_shifts]
    return jnp.pad(right_edges, ((0, 0), (0, num_shifts)), mode="constant")


def match_plane(
    left_edges: jnp.ndarray, right_ext: jnp.ndarray, shift: jnp.ndarray
) -> jnp.ndarray:
    """Single-shift match plane, int32 {0,1}.  ``shift`` may be traced
    (used inside the scan over shifts).  NOTE: equality, not AND — two
    non-edge pixels also match (src/stereo.c:122-123)."""
    h, w = left_edges.shape
    shift = jnp.asarray(shift)
    r = jax.lax.dynamic_slice(
        right_ext, (jnp.zeros((), shift.dtype), shift), (h, w)
    )
    return (left_edges == r).astype(jnp.int32)
