"""Contour rendering (reference ``draw_contour_map``, src/stereo.c:256-274):
global min/max reduction, interval = range / num_lines (C integer
division), pixel on a line iff (web - min) % interval == 0.

``interval`` is clamped to >= 1: the reference divides by zero when the
elevation range is smaller than num_lines (src/stereo.c:266-271) — a
documented bug fix, tested in tests/test_oracle.py.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def contour_bands(
    web: jnp.ndarray, num_lines: int, min_e: jnp.ndarray, max_e: jnp.ndarray
) -> jnp.ndarray:
    """Elementwise banding pass given a precomputed elevation range ->
    contour int32 {0,1}, same shape as ``web``.

    The ``% interval == 0`` test is evaluated division-free: the
    quotient comes from a float32 divide with the remainder checked
    back in int32 (integer division is a long instruction sequence on
    accelerators).  Elevations are
    winner indices <= num_shifts (far below 2^20), so the float32
    quotient is within +-1 of the true floor; the remainder test
    accepts r in {-interval, 0, interval}, which classifies every pixel
    exactly under that error bound (true remainder r' in [0, interval)
    maps to r in {r'-interval, r', r'+interval}; r' == 0 iff r is a
    multiple of interval in that window).
    """
    interval = jnp.maximum((max_e - min_e) // num_lines, 1)
    x = web - min_e
    q = jnp.floor(x.astype(jnp.float32) / interval.astype(jnp.float32))
    r = x - q.astype(jnp.int32) * interval
    return ((r == 0) | (r == interval) | (r == -interval)).astype(jnp.int32)


def draw_contour(
    web: jnp.ndarray, num_lines: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """-> (contour int32 {0,1} [H, W], min_elevation, max_elevation):
    the per-plane min/max reduction, then contour_bands."""
    max_e = web.max()
    min_e = web.min()
    return contour_bands(web, num_lines, min_e, max_e), min_e, max_e
