"""Windowed score aggregation (reference ``addup_pixels_in_square``,
src/stereo.c:132-148): square_width² box sum centered on each pixel.

The reference's CUDA kernel does square_width² (441) global reads per
pixel (src/stereo.cu:146-155) — the hot loop of the whole program.  Here
the box sum is either a summed-area table (two cumulative sums and a
4-corner difference, O(1) per pixel, exact in int32: window sums <= sw²
and SAT entries <= H*W < 2^31) or two banded-ones matrix products on the
tensor cores; the backend decision point (utils/platform.py) picks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from stereomatching.config import BoundaryMode


def pad_plane(
    plane: jnp.ndarray, half: int, mode: BoundaryMode
) -> jnp.ndarray:
    """Pad a match plane by ``half``: wrap-around (src/stereo.c:141-142)
    or the ghost variant's zero-filled match halo (src/stereo-ghost.c:93-97,
    140-141)."""
    if mode == BoundaryMode.WRAP:
        return jnp.pad(plane, half, mode="wrap")
    return jnp.pad(plane, half, mode="constant")


def box_sum_padded(padded: jnp.ndarray, half: int) -> jnp.ndarray:
    """Box sum over an already ``half``-padded plane (last two axes)
    -> int32 [..., H, W].  Leading batch/shard dims pass through."""
    k = 2 * half + 1
    sat = padded.astype(jnp.int32).cumsum(axis=-2).cumsum(axis=-1)
    pad = [(0, 0)] * (sat.ndim - 2) + [(1, 0), (1, 0)]
    sat = jnp.pad(sat, pad)
    return (
        sat[..., k:, k:]
        - sat[..., :-k, k:]
        - sat[..., k:, :-k]
        + sat[..., :-k, :-k]
    )


def make_col_band(
    out_rows: int, in_rows: int, k: int, y0: int = 0, band_dtype=jnp.bfloat16
) -> jnp.ndarray:
    """Banded-ones matrix [out_rows, in_rows] summing input rows
    [i+y0, i+y0+k) into output row i — the matrix-unit form of a
    k-wide column box sum (the band absorbs the halo offset y0)."""
    ii = jax.lax.broadcasted_iota(jnp.int32, (out_rows, in_rows), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (out_rows, in_rows), 1)
    return ((jj - ii >= y0) & (jj - ii < y0 + k)).astype(band_dtype)


def make_box_bands(
    out_rows: int,
    in_rows: int,
    in_cols: int,
    out_cols: int,
    k: int,
    y0: int = 0,
    band_dtype=jnp.bfloat16,
):
    """Banded-ones matrices realizing a k-wide separable box sum as two
    matmuls: ``col_band [out_rows, in_rows]`` sums rows [i+y0, i+y0+k)
    and ``row_band [in_cols, out_cols]`` sums columns [x, x+k)."""
    col_band = make_col_band(out_rows, in_rows, k, y0, band_dtype)
    jj2 = jax.lax.broadcasted_iota(jnp.int32, (in_cols, out_cols), 0)
    xx2 = jax.lax.broadcasted_iota(jnp.int32, (in_cols, out_cols), 1)
    row_band = ((jj2 - xx2 >= 0) & (jj2 - xx2 < k)).astype(band_dtype)
    return col_band, row_band


def apply_box_bands(col_band, row_band, plane, acc_dtype=jnp.float32):
    """sums = col_band @ plane @ row_band with the exactness-preserving
    cast discipline (inputs in band dtype, accumulate in acc_dtype)
    -> int32 with leading batch dims broadcast."""
    band_dtype = col_band.dtype
    cs = jnp.matmul(
        col_band, plane.astype(band_dtype), preferred_element_type=acc_dtype
    )
    s = jnp.matmul(
        cs.astype(band_dtype), row_band, preferred_element_type=acc_dtype
    )
    return s.astype(jnp.int32)


def box_sum_padded_matmul(padded: jnp.ndarray, half: int) -> jnp.ndarray:
    """Box sum over a ``half``-padded plane via two banded-ones matmuls
    on the tensor cores -> int32 [..., H, W] (leading batch dims
    broadcast).

    Exact: products are the plane's {0,1} entries in bf16 (integers
    <= 256 are exact in bf16 — requires square_width <= 255), the f32
    accumulator holds row sums <= k and window sums <= k^2 < 2^24
    exactly.  No operand is float32, so the TF32 default of float32
    matmuls on the GPU never applies.  Identical results to the SAT
    path.
    """
    k = 2 * half + 1
    hp, wp = padded.shape[-2], padded.shape[-1]
    h, w = hp - 2 * half, wp - 2 * half
    col_band, row_band = make_box_bands(h, hp, wp, w, k)
    return apply_box_bands(col_band, row_band, padded)


def box_sum_padded_auto(padded: jnp.ndarray, half: int) -> jnp.ndarray:
    """The box filter the backend's decision point picks
    (utils/platform.implementation("box_sum")); bit-identical either
    way.  Windows wider than 255 always take the SAT."""
    from stereomatching.utils.platform import implementation

    if implementation("box_sum") == "matmul" and 2 * half + 1 <= 255:
        return box_sum_padded_matmul(padded, half)
    return box_sum_padded(padded, half)


def box_sum(
    plane: jnp.ndarray, square_width: int, mode: BoundaryMode
) -> jnp.ndarray:
    half = square_width // 2
    return box_sum_padded(pad_plane(plane, half, mode), half)
