"""Ghost-zone halo exchange between row shards via ``jax.lax.ppermute``.

Distributed replacement for the reference's ghost-area buffers
(``src/ghost.h:6-55``): instead of one padded allocation whose halo is
filled once (``ghost_add_*``, src/ghost.h:34-44), each shard sends its
boundary rows to its mesh neighbors (over NVLink between the cards of a
host) and receives the rows it needs to read past its own boundary.

Two boundary behaviors, mirroring the reference's two program families:
  * circular (wrap mode): the first shard's top halo comes from the last
    shard — the distributed form of the modulo indexing in
    ``src/util.h:42-47``.
  * open (ghost mode): boundary shards fill their outer halo with a
    constant (128.0 for brightness per src/stereo-ghost.c:384-385, zero
    for everything else), exactly the reference's ``ghost_add`` fill.

All functions must be called inside ``shard_map`` with ``axis_name``
bound to the rows mesh axis.  They operate on ``[..., Hs, W]`` arrays
(leading batch dims pass through untouched), so no vmap over collectives
is needed.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _exchange_halo(
    x: jnp.ndarray,
    halo: int,
    axis_name: str,
    n_shards: int,
    circular: bool,
    fill: float | int,
    axis: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Shared body of the row (axis=-2) and column (axis=-1) exchanges:
    -> (low, high) halo blocks of ``halo`` slices each along ``axis``."""
    hs = x.shape[axis]
    if halo > hs:
        raise ValueError(
            f"halo {halo} exceeds shard extent {hs} on axis {axis}: use "
            "fewer shards on that mesh axis (halo width == dependency "
            "reach, src/stereo-ghost.c:11-12)"
        )
    take = lambda a, b: jax.lax.slice_in_dim(x, a, b, axis=axis)  # noqa: E731
    high_slices = take(hs - halo, hs)  # what the next shard needs as low
    low_slices = take(0, halo)  # what the previous shard needs as high

    if n_shards == 1:
        if circular:
            return high_slices, low_slices
        f = jnp.full_like(high_slices, fill)
        return f, jnp.full_like(low_slices, fill)

    if circular:
        perm_down = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        perm_up = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    else:
        perm_down = [(i, i + 1) for i in range(n_shards - 1)]
        perm_up = [(i, i - 1) for i in range(1, n_shards)]

    # ppermute delivers zeros to devices no pair targets — already the
    # right open-boundary fill for integer planes; overwrite when the
    # caller needs a different constant (the 128.0 brightness halo).
    low = jax.lax.ppermute(high_slices, axis_name, perm_down)
    high = jax.lax.ppermute(low_slices, axis_name, perm_up)

    if not circular and fill != 0:
        idx = jax.lax.axis_index(axis_name)
        low = jnp.where(idx == 0, jnp.full_like(low, fill), low)
        high = jnp.where(
            idx == n_shards - 1, jnp.full_like(high, fill), high
        )
    return low, high


def exchange_row_halo(
    x: jnp.ndarray,
    halo: int,
    axis_name: str,
    n_shards: int,
    circular: bool,
    fill: float | int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """-> (top, bottom) halo blocks of ``halo`` rows each, [..., halo, W].

    ``top`` is the ``halo`` rows just above this shard's first row (the
    bottom rows of shard i-1); ``bottom`` the rows just below its last.
    Open boundaries are filled with ``fill``.
    ``n_shards`` is the static size of the rows mesh axis.
    """
    return _exchange_halo(x, halo, axis_name, n_shards, circular, fill, -2)


def exchange_col_halo(
    x: jnp.ndarray,
    halo: int,
    axis_name: str,
    n_shards: int,
    circular: bool,
    fill: float | int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """-> (left, right) halo blocks of ``halo`` columns each,
    [..., H, halo] — the x-axis twin of exchange_row_halo, for the
    cols mesh axis.  The reference's ghost layer pads BOTH axes
    (src/ghost.h:54-55); the x halo is the wider one there (shift
    reach num_shifts + window half, src/stereo-ghost.c:11-12), so a
    cols split must size its exchange accordingly."""
    return _exchange_halo(x, halo, axis_name, n_shards, circular, fill, -1)


def with_row_halo(
    x: jnp.ndarray,
    halo: int,
    axis_name: str,
    n_shards: int,
    circular: bool,
    fill: float | int = 0,
) -> jnp.ndarray:
    """Concatenate exchanged halos: [..., Hs, W] -> [..., Hs + 2*halo, W]."""
    if halo == 0:
        return x
    top, bottom = exchange_row_halo(x, halo, axis_name, n_shards, circular, fill)
    return jnp.concatenate([top, x, bottom], axis=-2)


def with_col_halo(
    x: jnp.ndarray,
    halo: int,
    axis_name: str,
    n_shards: int,
    circular: bool,
    fill: float | int = 0,
    right_halo: int | None = None,
) -> jnp.ndarray:
    """Concatenate exchanged column halos: [..., H, Ws] ->
    [..., H, halo + Ws + right_halo].  ``right_halo`` (default =
    ``halo``) sizes the right side independently — the classic
    pipeline's x reach is asymmetric (the shift slide only reads to
    the RIGHT by num_shifts, the box window +-half both ways)."""
    rh = halo if right_halo is None else right_halo
    if halo == 0 and rh == 0:
        return x
    parts = []
    if halo:
        left, _ = exchange_col_halo(x, halo, axis_name, n_shards,
                                    circular, fill)
        parts.append(left)
    parts.append(x)
    if rh:
        _, right = exchange_col_halo(x, rh, axis_name, n_shards,
                                     circular, fill)
        parts.append(right)
    return jnp.concatenate(parts, axis=-1)
