"""Device mesh construction for the (data, rows[, cols]) layout.

Axes:
  * ``data`` — batch data parallelism: independent stereo pairs.
  * ``rows`` — spatial parallelism: image rows sharded across chips,
    stitched by ppermute halo exchange (parallel/halo.py).
  * ``cols`` (optional) — the second spatial axis: image COLUMNS
    sharded, with x-halo exchange sized to the x dependency reach
    (num_shifts + square_width//2 for the classic pipeline — the
    reference's ghost layer pads both axes, src/ghost.h:54-55, and its
    x halos are the wider ones, src/stereo-ghost.c:11-12).

The cards of one host are joined all to all by NVLink, so the mesh
follows the algorithm alone: any device order serves ``rows``/``cols``
equally.  ``data`` needs no steady-state communication at all (only the
per-image contour min/max reduce, parallel/pipeline.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
ROWS_AXIS = "rows"
COLS_AXIS = "cols"


def make_mesh(
    data: int = 1,
    rows: Optional[int] = None,
    cols: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, rows) mesh — or (data, rows, cols) when ``cols``
    is given — over ``devices``.  ``rows`` defaults to using all
    remaining devices.  Device order follows jax.devices().

    ``cols=None`` (the default) returns the 2-axis mesh every existing
    caller expects; pass ``cols`` (even 1) to get the 3-axis layout the
    2-D spatial tier shards over."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    c = 1 if cols is None else cols
    if rows is None:
        if n % (data * c) != 0:
            raise ValueError(
                f"{n} devices not divisible by data={data} * cols={c}"
            )
        rows = n // (data * c)
    if data * rows * c != n:
        raise ValueError(f"mesh {data}x{rows}x{c} != {n} devices")
    if cols is None:
        arr = np.asarray(devices).reshape(data, rows)
        return Mesh(arr, (DATA_AXIS, ROWS_AXIS))
    arr = np.asarray(devices).reshape(data, rows, cols)
    return Mesh(arr, (DATA_AXIS, ROWS_AXIS, COLS_AXIS))


def mesh_cols(mesh: Mesh) -> int:
    """Size of the cols axis, 1 when the mesh has none (2-axis layout)."""
    return mesh.shape.get(COLS_AXIS, 1)
