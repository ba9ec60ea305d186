"""Multi-chip tier: SPMD sharding over a (data, rows[, cols]) mesh.

The scaled-out generalization of the reference's ghost areas
(``src/ghost.h``): where the reference allocates one padded buffer and
fills the halo once on one device, here image batches are sharded
[B over "data", H over "rows", optionally W over "cols"] and halo
strips move between neighbor shards with ``jax.lax.ppermute``.  Halo
width == dependency reach, the reference's own rule
(src/stereo-ghost.c:11-12); the x halos (shift reach + window half)
are the wider ones, exactly as in the reference's ghost zones.
"""

from stereomatching.parallel.mesh import make_mesh, mesh_cols
from stereomatching.parallel.halo import (
    exchange_col_halo,
    exchange_row_halo,
    with_col_halo,
    with_row_halo,
)
from stereomatching.parallel.pipeline import (
    build_sharded_pipeline,
    sharded_classic_forward,
)
from stereomatching.parallel.modern import (
    build_sharded_modern_pipeline,
    sharded_modern_forward,
)

__all__ = [
    "make_mesh",
    "mesh_cols",
    "exchange_row_halo",
    "exchange_col_halo",
    "with_row_halo",
    "with_col_halo",
    "build_sharded_pipeline",
    "sharded_classic_forward",
    "build_sharded_modern_pipeline",
    "sharded_modern_forward",
]
