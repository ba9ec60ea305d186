"""Multi-host initialization.

The reference is strictly single-process (SURVEY.md §2: no NCCL/MPI/
Gloo anywhere); this framework's multi-host story is JAX's: one
process per host, ``jax.distributed.initialize`` at startup, then every
collective in the pipeline (the ppermute halo exchanges and the contour
pmax/pmin, parallel/pipeline.py) is part of the jitted program, which
XLA hands to NCCL.

Typical multi-host run:

    from stereomatching.parallel import distributed, make_mesh
    distributed.initialize("host0:1234", num_processes=N, process_id=i)
    mesh = make_mesh(data=DP, rows=SP)  # global device count = DP*SP
    fn = build_sharded_pipeline(params, mesh)
    # feed per-host shards via jax.make_array_from_process_local_data

Failure model: fail-fast, as the reference (xmalloc/checkCudaErrors
abort on error, src/util.h:49-58) — a host failure kills the job;
restart from the last artifact checkpoint (utils/artifacts.py).
"""

from __future__ import annotations

from typing import Optional


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed; no-op when already initialized or
    when running single-process (the common dev case)."""
    import jax

    if num_processes in (None, 1) and coordinator_address is None:
        # Single-host: nothing to do unless env says otherwise.
        import os

        if "JAX_COORDINATOR_ADDRESS" not in os.environ:
            return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # jax raises "distributed.initialize should only be called once."
        # on re-init; treat any already-initialized wording as the no-op.
        msg = str(e).lower()
        if "already" in msg or "once" in msg:
            return
        raise


def local_shard_bounds(global_rows: int, n_shards: int, shard_idx: int):
    """Row range [lo, hi) owned by shard ``shard_idx`` under the even
    row sharding build_sharded_pipeline uses (H must divide evenly)."""
    if global_rows % n_shards:
        raise ValueError(f"H={global_rows} not divisible by {n_shards} row shards")
    per = global_rows // n_shards
    return shard_idx * per, (shard_idx + 1) * per
