"""The one place that knows about backends: which implementation each
stage runs on the current device, and where compiled programs are cached.

Every module that has more than one implementation of a stage asks
``implementation(stage)`` instead of inspecting the backend itself.  A
backend that is not in the table is an error, never a silent fallback.
"""

from __future__ import annotations

import os
import pathlib

# stage -> {backend: implementation}.  Chosen by measurement on the card
# (PERF.md, "Findings"); the CPU column is what the tests run.
_IMPLEMENTATIONS = {
    # The classic match + box + argmax phase: the fused Pallas kernel
    # (ops/fused.py, Triton route) or the XLA shift scan (ops/argmax.py).
    "classic_match": {"gpu": "fused", "cpu": "xla"},
    # The XLA route's box filter: summed-area table or two banded-ones
    # matmuls (ops/aggregate.py); bit-identical.
    "box_sum": {"gpu": "matmul", "cpu": "sat"},
}

# Fixed so that the cache keys of one checkout stay stable between runs.
_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def implementation(stage: str, backend: str | None = None) -> str:
    """-> the implementation ``stage`` uses on ``backend`` (default: the
    backend JAX runs on)."""
    if backend is None:
        import jax

        backend = jax.default_backend()
    table = _IMPLEMENTATIONS[stage]
    if backend not in table:
        raise RuntimeError(
            f"no implementation of {stage!r} for backend {backend!r} "
            f"(known: {sorted(table)})"
        )
    return table[backend]


def require_gpu() -> dict:
    """-> {"platform", "kind", "count"} of the devices JAX runs on.
    Raises when they are not GPUs: a measurement or a chip check that
    finds no card fails instead of running on the CPU."""
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {dev.platform!r} ({dev.device_kind})"
        )
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them (one
    line per card), read by a child process that does not touch JAX."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def ensure_compile_cache() -> None:
    """Persist compiled programs: in ``JAX_COMPILATION_CACHE_DIR`` when it
    is set, else in ``.jax_cache`` at the root of the checkout."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
