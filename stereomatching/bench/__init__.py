"""Measurement harness: per-phase timers, size sweeps, throughput model.

The framework's version of the reference's measurement stack
(test/time.sh + test/make_graph.py + the one-line printf,
src/stereo.c:322-324): structured per-phase stats, the thesis's
pixel-pass throughput model, and the size-sweep table.
"""

from stereomatching.bench.harness import (
    BenchResult,
    pixel_passes,
    phase_timings,
    size_sweep,
    time_jitted,
)

__all__ = [
    "BenchResult",
    "pixel_passes",
    "phase_timings",
    "size_sweep",
    "time_jitted",
]
