"""Pure-NumPy serial oracle for the stereo pipeline.

Plays the role the reference's serial C programs (``src/stereo.c``,
``src/stereo-ghost.c``) play for its CUDA binaries: a trivially-correct,
CPU-runnable executable spec against which the accelerated (JAX/Pallas)
implementations are validated phase-by-phase, bit-for-bit
(reference ``test/diff.sh``).
"""

from stereomatching.oracle.pipeline import (
    find_edges,
    fill_matches,
    box_sum,
    record_scores,
    best_and_winner,
    fill_web_holes,
    draw_contour,
    run_pipeline,
)

__all__ = [
    "find_edges",
    "fill_matches",
    "box_sum",
    "record_scores",
    "best_and_winner",
    "fill_web_holes",
    "draw_contour",
    "run_pipeline",
]
