"""stereomatching — a dense stereo matching framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the CUDA
thesis project ``chrg127/stereomatching`` (see SURVEY.md):

* the classic binary edge-matching pipeline (edge extraction -> shift-match
  cost volume -> windowed score aggregation -> per-pixel disparity argmax ->
  hole-filling diffusion -> contour rendering), in both *wrap-around* and
  *ghost-zone (halo)* boundary modes, bit-comparable to the serial C oracle
  (reference ``src/stereo.c`` / ``src/stereo-ghost.c``);
* a pure-NumPy serial oracle playing the role the reference's serial C
  programs play for its CUDA binaries (reference ``test/diff.sh``);
* a fused GPU kernel (Pallas, Triton route) for the classic hot phase,
  one pass over the disparities with the window sums on chip (in place
  of the reference's one-kernel-per-phase CUDA, ``src/stereo.cu``);
* multi-device scaling via ``shard_map`` over a (data, rows) mesh with
  ppermute halo exchange (the scaled-out generalization of the reference's
  ghost areas, ``src/ghost.h``);
* modern extensions beyond the reference: SAD cost volumes, left-right
  consistency, sub-pixel refinement, multi-scale matching.
"""

from stereomatching.config import (
    BoundaryMode,
    ModernParams,
    StereoParams,
    DEFAULT_THRESHOLD,
    DEFAULT_SQUARE_WIDTH,
    DEFAULT_TIMES,
    DEFAULT_LINES,
    NUM_SHIFTS,
)

__version__ = "0.1.0"

__all__ = [
    "BoundaryMode",
    "ModernParams",
    "StereoParams",
    "DEFAULT_THRESHOLD",
    "DEFAULT_SQUARE_WIDTH",
    "DEFAULT_TIMES",
    "DEFAULT_LINES",
    "NUM_SHIFTS",
    # Lazy convenience re-exports (see __getattr__): Matcher,
    # ModernMatcher, StereoPairDataset, BatchLoader.
]


def __getattr__(name):
    """Lazy re-exports so ``import stereomatching`` stays light
    (no jax import at package import time)."""
    if name in ("Matcher", "ModernMatcher"):
        from stereomatching import serving

        return getattr(serving, name)
    if name in ("StereoPairDataset", "BatchLoader", "discover_pairs"):
        from stereomatching import data

        return getattr(data, name)
    raise AttributeError(name)
