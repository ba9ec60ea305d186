"""End-to-end stereo models.

``classic``  — the reference pipeline (edge matching + contour map),
               single-chip jitted, batched via vmap.
``modern``   — the extended pipeline (SAD cost volume, LR consistency,
               sub-pixel refinement, multi-scale).
"""

from stereomatching.models.classic import (
    classic_forward,
    classic_finish,
    build_classic_pipeline,
    build_classic_collect_pipeline,
    build_classic_finish_pipeline,
)
from stereomatching.models.modern import (
    modern_forward,
    build_modern_pipeline,
    disparity_one_view,
)

__all__ = [
    "classic_forward",
    "classic_finish",
    "build_classic_pipeline",
    "build_classic_collect_pipeline",
    "build_classic_finish_pipeline",
    "modern_forward",
    "build_modern_pipeline",
    "disparity_one_view",
]
