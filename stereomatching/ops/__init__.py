"""Compute ops.

Each op mirrors one phase of the reference pipeline (SURVEY.md §2) with
identical semantics to the NumPy oracle.  These are the plain JAX/XLA
implementations; the fused GPU kernel for the classic hot phase lives in
``fused.py`` and is imported only where it is used.
"""

from stereomatching.ops.edges import find_edges
from stereomatching.ops.matching import extend_right_edges, match_plane
from stereomatching.ops.aggregate import box_sum
from stereomatching.ops.argmax import match_and_score, match_and_score_collect
from stereomatching.ops.diffusion import fill_web_holes
from stereomatching.ops.contour import draw_contour
from stereomatching.ops.costvolume import (
    argmin_subpixel_scan,
    sad_disparity,
    lr_consistency,
    fill_invalid,
)

__all__ = [
    "find_edges",
    "extend_right_edges",
    "match_plane",
    "box_sum",
    "match_and_score",
    "match_and_score_collect",
    "fill_web_holes",
    "draw_contour",
    "argmin_subpixel_scan",
    "sad_disparity",
    "lr_consistency",
    "fill_invalid",
]
