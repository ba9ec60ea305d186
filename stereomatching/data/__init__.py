"""Data loading: stereo-pair datasets, a prefetching batch loader, and
ground-truth disparity formats (PFM / 16-bit disparity PNG)."""

from stereomatching.data.loader import (
    StereoPairDataset,
    BatchLoader,
    discover_pairs,
)
from stereomatching.data.formats import (
    read_pfm,
    write_pfm,
    read_disparity_png,
    write_disparity_png,
    read_ground_truth,
)

__all__ = [
    "StereoPairDataset",
    "BatchLoader",
    "discover_pairs",
    "read_pfm",
    "write_pfm",
    "read_disparity_png",
    "write_disparity_png",
    "read_ground_truth",
]
