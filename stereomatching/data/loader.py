"""Stereo-pair dataset + prefetching batch loader.

The reference's data story is two ``read_image`` calls per run
(src/stereo.c:345-348) over a fixture layout ``test/imgs/<name>/a.png``
+ ``b.png``.  A production pipeline needs the input side to keep the
card busy: decode on host threads (the native C++ codec when
built), assemble fixed-shape batches, and hand the next batch to the
device while the current one computes.

Components:
  * ``discover_pairs`` — finds ``(left, right)`` image pairs under a
    root (the reference's fixture layout, plus ``*_left/right`` and
    ``*_0/_1`` naming conventions).
  * ``StereoPairDataset`` — decodes pairs to uint8 [H, W]; validates
    equal shapes (the reference's CLI check, src/stereo.c:350).
  * ``BatchLoader`` — iterator of [B, H, W] brightness batches with a
    background decode thread pool and device prefetch depth 2 (the
    host-side analogue of double buffering).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from stereomatching.utils.imageio import read_png_gray

_PAIR_NAMES = (("a.png", "b.png"), ("left.png", "right.png"))


def discover_pairs(root: str) -> List[Tuple[str, str]]:
    """Find stereo pairs under ``root``: directories containing
    a/b.png or left/right.png (sorted), or flat files matching
    ``<stem>_left.png`` + ``<stem>_right.png``."""
    pairs: List[Tuple[str, str]] = []
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        names = set(filenames)
        for a, b in _PAIR_NAMES:
            if a in names and b in names:
                pairs.append((os.path.join(dirpath, a), os.path.join(dirpath, b)))
        for f in sorted(filenames):
            if f.endswith("_left.png"):
                mate = f[: -len("_left.png")] + "_right.png"
                if mate in names:
                    pairs.append(
                        (os.path.join(dirpath, f), os.path.join(dirpath, mate))
                    )
    return pairs


class StereoPairDataset:
    """Decodes image pairs to uint8 [H, W] on demand."""

    def __init__(self, pairs: Sequence[Tuple[str, str]]):
        self.pairs = list(pairs)

    @classmethod
    def from_root(cls, root: str) -> "StereoPairDataset":
        pairs = discover_pairs(root)
        if not pairs:
            raise FileNotFoundError(f"no stereo pairs under {root}")
        return cls(pairs)

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        a, b = self.pairs[i]
        left = read_png_gray(a)
        right = read_png_gray(b)
        if left.shape != right.shape:
            raise ValueError(
                f"{a} / {b}: the two images must have equal width and height"
            )
        return left, right


class BatchLoader:
    """Iterates fixed-shape [B, H, W] float32 brightness batches with
    threaded decode and device prefetch.

    Pairs whose shape differs from the first pair's are skipped with a
    warning (static shapes keep XLA from recompiling per batch);
    ``pad_to`` instead pads every image up to the given (H, W) with
    zeros.  The final partial batch is dropped unless ``drop_last`` is
    False, in which case it is padded by repeating the last pair (the
    ``count`` field of the yielded batch gives the real number).
    """

    def __init__(
        self,
        dataset: StereoPairDataset,
        batch_size: int,
        pad_to: Optional[Tuple[int, int]] = None,
        drop_last: bool = False,
        num_threads: int = 4,
        device_put: bool = True,
        prefetch: int = 2,
        mesh=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_to = pad_to
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.device_put = device_put
        self.prefetch = prefetch
        # With a mesh, batches are device_put PRE-SHARDED with the
        # pipeline's (data, rows[, cols]) layout, so the sharded tiers
        # consume them without a host round-trip or a resharding copy.
        self.mesh = mesh
        if mesh is not None:
            if batch_size % mesh.shape["data"]:
                raise ValueError(
                    f"batch_size {batch_size} must divide by the mesh "
                    f"data axis ({mesh.shape['data']})"
                )

    def _assemble(self, idxs: Sequence[int]):
        import sys

        decoded = [self.dataset[i] for i in idxs]
        target = self.pad_to or decoded[0][0].shape
        lefts, rights, kept = [], [], 0
        for (l, r), i in zip(decoded, idxs):
            if self.pad_to is None and l.shape != target:
                print(
                    f"warning: skipping pair {i} with shape {l.shape} != {target}",
                    file=sys.stderr,
                )
                continue
            if self.pad_to is not None:
                ph, pw = target[0] - l.shape[0], target[1] - l.shape[1]
                if ph < 0 or pw < 0:
                    raise ValueError(f"pair {i} larger than pad_to {target}")
                l = np.pad(l, ((0, ph), (0, pw)))
                r = np.pad(r, ((0, ph), (0, pw)))
            lefts.append(l)
            rights.append(r)
            kept += 1
        if not lefts:
            return None
        while len(lefts) < self.batch_size:  # pad partial batch
            lefts.append(lefts[-1])
            rights.append(rights[-1])
        lb = np.stack(lefts).astype(np.float32) / np.float32(256.0)
        rb = np.stack(rights).astype(np.float32) / np.float32(256.0)
        if self.device_put:
            import jax

            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec

                from stereomatching.parallel.mesh import (
                    COLS_AXIS,
                    DATA_AXIS,
                    ROWS_AXIS,
                )

                cols = (
                    COLS_AXIS
                    if COLS_AXIS in self.mesh.axis_names else None
                )
                sh = NamedSharding(
                    self.mesh, PartitionSpec(DATA_AXIS, ROWS_AXIS, cols)
                )
                lb = jax.device_put(lb, sh)
                rb = jax.device_put(rb, sh)
            else:
                lb, rb = jax.device_put(lb), jax.device_put(rb)
        return lb, rb, kept

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        n = len(self.dataset)
        batches = [
            list(range(i, min(i + self.batch_size, n)))
            for i in range(0, n, self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        # One worker per in-flight batch; each batch decodes serially in
        # its worker (no nested pool use, so no saturation deadlock).
        with ThreadPoolExecutor(max(self.num_threads, 1)) as pool:
            pending = []
            for idxs in batches:
                pending.append(pool.submit(self._assemble, idxs))
                # Keep `prefetch` batches in flight.
                while len(pending) > self.prefetch:
                    out = pending.pop(0).result()
                    if out is not None:
                        yield out
            for fut in pending:
                out = fut.result()
                if out is not None:
                    yield out
