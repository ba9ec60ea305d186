"""Serving API: a stateful ``Matcher`` wrapping the jitted pipelines.

The deployment-facing surface for continuous operation (the reference
is one-shot: load two images, run, exit, src/stereo.c:335-392).  A
``Matcher``:

  * caches one compiled executable per (shape, batch) — repeated calls
    at production shapes never retrace;
  * accepts uint8 pixel arrays or brightness floats, single pairs or
    batches;
  * selects the execution tier (the backend's choice / xla / pallas /
    sharded over a mesh);
  * exposes ``warmup`` so compilation happens at startup, not on the
    first request.

    matcher = Matcher(StereoParams(num_shifts=64))
    matcher.warmup((1080, 1920))
    arts = matcher(left_u8, right_u8)      # dict of np arrays
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from stereomatching.config import ModernParams, StereoParams


class Matcher:
    """Shape-cached classic-pipeline runner.

    ``tier`` selects the execution path:
      auto    — the match route the backend decision point picks
                (utils/platform.implementation("classic_match"));
      xla     — the XLA shift scan;
      pallas  — the fused GPU kernel (ops/fused.py);
      sharded — shard_map over ``mesh`` (parallel/pipeline.py), with the
                decision point's match route on each shard.
    """

    def __init__(
        self,
        params: Optional[StereoParams] = None,
        tier: str = "auto",
        mesh=None,
    ):
        if tier not in ("auto", "xla", "pallas", "sharded"):
            raise ValueError(tier)
        if tier == "sharded" and mesh is None:
            raise ValueError("sharded tier needs a mesh (parallel.make_mesh)")
        self.params = params or StereoParams(edge_rule="exact")
        self.tier = tier
        self.mesh = mesh
        self._cache: Dict[Tuple[int, ...], object] = {}

    def _build(self, batched: bool):
        from stereomatching.utils.platform import (
            ensure_compile_cache,
            implementation,
        )

        ensure_compile_cache()
        if self.tier in ("auto", "sharded"):
            use_pallas = implementation("classic_match") == "fused"
        else:
            use_pallas = self.tier == "pallas"
        if self.tier == "sharded":
            from stereomatching.parallel import build_sharded_pipeline

            return build_sharded_pipeline(self.params, self.mesh,
                                          use_pallas=use_pallas)
        from stereomatching.models.classic import build_classic_pipeline

        return build_classic_pipeline(
            self.params, batched=batched, use_pallas=use_pallas
        )

    def _fn(self, shape: Tuple[int, ...]):
        key = (len(shape),) + tuple(shape)
        if key not in self._cache:
            batched = len(shape) == 3 or self.tier == "sharded"
            self._cache[key] = self._build(batched)
        return self._cache[key]

    @staticmethod
    def _to_brightness(img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if np.issubdtype(img.dtype, np.integer):
            return img.astype(np.float32) / np.float32(256.0)
        return img.astype(np.float32)

    def warmup(self, hw: Tuple[int, int], batch: Optional[int] = None) -> None:
        """Compile for (H, W) (and batch) ahead of serving."""
        shape = (batch, *hw) if batch else hw
        if self.tier == "sharded" and batch is None:
            shape = (1, *hw)
        zeros = np.zeros(shape, np.float32)
        import jax

        jax.block_until_ready(self._fn(shape)(zeros, zeros))

    def __call__(self, left: np.ndarray, right: np.ndarray) -> Dict[str, np.ndarray]:
        import jax

        lb = self._to_brightness(left)
        rb = self._to_brightness(right)
        if lb.shape != rb.shape:
            raise ValueError("the two images must have equal width and height")
        squeeze = lb.ndim == 2 and self.tier == "sharded"
        if squeeze:
            lb, rb = lb[None], rb[None]
        n_real = lb.shape[0] if lb.ndim == 3 else None
        if self.tier == "sharded":
            from stereomatching.parallel.mesh import DATA_AXIS, ROWS_AXIS

            n_data = self.mesh.shape[DATA_AXIS]
            n_rows = self.mesh.shape[ROWS_AXIS]
            if lb.shape[0] % n_data:
                # Global-batch padding: repeat the last pair up to the
                # next data-axis multiple (shape-cached per padded
                # size); padded results are sliced away below.
                pad = n_data - lb.shape[0] % n_data
                reps = [(0, pad)] + [(0, 0)] * (lb.ndim - 1)
                lb = np.pad(lb, reps, mode="edge")
                rb = np.pad(rb, reps, mode="edge")
            if lb.shape[1] % n_rows:
                raise ValueError(
                    f"height {lb.shape[1]} must divide by the mesh rows "
                    f"axis ({n_rows})"
                )
        out = jax.device_get(self._fn(lb.shape)(lb, rb))
        if squeeze:
            out = {k: np.asarray(v)[0] for k, v in out.items()}
        elif n_real is not None and lb.shape[0] != n_real:
            out = {k: np.asarray(v)[:n_real] for k, v in out.items()}
        return {k: np.asarray(v) for k, v in out.items()}


class ModernMatcher:
    """Shape-cached modern-pipeline (SAD/census) runner.

    ``tier`` selects the execution path:
      xla     — the XLA pipeline on one device;
      sharded — shard_map over ``mesh`` (parallel/modern.py); inputs are
                treated as global [B, H, W] batches.
    """

    def __init__(
        self,
        params: Optional[ModernParams] = None,
        tier: str = "xla",
        mesh=None,
    ):
        if tier not in ("xla", "sharded"):
            raise ValueError(
                f"tier {tier!r}: the modern pipeline runs the 'xla' or "
                "'sharded' tier"
            )
        if tier == "sharded" and mesh is None:
            raise ValueError("sharded tier needs a mesh (parallel.make_mesh)")
        self.params = params or ModernParams()
        self.tier = tier
        self.mesh = mesh
        self._cache: Dict[Tuple[int, ...], object] = {}

    def _fn(self, shape: Tuple[int, ...]):
        if shape not in self._cache:
            from stereomatching.utils.platform import ensure_compile_cache

            ensure_compile_cache()
            if self.tier == "sharded":
                from stereomatching.parallel import (
                    build_sharded_modern_pipeline,
                )

                self._cache[shape] = build_sharded_modern_pipeline(
                    self.params, self.mesh
                )
            else:
                from stereomatching.models.modern import (
                    build_modern_pipeline,
                )

                self._cache[shape] = build_modern_pipeline(
                    self.params, batched=len(shape) == 3
                )
        return self._cache[shape]

    def warmup(self, hw: Tuple[int, int], batch: Optional[int] = None) -> None:
        shape = (batch, *hw) if batch else hw
        if self.tier == "sharded" and batch is None:
            shape = (1, *hw)
        zeros = np.zeros(shape, np.int32)
        import jax

        jax.block_until_ready(self._fn(shape)(zeros, zeros))

    @staticmethod
    def _to_pixels(img: np.ndarray) -> np.ndarray:
        """0..255 integer pixel planes.  Float inputs must be the same
        0..255 pixel scale (NOT [0,1) brightness — truncating those to
        int32 would silently zero the image, so brightness-scale floats
        are rejected)."""
        img = np.asarray(img)
        if np.issubdtype(img.dtype, np.floating):
            if img.size and float(img.max()) <= 1.0 and float(img.min()) >= 0.0:
                raise ValueError(
                    "ModernMatcher takes 0..255 pixel values, not [0,1) "
                    "brightness floats (multiply by 256 and floor first)"
                )
        elif not np.issubdtype(img.dtype, np.integer):
            raise ValueError(f"unsupported image dtype {img.dtype}")
        return img.astype(np.int32)

    def __call__(self, left: np.ndarray, right: np.ndarray) -> Dict[str, np.ndarray]:
        import jax

        l = self._to_pixels(left)
        r = self._to_pixels(right)
        if l.shape != r.shape:
            raise ValueError("the two images must have equal width and height")
        squeeze = l.ndim == 2 and self.tier == "sharded"
        if squeeze:
            l, r = l[None], r[None]
        n_real = l.shape[0] if l.ndim == 3 else None
        if self.tier == "sharded":
            from stereomatching.parallel.mesh import DATA_AXIS

            n_data = self.mesh.shape[DATA_AXIS]
            if l.shape[0] % n_data:
                # Global-batch padding: repeat the last pair up to the
                # next data-axis multiple; padded rows sliced away.
                pad = n_data - l.shape[0] % n_data
                reps = [(0, pad)] + [(0, 0)] * (l.ndim - 1)
                l = np.pad(l, reps, mode="edge")
                r = np.pad(r, reps, mode="edge")
        out = jax.device_get(self._fn(l.shape)(l, r))
        if squeeze:
            out = {k: np.asarray(v)[0] for k, v in out.items()}
        elif n_real is not None and l.shape[0] != n_real:
            out = {k: np.asarray(v)[:n_real] for k, v in out.items()}
        return {k: np.asarray(v) for k, v in out.items()}
