"""The modern pipeline's box route (SAD or census cost, window sum,
first-minimum argmin, sub-pixel, LR check) against a brute-force NumPy
cost volume."""

import jax.numpy as jnp
import numpy as np
import pytest

from stereomatching.config import ModernParams
from stereomatching.models.modern import (
    build_modern_pipeline,
    disparity_one_view,
    modern_forward,
)
from stereomatching.ops.costvolume import census_transform
from tests.test_modern import _brute_disparity
from tests.util import synthetic_pair


def _brute_box_volume(ref, other, params, reference):
    """[D, H, W] window sums of the per-pixel cost against the other
    view at x -/+ d (edge-replicated), zero-padded aggregation."""
    if params.cost == "census":
        ref = np.asarray(census_transform(jnp.asarray(ref),
                                          params.census_window))
        other = np.asarray(census_transform(jnp.asarray(other),
                                            params.census_window))
    ref, other = ref.astype(np.int64), other.astype(np.int64)
    h, w = ref.shape
    half = params.window // 2
    k = 2 * half + 1
    vol = np.zeros((params.num_disparities, h, w), np.int64)
    for d in range(params.num_disparities):
        xs = np.arange(w) - d if reference == "left" else np.arange(w) + d
        o = other[:, np.clip(xs, 0, w - 1)]
        if params.cost == "census":
            c = np.vectorize(lambda v: bin(v & 0xFFFFFFFF).count("1"))(ref ^ o)
        else:
            c = np.abs(ref - o)
        p = np.pad(c, half)
        for dy in range(k):
            for dx in range(k):
                vol[d] += p[dy:dy + h, dx:dx + w]
    return vol


@pytest.mark.parametrize("cost", ["sad", "census"])
@pytest.mark.parametrize("reference", ["left", "right"])
@pytest.mark.parametrize("window,d_count", [(7, 12), (1, 32), (11, 8)])
def test_box_route_matches_brute_force(cost, reference, window, d_count):
    params = ModernParams(num_disparities=d_count, window=window, cost=cost)
    left, right = synthetic_pair(h=24, w=40, seed=window + d_count)
    got = disparity_one_view(left.astype(np.int32), right.astype(np.int32),
                             params, reference)
    ref, other = (left, right) if reference == "left" else (right, left)
    want_d, want_sub, want_cost = _brute_disparity(
        _brute_box_volume(ref, other, params, reference))
    np.testing.assert_array_equal(np.asarray(got.disparity), want_d)
    np.testing.assert_array_equal(np.asarray(got.cost), want_cost)
    np.testing.assert_allclose(np.asarray(got.subpixel), want_sub, atol=1e-5)


@pytest.mark.parametrize("cost", ["sad", "census"])
def test_box_pipeline_lr_check_matches_brute_force(cost):
    params = ModernParams(num_disparities=8, window=5, cost=cost)
    left, right = synthetic_pair(h=20, w=32, seed=3)
    out = modern_forward(jnp.asarray(left, jnp.int32),
                         jnp.asarray(right, jnp.int32), params)
    dl = _brute_disparity(_brute_box_volume(left, right, params, "left"))[0]
    dr = _brute_disparity(_brute_box_volume(right, left, params, "right"))[0]
    np.testing.assert_array_equal(np.asarray(out["disparity_right"]), dr)
    h, w = dl.shape
    want = np.zeros((h, w), bool)
    for y in range(h):
        for x in range(w):
            xr = x - dl[y, x]
            want[y, x] = xr >= 0 and abs(int(dr[y, xr]) - int(dl[y, x])) <= 1
    np.testing.assert_array_equal(np.asarray(out["valid"]), want)


def test_box_batched_pipeline_matches_per_pair():
    params = ModernParams(num_disparities=8, window=5)
    pairs = [synthetic_pair(h=24, w=32, seed=s) for s in range(2)]
    l = np.stack([p[0] for p in pairs]).astype(np.int32)
    r = np.stack([p[1] for p in pairs]).astype(np.int32)
    got = build_modern_pipeline(params, batched=True)(l, r)
    for i in range(2):
        want = build_modern_pipeline(params)(l[i], r[i])
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k][i]),
                                          np.asarray(want[k]), err_msg=k)
