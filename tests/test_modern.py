"""Tests for the modern SAD pipeline (cost volume, sub-pixel refine,
LR consistency, hole filling, multi-scale fusion).

The spec here is a brute-force NumPy implementation that materializes
the full cost volume — the fused scan must match it exactly on integer
disparities and to float tolerance on the parabola offsets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereomatching.config import ModernParams
from stereomatching.models.modern import build_modern_pipeline, disparity_one_view
from stereomatching.ops.costvolume import fill_invalid, lr_consistency, sad_disparity
from tests.util import synthetic_pair


def _brute_cost_volume(ref, other, d_count, half, reference):
    """[D, H, W] aggregated SAD with edge-replicated out-of-frame reads
    and zero-padded window aggregation."""
    h, w = ref.shape
    ref = ref.astype(np.int64)
    other = other.astype(np.int64)
    vol = np.zeros((d_count, h, w), dtype=np.int64)
    for d in range(d_count):
        xs = np.arange(w) - d if reference == "left" else np.arange(w) + d
        xs = np.clip(xs, 0, w - 1)
        ad = np.abs(ref - other[:, xs])
        p = np.pad(ad, half)
        sat = np.pad(p.cumsum(0).cumsum(1), ((1, 0), (1, 0)))
        k = 2 * half + 1
        vol[d] = sat[k:, k:] - sat[:-k, k:] - sat[k:, :-k] + sat[:-k, :-k]
    return vol


def _brute_disparity(vol):
    """First-minimum argmin + parabola subpixel, matching the scan spec."""
    d_count, h, w = vol.shape
    best_d = vol.argmin(axis=0)  # np.argmin returns FIRST min
    best = vol.min(axis=0)
    sub = best_d.astype(np.float64)
    for y in range(h):
        for x in range(w):
            d = best_d[y, x]
            if 0 < d < d_count - 1:
                cl, cm, cr = float(vol[d - 1, y, x]), float(best[y, x]), float(vol[d + 1, y, x])
                denom = cl - 2 * cm + cr
                if denom > 0:
                    sub[y, x] = d + np.clip((cl - cr) / (2 * denom), -0.5, 0.5)
    return best_d.astype(np.int32), sub, best


@pytest.mark.parametrize("reference", ["left", "right"])
@pytest.mark.parametrize("d_count,window", [(16, 9), (8, 1), (32, 5)])
def test_sad_disparity_matches_brute_force(reference, d_count, window):
    left, right = synthetic_pair(h=32, w=48, seed=1)
    res = sad_disparity(left.astype(np.int32), right.astype(np.int32),
                        d_count, window, reference)
    ref, other = (left, right) if reference == "left" else (right, left)
    vol = _brute_cost_volume(ref, other, d_count, window // 2, reference)
    want_d, want_sub, want_cost = _brute_disparity(vol)
    np.testing.assert_array_equal(np.asarray(res.disparity), want_d)
    np.testing.assert_array_equal(np.asarray(res.cost), want_cost)
    np.testing.assert_allclose(np.asarray(res.subpixel), want_sub, atol=1e-5)


def test_known_shift_recovered():
    """A globally shifted image must come back as a constant disparity
    (away from the left border where the true match is out of frame)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=(40, 80)).astype(np.int32)
    shift = 5
    left = base
    right = np.roll(base, -shift, axis=1)  # R(x) = L(x+shift) -> d(x)=shift
    res = sad_disparity(left, right, 16, window=5, reference="left")
    got = np.asarray(res.disparity)[:, shift + 8 : -8]
    assert (got == shift).mean() > 0.99
    sub = np.asarray(res.subpixel)[:, shift + 8 : -8]
    np.testing.assert_allclose(sub, shift, atol=0.5)


def test_lr_consistency_flags_occlusions():
    dl = np.full((4, 16), 3, dtype=np.int32)
    dr = np.full((4, 16), 3, dtype=np.int32)
    dr[:, 5] = 9  # inconsistent pixel: dL(8)=3 -> dR(5)=9
    valid = np.asarray(lr_consistency(dl, dr, max_diff=1))
    assert not valid[0, 8]
    assert valid[0, 9]  # dR(6)=3 consistent
    assert not valid[:, :3].any()  # x - d < 0: out of frame


def test_fill_invalid_diffuses():
    d = np.zeros((8, 8), dtype=np.float32)
    d[:, :4] = 2.0
    d[:, 4:] = 6.0
    valid = np.ones((8, 8), dtype=bool)
    d_hole = d.copy()
    d_hole[3:5, 3:5] = 0.0
    valid_hole = valid.copy()
    valid_hole[3:5, 3:5] = False
    filled = np.asarray(fill_invalid(d_hole, valid_hole, iterations=8))
    assert (filled[3:5, 3:5] >= 2.0).all() and (filled[3:5, 3:5] <= 6.0).all()
    np.testing.assert_array_equal(filled[0], d[0])  # valid pixels untouched


@pytest.mark.parametrize("scales", [1, 2])
def test_modern_pipeline_end_to_end(scales):
    left, right = synthetic_pair(h=48, w=64, seed=3)
    params = ModernParams(num_disparities=16, window=7, scales=scales)
    fn = build_modern_pipeline(params)
    out = fn(left.astype(np.int32), right.astype(np.int32))
    assert out["disparity"].shape == (48, 64)
    assert out["valid"].dtype == bool
    assert np.asarray(out["valid"]).mean() > 0.5  # mostly consistent
    d = np.asarray(out["disparity"])
    assert d.min() >= 0 and d.max() < 16
    # filled map has no NaNs and stays in range
    filled = np.asarray(out["filled"])
    assert np.isfinite(filled).all()


def test_modern_batched():
    left, right = synthetic_pair(h=24, w=32, seed=5)
    params = ModernParams(num_disparities=8, window=5)
    single = build_modern_pipeline(params)
    batched = build_modern_pipeline(params, batched=True)
    l = np.stack([left, left]).astype(np.int32)
    r = np.stack([right, right]).astype(np.int32)
    got = batched(l, r)
    want = single(left.astype(np.int32), right.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(got["disparity"][0]),
                                  np.asarray(want["disparity"]))


def test_multiscale_coarse_influences_cost():
    """scales=2 must actually change the cost (pyramid fused in)."""
    left, right = synthetic_pair(h=32, w=32, seed=7)
    p1 = ModernParams(num_disparities=8, window=5, scales=1)
    p2 = ModernParams(num_disparities=8, window=5, scales=2)
    c1 = np.asarray(disparity_one_view(left.astype(np.int32), right.astype(np.int32), p1).cost)
    c2 = np.asarray(disparity_one_view(left.astype(np.int32), right.astype(np.int32), p2).cost)
    assert (c2 >= c1).all()  # coarse adds non-negative cost
    assert (c2 > c1).any()


def test_popcount32():
    from stereomatching.ops.costvolume import popcount32

    vals = np.array([0, 1, 3, 0xFFFFFF, 0x00F0F0F0, 2**24 - 1], dtype=np.int32)
    got = np.asarray(popcount32(vals))
    want = np.array([bin(int(v)).count("1") for v in vals])
    np.testing.assert_array_equal(got, want)


def test_census_transform_brute_force():
    from stereomatching.ops.costvolume import census_transform

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(12, 16)).astype(np.int32)
    got = np.asarray(census_transform(img, 3))
    p = np.pad(img, 1, mode="edge")
    for y in range(12):
        for x in range(16):
            bit = 0
            code = 0
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dy == 0 and dx == 0:
                        continue
                    if p[1 + y + dy, 1 + x + dx] < img[y, x]:
                        code |= 1 << bit
                    bit += 1
            assert got[y, x] == code, (y, x)


@pytest.mark.parametrize("scales", [1, 2])
def test_census_cost_recovers_known_shift(scales):
    from stereomatching.utils.metrics import bad_pixel_rate

    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, size=(40, 80)).astype(np.int32)
    shift = 4
    left, right = base, np.roll(base, -shift, axis=1)
    params = ModernParams(num_disparities=12, window=7, cost="census",
                          scales=scales)
    out = build_modern_pipeline(params)(left, right)
    valid = np.array(out["valid"])
    valid[:, : shift + 8] = False
    gt = np.full((40, 80), float(shift))
    assert bad_pixel_rate(np.asarray(out["disparity"]), gt, 1.0, valid) < 0.02


def test_census_invariant_to_illumination_gain():
    """Census matching must survive a brightness scaling of one view
    that breaks SAD."""
    from stereomatching.models.modern import disparity_one_view

    rng = np.random.default_rng(5)
    base = rng.integers(20, 200, size=(40, 80)).astype(np.int32)
    shift = 3
    left = base
    right_dimmed = (np.roll(base, -shift, axis=1) * 0.5).astype(np.int32)
    census = ModernParams(num_disparities=8, window=7, cost="census")
    d_census = np.asarray(
        disparity_one_view(left, right_dimmed, census).disparity
    )[:, shift + 8 : -8]
    sad = ModernParams(num_disparities=8, window=7, cost="sad")
    d_sad = np.asarray(
        disparity_one_view(left, right_dimmed, sad).disparity
    )[:, shift + 8 : -8]
    assert (d_census == shift).mean() > 0.95
    assert (d_census == shift).mean() > (d_sad == shift).mean()


def test_median3x3_matches_numpy():
    from stereomatching.ops.costvolume import median3x3

    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, size=(17, 23)).astype(np.int32)
    got = np.asarray(median3x3(x))
    p = np.pad(x, 1, mode="edge")
    for y in range(17):
        for xx in range(23):
            assert got[y, xx] == np.median(p[y : y + 3, xx : xx + 3]), (y, xx)


def test_median_filter_removes_speckle():
    from stereomatching.utils.metrics import bad_pixel_rate

    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, size=(40, 80)).astype(np.int32)
    shift = 4
    left, right = base, np.roll(base, -shift, axis=1)
    gt = np.full((40, 80), float(shift))
    # tiny window -> speckly disparity; median cleans it
    plain = ModernParams(num_disparities=8, window=3)
    med = ModernParams(num_disparities=8, window=3, median_filter=True)
    o1 = build_modern_pipeline(plain)(left, right)
    o2 = build_modern_pipeline(med)(left, right)
    v1 = np.array(o1["valid"]); v1[:, : shift + 6] = False
    v2 = np.array(o2["valid"]); v2[:, : shift + 6] = False
    r1 = bad_pixel_rate(np.asarray(o1["disparity"]), gt, 1.0, v1)
    r2 = bad_pixel_rate(np.asarray(o2["disparity"]), gt, 1.0, v2)
    assert r2 <= r1
    assert o2["subpixel"].shape == (40, 80)


def _brute_fill_invalid(d, v, iterations):
    """fill_invalid's Jacobi sweeps in float32 NumPy, literal loops."""
    d = d.astype(np.float32).copy()
    v = v.astype(bool).copy()
    h, w = d.shape
    for _ in range(iterations):
        nd, nv = d.copy(), v.copy()
        for y in range(h):
            for x in range(w):
                if v[y, x]:
                    continue
                num, den = np.float32(0), np.float32(0)
                for yy, xx in ((y, x + 1), (y, x - 1), (y + 1, x), (y - 1, x)):
                    if 0 <= yy < h and 0 <= xx < w and v[yy, xx]:
                        num += d[yy, xx]
                        den += 1
                if den > 0:
                    nd[y, x] = num / den
                    nv[y, x] = True
        d, v = nd, nv
    return d


@pytest.mark.parametrize("shape", [(17, 23), (24, 128), (9, 256), (33, 140)])
def test_fill_invalid_pallas_bit_identical(shape):
    """fill_invalid against literal loops (valid-aware 4-neighbour
    means, holes become valid once a neighbour is), including rows and
    columns at the image border; also unrolled == scanned."""
    h, w = shape
    rng = np.random.default_rng(h * w)
    d = rng.uniform(0, 60, size=(h, w)).astype(np.float32)
    v = rng.random((h, w)) < 0.6
    got = fill_invalid(jnp.asarray(d), jnp.asarray(v), iterations=3)
    np.testing.assert_allclose(np.asarray(got), _brute_fill_invalid(d, v, 3),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(fill_invalid(jnp.asarray(d), jnp.asarray(v), 3,
                                unroll=True)),
        np.asarray(got))


def test_fill_invalid_pallas_batched_and_zero_iters():
    rng = np.random.default_rng(7)
    d = jnp.asarray(rng.uniform(0, 60, size=(3, 20, 31)).astype(np.float32))
    v = jnp.asarray(rng.random((3, 20, 31)) < 0.5)
    got = jax.vmap(lambda a, b: fill_invalid(a, b, iterations=5))(d, v)
    for i in range(3):
        np.testing.assert_array_equal(
            np.asarray(got[i]), np.asarray(fill_invalid(d[i], v[i], 5)))
    np.testing.assert_array_equal(
        np.asarray(fill_invalid(d[0], v[0], iterations=0)), np.asarray(d[0])
    )


def test_lr_consistency_unroll_bit_identical():
    rng = np.random.default_rng(11)
    dl = jnp.asarray(rng.integers(0, 16, size=(21, 37)).astype(np.int32))
    dr = jnp.asarray(rng.integers(0, 16, size=(21, 37)).astype(np.int32))
    want = lr_consistency(dl, dr, max_diff=1, num_disparities=16)
    got = lr_consistency(dl, dr, max_diff=1, num_disparities=16, unroll=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_multiscale_sgm_fusion():
    """scales=2 fuses a half-res per-pixel cost prior into the SGM
    volume.  The fused volume must differ from single-scale, only add
    cost, and run end-to-end."""
    import jax.numpy as jnp

    from stereomatching.models.modern import _sgm_volume, build_modern_pipeline

    left, right = synthetic_pair(h=32, w=48, seed=5)
    p1 = ModernParams(num_disparities=8, aggregation="sgm", cost="census",
                      scales=1)
    p2 = ModernParams(num_disparities=8, aggregation="sgm", cost="census",
                      scales=2)
    v1 = np.asarray(_sgm_volume(jnp.asarray(left, jnp.int32),
                                jnp.asarray(right, jnp.int32), p1))
    v2 = np.asarray(_sgm_volume(jnp.asarray(left, jnp.int32),
                                jnp.asarray(right, jnp.int32), p2))
    assert (v2 >= v1).all()  # the coarse prior adds non-negative cost
    assert (v2 > v1).any()
    # Census costs are at most 24 per level.
    assert v2.max() <= 24 * (1 + p2.coarse_weight)

    out = build_modern_pipeline(p2)(left.astype(np.int32),
                                    right.astype(np.int32))
    assert np.asarray(out["disparity"]).shape == left.shape
