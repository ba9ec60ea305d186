"""Tests for the SGM aggregation: directional recurrence vs a brute-
force NumPy reference, and end-to-end quality gain over box matching on
low-texture scenes (SGM's raison d'être)."""

import jax.numpy as jnp
import numpy as np
import pytest

from stereomatching.config import ModernParams
from stereomatching.models.modern import build_modern_pipeline
from stereomatching.ops.sgm import (
    _directional,
    right_disparity_from_left_volume,
    sgm_aggregate,
    volume_argmin_subpixel,
)

BIG = 2**28


def _brute_lr(vol, p1, p2):
    """Left-to-right SGM recurrence, literal loops."""
    h, w, d_count = vol.shape
    out = np.zeros_like(vol)
    out[:, 0] = vol[:, 0]
    for x in range(1, w):
        for y in range(h):
            prev = out[y, x - 1]
            m = prev.min()
            for d in range(d_count):
                up = prev[d + 1] if d + 1 < d_count else BIG
                dn = prev[d - 1] if d - 1 >= 0 else BIG
                best = min(prev[d], min(up, dn) + p1, m + p2)
                out[y, x, d] = vol[y, x, d] + best - m
    return out


def test_directional_matches_brute_force():
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 30, size=(5, 9, 6)).astype(np.int32)
    got = np.asarray(_directional(vol, 2, 11))
    np.testing.assert_array_equal(got, _brute_lr(vol, 2, 11))


def test_aggregate_is_direction_sum():
    rng = np.random.default_rng(1)
    vol = rng.integers(0, 25, size=(6, 7, 5)).astype(np.int32)
    p1, p2 = 3, 20
    got = np.asarray(sgm_aggregate(vol, p1, p2))
    lr = _brute_lr(vol, p1, p2)
    rl = _brute_lr(vol[:, ::-1], p1, p2)[:, ::-1]
    tb = _brute_lr(vol.transpose(1, 0, 2), p1, p2).transpose(1, 0, 2)
    bt = _brute_lr(vol.transpose(1, 0, 2)[:, ::-1], p1, p2)[:, ::-1].transpose(1, 0, 2)
    np.testing.assert_array_equal(got, lr + rl + tb + bt)


def _brute_diag(vol, p1, p2, dy, dx):
    """One diagonal SGM pass (predecessor (y-dy, x-dx)), literal loops;
    no-predecessor cells are path starts (L = C)."""
    h, w, d_count = vol.shape
    out = np.zeros_like(vol)
    ys = range(h) if dy == 1 else range(h - 1, -1, -1)
    for y in ys:
        for x in range(w):
            py, px = y - dy, x - dx
            if not (0 <= py < h and 0 <= px < w):
                out[y, x] = vol[y, x]
                continue
            prev = out[py, px]
            m = prev.min()
            for d in range(d_count):
                up = prev[d + 1] if d + 1 < d_count else BIG
                dn = prev[d - 1] if d - 1 >= 0 else BIG
                best = min(prev[d], min(up, dn) + p1, m + p2)
                out[y, x, d] = vol[y, x, d] + best - m
    return out


@pytest.mark.parametrize("dx", [1, -1])
def test_directional_diag_matches_brute_force(dx):
    from stereomatching.ops.sgm import _directional_diag

    rng = np.random.default_rng(3)
    vol = rng.integers(0, 30, size=(6, 9, 5)).astype(np.int32)
    got = np.asarray(_directional_diag(vol, 2, 11, dx=dx))
    np.testing.assert_array_equal(got, _brute_diag(vol, 2, 11, 1, dx))


def test_aggregate_eight_directions_is_sum():
    rng = np.random.default_rng(4)
    vol = rng.integers(0, 25, size=(6, 7, 5)).astype(np.int32)
    p1, p2 = 3, 20
    got = np.asarray(sgm_aggregate(vol, p1, p2, directions=8))
    want = np.asarray(sgm_aggregate(vol, p1, p2))
    for dy in (1, -1):
        for dx in (1, -1):
            want = want + _brute_diag(vol, p1, p2, dy, dx)
    np.testing.assert_array_equal(got, want)


def test_volume_argmin_first_wins_and_subpixel():
    vol = np.full((1, 1, 5), 10, dtype=np.int32)
    vol[0, 0] = [9, 4, 4, 6, 10]  # tie at d=1,2 -> first wins
    d, sub, cost = volume_argmin_subpixel(np.asarray(vol))
    assert int(d[0, 0]) == 1 and int(cost[0, 0]) == 4
    # parabola on (9, 4, 4): denom = 9 - 8 + 4 = 5 > 0, offset = (9-4)/10 = .5
    assert float(sub[0, 0]) == pytest.approx(1.5)


def test_right_disparity_reprojection():
    h, w, d_count = 2, 6, 3
    vol = np.full((h, w, d_count), 50, dtype=np.int32)
    # left pixel x=4 prefers d=2 -> right pixel x'=2 should see it:
    # cost_R(2, d) = vol[:, 2+d, d]
    vol[:, 4, 2] = 1
    dr = np.asarray(right_disparity_from_left_volume(np.asarray(vol)))
    assert (dr[:, 2] == 2).all()


def test_sgm_pipeline_end_to_end_and_lowtexture_gain():
    """On a scene with a weakly-textured shifted region, SGM's smoothness
    paths must beat per-pixel box costs."""
    from stereomatching.utils.metrics import bad_pixel_rate

    rng = np.random.default_rng(7)
    # weak texture: small random jitter around a constant
    base = (128 + rng.integers(-6, 7, size=(48, 96))).astype(np.int32)
    shift = 5
    left, right = base, np.roll(base, -shift, axis=1)
    gt = np.full((48, 96), float(shift))

    sgm = ModernParams(num_disparities=12, cost="census", aggregation="sgm")
    out = build_modern_pipeline(sgm)(left, right)
    assert out["disparity"].shape == (48, 96)
    valid = np.array(out["valid"])
    valid[:, : shift + 6] = False
    rate_sgm = bad_pixel_rate(np.asarray(out["disparity"]), gt, 1.0, valid)

    box = ModernParams(num_disparities=12, cost="census", window=3)
    out_b = build_modern_pipeline(box)(left, right)
    valid_b = np.array(out_b["valid"])
    valid_b[:, : shift + 6] = False
    rate_box = bad_pixel_rate(np.asarray(out_b["disparity"]), gt, 1.0, valid_b)

    assert rate_sgm < 0.05, (rate_sgm, rate_box)
    assert rate_sgm <= rate_box


def test_sgm_batched():
    rng = np.random.default_rng(2)
    l = rng.integers(0, 256, size=(2, 16, 24)).astype(np.int32)
    r = rng.integers(0, 256, size=(2, 16, 24)).astype(np.int32)
    params = ModernParams(num_disparities=6, aggregation="sgm")
    out = build_modern_pipeline(params, batched=True)(l, r)
    assert out["disparity"].shape == (2, 16, 24)
    single = build_modern_pipeline(params)(l[0], r[0])
    np.testing.assert_array_equal(np.asarray(out["disparity"][0]),
                                  np.asarray(single["disparity"]))


def _brute_right_disparity(vol):
    """Right-view disparity by re-projection, literal loops:
    cost_R(x, d) = vol[x + d (clamped), d], first minimum wins."""
    h, w, d_count = vol.shape
    out = np.zeros((h, w), np.int32)
    for y in range(h):
        for x in range(w):
            costs = [vol[y, min(x + d, w - 1), d] for d in range(d_count)]
            out[y, x] = int(np.argmin(costs))
    return out


def _brute_argmin_subpixel(vol):
    """First-minimum argmin + parabola offset over the last axis."""
    disp = vol.argmin(axis=-1).astype(np.int32)
    cost = vol.min(axis=-1)
    sub = disp.astype(np.float64)
    h, w, d_count = vol.shape
    for y in range(h):
        for x in range(w):
            d = disp[y, x]
            if 0 < d < d_count - 1:
                cl, cm, cr = (float(vol[y, x, d - 1]), float(cost[y, x]),
                              float(vol[y, x, d + 1]))
                denom = cl - 2 * cm + cr
                if denom > 0:
                    sub[y, x] = d + np.clip((cl - cr) / (2 * denom), -0.5, 0.5)
    return disp, sub, cost


def _brute_aggregate(vol, p1, p2, directions):
    """Sum of the literal-loop directional passes."""
    vol = vol.astype(np.int64)
    out = (
        _brute_lr(vol, p1, p2)
        + _brute_lr(vol[:, ::-1], p1, p2)[:, ::-1]
        + _brute_lr(vol.transpose(1, 0, 2), p1, p2).transpose(1, 0, 2)
        + _brute_lr(vol.transpose(1, 0, 2)[:, ::-1], p1,
                    p2)[:, ::-1].transpose(1, 0, 2)
    )
    if directions == 8:
        for dy in (1, -1):
            for dx in (1, -1):
                out = out + _brute_diag(vol, p1, p2, dy, dx)
    return out


def _brute_volume(left, right, params):
    """[H, W, D] per-pixel cost: SAD or census Hamming distance against
    the right view at x - d, out-of-frame columns edge-replicated."""
    from stereomatching.ops.costvolume import census_transform

    if params.cost == "census":
        left = np.asarray(census_transform(jnp.asarray(left),
                                           params.census_window))
        right = np.asarray(census_transform(jnp.asarray(right),
                                            params.census_window))
    left = left.astype(np.int64)
    right = right.astype(np.int64)
    h, w = left.shape
    vol = np.zeros((h, w, params.num_disparities), np.int64)
    for d in range(params.num_disparities):
        other = right[:, np.clip(np.arange(w) - d, 0, w - 1)]
        if params.cost == "census":
            x = (left ^ other) & 0xFFFFFFFF
            vol[..., d] = [[bin(v).count("1") for v in row] for row in x]
        else:
            vol[..., d] = np.abs(left - other)
    return vol


class TestSGMReference:
    """The XLA SGM route against literal NumPy loops: aggregation over
    shapes, penalties and path counts; the volume per cost; the tail
    (argmin, sub-pixel, re-projection, uniqueness); the pipeline's
    post-processing options."""

    @pytest.mark.parametrize("shape", [(5, 7, 4), (6, 9, 5), (3, 11, 6),
                                       (8, 4, 3)])
    @pytest.mark.parametrize("p1,p2", [(0, 0), (3, 20), (8, 96)])
    @pytest.mark.parametrize("directions", [4, 8])
    def test_aggregate_matches_brute_force(self, shape, p1, p2, directions):
        rng = np.random.default_rng(sum(shape) + p2)
        vol = rng.integers(0, 40, size=shape).astype(np.int32)
        got = np.asarray(sgm_aggregate(jnp.asarray(vol), p1, p2,
                                       directions=directions))
        np.testing.assert_array_equal(
            got, _brute_aggregate(vol, p1, p2, directions))

    def test_aggregate_rejects_bad_arguments(self):
        vol = jnp.zeros((4, 4, 3), jnp.int32)
        with pytest.raises(ValueError):
            sgm_aggregate(vol, 5, 2)
        with pytest.raises(ValueError):
            sgm_aggregate(vol, 1, 2, directions=6)

    @pytest.mark.parametrize("cost", ["sad", "census"])
    @pytest.mark.parametrize("scales", [1, 2])
    def test_sgm_volume_matches_brute_force(self, cost, scales):
        from stereomatching.models.modern import _sgm_volume

        from tests.util import synthetic_pair

        left, right = synthetic_pair(h=12, w=20, seed=31)
        params = ModernParams(num_disparities=5, aggregation="sgm",
                              cost=cost, scales=scales)
        got = np.asarray(_sgm_volume(jnp.asarray(left, jnp.int32),
                                     jnp.asarray(right, jnp.int32), params))
        want = _brute_volume(left, right, params)
        if scales == 1:
            np.testing.assert_array_equal(got, want)
        else:
            # The half-resolution prior only adds cost.
            assert (got >= want).all() and (got > want).any()

    @pytest.mark.parametrize("shape", [(4, 9, 6), (7, 5, 3), (3, 16, 11)])
    @pytest.mark.parametrize("layout", ["hwd", "dhw"])
    def test_tail_matches_brute_force(self, shape, layout):
        rng = np.random.default_rng(shape[2])
        vol = rng.integers(0, 50, size=shape).astype(np.int32)
        arg = vol if layout == "hwd" else np.moveaxis(vol, -1, 0)
        disp, sub, cost = volume_argmin_subpixel(jnp.asarray(arg),
                                                 layout=layout)
        dr = right_disparity_from_left_volume(jnp.asarray(arg), layout=layout)
        want_d, want_sub, want_cost = _brute_argmin_subpixel(vol)
        np.testing.assert_array_equal(np.asarray(disp), want_d)
        np.testing.assert_array_equal(np.asarray(cost), want_cost)
        np.testing.assert_allclose(np.asarray(sub), want_sub, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(dr),
                                      _brute_right_disparity(vol))

    @pytest.mark.parametrize("cost", ["sad", "census"])
    @pytest.mark.parametrize("directions", [4, 8])
    @pytest.mark.parametrize("d_count", [4, 7])
    def test_modern_sgm_matches_brute_force(self, cost, directions, d_count):
        """The whole SGM route on one pair: volume, aggregation, argmin,
        re-projection and LR check against literal loops."""
        from stereomatching.models.modern import modern_forward

        from tests.util import synthetic_pair

        left, right = synthetic_pair(h=10, w=16, seed=d_count)
        params = ModernParams(num_disparities=d_count, aggregation="sgm",
                              cost=cost, sgm_directions=directions)
        got = modern_forward(jnp.asarray(left, jnp.int32),
                             jnp.asarray(right, jnp.int32), params)
        agg = _brute_aggregate(_brute_volume(left, right, params),
                               params.sgm_p1, params.sgm_p2, directions)
        want_d, want_sub, want_cost = _brute_argmin_subpixel(agg)
        want_dr = _brute_right_disparity(agg)
        np.testing.assert_array_equal(np.asarray(got["disparity"]), want_d)
        np.testing.assert_array_equal(np.asarray(got["cost"]), want_cost)
        np.testing.assert_array_equal(np.asarray(got["disparity_right"]),
                                      want_dr)
        np.testing.assert_allclose(np.asarray(got["subpixel"]), want_sub,
                                   atol=1e-5)
        h, w = want_d.shape
        want_valid = np.zeros((h, w), bool)
        for y in range(h):
            for x in range(w):
                xr = x - want_d[y, x]
                want_valid[y, x] = (
                    xr >= 0 and abs(int(want_dr[y, xr]) - int(want_d[y, x]))
                    <= params.lr_max_diff
                )
        np.testing.assert_array_equal(np.asarray(got["valid"]), want_valid)

    def test_modern_sgm_eight_directions_route(self):
        """8 paths change the result and equal the volume + 8-path
        aggregation + tail composition."""
        from stereomatching.models.modern import (
            _sgm_tail,
            _sgm_volume,
            modern_forward,
        )

        rng = np.random.default_rng(12)
        l = jnp.asarray(rng.integers(0, 256, size=(16, 40)).astype(np.int32))
        r = jnp.asarray(rng.integers(0, 256, size=(16, 40)).astype(np.int32))
        p4 = ModernParams(num_disparities=8, aggregation="sgm", cost="census")
        p8 = ModernParams(num_disparities=8, aggregation="sgm", cost="census",
                          sgm_directions=8)
        got = modern_forward(l, r, p8)
        agg = sgm_aggregate(_sgm_volume(l, r, p8), p8.sgm_p1, p8.sgm_p2,
                            directions=8)
        want = _sgm_tail(agg, p8)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]), err_msg=key)
        assert not np.array_equal(np.asarray(got["cost"]),
                                  np.asarray(modern_forward(l, r, p4)["cost"]))

    def test_uniqueness_second_best_brute(self):
        """c2 = min cost outside the winner's +-1 neighborhood, checked
        against literal loops."""
        from stereomatching.ops.sgm import (
            second_best_outside_neighborhood,
        )

        rng = np.random.default_rng(53)
        vol = rng.integers(0, 100, size=(5, 7, 9)).astype(np.int32)
        disp = np.argmin(vol, axis=-1).astype(np.int32)
        got = np.asarray(
            second_best_outside_neighborhood(jnp.asarray(vol),
                                             jnp.asarray(disp)))
        want = np.empty_like(disp)
        for y in range(5):
            for x in range(7):
                cands = [vol[y, x, d] for d in range(9)
                         if abs(d - disp[y, x]) > 1]
                want[y, x] = min(cands)
        np.testing.assert_array_equal(got, want)

    def test_uniqueness_all_excluded_sentinel(self):
        """D <= 3 puts every disparity inside the winner's +-1
        neighborhood: c2 keeps the _BIG sentinel (2^28)."""
        from stereomatching.ops.sgm import (
            second_best_outside_neighborhood,
        )

        rng = np.random.default_rng(71)
        vol = jnp.asarray(rng.integers(0, 100, size=(16, 12, 2))
                          .astype(np.int32))
        disp, _, _ = volume_argmin_subpixel(vol)
        got = np.asarray(second_best_outside_neighborhood(vol, disp))
        assert (got == 2**28).all()

    def test_modern_sgm_uniqueness(self):
        """The uniqueness plane is c2 / max(c1, 1) of the aggregated
        volume; the box route rejects the flag at config time."""
        from stereomatching.models.modern import modern_forward

        rng = np.random.default_rng(57)
        l = jnp.asarray(rng.integers(0, 256, size=(16, 50)).astype(np.int32))
        r = jnp.asarray(rng.integers(0, 256, size=(16, 50)).astype(np.int32))
        params = ModernParams(num_disparities=8, aggregation="sgm",
                              cost="census", uniqueness=True)
        out = modern_forward(l, r, params)
        u = np.asarray(out["uniqueness"])
        c1 = np.asarray(out["cost"])
        # c2 >= c1 by construction, so the ratio is >= 1 wherever the
        # best cost is >= 1 (c1 == 0 divides by the clamp instead).
        assert (u[c1 >= 1] >= 1.0).all() and (u >= 0).all()
        with pytest.raises(ValueError):
            ModernParams(num_disparities=8, uniqueness=True)

    def test_fill_background_semantics(self):
        """Background extension: holes take min(nearest valid left,
        nearest valid right); one-sided rows extend; empty rows -> 0."""
        from stereomatching.ops.costvolume import fill_background

        d = jnp.asarray(np.array(
            [[5.0, 0, 0, 2, 0, 9],
             [0.0, 0, 3, 0, 0, 0],
             [0.0, 0, 0, 0, 0, 0]], np.float32))
        v = jnp.asarray(np.array(
            [[1, 0, 0, 1, 0, 1],
             [0, 0, 1, 0, 0, 0],
             [0, 0, 0, 0, 0, 0]], bool))
        got = np.asarray(fill_background(d, v))
        want = np.array(
            [[5, 2, 2, 2, 2, 9],
             [3, 3, 3, 3, 3, 3],
             [0, 0, 0, 0, 0, 0]], np.float32)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("aggregation", ["box", "sgm"])
    def test_modern_fill_background(self, aggregation):
        """fill_mode='background': valid pixels keep their sub-pixel
        value, holes take the fill_background of the row."""
        from stereomatching.models.modern import modern_forward
        from stereomatching.ops.costvolume import fill_background

        rng = np.random.default_rng(51)
        l = jnp.asarray(rng.integers(0, 256, size=(16, 50)).astype(np.int32))
        r = jnp.asarray(rng.integers(0, 256, size=(16, 50)).astype(np.int32))
        params = ModernParams(num_disparities=6, aggregation=aggregation,
                              cost="census", fill_mode="background")
        out = modern_forward(l, r, params)
        valid = np.asarray(out["valid"])
        np.testing.assert_array_equal(
            np.asarray(out["filled"])[valid],
            np.asarray(out["subpixel"])[valid])
        np.testing.assert_array_equal(
            np.asarray(out["filled"]),
            np.asarray(fill_background(out["subpixel"], out["valid"])))

    def test_modern_sgm_median_filter_applies(self):
        """median_filter acts on the SGM route: the 3x3 median of the
        unfiltered route's planes, before the LR check."""
        from stereomatching.models.modern import modern_forward
        from stereomatching.ops.costvolume import lr_consistency, median3x3

        rng = np.random.default_rng(43)
        l = jnp.asarray(rng.integers(0, 256, size=(16, 50)).astype(np.int32))
        r = jnp.asarray(rng.integers(0, 256, size=(16, 50)).astype(np.int32))
        base = ModernParams(num_disparities=6, aggregation="sgm",
                            cost="census")
        med = ModernParams(num_disparities=6, aggregation="sgm",
                           cost="census", median_filter=True)
        plain = modern_forward(l, r, base)
        got = modern_forward(l, r, med)
        assert not np.array_equal(np.asarray(got["disparity"]),
                                  np.asarray(plain["disparity"]))
        disp = median3x3(plain["disparity"])
        dr = median3x3(plain["disparity_right"])
        np.testing.assert_array_equal(np.asarray(got["disparity"]),
                                      np.asarray(disp))
        np.testing.assert_array_equal(np.asarray(got["subpixel"]),
                                      np.asarray(median3x3(plain["subpixel"])))
        np.testing.assert_array_equal(
            np.asarray(got["valid"]),
            np.asarray(lr_consistency(disp, dr, med.lr_max_diff, 6)))
