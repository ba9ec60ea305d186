"""Modern-pipeline sharded tier vs single-device — bit-equality on the
8-device CPU mesh for every mesh shape."""

import numpy as np
import pytest

from stereomatching.config import ModernParams
from tests.util import synthetic_pair


def _mesh(data, rows):
    import jax

    from stereomatching.parallel import make_mesh

    if len(jax.devices()) < data * rows:
        pytest.skip("needs CPU mesh")
    return make_mesh(data=data, rows=rows,
                     devices=jax.devices()[: data * rows])


def _run_both(params, data, rows, h=48, w=64, seed=0):
    import jax

    from stereomatching.models.modern import build_modern_pipeline
    from stereomatching.parallel import build_sharded_modern_pipeline

    mesh = _mesh(data, rows)
    lefts, rights = [], []
    for i in range(data):
        l, r = synthetic_pair(h=h, w=w, seed=seed + i)
        lefts.append(l.astype(np.int32))
        rights.append(r.astype(np.int32))
    lb, rb = np.stack(lefts), np.stack(rights)

    sharded = jax.device_get(
        build_sharded_modern_pipeline(params, mesh)(lb, rb)
    )
    single = build_modern_pipeline(params, batched=True)
    want = jax.device_get(single(lb, rb))
    return sharded, want


def _assert_equal(sharded, want):
    for key in ("disparity", "disparity_right", "valid", "cost"):
        np.testing.assert_array_equal(sharded[key], want[key], err_msg=key)
    # Float planes: identical op order -> bitwise equality expected.
    np.testing.assert_array_equal(sharded["subpixel"], want["subpixel"])
    np.testing.assert_array_equal(sharded["filled"], want["filled"])


@pytest.mark.parametrize("data,rows", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_modern_sad_matches_single(data, rows):
    params = ModernParams(num_disparities=8, window=5)
    sharded, want = _run_both(params, data, rows)
    _assert_equal(sharded, want)


@pytest.mark.parametrize("rows", [2, 8])
def test_sharded_modern_census_matches_single(rows):
    params = ModernParams(num_disparities=8, window=5, cost="census",
                          census_window=5)
    sharded, want = _run_both(params, 1, rows, seed=3)
    _assert_equal(sharded, want)


def test_sharded_modern_median_matches_single():
    params = ModernParams(num_disparities=8, window=5, median_filter=True)
    sharded, want = _run_both(params, 2, 4, seed=5)
    _assert_equal(sharded, want)


@pytest.mark.parametrize("cost", ["sad", "census"])
def test_sharded_modern_rows4_matches_single(cost):
    params = ModernParams(num_disparities=8, window=5, cost=cost)
    sharded, want = _run_both(params, 1, 4, seed=7)
    _assert_equal(sharded, want)


def test_sharded_modern_window_one():
    # reach 0 for SAD at window 1: no halo exchange at all.
    params = ModernParams(num_disparities=8, window=1)
    sharded, want = _run_both(params, 1, 8, seed=9)
    _assert_equal(sharded, want)


@pytest.mark.parametrize("data,rows", [(1, 8), (2, 4), (8, 1)])
def test_sharded_modern_sgm_matches_single(data, rows):
    # The vertical recurrences run as a phased ppermute carry chain —
    # must be bit-identical to the single-chip scans for any row count.
    params = ModernParams(num_disparities=8, aggregation="sgm")
    sharded, want = _run_both(params, data, rows, seed=11)
    _assert_equal(sharded, want)


def test_sharded_modern_sgm_census_matches_single():
    params = ModernParams(
        num_disparities=8, aggregation="sgm", cost="census", census_window=5
    )
    sharded, want = _run_both(params, 1, 4, seed=13)
    _assert_equal(sharded, want)


def test_sharded_modern_sgm_data2_rows4_matches_single():
    params = ModernParams(num_disparities=8, aggregation="sgm")
    sharded, want = _run_both(params, 2, 4, seed=17)
    _assert_equal(sharded, want)


@pytest.mark.parametrize("dirs", [4, 8])
def test_sharded_modern_sgm_d32_matches_single(dirs):
    params = ModernParams(num_disparities=32, aggregation="sgm",
                          cost="census", sgm_directions=dirs)
    sharded, want = _run_both(params, 1, 4, seed=29 + dirs, h=32, w=48)
    _assert_equal(sharded, want)


def test_sharded_modern_sgm_uniqueness_matches_single():
    params = ModernParams(num_disparities=8, aggregation="sgm",
                          uniqueness=True)
    sharded, want = _run_both(params, 1, 4, seed=27)
    _assert_equal(sharded, want)
    np.testing.assert_array_equal(sharded["uniqueness"],
                                  want["uniqueness"])


def test_sharded_modern_fill_background_matches_single():
    # Background extension is x-only -> intra-shard, no exchange.
    params = ModernParams(num_disparities=8, aggregation="sgm",
                          fill_mode="background")
    sharded, want = _run_both(params, 1, 4, seed=23)
    _assert_equal(sharded, want)


def test_sharded_modern_sgm_median_matches_single():
    # median_filter on the SGM route: 1-row halo exchange before LR.
    params = ModernParams(num_disparities=8, aggregation="sgm",
                          median_filter=True)
    sharded, want = _run_both(params, 2, 4, seed=21)
    _assert_equal(sharded, want)


@pytest.mark.parametrize("rows", [4, 8])
def test_sharded_modern_sgm_eight_directions_matches_single(rows):
    # Diagonal paths: the carry's column shift is intra-shard, so the
    # phased chain must stay bit-identical to the single-chip 8-path
    # aggregation across shard boundaries.
    params = ModernParams(num_disparities=8, aggregation="sgm",
                          cost="census", sgm_directions=8)
    sharded, want = _run_both(params, 1, rows, seed=19)
    _assert_equal(sharded, want)


@pytest.mark.parametrize("rows,dirs", [(4, 4), (8, 4), (4, 8), (8, 8)])
def test_sharded_modern_sgm_rows_dirs_matches_single(rows, dirs):
    # The y-crossing passes (verticals AND diagonals) as a phased carry
    # chain: every mesh shape stays bit-identical to the single-device
    # scans — tiling must not change the per-tile result (the
    # reference's ghost rule, src/stereo-ghost.cu:146-159).
    params = ModernParams(num_disparities=8, aggregation="sgm",
                          cost="census", sgm_directions=dirs)
    sharded, want = _run_both(params, 1, rows, seed=23)
    _assert_equal(sharded, want)


def test_sharded_modern_validation():
    from stereomatching.parallel import sharded_modern_forward

    mesh = _mesh(1, 8)
    lb = np.zeros((1, 48, 64), np.int32)
    with pytest.raises(ValueError, match="scales=1"):
        sharded_modern_forward(
            lb, lb, ModernParams(num_disparities=8, scales=2), mesh
        )
    with pytest.raises(ValueError, match="row shards"):
        sharded_modern_forward(
            lb[:, :44], lb[:, :44], ModernParams(num_disparities=8), mesh
        )


@pytest.mark.parametrize("cost", ["sad", "census"])
@pytest.mark.parametrize("data,rows,cols", [(1, 2, 4), (2, 2, 2), (1, 1, 4)])
def test_sharded_modern_2d_matches_single(cost, data, rows, cols):
    """2-D (rows x cols) modern box tier: the slide's x reach, the box
    window, LR's right-view lookup, median, and the diffusion fill all
    ride column halo exchanges; bit-identical to the single-chip
    pipeline for every mesh shape."""
    import jax
    import jax.numpy as jnp

    from stereomatching.models.modern import modern_forward
    from stereomatching.parallel import (
        build_sharded_modern_pipeline,
        make_mesh,
    )

    params = ModernParams(num_disparities=8, window=5, cost=cost,
                          median_filter=True)
    rng = np.random.default_rng(37)
    lb = jnp.asarray(rng.integers(0, 256, (data, rows * 12, cols * 24))
                     .astype(np.int32))
    rb = jnp.asarray(rng.integers(0, 256, (data, rows * 12, cols * 24))
                     .astype(np.int32))
    mesh = make_mesh(data=data, rows=rows, cols=cols,
                     devices=jax.devices()[: data * rows * cols])
    got = build_sharded_modern_pipeline(params, mesh)(lb, rb)
    want = jax.vmap(lambda a, b: modern_forward(a, b, params))(lb, rb)
    _assert_equal(got, want)


def test_sharded_modern_2d_validation():
    import jax.numpy as jnp

    from stereomatching.parallel import (
        make_mesh,
        sharded_modern_forward,
    )

    mesh = make_mesh(data=1, rows=1, cols=8)
    lb = jnp.zeros((1, 16, 64), jnp.int32)
    with pytest.raises(ValueError, match="x halo reach"):
        sharded_modern_forward(lb, lb, ModernParams(num_disparities=8),
                               mesh)
    with pytest.raises(ValueError, match="rows-only"):
        sharded_modern_forward(
            lb, lb, ModernParams(num_disparities=8, aggregation="sgm"),
            make_mesh(data=1, rows=2, cols=4),
        )
    with pytest.raises(ValueError, match="background"):
        sharded_modern_forward(
            lb, lb,
            ModernParams(num_disparities=8, fill_mode="background"),
            make_mesh(data=1, rows=2, cols=4),
        )


def test_sharded_rejects_multiscale_sgm():
    """Round 5: scales=2 fuses a cost pyramid into the SGM volume on
    the single-chip XLA tier; the sharded tier does not implement the
    fusion and must reject rather than silently compute single-scale."""
    import jax
    import pytest

    from stereomatching.config import ModernParams
    from stereomatching.parallel import (
        build_sharded_modern_pipeline,
        make_mesh,
    )

    mesh = make_mesh(data=1, rows=2, devices=jax.devices()[:2])
    params = ModernParams(num_disparities=8, aggregation="sgm", scales=2)
    fn = build_sharded_modern_pipeline(params, mesh)
    l = np.zeros((1, 32, 64), np.int32)
    with pytest.raises(ValueError, match="scales=1"):
        fn(l, l)
