"""Tests for the data loader and serving API."""

import os

import numpy as np
import pytest

from stereomatching.config import ModernParams, StereoParams
from stereomatching.data import BatchLoader, StereoPairDataset, discover_pairs
from stereomatching.oracle import pipeline as oracle
from stereomatching.serving import Matcher, ModernMatcher
from stereomatching.utils.imageio import to_brightness, write_png_gray
from tests.util import synthetic_pair


@pytest.fixture
def dataset_root(tmp_path):
    for i in range(5):
        d = tmp_path / f"{i}-pair"
        d.mkdir()
        l, r = synthetic_pair(h=32, w=48, seed=i)
        write_png_gray(str(d / "a.png"), l)
        write_png_gray(str(d / "b.png"), r)
    # one flat-convention pair
    l, r = synthetic_pair(h=32, w=48, seed=9)
    write_png_gray(str(tmp_path / "x_left.png"), l)
    write_png_gray(str(tmp_path / "x_right.png"), r)
    return str(tmp_path)


def test_discover_and_dataset(dataset_root):
    pairs = discover_pairs(dataset_root)
    assert len(pairs) == 6
    ds = StereoPairDataset.from_root(dataset_root)
    l, r = ds[0]
    assert l.shape == (32, 48) and l.dtype == np.uint8


def test_batch_loader_shapes_and_counts(dataset_root):
    ds = StereoPairDataset.from_root(dataset_root)
    batches = list(BatchLoader(ds, batch_size=4, device_put=False))
    assert len(batches) == 2
    lb, rb, count = batches[0]
    assert lb.shape == (4, 32, 48) and lb.dtype == np.float32
    assert count == 4
    _, _, count2 = batches[1]
    assert count2 == 2  # padded partial batch, real count preserved
    assert batches[1][0].shape == (4, 32, 48)


def test_batch_loader_drop_last_and_values(dataset_root):
    ds = StereoPairDataset.from_root(dataset_root)
    batches = list(BatchLoader(ds, batch_size=4, drop_last=True, device_put=False))
    assert len(batches) == 1
    l0, _ = ds[0]
    np.testing.assert_array_equal(
        np.asarray(batches[0][0][0]), to_brightness(l0, np.float32)
    )


def test_batch_loader_mixed_shapes_skips(tmp_path, capsys):
    for i, (h, w) in enumerate([(32, 48), (32, 48), (16, 24)]):
        d = tmp_path / f"{i}"
        d.mkdir()
        l, r = synthetic_pair(h=h, w=w, seed=i)
        write_png_gray(str(d / "a.png"), l)
        write_png_gray(str(d / "b.png"), r)
    ds = StereoPairDataset.from_root(str(tmp_path))
    batches = list(BatchLoader(ds, batch_size=3, device_put=False))
    assert batches[0][2] == 2  # third pair skipped


def test_batch_loader_pad_to(tmp_path):
    for i, (h, w) in enumerate([(32, 48), (16, 24)]):
        d = tmp_path / f"{i}"
        d.mkdir()
        l, r = synthetic_pair(h=h, w=w, seed=i)
        write_png_gray(str(d / "a.png"), l)
        write_png_gray(str(d / "b.png"), r)
    ds = StereoPairDataset.from_root(str(tmp_path))
    batches = list(BatchLoader(ds, batch_size=2, pad_to=(32, 48), device_put=False))
    assert batches[0][0].shape == (2, 32, 48)
    assert batches[0][2] == 2


def test_matcher_single_and_batch():
    params = StereoParams(square_width=9, times=4, lines=4, num_shifts=8,
                          edge_rule="exact")
    m = Matcher(params)
    left, right = synthetic_pair(h=32, w=48, seed=1)
    out = m(left, right)  # uint8 input path
    want = oracle.run_pipeline(to_brightness(left), to_brightness(right), params)
    np.testing.assert_array_equal(out["output-0"], want["output-0"])
    lb = np.stack([to_brightness(left, np.float32)] * 2)
    rb = np.stack([to_brightness(right, np.float32)] * 2)
    out_b = m(lb, rb)  # float batch path
    np.testing.assert_array_equal(out_b["output-0"][0], want["output-0"])
    assert len(m._cache) == 2  # one executable per shape


def test_matcher_warmup_caches():
    m = Matcher(StereoParams(square_width=5, times=2, num_shifts=4,
                             edge_rule="exact"))
    m.warmup((16, 24))
    assert len(m._cache) == 1
    left, right = synthetic_pair(h=16, w=24, seed=2)
    m(left, right)
    assert len(m._cache) == 1  # reused


def test_matcher_sharded_tier():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs CPU mesh")
    from stereomatching.parallel import make_mesh

    params = StereoParams(square_width=9, times=4, lines=4, num_shifts=8,
                          edge_rule="exact")
    m = Matcher(params, tier="sharded", mesh=make_mesh(data=1, rows=8))
    left, right = synthetic_pair(h=64, w=48, seed=3)
    out = m(left, right)
    want = oracle.run_pipeline(to_brightness(left), to_brightness(right), params)
    np.testing.assert_array_equal(out["output-0"], want["output-0"])


def test_modern_matcher():
    m = ModernMatcher(ModernParams(num_disparities=8, window=5))
    left, right = synthetic_pair(h=24, w=32, seed=4)
    out = m(left, right)
    assert out["disparity"].shape == (24, 32)
    m.warmup((24, 32))
    assert len(m._cache) == 1


def test_modern_matcher_rejects_brightness_floats():
    m = ModernMatcher(ModernParams(num_disparities=8, window=5))
    left, right = synthetic_pair(h=16, w=24, seed=5)
    lb = left.astype(np.float32) / 256.0
    rb = right.astype(np.float32) / 256.0
    with pytest.raises(ValueError, match="0..255 pixel values"):
        m(lb, rb)
    # Pixel-scale floats are accepted (truncation is well defined).
    out = m(left.astype(np.float64), right.astype(np.float64))
    want = m(left, right)
    np.testing.assert_array_equal(out["disparity"], want["disparity"])


def test_modern_matcher_tiers_agree():
    """The modern pipeline runs the xla (default) and sharded tiers; the
    tiers without a kernel are rejected."""
    params = ModernParams(num_disparities=8, window=5)
    left, right = synthetic_pair(h=24, w=32, seed=6)
    xla = ModernMatcher(params, tier="xla")(left, right)
    default = ModernMatcher(params)(left, right)
    for k in xla:
        np.testing.assert_array_equal(xla[k], default[k], err_msg=k)
    for tier in ("pallas", "auto"):
        with pytest.raises(ValueError, match="xla"):
            ModernMatcher(params, tier=tier)


def test_modern_matcher_pallas_tier_rejects_unsupported():
    with pytest.raises(ValueError, match="'pallas'"):
        ModernMatcher(ModernParams(num_disparities=8, scales=2),
                      tier="pallas")
    # Multi-scale runs on the default tier.
    m = ModernMatcher(ModernParams(num_disparities=8, scales=2))
    left, right = synthetic_pair(h=16, w=24, seed=7)
    out = m(left, right)
    assert out["disparity"].shape == (16, 24)


def test_modern_matcher_sgm_pallas_tier():
    """The SGM route through the serving surface equals modern_forward
    called directly."""
    import jax.numpy as jnp

    from stereomatching.models.modern import modern_forward

    params = ModernParams(num_disparities=8, aggregation="sgm")
    left, right = synthetic_pair(h=16, w=24, seed=8)
    got = ModernMatcher(params)(left, right)
    want = modern_forward(jnp.asarray(left, jnp.int32),
                          jnp.asarray(right, jnp.int32), params)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("tier", ["auto", "xla"])
def test_matcher_tiers_agree_with_oracle(tier):
    """On the CPU the decision point picks the XLA match route for
    "auto"; both equal the oracle."""
    from stereomatching.config import BoundaryMode
    from stereomatching.oracle import pipeline as oracle
    from stereomatching.utils.imageio import to_brightness

    params = StereoParams(square_width=9, times=4, lines=4, num_shifts=8,
                          mode=BoundaryMode.GHOST, edge_rule="exact")
    left, right = synthetic_pair(h=24, w=32, seed=12)
    got = Matcher(params, tier=tier)(left, right)
    want = oracle.run_pipeline(to_brightness(left), to_brightness(right),
                               params)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_matcher_pallas_tier_raises_off_gpu():
    """The kernel is never interpreted behind the user's back: on the
    CPU the pallas tier fails to compile."""
    left, right = synthetic_pair(h=24, w=32, seed=13)
    params = StereoParams(square_width=9, num_shifts=8, edge_rule="exact")
    with pytest.raises(ValueError, match="interpret"):
        Matcher(params, tier="pallas")(left, right)
    with pytest.raises(ValueError):
        Matcher(params, tier="gpu")


def test_modern_matcher_sharded_tier():
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs CPU mesh")
    from stereomatching.parallel import make_mesh

    params = ModernParams(num_disparities=8, window=5)
    mesh = make_mesh(data=1, rows=4, devices=jax.devices()[:4])
    m = ModernMatcher(params, tier="sharded", mesh=mesh)
    left, right = synthetic_pair(h=32, w=48, seed=9)
    out = m(left, right)
    want = ModernMatcher(params, tier="xla")(left, right)
    np.testing.assert_array_equal(out["disparity"], want["disparity"])
    np.testing.assert_array_equal(out["filled"], want["filled"])


def test_matcher_sharded_batch_padding_and_validation():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs CPU mesh")
    from stereomatching.parallel import make_mesh

    params = StereoParams(square_width=5, times=2, num_shifts=4,
                          edge_rule="exact")
    m = Matcher(params, tier="sharded", mesh=make_mesh(data=2, rows=4))
    left, right = synthetic_pair(h=32, w=32, seed=8)
    # Non-divisible global batches are PADDED (repeat the last pair) up
    # to the data axis and the pad sliced away — a batch of 3 on a
    # data=2 mesh returns 3 results equal to the single-chip tier's.
    lb = np.stack([left, right, left])
    rb = np.stack([right, left, right])
    out = m(lb, rb)
    assert out["output-0"].shape == (3, 32, 32)
    want = Matcher(params, tier="xla")(lb, rb)
    np.testing.assert_array_equal(out["output-0"], want["output-0"])
    np.testing.assert_array_equal(out["web-2"], want["web-2"])
    # A single pair on a data=2 mesh pads too (squeeze path).
    one = m(left, right)
    np.testing.assert_array_equal(one["output-0"], want["output-0"][0])
    with pytest.raises(ValueError, match="mesh rows"):
        m(np.stack([left] * 2)[:, :30], np.stack([right] * 2)[:, :30])


def test_batch_loader_mesh_sharded_feed(dataset_root):
    """BatchLoader(mesh=...) yields pre-sharded device batches that the
    sharded pipeline consumes directly — bit-equal to the single-chip
    tier."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs CPU mesh")
    from stereomatching.parallel import make_mesh

    mesh = make_mesh(data=2, rows=4)
    params = StereoParams(square_width=5, times=2, num_shifts=4,
                          edge_rule="exact")
    sharded = Matcher(params, tier="sharded", mesh=mesh)
    single = Matcher(params)
    ds = StereoPairDataset.from_root(dataset_root)
    total = 0
    for lb, rb, count in BatchLoader(ds, batch_size=4, mesh=mesh):
        assert getattr(lb, "sharding", None) is not None
        got = sharded(np.asarray(lb), np.asarray(rb))
        want = single(np.asarray(lb), np.asarray(rb))
        np.testing.assert_array_equal(got["output-0"], want["output-0"])
        total += count
    assert total == 6
    with pytest.raises(ValueError, match="data axis"):
        BatchLoader(ds, batch_size=3, mesh=mesh)


def test_loader_feeds_matcher(dataset_root):
    params = StereoParams(square_width=5, times=2, num_shifts=4, edge_rule="exact")
    m = Matcher(params)
    ds = StereoPairDataset.from_root(dataset_root)
    total = 0
    for lb, rb, count in BatchLoader(ds, batch_size=4, device_put=True):
        out = m(np.asarray(lb), np.asarray(rb))
        assert out["output-0"].shape == (4, 32, 48)
        total += count
    assert total == 6


def test_modern_matcher_sgm_tiers_agree_batched():
    """The serving surface's batched SGM route equals its single-pair
    route bit for bit."""
    params = ModernParams(num_disparities=8, aggregation="sgm")
    left, right = synthetic_pair(h=24, w=32, seed=9)
    m = ModernMatcher(params)
    lb = np.stack([left, np.flipud(left)])
    rb = np.stack([right, np.flipud(right)])
    xb = m(lb, rb)
    for i in range(2):
        single = m(lb[i], rb[i])
        for k in single:
            np.testing.assert_array_equal(xb[k][i], single[k], err_msg=k)
