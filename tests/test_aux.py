"""Tests for auxiliary subsystems: synthetic fixtures, distributed
init helper, CLI pallas tier off the GPU."""

import numpy as np
import pytest

from stereomatching.utils.synthetic import blob_scene, size_sweep_sizes, textured_shift


def test_blob_scene_ground_truth_consistent():
    left, right, disp = blob_scene(h=40, w=64, seed=2, max_disparity=6)
    assert left.dtype == np.uint8 and right.dtype == np.uint8
    assert disp.min() >= 0 and disp.max() < 6
    # right[y, x] must equal left[y, x + d] (wrapped).
    yy, xx = np.mgrid[0:40, 0:64]
    np.testing.assert_array_equal(right, left[yy, (xx + disp) % 64])


def test_textured_shift_recoverable_by_modern():
    from stereomatching.config import ModernParams
    from stereomatching.models.modern import build_modern_pipeline
    from stereomatching.utils.metrics import bad_pixel_rate

    left, right, disp = textured_shift(32, 64, shift=3, seed=1)
    out = build_modern_pipeline(ModernParams(num_disparities=8, window=5))(
        left.astype(np.int32), right.astype(np.int32)
    )
    valid = np.array(out["valid"])
    valid[:, :8] = False
    assert bad_pixel_rate(np.asarray(out["disparity"]), disp, 1.0, valid) < 0.02


def test_size_sweep_sizes_match_reference_fixtures():
    sizes = size_sweep_sizes()
    assert (135, 240) in sizes and (4320, 7680) in sizes


def test_distributed_initialize_noop_single_host():
    from stereomatching.parallel import distributed

    distributed.initialize()  # must not raise on a single host
    lo, hi = distributed.local_shard_bounds(64, 8, 3)
    assert (lo, hi) == (24, 32)
    with pytest.raises(ValueError):
        distributed.local_shard_bounds(65, 8, 0)


def test_cli_pallas_tier(tmp_path, capsys):
    """--tier pallas forces the fused kernel; on the CPU it cannot
    compile, and the CLI reports the error instead of interpreting it."""
    from stereomatching import cli
    from stereomatching.utils.imageio import write_png_gray
    from tests.util import synthetic_pair

    left, right = synthetic_pair(h=40, w=56, seed=2)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png_gray(a, left)
    write_png_gray(b, right)
    rc = cli.main(
        [a, b, "0.15", "9", "6", "4", "--tier", "pallas", "--mode", "ghost",
         "--edge-rule", "exact", "--shifts", "12", "--no-writes"]
    )
    assert rc == 1
    assert "interpret" in capsys.readouterr().err


def test_random_dot_stereogram_solvable_only_by_stereo():
    """The Julesz RDS has zero monocular structure; the modern pipeline
    must still recover the raised square."""
    from stereomatching.config import ModernParams
    from stereomatching.models.modern import build_modern_pipeline
    from stereomatching.utils.metrics import bad_pixel_rate
    from stereomatching.utils.synthetic import random_dot_stereogram

    left, right, disp = random_dot_stereogram(64, 96, seed=1, max_disparity=8)
    out = build_modern_pipeline(ModernParams(num_disparities=8, window=7))(
        left.astype(np.int32), right.astype(np.int32)
    )
    valid = np.array(out["valid"])
    valid[:, :12] = False  # left occlusion band
    # interior of both regions (boundaries are genuinely ambiguous)
    rate = bad_pixel_rate(np.asarray(out["disparity"]), disp, 1.0, valid)
    assert rate < 0.08, rate


def test_slanted_plane_subpixel_beats_integer():
    """On a disparity ramp, parabola sub-pixel output must track the
    ramp more closely than the integer staircase does."""
    from stereomatching.config import ModernParams
    from stereomatching.models.modern import build_modern_pipeline
    from stereomatching.utils.metrics import end_point_error
    from stereomatching.utils.synthetic import slanted_plane

    left, right, gt = slanted_plane(48, 128, seed=2, d_min=1.0, d_max=5.0)
    out = build_modern_pipeline(ModernParams(num_disparities=8, window=9))(
        left.astype(np.int32), right.astype(np.int32)
    )
    valid = np.array(out["valid"])
    valid[:, :12] = False
    valid[:, -4:] = False
    epe_int = end_point_error(np.asarray(out["disparity"]), gt, valid)
    epe_sub = end_point_error(np.asarray(out["subpixel"]), gt, valid)
    assert epe_sub < epe_int, (epe_sub, epe_int)
    assert epe_sub < 0.35, epe_sub
