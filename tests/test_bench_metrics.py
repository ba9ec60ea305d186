"""Tests for the measurement harness, quality metrics, and artifact
checkpointing."""

import json
import os

import numpy as np
import pytest

from stereomatching.bench.harness import pixel_passes, size_sweep, time_jitted
from stereomatching.config import ModernParams, StereoParams
from stereomatching.utils.artifacts import (
    compare_artifacts,
    load_artifacts,
    save_artifacts,
)
from stereomatching.utils.metrics import (
    bad_pixel_rate,
    disparity_report,
    end_point_error,
)


def test_pixel_passes_reference_model():
    # The thesis model at default params (test/make_graph.py:51):
    # 4*2 + 30 + 21^2 + 30*2 + 1 + 32 + 3 = 575.
    assert pixel_passes(StereoParams()) == 575


def test_time_jitted_and_sweep_smoke():
    import jax

    fn = jax.jit(lambda x, y: x + y)
    a = np.ones((64, 64), np.float32)
    r = time_jitted(fn, (a, a), iters=2, warmup=1, name="add", pixels=64 * 64)
    assert r.mean_s > 0 and r.pixels_per_s > 0
    params = StereoParams(square_width=9, times=4, num_shifts=8, edge_rule="exact")
    sweep = size_sweep([(32, 48), (48, 64)], params, iters=1)
    assert [s.name for s in sweep] == ["48x32", "64x48"]
    assert all(s.mean_s > 0 for s in sweep)


def test_bench_cli_runs(capsys):
    from stereomatching.bench.__main__ import main

    rc = main([
        "--sizes", "32x48", "--phases-size", "32x48", "--iters", "1",
        "--shifts", "6", "--json",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "per-phase breakdown" in out
    json_lines = [l for l in out.splitlines() if l.startswith("{")]
    assert any("gpixel_passes_per_s" in l for l in json_lines)
    for l in json_lines:
        json.loads(l)


def test_graphs_written(tmp_path):
    pytest.importorskip("matplotlib")
    from stereomatching.bench.graphs import (
        speedup_graph,
        throughput_graph,
        times_graph,
    )
    from stereomatching.bench.harness import BenchResult

    rs = [
        BenchResult("48x32", 0.01, 0.009, 0.001, 3, pixels=48 * 32 * 575),
        BenchResult("64x48", 0.02, 0.019, 0.001, 3, pixels=64 * 48 * 575),
    ]
    r2 = [BenchResult(r.name, r.mean_s / 4, r.min_s / 4, 0.0, 3) for r in rs]
    assert times_graph({"xla": rs, "pallas": r2}, str(tmp_path / "t.png"))
    assert speedup_graph(rs, r2, str(tmp_path / "s.png"))
    assert throughput_graph(rs, str(tmp_path / "th.png"))
    assert os.path.getsize(tmp_path / "t.png") > 0


def test_metrics():
    gt = np.zeros((10, 10))
    d = gt.copy()
    d[0, :5] = 3.0  # 5 bad pixels out of 100
    assert bad_pixel_rate(d, gt, 1.0) == pytest.approx(0.05)
    assert end_point_error(d, gt) == pytest.approx(0.15)
    valid = np.ones((10, 10), bool)
    valid[0, :5] = False
    assert bad_pixel_rate(d, gt, 1.0, valid) == 0.0
    rep = disparity_report(d, gt, valid)
    assert rep["coverage"] == pytest.approx(0.95)
    assert rep["epe"] == 0.0


def test_modern_quality_on_known_shift():
    """End-to-end quality gate: on a pure horizontal shift the modern
    pipeline's bad-pixel rate (1 px) must be tiny on valid pixels."""
    from stereomatching.models.modern import build_modern_pipeline

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=(48, 96)).astype(np.int32)
    shift = 4
    left = base
    right = np.roll(base, -shift, axis=1)
    params = ModernParams(num_disparities=16, window=7)
    out = build_modern_pipeline(params)(left, right)
    gt = np.full((48, 96), float(shift))
    valid = np.array(out["valid"])
    valid[:, : shift + 4] = False  # true match out of frame near border
    rate = bad_pixel_rate(np.asarray(out["subpixel"]), gt, 1.0, valid)
    assert rate < 0.02, rate


def test_artifact_roundtrip(tmp_path):
    arts = {
        "web-1": np.arange(12, dtype=np.int32).reshape(3, 4),
        "output-0": np.ones((3, 4), np.uint8),
    }
    p = str(tmp_path / "arts.npz")
    save_artifacts(p, arts)
    loaded = load_artifacts(p)
    assert compare_artifacts(arts, loaded) == []
    loaded["web-1"][0, 0] = 99
    assert compare_artifacts(arts, loaded) == ["web-1"]
    missing = {"web-1": arts["web-1"]}
    assert compare_artifacts(arts, missing) == ["output-0"]


def test_compare_artifacts_tolerance():
    a = {"x": np.array([1.0, 2.0])}
    b = {"x": np.array([1.0, 2.0 + 1e-7])}
    assert compare_artifacts(a, b) == ["x"]
    assert compare_artifacts(a, b, atol=1e-6) == []


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3"])
def test_peak_table_holds_published_h100_rates(kind):
    from stereomatching.bench.roofline import peaks_for

    p = peaks_for(kind)
    assert p.hbm_bytes_per_s == 3.35e12
    assert p.ops_per_s["bf16"] == 989e12 and p.ops_per_s["int8"] == 1979e12
    assert p.ops_per_s["tf32"] == 495e12 and p.ops_per_s["fp32"] == 67e12
    assert p.memory_bytes == 80e9 and "data sheet" in p.source


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "cpu", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_rejects_unknown_devices(kind):
    from stereomatching.bench.roofline import peaks_for, roofline_share

    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for(kind)
    with pytest.raises(KeyError):
        roofline_share(1.0, 1.0, kind)


@pytest.mark.parametrize("seconds,nbytes,ops,op_type,share,bound", [
    (1e-3, 3.35e9, 0.0, "fp32", 1.0, "memory"),
    (2e-3, 3.35e9, 0.0, "fp32", 0.5, "memory"),
    (1e-3, 0.0, 989e9, "bf16", 1.0, "compute"),
    (4e-3, 3.35e9, 989e9 * 2, "bf16", 0.5, "compute"),
    (1e-3, 3.35e9, 1.0, "int8", 1.0, "memory"),
])
def test_roofline_share(seconds, nbytes, ops, op_type, share, bound):
    from stereomatching.bench.roofline import roofline_share

    got, got_bound = roofline_share(seconds, nbytes, "NVIDIA H100 80GB HBM3",
                                    ops=ops, op_type=op_type)
    assert got == pytest.approx(share) and got_bound == bound


def test_roofline_share_rejects_nonpositive_time():
    from stereomatching.bench.roofline import roofline_share

    with pytest.raises(ValueError):
        roofline_share(0.0, 1.0, "NVIDIA H100 80GB HBM3")
