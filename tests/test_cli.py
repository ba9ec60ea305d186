"""CLI tests: argument handling, artifact dumps, timing line format."""

import os
import re

import numpy as np
import pytest

from stereomatching import cli
from stereomatching.config import BoundaryMode, StereoParams
from stereomatching.oracle import pipeline as oracle
from stereomatching.utils.imageio import read_ppm, to_brightness, write_png_gray
from tests.util import synthetic_pair

TIMING_RE = re.compile(
    r"^width = (\d+), height = (\d+), t1 = [\d.]+, t2 = [\d.]+, "
    r"elapsed = ([\d.]+)$"
)


@pytest.fixture
def pair_paths(tmp_path):
    left, right = synthetic_pair(h=40, w=56, seed=2)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png_gray(a, left)
    write_png_gray(b, right)
    return a, b, left, right


def test_timing_line_is_reference_compatible(pair_paths, tmp_path, capsys):
    a, b, _, _ = pair_paths
    rc = cli.main([a, b, "--tier", "oracle", "--outdir", str(tmp_path / "out")])
    assert rc == 0
    line = capsys.readouterr().out.strip()
    m = TIMING_RE.match(line)
    assert m, line
    assert (int(m.group(1)), int(m.group(2))) == (56, 40)
    # The reference's test/time.sh extracts awk field 15.
    assert line.split()[14] == m.group(3)


@pytest.mark.parametrize("tier", ["oracle", "jax"])
def test_tiers_dump_identical_artifacts(pair_paths, tmp_path, tier):
    a, b, left, right = pair_paths
    outdir = str(tmp_path / tier)
    rc = cli.main(
        [a, b, "0.15", "9", "6", "4", "--tier", tier, "--mode", "ghost",
         "--edge-rule", "exact", "--shifts", "12", "--outdir", outdir]
    )
    assert rc == 0
    params = StereoParams(
        square_width=9, times=6, lines=4, num_shifts=12,
        mode=BoundaryMode.GHOST, edge_rule="exact",
    )
    want = oracle.run_pipeline(to_brightness(left), to_brightness(right), params)
    got = read_ppm(os.path.join(outdir, "output-0.ppm"))
    # BINARY ppm maps 1 -> 0, else 255.
    np.testing.assert_array_equal(got == 0, want["output-0"] == 1)
    assert os.path.exists(os.path.join(outdir, "score_best-0.ppm"))


def test_collect_dumps_per_shift_planes(pair_paths, tmp_path):
    a, b, _, _ = pair_paths
    outdir = str(tmp_path / "dbg")
    rc = cli.main(
        [a, b, "--tier", "oracle", "--shifts", "5", "--collect",
         "--outdir", outdir, "0.15", "9", "2", "4"]
    )
    assert rc == 0
    for i in range(5):
        for base in ("matches", "score_all", "scores"):
            assert os.path.exists(os.path.join(outdir, f"{base}-{i}.ppm"))


def test_no_writes(pair_paths, tmp_path):
    a, b, _, _ = pair_paths
    outdir = str(tmp_path / "nw")
    rc = cli.main([a, b, "--tier", "oracle", "--no-writes", "--outdir", outdir])
    assert rc == 0
    assert not os.path.exists(outdir)


def test_mismatched_sizes_error(tmp_path, capsys):
    l1, _ = synthetic_pair(h=20, w=20)
    l2, _ = synthetic_pair(h=24, w=20)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png_gray(a, l1)
    write_png_gray(b, l2)
    assert cli.main([a, b]) == 1
    assert "equal width and height" in capsys.readouterr().err


def test_bad_params_error(pair_paths, capsys):
    a, b, _, _ = pair_paths
    assert cli.main([a, b, "1.5"]) == 1  # threshold out of range
    assert "threshold" in capsys.readouterr().err
    assert cli.main([a, b, "0.15", "99"]) == 1  # window bigger than image
    assert "square" in capsys.readouterr().err


def test_sharded_tier_runs(pair_paths, tmp_path):
    a, b, left, right = pair_paths
    outdir = str(tmp_path / "sh")
    rc = cli.main(
        [a, b, "0.15", "9", "6", "4", "--tier", "sharded", "--mode", "ghost",
         "--edge-rule", "exact", "--shifts", "12", "--outdir", outdir]
    )
    assert rc == 0
    params = StereoParams(
        square_width=9, times=6, lines=4, num_shifts=12,
        mode=BoundaryMode.GHOST, edge_rule="exact",
    )
    want = oracle.run_pipeline(to_brightness(left), to_brightness(right), params)
    got = read_ppm(os.path.join(outdir, "output-0.ppm"))
    np.testing.assert_array_equal(got == 0, want["output-0"] == 1)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    import jax

    out = jax.jit(fn)(*args)
    assert out["output-0"].shape == args[0].shape
    ge.dryrun_multichip(8)


def test_modern_pipeline_cli(pair_paths, tmp_path):
    a, b, _, _ = pair_paths
    outdir = str(tmp_path / "modern")
    rc = cli.main(
        [a, b, "--pipeline", "modern", "--shifts", "8", "0.15", "5",
         "--outdir", outdir]
    )
    assert rc == 0
    import numpy as np

    with np.load(os.path.join(outdir, "disparity.npz")) as z:
        assert z["disparity"].shape == (40, 56)
        assert z["valid"].dtype == bool
    assert os.path.exists(os.path.join(outdir, "disparity.ppm"))
    assert os.path.exists(os.path.join(outdir, "valid.ppm"))


def test_modern_cli_pallas_tier(pair_paths, capsys):
    """The modern pipeline has no kernel tier: --tier pallas is an
    error, not a silent fallback."""
    a, b, _, _ = pair_paths
    base = [a, b, "--pipeline", "modern", "--shifts", "8", "0.15", "5"]
    assert cli.main(base + ["--tier", "pallas", "--no-writes"]) == 1
    assert "not available" in capsys.readouterr().err


def test_modern_cli_pallas_tier_unsupported(pair_paths, tmp_path):
    """Multi-scale fusion runs on the jax tier and writes its outputs."""
    a, b, _, _ = pair_paths
    outdir = str(tmp_path / "ms")
    rc = cli.main(
        [a, b, "--pipeline", "modern", "--tier", "jax",
         "--scales", "2", "--shifts", "8", "--outdir", outdir]
    )
    assert rc == 0
    import numpy as np

    with np.load(os.path.join(outdir, "disparity.npz")) as z:
        assert z["disparity"].shape == z["valid"].shape


def test_modern_cli_sharded_tier(pair_paths, tmp_path):
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs CPU mesh")
    a, b, _, _ = pair_paths
    out_s = str(tmp_path / "modern_sharded")
    out_x = str(tmp_path / "modern_xla2")
    base = [a, b, "--pipeline", "modern", "--shifts", "8", "0.15", "5"]
    assert cli.main(base + ["--tier", "sharded", "--outdir", out_s]) == 0
    assert cli.main(base + ["--tier", "jax", "--outdir", out_x]) == 0
    import numpy as np

    with np.load(os.path.join(out_s, "disparity.npz")) as zs, np.load(
        os.path.join(out_x, "disparity.npz")
    ) as zx:
        np.testing.assert_array_equal(zs["disparity"], zx["disparity"])
        np.testing.assert_array_equal(zs["filled"], zx["filled"])


def test_modern_cli_sgm_census(pair_paths, tmp_path):
    a, b, _, _ = pair_paths
    outdir = str(tmp_path / "sgm")
    rc = cli.main(
        [a, b, "--pipeline", "modern", "--shifts", "8", "--cost", "census",
         "--aggregation", "sgm", "--outdir", outdir]
    )
    assert rc == 0
    assert os.path.exists(os.path.join(outdir, "disparity.npz"))


def test_modern_cli_sgm_quality_stack(pair_paths, tmp_path):
    """The round-3 SGM options end-to-end through the CLI: 8 paths,
    median, uniqueness plane, background fill."""
    import numpy as np

    a, b, _, _ = pair_paths
    outdir = str(tmp_path / "sgm8")
    rc = cli.main(
        [a, b, "--pipeline", "modern", "--shifts", "8", "--cost", "census",
         "--aggregation", "sgm", "--sgm-directions", "8", "--median",
         "--uniqueness", "--fill-mode", "background", "--outdir", outdir]
    )
    assert rc == 0
    z = np.load(os.path.join(outdir, "disparity.npz"))
    assert "uniqueness" in z.files
    assert np.isfinite(z["uniqueness"]).all()


def _read_all_ppms(d):
    return {
        f: open(os.path.join(d, f), "rb").read()
        for f in sorted(os.listdir(d))
        if f.endswith(".ppm")
    }


def test_checkpoint_resume_bit_identical(pair_paths, tmp_path):
    """--save-artifacts then --resume must reproduce the uninterrupted
    run's artifacts byte-for-byte (the reference's phase dumps as
    restartable state, src/stereo.c:302-320) — including a resume on a
    DIFFERENT tier (the finishing phases are pure integer functions of
    the saved winner web)."""
    a, b, _, _ = pair_paths
    ck = str(tmp_path / "ck.npz")
    full = str(tmp_path / "full")
    args = [a, b, "0.15", "9", "6", "4", "--shifts", "12",
            "--tier", "oracle"]
    assert cli.main(args + ["--outdir", full, "--save-artifacts", ck]) == 0

    resumed = str(tmp_path / "resumed")
    assert cli.main(args + ["--outdir", resumed, "--resume", ck]) == 0
    assert _read_all_ppms(full) == _read_all_ppms(resumed)

    cross = str(tmp_path / "cross")
    assert cli.main(
        [a, b, "0.15", "9", "6", "4", "--shifts", "12", "--tier", "jax",
         "--outdir", cross, "--resume", ck]
    ) == 0
    assert _read_all_ppms(full) == _read_all_ppms(cross)


def test_resume_changed_finishing_params(pair_paths, tmp_path):
    """times/lines may change on resume (they only shape the finishing
    phases); the result must equal a from-scratch run with the new
    values."""
    a, b, _, _ = pair_paths
    ck = str(tmp_path / "ck.npz")
    assert cli.main(
        [a, b, "0.15", "9", "6", "4", "--shifts", "12", "--tier",
         "oracle", "--no-writes", "--save-artifacts", ck]
    ) == 0
    resumed = str(tmp_path / "res")
    assert cli.main(
        [a, b, "0.15", "9", "12", "7", "--shifts", "12", "--tier",
         "oracle", "--outdir", resumed, "--resume", ck]
    ) == 0
    scratch = str(tmp_path / "scratch")
    assert cli.main(
        [a, b, "0.15", "9", "12", "7", "--shifts", "12", "--tier",
         "oracle", "--outdir", scratch]
    ) == 0
    assert _read_all_ppms(resumed) == _read_all_ppms(scratch)


def test_resume_rejects_mismatched_upstream_params(pair_paths, tmp_path, capsys):
    a, b, _, _ = pair_paths
    ck = str(tmp_path / "ck.npz")
    assert cli.main(
        [a, b, "0.15", "9", "6", "4", "--shifts", "12", "--tier",
         "oracle", "--no-writes", "--save-artifacts", ck]
    ) == 0
    rc = cli.main(
        [a, b, "0.2", "9", "6", "4", "--shifts", "12", "--tier",
         "oracle", "--no-writes", "--resume", ck]
    )
    assert rc == 1
    assert "threshold" in capsys.readouterr().err


def test_resume_rejects_modern_pipeline(pair_paths, tmp_path, capsys):
    a, b, _, _ = pair_paths
    rc = cli.main(
        [a, b, "--pipeline", "modern", "--resume", str(tmp_path / "x.npz")]
    )
    assert rc == 1
    assert "classic-pipeline" in capsys.readouterr().err
