"""Ground-truth format tests: PFM and disparity-PNG codecs
(stereomatching/data/formats.py) — round trips, cross-validation
against an independent codec (Pillow, when installed), and the
end-to-end quality gate on the synthetic scene."""

import numpy as np
import pytest

from stereomatching.data.formats import (
    read_disparity_png,
    read_ground_truth,
    read_pfm,
    write_disparity_png,
    write_pfm,
)


def _gt_plane(h=23, w=37, seed=0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.0, 64.0, size=(h, w)).astype(np.float32)
    gt[rng.random((h, w)) < 0.1] = np.nan  # unknown-disparity holes
    return gt


@pytest.mark.parametrize("little_endian", [True, False])
def test_pfm_roundtrip(tmp_path, little_endian):
    gt = _gt_plane()
    path = str(tmp_path / "d.pfm")
    write_pfm(path, gt, little_endian=little_endian)
    back = read_pfm(path)
    np.testing.assert_array_equal(np.isnan(back), np.isnan(gt))
    np.testing.assert_array_equal(back[~np.isnan(gt)], gt[~np.isnan(gt)])


def test_pfm_row_order_bottom_to_top(tmp_path):
    """PFM stores rows bottom-to-top: a hand-built file whose FIRST
    stored row is [9, 9] must decode with that row LAST."""
    path = str(tmp_path / "o.pfm")
    body = np.array([[9.0, 9.0], [1.0, 2.0]], "<f4").tobytes()
    with open(path, "wb") as f:
        f.write(b"Pf\n2 2\n-1.0\n" + body)
    img = read_pfm(path)
    np.testing.assert_array_equal(img, [[1.0, 2.0], [9.0, 9.0]])


def test_pfm_color_and_infinity(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, size=(8, 6, 3)).astype(np.float32)
    img[0, 0, 0] = np.inf  # Middlebury marks unknown with +inf
    path = str(tmp_path / "c.pfm")
    write_pfm(path, img)
    back = read_pfm(path)
    assert back.shape == (8, 6, 3)
    assert np.isnan(back[0, 0, 0])  # normalized to NaN
    np.testing.assert_array_equal(back[1:], img[1:])


def test_pfm_rejects_garbage(tmp_path):
    path = str(tmp_path / "bad.pfm")
    with open(path, "wb") as f:
        f.write(b"P5\n2 2\n255\n\x00\x00\x00\x00")
    with pytest.raises(ValueError, match="not a PFM"):
        read_pfm(path)


def test_disparity_png16_roundtrip(tmp_path):
    gt = _gt_plane(h=31, w=29, seed=2)
    path = str(tmp_path / "d.png")
    write_disparity_png(path, gt)  # KITTI: value = round(d * 256)
    back = read_disparity_png(path)
    np.testing.assert_array_equal(np.isnan(back), np.isnan(gt))
    ok = ~np.isnan(gt)
    assert np.abs(back[ok] - gt[ok]).max() <= 0.5 / 256 + 1e-6


def test_disparity_png16_invalid_zero(tmp_path):
    path = str(tmp_path / "z.png")
    write_disparity_png(path, np.array([[0.0, 1.0], [np.nan, 2.0]]))
    back = read_disparity_png(path)
    # 0.0 encodes to pixel 0 == the KITTI invalid marker, like NaN.
    assert np.isnan(back[0, 0]) and np.isnan(back[1, 0])
    np.testing.assert_allclose(back[0, 1], 1.0)


def test_disparity_png8_middlebury_scale(tmp_path):
    """8-bit quarter-pixel Middlebury encoding via an independent
    encoder (Pillow)."""
    PIL = pytest.importorskip("PIL.Image")
    vals = np.arange(0, 256, dtype=np.uint8).reshape(16, 16)
    path = str(tmp_path / "q.png")
    PIL.fromarray(vals, mode="L").save(path)
    disp = read_disparity_png(path, scale=0.25, zero_invalid=False)
    np.testing.assert_allclose(disp, vals.astype(np.float32) / 4.0)


def test_png16_cross_codec_parity(tmp_path):
    """Decode a Pillow-encoded 16-bit grayscale PNG (exercises real
    filter choices from an independent encoder) and let Pillow decode
    ours."""
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(3)
    # Smooth ramp makes Pillow pick non-trivial row filters.
    vals = (
        np.cumsum(rng.integers(0, 7, size=(33, 47)), axis=1) % 65536
    ).astype(np.uint16)
    theirs = str(tmp_path / "pil.png")
    PIL.fromarray(vals).save(theirs)  # mode I;16 -> 16-bit gray PNG
    got = read_disparity_png(theirs, scale=1.0, zero_invalid=False)
    np.testing.assert_array_equal(got.astype(np.uint16), vals)

    ours = str(tmp_path / "ours.png")
    write_disparity_png(ours, vals.astype(np.float64) / 256.0)
    back = np.asarray(PIL.open(ours))
    np.testing.assert_array_equal(back.astype(np.uint16), vals)


def test_read_ground_truth_dispatch(tmp_path):
    gt = _gt_plane(h=9, w=11, seed=4)
    pfm = str(tmp_path / "a.pfm")
    png = str(tmp_path / "a.png")
    npy = str(tmp_path / "a.npy")
    write_pfm(pfm, gt)
    write_disparity_png(png, gt)
    np.save(npy, gt)
    for path in (pfm, png, npy):
        got = read_ground_truth(path)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(gt))
    with pytest.raises(ValueError, match="unknown ground-truth"):
        read_ground_truth(str(tmp_path / "a.exr"))


def test_metrics_mask_nan_ground_truth():
    from stereomatching.utils.metrics import disparity_report

    gt = np.array([[1.0, np.nan], [3.0, 4.0]])
    pred = np.array([[1.0, 99.0], [3.0, 7.0]])
    rep = disparity_report(pred, gt)
    # The NaN cell (error 98) is excluded: one bad pixel of three.
    assert rep["bad2"] == pytest.approx(1 / 3)
    assert rep["epe"] == pytest.approx(1.0)


def test_quality_gate_on_synthetic_scene(tmp_path):
    """End-to-end quality regression: modern pipeline vs ground truth
    loaded through the dataset-format path (the BASELINE.md bad-pixel
    gate, reportable the moment a real dataset is mounted)."""
    from stereomatching.models.modern import build_modern_pipeline
    from stereomatching.config import ModernParams
    from stereomatching.utils.metrics import disparity_report
    from stereomatching.utils.synthetic import blob_scene

    left, right, gt = blob_scene(h=72, w=96, seed=0, max_disparity=12)
    path = str(tmp_path / "gt.pfm")
    write_pfm(path, gt.astype(np.float32))
    gt_loaded = read_ground_truth(path)

    fn = build_modern_pipeline(ModernParams(num_disparities=16, window=9))
    out = fn(left.astype(np.int32), right.astype(np.int32))
    rep = disparity_report(
        np.asarray(out["subpixel"]), gt_loaded, np.asarray(out["valid"])
    )
    assert rep["coverage"] > 0.85
    # Regression gate (current: bad2 ~= 0.126 on LR-consistent pixels —
    # errors concentrate at the scene's occlusion boundaries).
    assert rep["bad2"] < 0.15


class TestPGMInput:
    """Input-breadth: the reference accepts any stb-decodable grayscale
    (src/image.c:18-35); our core adds PGM P5/P2 next to PNG (JPEG is a
    documented non-goal, docs/PARITY.md component 8)."""

    def _img(self):
        from tests.util import synthetic_pair

        left, _ = synthetic_pair(h=24, w=32, seed=9)
        return left

    def test_p5_roundtrip(self, tmp_path):
        from stereomatching.utils.imageio import read_png_gray

        img = self._img()
        p = tmp_path / "x.pgm"
        p.write_bytes(
            b"P5\n# comment\n%d %d\n255\n" % (img.shape[1], img.shape[0])
            + img.tobytes()
        )
        np.testing.assert_array_equal(read_png_gray(str(p)), img)

    def test_p2_roundtrip(self, tmp_path):
        from stereomatching.utils.imageio import read_png_gray

        img = self._img()
        body = "\n".join(
            " ".join(str(v) for v in row) for row in img
        )
        p = tmp_path / "x.pgm"
        p.write_text(
            f"P2\n{img.shape[1]} {img.shape[0]}\n255\n{body}\n"
        )
        np.testing.assert_array_equal(read_png_gray(str(p)), img)

    def test_16bit_rejected(self, tmp_path):
        from stereomatching.utils.imageio import read_png_gray

        p = tmp_path / "x.pgm"
        p.write_bytes(b"P5\n2 2\n65535\n" + b"\0" * 8)
        with pytest.raises(ValueError, match="16-bit"):
            read_png_gray(str(p))

    def test_cli_accepts_pgm_pair(self, tmp_path):
        from tests.util import synthetic_pair

        from stereomatching import cli

        left, right = synthetic_pair(h=24, w=32, seed=9)
        paths = []
        for name, img in (("a", left), ("b", right)):
            p = tmp_path / f"{name}.pgm"
            p.write_bytes(
                b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0])
                + img.tobytes()
            )
            paths.append(str(p))
        rc = cli.main(
            paths + ["0.15", "9", "4", "4", "--shifts", "8",
                     "--tier", "oracle", "--outdir", str(tmp_path / "o")]
        )
        assert rc == 0
