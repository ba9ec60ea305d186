"""chip_smoke.py's comparison helpers and its refusal to run without a
GPU (the smoke itself runs on the card)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_compare_exact_passes_equal_arrays():
    a = {"x": np.arange(6).reshape(2, 3), "y": np.ones(4, bool)}
    assert chip_smoke.compare_exact("t", a, dict(a), ["x", "y"]) == []


@pytest.mark.parametrize("got,want,msg", [
    (np.array([1, 2, 3]), np.array([1, 2, 4]), "differs at 1 of 3"),
    (np.zeros((2, 3)), np.zeros((3, 2)), "shape"),
    (np.array([0.5, 1.0]), np.array([0.5, 1.0 + 1e-7]), "differs at 1 of 2"),
])
def test_compare_exact_reports(got, want, msg):
    bad = chip_smoke.compare_exact("t", {"k": got}, {"k": want}, ["k"])
    assert len(bad) == 1 and msg in bad[0] and "k" in bad[0]


def test_compare_close_within_tolerance():
    got = {"s": np.array([1.0, 2.00005], np.float32)}
    want = {"s": np.array([1.0, 2.0], np.float32)}
    assert chip_smoke.compare_close("t", got, want, ["s"], 1e-4) == []


@pytest.mark.parametrize("got,msg", [
    (np.array([1.0, 2.001]), "max |diff|"),
    (np.array([1.0, np.nan]), "non-finite"),
    (np.array([1.0, 2.0, 3.0]), "shape"),
])
def test_compare_close_reports(got, msg):
    want = {"s": np.array([1.0, 2.0])}
    bad = chip_smoke.compare_close("t", {"s": got}, want, ["s"], 1e-4)
    assert len(bad) == 1 and msg in bad[0]


def test_pairs_are_seeded_and_sized():
    l1, r1 = chip_smoke._pairs(3, 32, 48, seed=5)
    l2, r2 = chip_smoke._pairs(3, 32, 48, seed=5)
    assert l1.shape == r1.shape == (3, 32, 48) and l1.dtype == np.uint8
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(r1, r2)
    assert not np.array_equal(l1[0], l1[1])


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [(), ("--multi",)])
def test_refuses_without_gpu(args):
    r = _run(REPO, *args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    # nvidia-smi is asked first; where it exists, JAX then finds no GPU.
    assert "nvidia-smi" in r.stderr or "no GPU" in r.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
