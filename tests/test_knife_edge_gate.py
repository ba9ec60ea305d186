"""Pin the accelerated tiers' knife-edge divergence from the C reference.

The `exact` edge rule (the bit-deterministic rule the pallas/sharded tiers
run) legitimately diverges from the C reference's double-order float rule
only at rational TIES of the edge predicate (tools/knife_edge.py).  On the
reference's own smallest fixture that divergence is exactly 3 pixels in
edges-1 and 0 in edges-2, in both boundary modes — pinned here so any
kernel regression that widens the gap trips immediately, and every one of
the 3 is re-proven an exact tie (rational margin 0).  The downstream gate
then proves the remaining artifacts bit-equivalent to the C semantics
conditional on those edges.

The on-device version of this gate is ``tools/diff_vs_reference.sh ''
'' pallas``; this CPU test pins the same invariants without a card via
the NumPy oracle's exact rule, which the jax/pallas/sharded routes'
edges are bit-identical to (tests/test_jax_pipeline.py,
tests/test_pallas.py).
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from stereomatching.config import BoundaryMode, StereoParams
from stereomatching.oracle import pipeline as oracle
from stereomatching.utils.imageio import (
    artifact_ppm_type,
    ppm_bytes,
    read_png_gray,
    to_brightness,
    write_ppm,
)

REF = "/root/reference"
CACHE = "/tmp/stereo_ref_build"
FIXTURE = os.path.join(REF, "test/imgs/1-240x135")
_TOOL = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools", "knife_edge.py")

pytestmark = pytest.mark.skipif(
    shutil.which("gcc") is None or not os.path.isdir(FIXTURE),
    reason="needs gcc and the reference fixtures",
)

# The pinned divergence: fixture 1, threshold 0.15 — exactly these pixels,
# each an exact rational tie 2|ka-kb| == (3/20)(ka+kb) (measured; see
# tools/knife_edge.py header).  Interior pixels, so wrap and ghost agree.
PINNED_EDGES1 = {(56, 67), (77, 233), (106, 129)}
# Fixture 2 (480x270): tie COUNTS per artifact (both modes; every one
# margin-0.0).  Counts, not coordinates — a second size anchors the
# ~1e-4 tie-density scaling without double maintenance.
PINNED_FIX2_COUNTS = {"edges-1": 7, "edges-2": 3}


def _knife_edge():
    spec = importlib.util.spec_from_file_location("knife_edge", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["knife_edge"] = mod  # dataclasses resolve via sys.modules
    spec.loader.exec_module(mod)
    return mod


def _build(src_name: str, out_name: str) -> str:
    os.makedirs(CACHE, exist_ok=True)
    out = os.path.join(CACHE, out_name)
    src = os.path.join(REF, "src", src_name)
    if os.path.exists(out) and os.path.getmtime(out) > os.path.getmtime(src):
        return out
    subprocess.run(
        ["gcc", "-O2", "-DDEBUG", "-I", os.path.join(REF, "src"),
         src, os.path.join(REF, "src", "image.c"), "-lm", "-o", out],
        check=True, capture_output=True,
    )
    return out


@pytest.mark.parametrize(
    "mode,src,subdir",
    [
        (BoundaryMode.WRAP, "stereo.c", "ser"),
        (BoundaryMode.GHOST, "stereo-ghost.c", "sergh"),
    ],
)
def test_fixture1_divergence_pinned_and_gated(tmp_path, mode, src, subdir):
    ke = _knife_edge()
    a = os.path.join(FIXTURE, "a.png")
    b = os.path.join(FIXTURE, "b.png")

    binary = _build(src, f"ref-{subdir}")
    ref_dir = tmp_path / subdir
    ref_dir.mkdir()
    subprocess.run([binary, a, b], cwd=tmp_path, check=True, capture_output=True)

    params = StereoParams(mode=mode, edge_rule="exact")
    arts = oracle.run_pipeline(
        to_brightness(read_png_gray(a)), to_brightness(read_png_gray(b)), params
    )
    our_dir = tmp_path / "ours"
    our_dir.mkdir()
    for name, data in arts.items():
        fname = "score_best-0" if name == "score_best" else name
        write_ppm(str(our_dir / f"{fname}.ppm"), np.asarray(data),
                  artifact_ppm_type(fname))

    # Pin the divergence set exactly.
    for name, img in (("edges-1", a), ("edges-2", b)):
        ref_e = ke.edges_from_ppm(str(ref_dir / f"{name}.ppm"))
        our_e = ke.edges_from_ppm(str(our_dir / f"{name}.ppm"))
        diffs = ke.classify_edge_diffs(
            to_brightness(read_png_gray(img)), ref_e, our_e, "0.15", mode
        )
        got = {(d.y, d.x) for d in diffs}
        want = PINNED_EDGES1 if name == "edges-1" else set()
        assert got == want, f"{name} divergence moved: {got} != {want}"
        assert all(d.is_tie for d in diffs)
        assert all(d.margin == 0.0 for d in diffs), (
            "pinned pixels must be EXACT rational ties"
        )

    # Full gate: ties proven + downstream byte-identical conditional on edges.
    n_tie, n_ok = ke.gate_pair(
        str(ref_dir), str(our_dir), a, b, "0.15", params, max_frac=2e-4,
        verbose=False,
    )
    assert n_tie == 3
    assert n_ok == len(ke.DOWNSTREAM)


@pytest.mark.parametrize(
    "mode,src,subdir",
    [
        (BoundaryMode.WRAP, "stereo.c", "ser"),
        (BoundaryMode.GHOST, "stereo-ghost.c", "sergh"),
    ],
)
def test_fixture2_tie_counts_pinned(tmp_path, mode, src, subdir):
    """Second-size anchor: fixture 2's divergence stays at 7+3 proven
    exact ties per mode (the tie density holds at ~1e-4 of pixels
    across the fixture ladder: 3/10/44 ties at the three smallest
    fixtures)."""
    ke = _knife_edge()
    fix2 = os.path.join(REF, "test/imgs/2-480x270")
    if not os.path.isdir(fix2):
        pytest.skip("fixture 2 unavailable")
    binary = _build(src, f"ref-{subdir}")
    (tmp_path / subdir).mkdir()
    subprocess.run(
        [binary, f"{fix2}/a.png", f"{fix2}/b.png"],
        cwd=tmp_path, check=True, capture_output=True,
    )
    for name, img in (("edges-1", "a"), ("edges-2", "b")):
        ref_e = ke.edges_from_ppm(str(tmp_path / subdir / f"{name}.ppm"))
        br = to_brightness(read_png_gray(f"{fix2}/{img}.png"))
        our_e = oracle.find_edges(br, 0.15, mode, rule="exact")
        diffs = ke.classify_edge_diffs(br, ref_e, our_e, "0.15", mode)
        assert len(diffs) == PINNED_FIX2_COUNTS[name], (name, diffs)
        assert all(d.is_tie and d.margin == 0.0 for d in diffs)


def test_gate_rejects_non_tie_divergence(tmp_path):
    """A fabricated non-tie edge flip must fail the gate loudly."""
    ke = _knife_edge()
    a = os.path.join(FIXTURE, "a.png")
    br = to_brightness(read_png_gray(a))
    ref_e = oracle.find_edges(br, 0.15, BoundaryMode.WRAP, rule="exact")
    our_e = ref_e.copy()
    # Flip one pixel that is NOT near the predicate boundary.
    flat = np.flatnonzero(ref_e == 0)
    our_e.flat[flat[len(flat) // 2]] ^= 1
    with pytest.raises(AssertionError, match="NOT an edge-rule knife edge"):
        ke.classify_edge_diffs(br, ref_e, our_e, "0.15", BoundaryMode.WRAP)


def test_seeded_oracle_matches_direct_run():
    """run_pipeline_from_edges(find_edges(...)) == run_pipeline(...)."""
    from tests.util import synthetic_pair

    l8, r8 = synthetic_pair(h=40, w=64, seed=11)
    params = StereoParams(square_width=9, num_shifts=8, times=6, lines=4)
    left, right = to_brightness(l8), to_brightness(r8)
    direct = oracle.run_pipeline(left, right, params)
    el = oracle.find_edges(left, params.threshold, params.mode)
    er = oracle.find_edges(right, params.threshold, params.mode)
    seeded = oracle.run_pipeline_from_edges(el, er, params)
    assert direct.keys() == seeded.keys()
    for k in direct:
        np.testing.assert_array_equal(direct[k], seeded[k])
