"""The classic pipeline's finishing phases (web hole-filling diffusion
and contour) on the XLA route against the NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereomatching.config import StereoParams
from stereomatching.oracle import pipeline as oracle
from stereomatching.ops.contour import draw_contour
from stereomatching.ops.diffusion import fill_web_holes


def _web(h, w, seed, hole_frac=0.3, max_v=30):
    rng = np.random.default_rng(seed)
    web = rng.integers(1, max_v + 1, size=(h, w)).astype(np.int32)
    web[rng.random((h, w)) < hole_frac] = 0
    return web


@pytest.mark.parametrize("times", [2, 5, 32])
@pytest.mark.parametrize("h,w", [(48, 128), (40, 256), (13, 37)])
def test_diffusion_matches_oracle(times, h, w):
    web = _web(h, w, seed=times)
    want = oracle.fill_web_holes(web, times)
    got = fill_web_holes(jnp.asarray(web), times)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_diffusion_batched_vmap():
    webs = np.stack([_web(24, 128, s) for s in range(3)])
    want = np.stack([oracle.fill_web_holes(webs[i], 8) for i in range(3)])
    got = jax.vmap(lambda wb: fill_web_holes(wb, 8))(jnp.asarray(webs))
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("times", [0, 1])
def test_diffusion_times_leq_one_identity(times):
    web = _web(16, 128, 9)
    np.testing.assert_array_equal(
        np.asarray(fill_web_holes(jnp.asarray(web), times)), web
    )


@pytest.mark.parametrize("w", [100, 240, 960, 127, 129])
def test_diffusion_unaligned_widths(w):
    """The flat-index p±1 row-crossing semantics must hold at any width
    — the crossing columns are the most layout-sensitive cells."""
    web = _web(24, w, 3)
    want = oracle.fill_web_holes(web, 6)
    got = fill_web_holes(jnp.asarray(web), 6)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_boundary_rows_stay_zero_semantics():
    """A hole on the top row must average with the non-evolving zero
    above it — the reference's out-of-buffer-is-0 semantics."""
    web = np.full((16, 128), 8, dtype=np.int32)
    web[0, 64] = 0
    want = oracle.fill_web_holes(web, 6)
    got = fill_web_holes(jnp.asarray(web), 6)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_wide_image_matches_oracle():
    web = _web(40, 7680, seed=9)
    want = oracle.fill_web_holes(web, 32)
    got = fill_web_holes(jnp.asarray(web), 32)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("lines", [1, 10, 64])
@pytest.mark.parametrize("max_v", [3, 30])
def test_contour_matches_oracle(lines, max_v):
    """Contour bands and the elevation range, including a range smaller
    than the line count (the interval clamps to 1)."""
    web = _web(24, 50, seed=lines + max_v, hole_frac=0.0, max_v=max_v)
    out, mn, mx = draw_contour(jnp.asarray(web), lines)
    want, want_mn, want_mx = oracle.draw_contour(web, lines)
    np.testing.assert_array_equal(np.asarray(out), want)
    assert int(mn) == want_mn and int(mx) == want_mx


def test_classic_finish_batched_matches_oracle():
    from stereomatching.models.classic import classic_finish

    params = StereoParams(times=6, lines=5)
    webs = np.stack([_web(20, 33, 40 + s) for s in range(2)])
    got = jax.vmap(lambda wb: classic_finish(wb, params))(jnp.asarray(webs))
    for i in range(2):
        web = oracle.fill_web_holes(webs[i], params.times)
        out, mn, mx = oracle.draw_contour(web, params.lines)
        np.testing.assert_array_equal(np.asarray(got["web-2"][i]), web)
        np.testing.assert_array_equal(np.asarray(got["output-0"][i]), out)
        assert int(got["min_elevation"][i]) == mn
        assert int(got["max_elevation"][i]) == mx
