"""Differential tests for the fused match + box + argmax kernel
(ops/fused.py, Pallas Triton route).

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``
is asked for explicitly; the wrappers never choose it themselves); the
compiled kernel is checked on the card by the ``gpu`` tests at the end.
The oracle is the spec, as test/diff.sh's serial C is for the reference's
CUDA kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereomatching.config import BoundaryMode, StereoParams
from stereomatching.oracle import pipeline as oracle
from stereomatching.ops import fused
from stereomatching.ops.fused import (
    match_and_score_fused,
    match_and_score_fused_prehalo,
)
from stereomatching.utils.imageio import to_brightness
from tests.util import synthetic_pair


def _edges_and_expected(params, h=48, w=64, seed=0):
    left, right = synthetic_pair(h=h, w=w, seed=seed)
    lb = to_brightness(left)
    rb = to_brightness(right)
    el = oracle.find_edges(lb, params.threshold, params.mode, rule=params.edge_rule)
    er = oracle.find_edges(rb, params.threshold, params.mode, rule=params.edge_rule)
    matches = oracle.fill_matches(el, er, params.num_shifts, params.mode)
    sums = np.stack(
        [
            oracle.box_sum(matches[i], params.square_width, params.mode)
            for i in range(params.num_shifts)
        ]
    )
    scores = oracle.record_scores(matches, sums)
    best, winner = oracle.best_and_winner(scores)
    return el, er, best, winner


def _fused(el, er, params, **kw):
    return match_and_score_fused(
        el.astype(np.int32), er.astype(np.int32), params, interpret=True, **kw
    )


@pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
@pytest.mark.parametrize("sw,d", [(9, 12), (21, 30), (5, 64)])
def test_fused_kernel_matches_oracle(mode, sw, d):
    params = StereoParams(square_width=sw, num_shifts=d, mode=mode, edge_rule="exact")
    el, er, best, winner = _edges_and_expected(params, h=48, w=64)
    got_best, got_winner = _fused(el, er, params)
    np.testing.assert_array_equal(np.asarray(got_best), best, err_msg="best")
    np.testing.assert_array_equal(np.asarray(got_winner), winner, err_msg="winner")


def test_fused_kernel_ragged_height():
    """H not divisible by the output tile: rows past H are sliced off."""
    params = StereoParams(square_width=9, num_shifts=8, mode=BoundaryMode.GHOST,
                          edge_rule="exact")
    el, er, best, winner = _edges_and_expected(params, h=37, w=48, seed=4)
    got_best, got_winner = _fused(el, er, params)
    np.testing.assert_array_equal(np.asarray(got_best), best)
    np.testing.assert_array_equal(np.asarray(got_winner), winner)


def test_fused_kernel_wrap_tall_tiles():
    """An image smaller than one tile: the single-tile grid."""
    params = StereoParams(square_width=7, num_shifts=10, mode=BoundaryMode.WRAP,
                          edge_rule="exact")
    el, er, best, winner = _edges_and_expected(params, h=24, w=40, seed=2)
    got_best, got_winner = _fused(el, er, params)
    np.testing.assert_array_equal(np.asarray(got_best), best)
    np.testing.assert_array_equal(np.asarray(got_winner), winner)


def test_fused_kernel_batched():
    """Native batch support: [B, H, W] inputs via the grid batch dim."""
    params = StereoParams(square_width=9, num_shifts=8, mode=BoundaryMode.GHOST,
                          edge_rule="exact")
    els, ers, bests, winners = [], [], [], []
    for seed in range(3):
        el, er, best, winner = _edges_and_expected(params, h=32, w=48, seed=seed)
        els.append(el); ers.append(er); bests.append(best); winners.append(winner)
    gb, gw = _fused(np.stack(els), np.stack(ers), params)
    np.testing.assert_array_equal(np.asarray(gb), np.stack(bests))
    np.testing.assert_array_equal(np.asarray(gw), np.stack(winners))


def test_batched_pallas_pipeline_matches_xla():
    from stereomatching.models.classic import build_classic_pipeline

    params = StereoParams(square_width=9, num_shifts=8, times=4, lines=4,
                          mode=BoundaryMode.GHOST, edge_rule="exact")
    pairs = [synthetic_pair(h=32, w=48, seed=s) for s in range(2)]
    l = np.stack([to_brightness(p[0], np.float32) for p in pairs])
    r = np.stack([to_brightness(p[1], np.float32) for p in pairs])
    want = jax.device_get(build_classic_pipeline(params, batched=True)(l, r))
    got = jax.device_get(
        build_classic_pipeline(params, batched=True, use_pallas=True,
                               interpret=True)(l, r)
    )
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("half,block", [
    (0, (16, 64)), (2, (32, 128)), (4, (32, 128)), (10, (64, 128)),
    (24, (64, 128)), (40, (128, 256)), (127, (512, 512)),
])
def test_tile_shape(half, block):
    """Blocks are powers of two (Triton's rule) with at least 16 output
    rows and 64 output columns left after the box halo."""
    bh, bw = fused.tile_shape(half)
    assert (bh, bw) == block
    assert bh - 2 * half >= 16 and bw - 2 * half >= 64


@pytest.mark.parametrize("h,w,half,d", [
    (1024, 1024, 10, 64), (37, 48, 4, 8), (2160, 3840, 10, 64),
    (44, 108, 10, 1), (45, 109, 10, 3),
])
def test_geometry_covers_every_block_load(h, w, half, d):
    """The padded planes hold every halo, centre and shifted block the
    grid loads, and the output tiles cover the image exactly once."""
    bh, bw, th, tw, n_ty, n_tx, hl, wl, wr = fused._geometry(h, w, half, d)
    assert (th, tw) == (bh - 2 * half, bw - 2 * half)
    assert n_ty * th >= h > (n_ty - 1) * th
    assert n_tx * tw >= w > (n_tx - 1) * tw
    last_y, last_x = (n_ty - 1) * th, (n_tx - 1) * tw
    assert last_y + half + bh <= hl  # centre block of the last row tile
    assert last_x + half + bw <= wl
    assert last_x + half + (d - 1) + bw <= wr  # last shift's centre block
    assert wr == wl + d


def test_fused_rejects_wide_window_and_bad_padding():
    with pytest.raises(ValueError, match="square_width <= 255"):
        match_and_score_fused(jnp.zeros((300, 300), jnp.int32),
                              jnp.zeros((300, 300), jnp.int32),
                              StereoParams(square_width=257, edge_rule="exact"),
                              interpret=True)
    with pytest.raises(ValueError, match="tile geometry"):
        fused._fused_call(jnp.zeros((1, 10, 10), jnp.int8),
                          jnp.zeros((1, 10, 10), jnp.int8), 8, 8, 1, 2,
                          False, True)


@pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
def test_pad_edges_layout(mode):
    """Image pixel (y, x) lands at (y + half, x + half) of both padded
    planes; ghost pads the left map with the non-edge sentinel and the
    right with zeros, wrap wraps."""
    half, h, w = 2, 5, 7
    rng = np.random.default_rng(0)
    el = rng.integers(0, 2, (1, h, w))
    er = rng.integers(0, 2, (1, h, w))
    hl, wl, wr = 12, 14, 17
    lp, rp = fused._pad_edges(jnp.asarray(el), jnp.asarray(er), mode, half,
                              hl, wl, wr)
    lp, rp = np.asarray(lp), np.asarray(rp)
    assert lp.shape == (1, hl, wl) and rp.shape == (1, hl, wr)
    assert lp.dtype == np.int8 and rp.dtype == np.int8
    np.testing.assert_array_equal(lp[0, half:half + h, half:half + w], el[0])
    np.testing.assert_array_equal(rp[0, half:half + h, half:half + w], er[0])
    if mode == BoundaryMode.WRAP:
        assert lp[0, 0, 0] == el[0, (-half) % h, (-half) % w]
        assert rp[0, half, half + w + 1] == er[0, 0, 1]
    else:
        assert (lp[0, :half] == 2).all() and (lp[0, :, :half] == 2).all()
        assert (rp[0, :half] == 0).all() and (rp[0, :, half + w:] == 0).all()


@pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
def test_fused_kernel_x_tiled(mode):
    """Several column tiles (w > 108 outputs per tile at sw=21) must be
    invisible: bit-equal to the oracle, also for a ragged last tile."""
    params = StereoParams(square_width=21, times=4, lines=4, num_shifts=8,
                          mode=mode, edge_rule="exact")
    el, er, want_best, want_winner = _edges_and_expected(params, h=24, w=250,
                                                         seed=11)
    best, winner = _fused(el, er, params)
    np.testing.assert_array_equal(np.asarray(best), want_best)
    np.testing.assert_array_equal(np.asarray(winner), want_winner)


@pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
@pytest.mark.parametrize("sw,d", [(9, 12), (21, 8)])
def test_fused_edges_kernel_matches_oracle(mode, sw, d):
    """Brightness in, through classic_forward on the fused route: edges +
    match phase bit-equal to the oracle's separate phases."""
    from stereomatching.models.classic import classic_forward

    params = StereoParams(square_width=sw, num_shifts=d, mode=mode,
                          edge_rule="exact", times=4, lines=4)
    left, right = synthetic_pair(h=48, w=64, seed=21)
    lb = to_brightness(left).astype(np.float32)
    rb = to_brightness(right).astype(np.float32)
    want = oracle.run_pipeline(lb.astype(np.float64), rb.astype(np.float64),
                               params)
    got = classic_forward(jnp.asarray(lb), jnp.asarray(rb), params,
                          use_pallas=True, interpret=True)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


@pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
@pytest.mark.parametrize("d", [1, 8])
def test_fused_subpixel_matches_xla(mode, d):
    """subpixel=True carries the winner's neighbour scores through the
    fused loop; must equal ops/argmax.match_and_score_subpixel exactly
    (same parabola arithmetic on the same int scores)."""
    from stereomatching.ops.argmax import match_and_score_subpixel

    params = StereoParams(square_width=9, num_shifts=d, mode=mode,
                          edge_rule="exact")
    el, er, want_best, want_winner = _edges_and_expected(params, h=24, w=200,
                                                         seed=51)
    want_b, want_w, want_s = match_and_score_subpixel(
        jnp.asarray(el), jnp.asarray(er), params)
    best, winner, sub = _fused(el, er, params, subpixel=True)
    np.testing.assert_array_equal(np.asarray(best), want_best)
    np.testing.assert_array_equal(np.asarray(winner), want_winner)
    np.testing.assert_array_equal(np.asarray(sub), np.asarray(want_s))


def test_fused_edges_kernel_subpixel_and_classic_surface():
    """The classic_forward "subpixel" artifact: fused vs XLA route
    bit-equal."""
    from stereomatching.models.classic import classic_forward
    from stereomatching.ops.argmax import match_and_score_subpixel
    from stereomatching.ops.edges import find_edges

    params = StereoParams(square_width=9, num_shifts=8,
                          mode=BoundaryMode.GHOST, edge_rule="exact")
    left, right = synthetic_pair(h=48, w=64, seed=23)
    lb = to_brightness(left).astype(np.float32)
    rb = to_brightness(right).astype(np.float32)
    el = find_edges(jnp.asarray(lb), params.threshold, params.mode, "exact")
    er = find_edges(jnp.asarray(rb), params.threshold, params.mode, "exact")
    _, _, want_sub = match_and_score_subpixel(el, er, params)

    res_p = classic_forward(jnp.asarray(lb), jnp.asarray(rb), params,
                            use_pallas=True, subpixel=True, interpret=True)
    res_x = classic_forward(jnp.asarray(lb), jnp.asarray(rb), params,
                            use_pallas=False, subpixel=True)
    np.testing.assert_array_equal(np.asarray(res_p["subpixel"]),
                                  np.asarray(want_sub))
    np.testing.assert_array_equal(np.asarray(res_x["subpixel"]),
                                  np.asarray(want_sub))
    np.testing.assert_array_equal(np.asarray(res_p["output-0"]),
                                  np.asarray(res_x["output-0"]))


@pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
@pytest.mark.parametrize("halo", [4, 6])
def test_prehalo_matches_full_image(mode, halo):
    """The sharded tier's entry: a row block with ``halo`` exchanged rows
    on each side gives the full-image kernel's rows of that block."""
    from stereomatching.ops.matching import extend_right_edges

    params = StereoParams(square_width=9, num_shifts=8, mode=mode,
                          edge_rule="exact")
    el, er, want_best, want_winner = _edges_and_expected(params, h=40, w=48,
                                                         seed=5)
    r_ext = np.asarray(extend_right_edges(jnp.asarray(er), 8, mode))
    lo, hi = 16, 32
    rows = np.arange(lo - halo, hi + halo)
    if mode == BoundaryMode.WRAP:
        rows = rows % el.shape[0]
    l_blk, r_blk = el[rows][None], r_ext[rows][None]
    best, winner = match_and_score_fused_prehalo(
        jnp.asarray(l_blk), jnp.asarray(r_blk), params, halo=halo,
        interpret=True)
    np.testing.assert_array_equal(np.asarray(best)[0], want_best[lo:hi])
    np.testing.assert_array_equal(np.asarray(winner)[0], want_winner[lo:hi])
    with pytest.raises(ValueError, match="halo"):
        match_and_score_fused_prehalo(jnp.asarray(l_blk), jnp.asarray(r_blk),
                                      params.replace(square_width=21),
                                      halo=halo, interpret=True)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
def test_fused_kernel_compiled_matches_xla(gpu, mode):
    """The kernel as compiled for the card, against the XLA route on the
    same card, at the bench's width."""
    from stereomatching.ops.argmax import match_and_score

    params = StereoParams(num_shifts=64, mode=mode, edge_rule="exact")
    rng = np.random.default_rng(0)
    el = jnp.asarray(rng.integers(0, 2, (2, 256, 1024)), jnp.int32)
    er = jnp.asarray(rng.integers(0, 2, (2, 256, 1024)), jnp.int32)
    best, winner = match_and_score_fused(el, er, params)
    want = jax.vmap(lambda a, b: match_and_score(a, b, params))(el, er)
    np.testing.assert_array_equal(np.asarray(best), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(winner), np.asarray(want[1]))
