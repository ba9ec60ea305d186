"""Unit tests of the NumPy oracle's phase semantics.

These encode the reference's per-phase behavior contracts (SURVEY.md §2)
as executable assertions; the golden test (test_golden_vs_reference.py)
then checks the oracle end-to-end against the compiled C reference.
"""

import numpy as np
import pytest

from stereomatching.config import BoundaryMode, StereoParams
from stereomatching.oracle import pipeline as oracle
from tests.util import synthetic_pair


def brightness_pair(h=48, w=64, seed=0):
    from stereomatching.utils.imageio import to_brightness

    l, r = synthetic_pair(h, w, seed)
    return to_brightness(l), to_brightness(r)


class TestEdges:
    def test_wrap_shapes_and_binary(self):
        l, _ = brightness_pair()
        e = oracle.find_edges(l, 0.15, BoundaryMode.WRAP)
        assert e.shape == l.shape and e.dtype == np.uint8
        assert set(np.unique(e)) <= {0, 1}

    def test_uniform_image_has_no_edges(self):
        b = np.full((16, 16), 0.5)
        assert oracle.find_edges(b, 0.15, BoundaryMode.WRAP).sum() == 0

    def test_vertical_step_detected(self):
        b = np.zeros((16, 16))
        b[:, 8:] = 0.9
        e = oracle.find_edges(b, 0.15, BoundaryMode.WRAP)
        # Edge pixels flank the step columns 7/8.
        assert e[:, 7].all() and e[:, 8].all()
        assert not e[:, 3].any()

    def test_threshold_zero_marks_any_difference(self):
        l, _ = brightness_pair()
        e0 = oracle.find_edges(l, 0.0, BoundaryMode.WRAP)
        e9 = oracle.find_edges(l, 0.9, BoundaryMode.WRAP)
        assert e0.sum() >= e9.sum()

    def test_ghost_differs_from_wrap_only_at_border(self):
        # Ghost mode pads brightness with 128.0 (src/stereo-ghost.c:384);
        # interior pixels see identical neighborhoods in both modes.
        l, _ = brightness_pair()
        ew = oracle.find_edges(l, 0.15, BoundaryMode.WRAP)
        eg = oracle.find_edges(l, 0.15, BoundaryMode.GHOST)
        assert np.array_equal(ew[1:-1, 1:-1], eg[1:-1, 1:-1])
        # The out-of-band 128.0 halo makes every border pixel an edge here.
        assert eg[0].all() and eg[-1].all()

    def test_f32_tier_matches_f64_on_fixture(self):
        l, _ = brightness_pair()
        e64 = oracle.find_edges(l, 0.15, BoundaryMode.WRAP, np.float64)
        e32 = oracle.find_edges(l, 0.15, BoundaryMode.WRAP, np.float32)
        assert np.array_equal(e64, e32)


class TestMatches:
    def test_match_is_equality_not_and(self):
        # Two non-edge pixels also 'match' (src/stereo.c:122-123).
        l = np.zeros((4, 8), dtype=np.uint8)
        r = np.zeros((4, 8), dtype=np.uint8)
        m = oracle.fill_matches(l, r, 3, BoundaryMode.WRAP)
        assert m.all()

    def test_wrap_slide(self):
        l = np.zeros((2, 8), dtype=np.uint8)
        r = np.zeros((2, 8), dtype=np.uint8)
        r[:, 0] = 1
        m = oracle.fill_matches(l, r, 3, BoundaryMode.WRAP)
        # shift i compares l[x] to r[(x+i) % 8]: the r edge at x=0 breaks
        # the match at x = (0 - i) mod 8.
        assert m[0, 0, 0] == 0 and m[1, 0, 7] == 0 and m[2, 0, 6] == 0
        assert m[1, 0, 0] == 1

    def test_ghost_reads_zero_halo(self):
        l = np.ones((2, 8), dtype=np.uint8)
        r = np.ones((2, 8), dtype=np.uint8)
        m = oracle.fill_matches(l, r, 3, BoundaryMode.GHOST)
        # At shift 2, x=6,7 read the zero halo -> no match with l==1.
        assert m[2, 0, 5] == 1 and m[2, 0, 6] == 0 and m[2, 0, 7] == 0


class TestBoxSum:
    @pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
    def test_matches_naive_loop(self, mode):
        rng = np.random.default_rng(1)
        p = rng.integers(0, 2, size=(13, 17)).astype(np.uint8)
        sw = 5
        got = oracle.box_sum(p, sw, mode)
        h, w = p.shape
        half = sw // 2
        want = np.zeros((h, w), dtype=np.int64)
        for y in range(h):
            for x in range(w):
                s = 0
                for sy in range(-half, half + 1):
                    for sx in range(-half, half + 1):
                        yy, xx = y + sy, x + sx
                        if mode == BoundaryMode.WRAP:
                            s += p[yy % h, xx % w]
                        elif 0 <= yy < h and 0 <= xx < w:
                            s += p[yy, xx]
                want[y, x] = s
        assert np.array_equal(got, want)

    def test_window_one_is_identity(self):
        p = np.arange(12, dtype=np.uint8).reshape(3, 4) % 2
        assert np.array_equal(oracle.box_sum(p, 1, BoundaryMode.WRAP), p.astype(np.int32))


class TestBestAndWinner:
    def test_last_wins_tie_rule(self):
        # Ties go to the LAST shift achieving the max, stored as i+1
        # (src/stereo.c:211-219).
        scores = np.zeros((4, 1, 1), dtype=np.int32)
        scores[1, 0, 0] = 7
        scores[3, 0, 0] = 7
        best, winner = oracle.best_and_winner(scores)
        assert best[0, 0] == 7 and winner[0, 0] == 4

    def test_all_zero_scores_give_winner_num_shifts(self):
        scores = np.zeros((5, 2, 2), dtype=np.int32)
        best, winner = oracle.best_and_winner(scores)
        assert (best == 0).all() and (winner == 5).all()

    def test_web_never_zero(self):
        l, r = brightness_pair()
        arts = oracle.run_pipeline(l, r, StereoParams(square_width=5, num_shifts=8))
        assert (arts["web-1"] >= 1).all()


class TestDiffusion:
    def test_no_holes_is_identity(self):
        web = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
        assert np.array_equal(oracle.fill_web_holes(web, 32), web)

    def test_times_leq_one_returns_input(self):
        # The reference's pointer-swap dance returns X[times-1]; for
        # times in {0, 1} that is the input (src/stereo.c:232-250).
        web = np.zeros((3, 4), dtype=np.int32)
        web[1, 1] = 8
        assert np.array_equal(oracle.fill_web_holes(web, 0), web)
        assert np.array_equal(oracle.fill_web_holes(web, 1), web)

    def test_two_history_recurrence(self):
        # times=3 -> two effective steps of
        # X[t+1] = where(X[t]==0, avg4(X[t]), X[t-1]).
        web = np.zeros((1, 5), dtype=np.int32)
        web[0, 2] = 8
        # Step 1: holes take floor(avg of flat neighbors).
        # x=1: (right=8 + down=0 + left=0 + up=0)//4 = 2; x=3: 2.
        x1 = np.array([[0, 2, 8, 2, 0]], dtype=np.int32)
        # Step 2 from X1 with fallback X0:
        # x=0: X1==0 -> (2+0+0+0)//4 = 0; x=4: (0+0+2+0)//4=0;
        # x=1,3 nonzero in X1 -> fallback X0 = 0?? No: fallback is X[t-1]=X0
        # which is 0 there -> value becomes 0 again (the reference's
        # oscillation quirk).  x=2 nonzero -> X0[2] = 8.
        x2 = np.array([[0, 0, 8, 0, 0]], dtype=np.int32)
        got1 = oracle.fill_web_holes(web, 2)  # returns X[1]
        got2 = oracle.fill_web_holes(web, 3)  # returns X[2]
        assert np.array_equal(got1, x1)
        assert np.array_equal(got2, x2)

    def test_integer_division_floors(self):
        web = np.array([[1, 0, 2]], dtype=np.int32)
        # hole at p=1: (2 + 0 + 1 + 0)//4 = 0
        got = oracle.fill_web_holes(web, 2)
        assert got[0, 1] == 0


class TestContour:
    def test_banding(self):
        web = np.arange(0, 40, dtype=np.int32).reshape(4, 10)
        out, mn, mx = oracle.draw_contour(web, 10)
        assert mn == 0 and mx == 39
        interval = 39 // 10  # == 3
        want = ((np.arange(40).reshape(4, 10) % interval) == 0).astype(np.uint8)
        assert np.array_equal(out, want)

    def test_degenerate_range_does_not_crash(self):
        # The reference divides by zero when range < num_lines.
        web = np.full((3, 3), 7, dtype=np.int32)
        out, _, _ = oracle.draw_contour(web, 10)
        assert out.all()


class TestPipeline:
    @pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
    def test_end_to_end_artifacts(self, mode):
        l, r = brightness_pair()
        p = StereoParams(square_width=5, num_shifts=8, mode=mode)
        arts = oracle.run_pipeline(l, r, p, collect=True)
        assert arts["output-0"].dtype == np.uint8
        assert set(np.unique(arts["output-0"])) <= {0, 1}
        assert arts["web-1"].min() >= 1 and arts["web-1"].max() <= 8
        for i in range(8):
            assert f"matches-{i}" in arts and f"scores-{i}" in arts

    def test_square_width_validation(self):
        l, r = brightness_pair(h=16, w=16)
        with pytest.raises(ValueError):
            oracle.run_pipeline(l, r, StereoParams(square_width=21))

    def test_params_validation(self):
        with pytest.raises(ValueError):
            StereoParams(threshold=1.5)
        with pytest.raises(ValueError):
            StereoParams(square_width=4)
        with pytest.raises(ValueError):
            StereoParams(lines=0)
