"""Differential tests: JAX/XLA tier vs the NumPy oracle.

The oracle is bit-exact to the C reference (test_golden_vs_reference.py);
these tests close the chain reference -> oracle -> XLA tier.  Integer
phases must match bitwise; the float edge phase matches bitwise too when
both run the same dtype on CPU (identical IEEE op order).
"""

import numpy as np
import pytest

from stereomatching.config import BoundaryMode, StereoParams
from stereomatching.models.classic import (
    build_classic_collect_pipeline,
    build_classic_pipeline,
)
from stereomatching.oracle import pipeline as oracle
from stereomatching.utils.imageio import to_brightness
from tests.util import synthetic_pair

MODES = [BoundaryMode.WRAP, BoundaryMode.GHOST]


def pair(dtype=np.float32, h=48, w=64, seed=0):
    l, r = synthetic_pair(h, w, seed)
    return to_brightness(l, dtype), to_brightness(r, dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_full_pipeline_bitwise_vs_oracle(mode, dtype):
    # edge_rule='exact' is the cross-backend deterministic tier: the whole
    # pipeline must match the oracle bitwise on any backend.
    l, r = pair(dtype)
    params = StereoParams(
        square_width=9, num_shifts=12, mode=mode, edge_rule="exact"
    )
    want = oracle.run_pipeline(l, r, params, dtype=np.dtype(dtype), collect=True)
    got = build_classic_collect_pipeline(params)(l, r)

    for name in ("edges-1", "edges-2", "score_best", "web-1", "web-2", "output-0"):
        assert np.array_equal(np.asarray(got[name]), want[name]), name
    for i in range(params.num_shifts):
        assert np.array_equal(np.asarray(got["matches"][i]), want[f"matches-{i}"]), i
        assert np.array_equal(np.asarray(got["score_all"][i]), want[f"score_all-{i}"]), i
        assert np.array_equal(np.asarray(got["scores"][i]), want[f"scores-{i}"]), i


@pytest.mark.parametrize("mode", MODES)
def test_default_params_pipeline(mode):
    # Reference default geometry (sw=21, D=30, times=32, lines=10) on a
    # bigger image.
    l, r = pair(h=64, w=96, seed=5)
    params = StereoParams(mode=mode)
    want = oracle.run_pipeline(l, r, params, dtype=np.dtype(np.float32))
    got = build_classic_pipeline(params)(l, r)
    for name in ("edges-1", "score_best", "web-1", "web-2", "output-0"):
        assert np.array_equal(np.asarray(got[name]), want[name]), name
    assert int(got["min_elevation"]) == int(want["web-2"].min())
    assert int(got["max_elevation"]) == int(want["web-2"].max())


def test_batched_vmap_matches_per_pair():
    params = StereoParams(square_width=7, num_shifts=8)
    pairs = [pair(seed=s) for s in (1, 2, 3)]
    lb = np.stack([p[0] for p in pairs])
    rb = np.stack([p[1] for p in pairs])
    batched = build_classic_pipeline(params, batched=True)(lb, rb)
    single = build_classic_pipeline(params)
    for b, (l, r) in enumerate(pairs):
        one = single(l, r)
        for name in ("web-1", "output-0"):
            assert np.array_equal(
                np.asarray(batched[name][b]), np.asarray(one[name])
            ), (b, name)


def test_reference_rule_diverges_only_at_float_ties():
    """The 'reference' edge rule reproduces the C float op order, but XLA
    may lower division as reciprocal-multiply; any pixel where the XLA
    edge decision differs from the oracle must be a knife-edge tie (the
    decision margin within a few ulps of zero)."""
    import jax

    from stereomatching.ops.edges import find_edges as jax_edges
    from stereomatching.oracle.pipeline import _EDGE_OPERATORS

    l, _ = pair(np.float64, h=64, w=96, seed=11)
    thr = 0.15
    e_np = oracle.find_edges(l, thr, BoundaryMode.WRAP, np.float64)
    e_jx = np.asarray(
        jax.jit(lambda b: jax_edges(b, thr, BoundaryMode.WRAP))(l)
    )
    disagree = e_np != np.asarray(e_jx, np.uint8)
    if not disagree.any():
        return
    # Compute per-pixel minimum |margin| over the four operators.
    p = np.pad(l, 1, mode="wrap")
    h, w = l.shape

    def nb(dx, dy):
        return p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    min_margin = np.full((h, w), np.inf)
    for sa, sb in _EDGE_OPERATORS:
        A = (nb(*sa[0]) + nb(*sa[1]) + nb(*sa[2])) / 3.0
        B = (nb(*sb[0]) + nb(*sb[1]) + nb(*sb[2])) / 3.0
        bound = np.clip(thr * ((A + B) / 2.0), 0.0, 1.0)
        min_margin = np.minimum(min_margin, np.abs(np.abs(A - B) - bound))
    assert (min_margin[disagree] < 1e-12).all(), (
        "reference-rule divergence at a non-tie pixel"
    )


def test_exact_rule_agrees_with_reference_rule_away_from_ties():
    l, _ = pair(np.float64, h=64, w=96, seed=12)
    e_ref = oracle.find_edges(l, 0.15, BoundaryMode.WRAP, np.float64)
    e_exact = oracle.find_edges(l, 0.15, BoundaryMode.WRAP, rule="exact")
    # Identical predicate up to intermediate rounding: tiny disagreement.
    rate = (e_ref != e_exact).mean()
    assert rate < 1e-3, rate


def test_num_shifts_exceeding_width_wraps():
    # wrap mode must handle num_shifts > W (extend_right_edges tiling).
    l, r = pair(h=16, w=16, seed=4)
    params = StereoParams(square_width=5, num_shifts=40, mode=BoundaryMode.WRAP)
    want = oracle.run_pipeline(l, r, params)
    got = build_classic_pipeline(params)(l, r)
    assert np.array_equal(np.asarray(got["web-1"]), want["web-1"])


def test_match_and_score_subpixel():
    """Opt-in parabola refine: winner bit-identical to match_and_score,
    offset within +-0.5 and zero at boundaries/missing neighbors."""
    import jax.numpy as jnp

    from stereomatching.ops.argmax import (
        match_and_score,
        match_and_score_subpixel,
    )
    from stereomatching.ops.edges import find_edges
    from stereomatching.utils.imageio import to_brightness

    params = StereoParams(square_width=9, num_shifts=8, edge_rule="exact")
    left, right = synthetic_pair(h=32, w=48, seed=17)
    el = find_edges(jnp.asarray(to_brightness(left, np.float32)),
                    params.threshold, params.mode, params.edge_rule)
    er = find_edges(jnp.asarray(to_brightness(right, np.float32)),
                    params.threshold, params.mode, params.edge_rule)
    best0, winner0 = match_and_score(el, er, params)
    best, winner, sub = match_and_score_subpixel(el, er, params)
    np.testing.assert_array_equal(np.asarray(best), np.asarray(best0))
    np.testing.assert_array_equal(np.asarray(winner), np.asarray(winner0))
    sub = np.asarray(sub)
    w = np.asarray(winner)
    assert np.all(np.abs(sub - w) <= 0.5 + 1e-6)
    # Winners at the shift-range ends have a missing neighbor -> offset 0.
    ends = (w == 1) | (w == params.num_shifts)
    np.testing.assert_array_equal(sub[ends], w[ends].astype(np.float32))
