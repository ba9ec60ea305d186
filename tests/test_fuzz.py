"""Parameter-space fuzzing: random configurations, every tier must match
the oracle bitwise.  Catches interactions (window vs image size, shifts
vs width, odd times) that the targeted tests don't enumerate."""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # randomized sweeps: the test-all tier

from stereomatching.config import BoundaryMode, StereoParams
from stereomatching.models.classic import build_classic_pipeline
from stereomatching.oracle import pipeline as oracle
from stereomatching.ops.fused import match_and_score_fused
from stereomatching.utils.imageio import to_brightness
from tests.util import synthetic_pair

import jax


def _random_config(rng):
    h = int(rng.integers(17, 64))
    w = int(rng.integers(21, 96))
    sw = int(rng.choice([1, 3, 5, 7, 9, 11]))
    sw = min(sw, (min(h, w) - 1) | 1)
    return dict(
        h=h,
        w=w,
        params=StereoParams(
            threshold=float(rng.uniform(0.05, 0.5)),
            square_width=sw,
            times=int(rng.integers(0, 12)),
            lines=int(rng.integers(1, 12)),
            num_shifts=int(rng.integers(1, min(w + 10, 40))),
            mode=BoundaryMode(rng.choice(["wrap", "ghost"])),
            edge_rule="exact",
        ),
    )


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_jax_tier_matches_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    cfg = _random_config(rng)
    left, right = synthetic_pair(h=cfg["h"], w=cfg["w"], seed=seed)
    params = cfg["params"]
    want = oracle.run_pipeline(to_brightness(left), to_brightness(right), params)
    fn = build_classic_pipeline(params)
    got = jax.device_get(
        fn(to_brightness(left, np.float32), to_brightness(right, np.float32))
    )
    for k in ("edges-1", "score_best", "web-1", "web-2", "output-0"):
        np.testing.assert_array_equal(
            np.asarray(got[k]), want[k], err_msg=f"{k} cfg={params}"
        )


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_pallas_kernel_matches_oracle(seed):
    rng = np.random.default_rng(2000 + seed)
    cfg = _random_config(rng)
    left, right = synthetic_pair(h=cfg["h"], w=cfg["w"], seed=seed)
    params = cfg["params"]
    el = oracle.find_edges(to_brightness(left), params.threshold, params.mode,
                           rule="exact")
    er = oracle.find_edges(to_brightness(right), params.threshold, params.mode,
                           rule="exact")
    matches = oracle.fill_matches(el, er, params.num_shifts, params.mode)
    sums = np.stack([
        oracle.box_sum(matches[i], params.square_width, params.mode)
        for i in range(params.num_shifts)
    ])
    best, winner = oracle.best_and_winner(oracle.record_scores(matches, sums))
    gb, gw = match_and_score_fused(
        el.astype(np.int32), er.astype(np.int32), params, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(gb), best,
                                  err_msg=f"best cfg={params}")
    np.testing.assert_array_equal(np.asarray(gw), winner,
                                  err_msg=f"winner cfg={params}")


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_sharded_matches_oracle(seed):
    if len(jax.devices()) < 8:
        pytest.skip("needs CPU mesh")
    from stereomatching.parallel import build_sharded_pipeline, make_mesh
    from stereomatching.oracle import pipeline as oracle_mod

    rng = np.random.default_rng(3000 + seed)
    rows = int(rng.choice([2, 4, 8]))
    data = int(rng.choice([1, 2]))
    if data * rows > 8:
        data = 1
    sw = int(rng.choice([3, 5, 7, 9]))
    hs = int(rng.integers(max(sw // 2, 2), 20))
    h = rows * hs
    w = int(rng.integers(24, 80))
    params = StereoParams(
        threshold=float(rng.uniform(0.05, 0.4)),
        square_width=sw,
        times=int(rng.integers(0, 8)),
        lines=int(rng.integers(1, 8)),
        num_shifts=int(rng.integers(1, 24)),
        mode=BoundaryMode(rng.choice(["wrap", "ghost"])),
        edge_rule="exact",
    )
    use_pallas = bool(rng.integers(0, 2))
    mesh = make_mesh(data=data, rows=rows, devices=jax.devices()[: data * rows])
    lefts, rights = [], []
    for i in range(data):
        l, r = synthetic_pair(h=h, w=w, seed=seed * 10 + i)
        lefts.append(to_brightness(l, np.float32))
        rights.append(to_brightness(r, np.float32))
    lb, rb = np.stack(lefts), np.stack(rights)
    got = jax.device_get(
        build_sharded_pipeline(params, mesh, use_pallas=use_pallas,
                               interpret=use_pallas)(lb, rb)
    )
    for i in range(data):
        want = oracle_mod.run_pipeline(
            lb[i].astype(np.float64), rb[i].astype(np.float64), params
        )
        for k in ("score_best", "web-2", "output-0"):
            np.testing.assert_array_equal(
                np.asarray(got[k][i]), want[k],
                err_msg=f"{k} mesh={data}x{rows} pallas={use_pallas} {params}",
            )
