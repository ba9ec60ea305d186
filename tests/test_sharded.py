"""Differential tests for the sharded (shard_map + ppermute halo) tier.

The role test/diff.sh plays for the reference's CUDA programs: the
NumPy oracle is the executable spec; the multi-chip pipeline must
reproduce it bitwise on an emulated 8-device CPU mesh, for every mesh
shape and both boundary modes.
"""

import jax
import numpy as np
import pytest

from stereomatching.config import BoundaryMode, StereoParams
from stereomatching.oracle import pipeline as oracle
from stereomatching.parallel import build_sharded_pipeline, make_mesh
from stereomatching.utils.imageio import to_brightness
from tests.util import synthetic_pair

pytestmark = pytest.mark.usefixtures("eight_devices")


def _batch(n_pairs, h, w, seed0=0):
    lefts, rights = [], []
    for i in range(n_pairs):
        l, r = synthetic_pair(h=h, w=w, seed=seed0 + i)
        lefts.append(to_brightness(l, np.float32))
        rights.append(to_brightness(r, np.float32))
    return np.stack(lefts), np.stack(rights)


def _oracle_batch(lefts, rights, params):
    outs = [
        oracle.run_pipeline(
            lefts[i].astype(np.float64), rights[i].astype(np.float64), params
        )
        for i in range(lefts.shape[0])
    ]
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
@pytest.mark.parametrize("data,rows", [(1, 8), (2, 4), (8, 1), (4, 2)])
def test_sharded_matches_oracle(mode, data, rows):
    params = StereoParams(
        square_width=9, times=6, lines=4, num_shifts=12, mode=mode,
        edge_rule="exact",
    )
    mesh = make_mesh(data=data, rows=rows)
    lefts, rights = _batch(n_pairs=data, h=rows * 12, w=48)
    got = jax.device_get(build_sharded_pipeline(params, mesh)(lefts, rights))
    want = _oracle_batch(lefts, rights, params)
    for name in ("edges-1", "edges-2", "score_best", "web-1", "web-2", "output-0"):
        np.testing.assert_array_equal(
            np.asarray(got[name]), want[name], err_msg=f"{name} [{mode} {data}x{rows}]"
        )


@pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
def test_sharded_default_params(mode):
    """Default reference parameters (sw=21, times=32, 30 shifts) on a
    2x4 mesh — shard height 22 > halo 10."""
    params = StereoParams(mode=mode, edge_rule="exact")
    mesh = make_mesh(data=2, rows=4)
    lefts, rights = _batch(n_pairs=2, h=88, w=64, seed0=5)
    got = jax.device_get(build_sharded_pipeline(params, mesh)(lefts, rights))
    want = _oracle_batch(lefts, rights, params)
    for name in ("score_best", "web-2", "output-0"):
        np.testing.assert_array_equal(np.asarray(got[name]), want[name], err_msg=name)


def test_halo_too_wide_raises():
    params = StereoParams(square_width=21, mode=BoundaryMode.GHOST)
    mesh = make_mesh(data=1, rows=8)
    lefts, rights = _batch(n_pairs=1, h=8 * 8, w=32)  # shard height 8 < halo 10
    with pytest.raises(ValueError, match="halo"):
        build_sharded_pipeline(params, mesh)(lefts, rights)


def test_sharded_matches_single_chip_reference_rule():
    """'reference' edge rule: sharded vs single-chip JAX tier must agree
    bitwise (same backend, same arithmetic) even where the oracle's f64
    would differ."""
    from stereomatching.models.classic import build_classic_pipeline

    params = StereoParams(
        square_width=9, times=6, lines=4, num_shifts=12,
        mode=BoundaryMode.GHOST, edge_rule="reference",
    )
    mesh = make_mesh(data=1, rows=8)
    lefts, rights = _batch(n_pairs=1, h=64, w=48, seed0=9)
    got = jax.device_get(build_sharded_pipeline(params, mesh)(lefts, rights))
    single = build_classic_pipeline(params, batched=True)
    want = jax.device_get(single(lefts, rights))
    for name in ("edges-1", "score_best", "web-2", "output-0"):
        np.testing.assert_array_equal(
            np.asarray(got[name]), np.asarray(want[name]), err_msg=name
        )


@pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
def test_sharded_pallas_matches_oracle(mode):
    """Sharded tier with the fused match kernel on each shard (in the
    Pallas interpreter here): halo exchange feeds the kernel, output
    stays bit-identical."""
    params = StereoParams(
        square_width=9, times=6, lines=4, num_shifts=12, mode=mode,
        edge_rule="exact",
    )
    mesh = make_mesh(data=2, rows=4)
    lefts, rights = _batch(n_pairs=2, h=4 * 12, w=48)
    got = jax.device_get(
        build_sharded_pipeline(params, mesh, use_pallas=True,
                               interpret=True)(lefts, rights)
    )
    want = _oracle_batch(lefts, rights, params)
    for name in ("score_best", "web-1", "web-2", "output-0"):
        np.testing.assert_array_equal(
            np.asarray(got[name]), want[name], err_msg=f"{name} [{mode}]"
        )


@pytest.mark.parametrize("mode", [BoundaryMode.WRAP, BoundaryMode.GHOST])
@pytest.mark.parametrize("data,rows,cols,pallas", [
    (1, 2, 4, False), (2, 2, 2, False), (1, 1, 8, False),
    (1, 2, 4, True), (1, 1, 8, True),
])
def test_sharded_2d_matches_oracle(mode, data, rows, cols, pallas):
    """2-D spatial sharding (rows x cols): every x dependency — the
    shift slide's num_shifts reach and the box window's half — is one
    column halo exchange (the reference's x ghost zones,
    src/ghost.h:54-55, src/stereo-ghost.c:11-12), and the result stays
    bit-identical to the serial oracle in both boundary modes, on both
    the XLA and per-shard-kernel routes."""
    params = StereoParams(
        square_width=9, times=6, lines=4, num_shifts=12, mode=mode,
        edge_rule="exact",
    )
    mesh = make_mesh(data=data, rows=rows, cols=cols)
    # shard width must cover num_shifts + half = 16
    lefts, rights = _batch(n_pairs=data, h=max(rows * 12, 16), w=cols * 20)
    got = jax.device_get(
        build_sharded_pipeline(params, mesh, use_pallas=pallas,
                               interpret=pallas)(lefts, rights)
    )
    want = _oracle_batch(lefts, rights, params)
    names = ("edges-1", "edges-2", "score_best", "web-1", "web-2", "output-0")
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(got[name]), want[name],
            err_msg=f"{name} [{mode} {data}x{rows}x{cols} pallas={pallas}]",
        )


def test_sharded_2d_validation():
    from stereomatching.parallel import sharded_classic_forward

    params = StereoParams(square_width=9, num_shifts=12)
    mesh = make_mesh(data=1, rows=1, cols=8)
    lefts = np.zeros((1, 16, 64), np.float32)  # 8 cols -> ws=8 < 16
    with pytest.raises(ValueError, match="x halo reach"):
        sharded_classic_forward(lefts, lefts, params, mesh)
