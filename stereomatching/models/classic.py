"""The classic pipeline on one device.

One jitted function covering the reference's whole ``algorithm()``
(src/stereo.c:287-333): edges -> shift matching + windowed scoring +
argmax -> diffusion -> contour.  Both boundary modes.  Batched over a
leading pairs axis.

The match phase has two implementations, bit-identical: the XLA shift
scan (ops/argmax.py) and the fused GPU kernel (ops/fused.py, selected by
``use_pallas``).  The distributed tier (parallel/) shards this same
computation over a (data, rows) mesh.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import jax
import jax.numpy as jnp

from stereomatching.config import StereoParams
from stereomatching.ops.argmax import match_and_score, match_and_score_collect
from stereomatching.ops.contour import draw_contour
from stereomatching.ops.diffusion import fill_web_holes
from stereomatching.ops.edges import find_edges


def _match(edges_l, edges_r, params: StereoParams, use_pallas: bool,
           subpixel: bool, interpret: bool):
    """-> (best, winner, [subpixel]) for [H, W] or (fused) [B, H, W]."""
    if use_pallas:
        from stereomatching.ops.fused import match_and_score_fused

        return match_and_score_fused(edges_l, edges_r, params,
                                     subpixel=subpixel, interpret=interpret)
    if subpixel:
        from stereomatching.ops.argmax import match_and_score_subpixel

        return match_and_score_subpixel(edges_l, edges_r, params)
    return match_and_score(edges_l, edges_r, params)


def _artifacts(edges_l, edges_r, best, winner, sub, params: StereoParams):
    res = {
        "edges-1": edges_l,
        "edges-2": edges_r,
        "score_best": best,
        "web-1": winner,
        **classic_finish(winner, params),
    }
    if sub:
        res["subpixel"] = sub[0]
    return res


def classic_forward(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: StereoParams,
    use_pallas: bool = False,
    subpixel: bool = False,
    interpret: bool = False,
) -> Dict[str, jnp.ndarray]:
    """Full pipeline on one brightness pair [H, W] -> artifact dict.
    Trace-time params; wrap in jit via ``build_classic_pipeline``.
    ``use_pallas`` routes the match phase through the fused kernel
    (``interpret`` runs it in the Pallas interpreter, for tests).

    ``subpixel`` (opt-in extension beyond the reference) adds a
    float32 "subpixel" artifact: the winning shift parabola-refined on
    its neighbour scores (ops/argmax.match_and_score_subpixel).  All
    reference artifacts stay bit-identical."""
    edges_l = find_edges(left, params.threshold, params.mode, params.edge_rule)
    edges_r = find_edges(right, params.threshold, params.mode, params.edge_rule)
    best, winner, *sub = _match(edges_l, edges_r, params, use_pallas,
                                subpixel, interpret)
    return _artifacts(edges_l, edges_r, best, winner, sub, params)


def classic_forward_batched(
    left: jnp.ndarray,
    right: jnp.ndarray,
    params: StereoParams,
    use_pallas: bool = False,
    subpixel: bool = False,
    interpret: bool = False,
) -> Dict[str, jnp.ndarray]:
    """Batched [B, H, W] pipeline, traceable inside an outer jit.  The
    fused kernel takes the batch as a grid dimension; everything else is
    vmapped."""
    if not use_pallas:
        return jax.vmap(
            functools.partial(classic_forward, params=params,
                              subpixel=subpixel)
        )(left, right)
    edges = jax.vmap(
        lambda x: find_edges(x, params.threshold, params.mode,
                             params.edge_rule)
    )
    edges_l, edges_r = edges(left), edges(right)
    best, winner, *sub = _match(edges_l, edges_r, params, True, subpixel,
                                interpret)
    res = {
        "edges-1": edges_l,
        "edges-2": edges_r,
        "score_best": best,
        "web-1": winner,
        **jax.vmap(functools.partial(classic_finish, params=params))(winner),
    }
    if sub:
        res["subpixel"] = sub[0]
    return res


def build_classic_pipeline(
    params: StereoParams,
    batched: bool = False,
    use_pallas: bool = False,
    subpixel: bool = False,
    interpret: bool = False,
) -> Callable[[jnp.ndarray, jnp.ndarray], Dict[str, jnp.ndarray]]:
    """Jitted pipeline for fixed params.  With ``batched=True`` the inputs
    carry a leading pairs axis [B, H, W] (the throughput mode of
    BASELINE.md config 4) — per-pair contour min/max.  ``subpixel`` adds
    the opt-in refined-disparity artifact (classic_forward)."""
    fn = classic_forward_batched if batched else classic_forward
    return jax.jit(
        functools.partial(fn, params=params, use_pallas=use_pallas,
                          subpixel=subpixel, interpret=interpret)
    )


def classic_finish(
    winner: jnp.ndarray,
    params: StereoParams,
) -> Dict[str, jnp.ndarray]:
    """The finishing phases alone — diffusion + contour from a
    post-argmax winner web [H, W].  The resume entry point: the
    reference's phase dumps double as restartable state
    (src/stereo.c:302-320); here the CLI's ``--resume`` feeds a saved
    ``web-1`` checkpoint back through exactly these phases, and the
    result is bit-identical to the uninterrupted run (the phases are
    pure integer functions of the winner web)."""
    web = fill_web_holes(winner, params.times)
    out, min_e, max_e = draw_contour(web, params.lines)
    return {
        "web-2": web,
        "output-0": out,
        "min_elevation": min_e,
        "max_elevation": max_e,
    }


def build_classic_finish_pipeline(
    params: StereoParams,
) -> Callable[[jnp.ndarray], Dict[str, jnp.ndarray]]:
    """Jitted ``classic_finish`` for fixed params (CLI ``--resume``)."""
    return jax.jit(functools.partial(classic_finish, params=params))


def build_classic_collect_pipeline(
    params: StereoParams,
) -> Callable[[jnp.ndarray, jnp.ndarray], Dict[str, jnp.ndarray]]:
    """Artifact-collecting variant: additionally returns the stacked
    per-shift planes (matches/score_all/scores, [D, H, W]) the reference
    dumps in debug builds — the cross-implementation golden surface."""

    def forward(left: jnp.ndarray, right: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        edges_l = find_edges(left, params.threshold, params.mode, params.edge_rule)
        edges_r = find_edges(right, params.threshold, params.mode, params.edge_rule)
        matches, sums, scores, best, winner = match_and_score_collect(
            edges_l, edges_r, params
        )
        return {
            **_artifacts(edges_l, edges_r, best, winner, [], params),
            "matches": matches,
            "score_all": sums,
            "scores": scores,
        }

    return jax.jit(forward)
