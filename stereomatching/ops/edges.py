"""Edge extraction (reference ``find_all_edges``, src/stereo.c:16-84).

Four directional 3-pixel-strip mean comparisons with an adaptive threshold,
OR-combined into a binary edge map.  XLA fuses the whole thing into one
elementwise pass over the 3x3 neighborhood — there is no reuse to exploit
beyond that, so no Pallas kernel is needed for this phase.
"""

from __future__ import annotations

import jax.numpy as jnp

from stereomatching.config import BoundaryMode, GHOST_BRIGHTNESS_FILL

# (side_a offsets, side_b offsets) as (dx, dy), C summation order preserved
# (src/stereo.c:16-70).
EDGE_OPERATORS = (
    (((-1, -1), (-1, 0), (-1, 1)), ((1, -1), (1, 0), (1, 1))),  # left_right
    (((-1, -1), (0, -1), (1, -1)), ((-1, 1), (0, 1), (1, 1))),  # top_bottom
    (((-1, -1), (0, -1), (-1, 0)), ((1, 0), (0, 1), (1, 1))),  # upleft_downright
    (((-1, 1), (0, 1), (-1, 0)), ((0, -1), (1, -1), (1, 0))),  # downleft_upright
)


def pad_brightness(brightness: jnp.ndarray, mode: BoundaryMode) -> jnp.ndarray:
    """1-px pad: modulo wrap (src/util.h:42-47) or the ghost programs'
    128.0-filled halo (src/stereo-ghost.c:384-385)."""
    if mode == BoundaryMode.WRAP:
        return jnp.pad(brightness, 1, mode="wrap")
    return jnp.pad(
        brightness,
        1,
        mode="constant",
        constant_values=jnp.asarray(GHOST_BRIGHTNESS_FILL, brightness.dtype),
    )


def find_edges(
    brightness: jnp.ndarray,
    threshold: float,
    mode: BoundaryMode = BoundaryMode.WRAP,
    rule: str = "reference",
) -> jnp.ndarray:
    """Binary edge map, int32 {0,1}, shape [H, W].

    A pixel is an edge if any directional operator's side-mean difference
    exceeds clamp(threshold * overall_mean, 0, 1) (src/stereo.c:26-27).

    ``rule="reference"`` runs float ops in ``brightness.dtype`` with the C
    operation order (backend division rounding may flip knife-edge ties);
    ``rule="exact"`` runs the rescaled integer predicate
    2*|ka-kb| > min(f32(threshold)*(ka+kb), 1536), bit-deterministic on
    every backend (see config.StereoParams.edge_rule).
    """
    p = pad_brightness(brightness, mode)
    return find_edges_padded(p, threshold, rule)


def find_edges_padded(
    p: jnp.ndarray, threshold: float, rule: str = "reference"
) -> jnp.ndarray:
    """Edge map from an already 1-px-padded brightness array.

    Split out so the sharded pipeline can pad via halo exchange
    (parallel/halo.py) and reuse the same arithmetic.
    """
    if rule == "exact":
        return _find_edges_padded_exact(p, threshold)
    h, w = p.shape[0] - 2, p.shape[1] - 2
    dt = p.dtype
    thr = jnp.asarray(threshold, dt)
    three = jnp.asarray(3.0, dt)
    two = jnp.asarray(2.0, dt)
    zero = jnp.asarray(0.0, dt)
    one = jnp.asarray(1.0, dt)

    def nb(dx: int, dy: int) -> jnp.ndarray:
        return p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    edges = jnp.zeros((h, w), dtype=bool)
    for (a0, a1, a2), (b0, b1, b2) in EDGE_OPERATORS:
        avg_a = (nb(*a0) + nb(*a1) + nb(*a2)) / three
        avg_b = (nb(*b0) + nb(*b1) + nb(*b2)) / three
        overall = (avg_a + avg_b) / two
        bound = jnp.clip(thr * overall, zero, one)
        edges = edges | (jnp.abs(avg_a - avg_b) > bound)
    return edges.astype(jnp.int32)


def _find_edges_padded_exact(p: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """The 'exact' rule: integer 3-pixel sums of brightness*256, decision
    2*|ka-kb| > min(f32(threshold)*(ka+kb), 1536).  ka+kb < 2^18 is exact
    in f32; the single IEEE multiply rounds identically on every backend.
    Derivation in oracle/pipeline.py:_find_edges_exact."""
    h, w = p.shape[0] - 2, p.shape[1] - 2
    k = jnp.round(p * jnp.asarray(256.0, p.dtype)).astype(jnp.int32)

    def nb(dx: int, dy: int) -> jnp.ndarray:
        return k[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    t32 = jnp.float32(threshold)
    edges = jnp.zeros((h, w), dtype=bool)
    for (a0, a1, a2), (b0, b1, b2) in EDGE_OPERATORS:
        ka = nb(*a0) + nb(*a1) + nb(*a2)
        kb = nb(*b0) + nb(*b1) + nb(*b2)
        lhs = (2 * jnp.abs(ka - kb)).astype(jnp.float32)
        rhs = jnp.minimum(t32 * (ka + kb).astype(jnp.float32), jnp.float32(1536.0))
        edges = edges | (lhs > rhs)
    return edges.astype(jnp.int32)
