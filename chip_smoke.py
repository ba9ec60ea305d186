"""Chip smoke test: run the main paths once on the GPU at real size and
check what comes out.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards: the sharded paths only

One card, 1024x1024 frames, 64 disparities, synthetic scenes from a seed:

  classic  ``Matcher`` (ghost mode, exact edges) on a few batches; every
           integer artifact of one pair bit-equal to the NumPy oracle;
  sgm      ``ModernMatcher`` census + 4-direction SGM, and
  box      ``ModernMatcher()`` (SAD, box aggregation): integer outputs
           bit-equal, float outputs within 1e-4 of the same jitted
           function run on the host CPU;
  cli      ``python -m stereomatching.cli`` for each pipeline, in this
           process, bit-equal to the matchers on the same pair.

``--multi`` runs the sharded classic and sharded census SGM pipelines on
a (data=1, rows=4) mesh at 3840x2160 and compares each bit for bit with
the single-card route on the first card.

Prints the card's name and power limit, and per path the compile time,
``memory_analysis()`` and ``peak_bytes_in_use``.  Exits non-zero without
a result line when there is no GPU or any phase fails; otherwise the
last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SIZE = 1024
DISPARITIES = 64
MULTI_HW = (2160, 3840)
EXACT_MODERN = ("disparity", "disparity_right", "valid", "cost")
# The float planes: sums are taken in another order, and division lowers
# differently, on the GPU than on the CPU.
CLOSE_MODERN = ("subpixel", "filled")
CLASSIC_ORACLE = ("edges-1", "edges-2", "score_best", "web-1", "web-2",
                  "output-0")


def compare_exact(what, got, want, keys):
    """-> failure messages for keys whose arrays are not bit-equal."""
    bad = []
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.shape != w.shape:
            bad.append(f"{what}: {k} shape {g.shape} != {w.shape}")
        elif not np.array_equal(g, w):
            n = int(np.sum(g != w))
            bad.append(f"{what}: {k} differs at {n} of {g.size} entries")
    return bad


def compare_close(what, got, want, keys, atol):
    """-> failure messages for keys whose arrays differ by more than
    ``atol`` anywhere (or are not finite, or differ in shape)."""
    bad = []
    for k in keys:
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        if g.shape != w.shape:
            bad.append(f"{what}: {k} shape {g.shape} != {w.shape}")
        elif not np.all(np.isfinite(g)):
            bad.append(f"{what}: {k} has non-finite values")
        else:
            err = float(np.max(np.abs(g - w))) if g.size else 0.0
            if err > atol:
                bad.append(f"{what}: {k} max |diff| {err} > {atol}")
    return bad


def _pairs(n, h, w, seed):
    """n synthetic pairs -> (left u8 [n, h, w], right u8 [n, h, w])."""
    from stereomatching.utils.synthetic import blob_scene, slanted_plane

    ls, rs = [], []
    for i in range(n):
        if i % 2:
            left, right, _ = slanted_plane(h, w, seed=seed + i, d_max=40.0)
        else:
            left, right, _ = blob_scene(h, w, seed=seed + i, max_disparity=48,
                                        n_blobs=12)
        ls.append(left)
        rs.append(right)
    return np.stack(ls), np.stack(rs)


def _report_compile(name, jitted, *args):
    """Compile ``jitted`` for ``args``; print compile time and memory."""
    import jax

    specs = [jax.ShapeDtypeStruct(a.shape, a.dtype) for a in args]
    t0 = time.perf_counter()
    compiled = jitted.lower(*specs).compile()
    print(f"[{name}] compile {time.perf_counter() - t0:.2f} s; "
          f"memory_analysis: {compiled.memory_analysis()}")


def _peak(name):
    import jax

    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.local_devices()]
    print(f"[{name}] peak_bytes_in_use per card: {peaks}")


def _timed_calls(name, fn, batches):
    outs = []
    for i, (left, right) in enumerate(batches):
        t0 = time.perf_counter()
        outs.append(fn(left, right))
        dt = time.perf_counter() - t0
        print(f"[{name}] batch {i}: {left.shape[0]} pairs in {dt:.4f} s "
              "(host arrays in and out)")
    return outs


def phase_classic(failures):
    from stereomatching.config import BoundaryMode, StereoParams
    from stereomatching.oracle import pipeline as oracle
    from stereomatching.serving import Matcher
    from stereomatching.utils.imageio import to_brightness
    from stereomatching.utils.platform import implementation

    params = StereoParams(num_shifts=DISPARITIES, edge_rule="exact",
                          mode=BoundaryMode.GHOST)
    matcher = Matcher(params)
    print(f"[classic] match route: {implementation('classic_match')}")
    batches = [_pairs(4, SIZE, SIZE, seed=10 * i) for i in range(3)]
    lb = batches[0][0].astype(np.float32) / np.float32(256.0)
    _report_compile("classic", matcher._fn(lb.shape), lb, lb)
    outs = _timed_calls("classic", matcher, batches)
    _peak("classic")
    left, right = batches[0][0][0], batches[0][1][0]
    t0 = time.perf_counter()
    want = oracle.run_pipeline(to_brightness(left), to_brightness(right),
                               params)
    print(f"[classic] oracle on one pair: {time.perf_counter() - t0:.1f} s")
    got = {k: v[0] for k, v in outs[0].items()}
    failures += compare_exact("classic vs oracle", got, want, CLASSIC_ORACLE)
    return batches[0], outs[0]


def _modern_phase(name, params, n_pairs, failures):
    import jax

    from stereomatching.models.modern import build_modern_pipeline
    from stereomatching.serving import ModernMatcher

    matcher = ModernMatcher(params)
    batches = [_pairs(n_pairs, SIZE, SIZE, seed=100 + 10 * i)
               for i in range(2)]
    li = batches[0][0].astype(np.int32)
    _report_compile(name, matcher._fn(li.shape), li, li)
    outs = _timed_calls(name, matcher, batches)
    _peak(name)
    cpu = jax.devices("cpu")[0]
    left = jax.device_put(batches[0][0][0].astype(np.int32), cpu)
    right = jax.device_put(batches[0][1][0].astype(np.int32), cpu)
    t0 = time.perf_counter()
    want = jax.device_get(build_modern_pipeline(params)(left, right))
    print(f"[{name}] host CPU reference on one pair: "
          f"{time.perf_counter() - t0:.1f} s")
    got = {k: v[0] for k, v in outs[0].items()}
    failures += compare_exact(f"{name} vs cpu", got, want, EXACT_MODERN)
    failures += compare_close(f"{name} vs cpu", got, want, CLOSE_MODERN, 1e-4)
    return batches[0], outs[0]


def phase_cli(classic, sgm, failures):
    from stereomatching import cli
    from stereomatching.utils.artifacts import load_artifacts
    from stereomatching.utils.imageio import write_png_gray

    (cl, cr), c_out = classic
    (sl, sr), s_out = sgm
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for key, img in (("cl", cl[0]), ("cr", cr[0]), ("sl", sl[0]),
                         ("sr", sr[0])):
            paths[key] = os.path.join(tmp, f"{key}.png")
            write_png_gray(paths[key], img)
        ck = os.path.join(tmp, "classic.npz")
        t0 = time.perf_counter()
        rc = cli.main([paths["cl"], paths["cr"], "--mode", "ghost",
                       "--edge-rule", "exact", "--shifts", str(DISPARITIES),
                       "--no-writes", "--save-artifacts", ck])
        print(f"[cli classic] rc={rc} in {time.perf_counter() - t0:.1f} s")
        if rc != 0:
            failures.append(f"cli classic exited {rc}")
        else:
            failures += compare_exact(
                "cli classic vs Matcher", load_artifacts(ck),
                {k: v[0] for k, v in c_out.items()}, CLASSIC_ORACLE)
        t0 = time.perf_counter()
        rc = cli.main([paths["sl"], paths["sr"], "--pipeline", "modern",
                       "--cost", "census", "--aggregation", "sgm",
                       "--shifts", str(DISPARITIES), "--outdir", tmp])
        print(f"[cli sgm] rc={rc} in {time.perf_counter() - t0:.1f} s")
        if rc != 0:
            failures.append(f"cli sgm exited {rc}")
        else:
            with np.load(os.path.join(tmp, "disparity.npz")) as got:
                failures += compare_exact(
                    "cli sgm vs ModernMatcher", dict(got),
                    {k: v[0] for k, v in s_out.items()}, EXACT_MODERN)


def phase_multi(failures):
    import jax

    from stereomatching.config import BoundaryMode, ModernParams, StereoParams
    from stereomatching.parallel import make_mesh
    from stereomatching.serving import Matcher, ModernMatcher

    devices = jax.devices()[:4]
    mesh = make_mesh(data=1, rows=4, devices=devices)
    left, right = _pairs(1, *MULTI_HW, seed=7)
    cases = [
        ("sharded classic",
         StereoParams(num_shifts=DISPARITIES, edge_rule="exact",
                      mode=BoundaryMode.GHOST),
         Matcher, left.astype(np.float32) / np.float32(256.0),
         right.astype(np.float32) / np.float32(256.0)),
        ("sharded sgm",
         ModernParams(num_disparities=DISPARITIES, cost="census",
                      aggregation="sgm", sgm_directions=4),
         ModernMatcher, left.astype(np.int32), right.astype(np.int32)),
    ]
    for name, params, cls, lx, rx in cases:
        sharded = cls(params, tier="sharded", mesh=mesh)
        fn = sharded._fn(lx.shape)
        _report_compile(name, fn, lx, rx)
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(lx, rx))
        print(f"[{name}] first call {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(lx, rx))
        print(f"[{name}] second call {time.perf_counter() - t0:.4f} s")
        plane = next(v for v in out.values() if v.ndim == 3)
        for s in plane.addressable_shards:
            rows = s.index[1]
            print(f"[{name}] rows {rows.start}:{rows.stop} on device "
                  f"{s.device.id} ({s.device.device_kind})")
        got = {k: np.asarray(v) for k, v in jax.device_get(out).items()}
        single = cls(params)
        t0 = time.perf_counter()
        want = single(lx, rx)
        print(f"[{name}] single-card route {time.perf_counter() - t0:.2f} s")
        _peak(name)
        failures += compare_exact(f"{name} vs single card", got, want,
                                  sorted(want))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card sharded paths")
    args = p.parse_args(argv)

    from stereomatching.utils.platform import (
        card_info,
        ensure_compile_cache,
        require_gpu,
    )

    card = card_info()  # nvidia-smi in a child process, before JAX starts
    dev = require_gpu()
    want_count = 4 if args.multi else 1
    if dev["count"] < want_count:
        raise RuntimeError(f"need {want_count} GPUs, JAX sees {dev['count']}")
    ensure_compile_cache()
    print(f"device: {dev}")

    failures: list = []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            result = fn(*a, failures)
        except Exception:  # a failed phase fails the smoke, not the others
            traceback.print_exc()
            failures.append(f"{name}: raised")
            result = None
        print(f"[{name}] phase {time.perf_counter() - t0:.1f} s")
        return result

    if args.multi:
        run("multi", phase_multi)
    else:
        from stereomatching.config import ModernParams

        classic = run("classic", phase_classic)
        sgm = run("sgm", _modern_phase, "sgm",
                  ModernParams(num_disparities=DISPARITIES, cost="census",
                               aggregation="sgm", sgm_directions=4), 2)
        run("box", _modern_phase, "box", ModernParams(), 2)
        if classic is not None and sgm is not None:
            run("cli", phase_cli, classic, sgm)
    for f in failures:
        print(f"FAIL {f}", file=sys.stderr)
    if failures:
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
