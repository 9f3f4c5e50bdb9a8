"""Per-stage device-time breakdown of the batched extraction pipeline.

Times each pipeline stage as its own device-side fori_loop (ring of G
distinct inputs so nothing hoists; outputs folded into the carry so
nothing elides), matching bench.py's serving protocol. Prints one line
per stage: name, µs/frame, share of the summed pipeline; with --out it
also writes the breakdown as JSON.

Stages run through the same platform dispatch as the product path: the
CUDA growing kernel and the Triton merge kernel on a GPU.

Usage:  timeout 1800 python scripts/stage_bench.py [--repeats 200]
                [--batch 8] [--out chiprun_out/stage_bench.json]
"""

import argparse
import functools
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))

import jax
import jax.numpy as jnp
import numpy as np

from deplex_tpu import Config
from deplex_tpu.utils import DepthImage, read_intrinsics


def make_runner(stage_fn):
    """Jitted ring loop for one stage. Built ONCE per stage: rebuilding the
    jit wrapper per call would retrace + re-load the compiled program on
    every invocation, timing the trace/cache path instead of the device."""

    @functools.partial(jax.jit, static_argnames=("n",))
    def run(ring, n):
        G = jax.tree.leaves(ring)[0].shape[0]

        def body(i, acc):
            out = stage_fn(jax.tree.map(lambda a: a[i % G], ring))
            out = jax.lax.optimization_barrier(out)
            leaves = jax.tree.leaves(out)
            s = jnp.float32(0)
            for leaf in leaves:
                s = s + jnp.sum(leaf.astype(jnp.float32).ravel()[:8])
            return acc + s

        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    return run


def diff_time(run_n, repeats, batch):
    """(T(2n) - T(n)) / (n*batch), with the scalar result FETCHED inside
    each timed region, so the fixed dispatch and fetch cost cancels in the
    difference. Both program sizes are compiled during warmup (n is
    static)."""
    import numpy as np

    run_n(repeats)
    float(np.asarray(run_n(2 * repeats)))  # warm + compile both sizes

    def best_of(n, k=3):
        best = float("inf")
        for _ in range(k):
            t0 = time.perf_counter()
            float(np.asarray(run_n(n)))
            best = min(best, time.perf_counter() - t0)
        return best

    t1 = best_of(repeats)
    t2 = best_of(2 * repeats)
    return max(t2 - t1, 1e-12) / (repeats * batch) * 1e6


def time_stage(name, stage_fn, ring, repeats, batch):
    run = make_runner(stage_fn)
    return name, diff_time(lambda n: run(ring, n), repeats, batch)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ring", type=int, default=4)
    ap.add_argument("--out", default=None,
                    help="write the breakdown as a JSON artifact")
    args = ap.parse_args()

    img = DepthImage(str(ROOT / "data" / "tum" / "1341848230.910894.png"))
    K = jnp.asarray(
        read_intrinsics(str(ROOT / "data" / "configs" / "TUM_fr3_long_val.K")),
        jnp.float32)
    cfg = Config()
    B, G = args.batch, args.ring
    H, W = img.height, img.width

    rng = np.random.default_rng(0)
    base = np.asarray(img.data, np.uint16)
    frames = np.stack([
        np.roll(base, (rng.integers(0, 8), rng.integers(0, 8)), (0, 1))
        for _ in range(G * B)])
    depth_ring = jnp.asarray(frames.reshape(G, B, H, W))

    from deplex_tpu.ops.cellstats import compute_cell_stats
    from deplex_tpu.ops.growing import finalize_rounds, grow_rounds_device
    from deplex_tpu.ops.merge import merge_planes_device, rasterize_labels
    from deplex_tpu.parallel.batch import extract_depth_batch
    from deplex_tpu.pipeline import backproject_device

    P = min(cfg.patch_size, min(H, W))

    def cell_stats(d):
        return jax.vmap(lambda f: compute_cell_stats(
            backproject_device(f, K), H, W, cfg))(d)

    def grow(s):
        return jax.vmap(lambda f: grow_rounds_device(f, cfg))(s)

    # Precompute inter-stage inputs once (rings of real intermediates).
    stats_ring = jax.jit(jax.vmap(cell_stats))(depth_ring)
    rounds_ring = jax.jit(jax.vmap(grow))(stats_ring)
    lmseg_ring = jax.jit(jax.vmap(jax.vmap(
        lambda r: finalize_rounds(r, cfg))))(rounds_ring)
    labels_map_ring, segments_ring = lmseg_ring

    results = []
    results.append(time_stage(
        "cellstats (back-projection, moments, finalize)",
        cell_stats, depth_ring, args.repeats, B))
    results.append(time_stage(
        "grow_rounds (kernel on a GPU)", grow, stats_ring, args.repeats, B))
    results.append(time_stage(
        "finalize_rounds (fits+gates+labels)",
        jax.vmap(lambda r: finalize_rounds(r, cfg)),
        rounds_ring, args.repeats, B))

    def merge_raster(args2):
        lm, seg = args2
        ml, _ = jax.vmap(lambda l, s: merge_planes_device(l, s, cfg))(lm, seg)
        return jax.vmap(lambda l, m: rasterize_labels(l, m, H, W, P))(lm, ml)

    @functools.partial(jax.jit, static_argnames=("n",))
    def run_merge(lm_ring, seg_ring, n):
        Gn = lm_ring.shape[0]

        def body(i, acc):
            lm, seg = jax.tree.map(lambda a: a[i % Gn], (lm_ring, seg_ring))
            out = merge_raster((lm, seg))
            out = jax.lax.optimization_barrier(out)
            return acc + jnp.sum(out.astype(jnp.float32).ravel()[:8])

        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    results.append(("merge+rasterize", diff_time(
        lambda n: run_merge(labels_map_ring, segments_ring, n),
        args.repeats, B)))

    results.append(time_stage(
        "FULL pipeline (extract_depth_batch)",
        lambda d: extract_depth_batch(d, K, cfg),
        depth_ring, args.repeats, B))

    # Same FULL program over an IDENTICAL-frame ring — bench.py's input
    # (G x B copies of the one TUM frame). The rolled ring above is
    # heterogeneous, so its FULL row is the mixed-traffic number and this
    # row is the protocol-parity number.
    ident_ring = jnp.asarray(
        np.broadcast_to(base, (G, B) + base.shape).copy())
    results.append(time_stage(
        "FULL pipeline, identical-frame ring (bench.py input)",
        lambda d: extract_depth_batch(d, K, cfg),
        ident_ring, args.repeats, B))

    total = dict(results)["FULL pipeline (extract_depth_batch)"]
    print(f"\nB={B}, {args.repeats} iters, µs/frame (device loop):")
    for name, us in results:
        print(f"  {name:45s} {us:8.1f}  ({us / total * 100:5.1f}% of full)")

    if args.out:
        import json

        payload = {
            "protocol": ("device-side fori_loop ring per stage; "
                         "DIFFERENTIAL fetched timing (T(2n)-T(n))/n with "
                         "best-of-3 per size; stages through the platform "
                         "dispatch"),
            "platform": jax.devices()[0].platform,
            "device": jax.devices()[0].device_kind,
            "batch": B,
            "repeats": args.repeats,
            "us_per_frame": {name: round(us, 2) for name, us in results},
            "frames_per_s_per_device": round(1e6 / total, 1),
        }
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=2)
            fh.write("\n")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
