"""Measure the TP-analog spatial-sharding crossover (DESIGN.md §5).

parallel/spatial.py shards ONE frame's cell grid over a mesh axis; the
docstring claims it "wins only when one frame's compute dominates". This
script replaces that claim with numbers:

  * --mode mesh (default): 1280x720 fine-grid frame on the simulated
    N-device CPU mesh — extract_planes_spatial at shard counts 1/2/4/8 vs
    the single-device pipeline on the same host. Fake devices share one
    socket, so the sweep measures the PER-STEP OVERHEAD the sharding adds
    (halo exchange, psum'd fixpoint rounds, padding), not hardware
    speedup — which is exactly the quantity the crossover argument needs:
    spatial sharding pays off only when per-chip compute saved exceeds
    this overhead.
  * --mode gpu: run on the GPUs — single-device pipeline vs the spatial
    path on meshes of 1 and, where present, 2 and 4 cards, at 640x480 and
    1280x720. Fails without a GPU.

Writes one JSON artifact with per-config µs/frame.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/spatial_bench.py --mode mesh --out data/golden/spatial_crossover.json
  python scripts/spatial_bench.py --mode gpu --out chiprun_out/spatial_gpu.json
"""

import argparse
import functools
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))


def synthetic_cloud(H, W, seed=0):
    import numpy as np

    fx = fy = 1000.0
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    u = (np.tile(np.arange(W, dtype=np.float32), (H, 1)) - cx) / fx
    v = (np.tile(np.arange(H, dtype=np.float32)[:, None], (1, W)) - cy) / fy
    z_floor = np.where(v > 0.15, 1000.0 / np.maximum(v, 0.15), np.inf)
    z_wall = np.full((H, W), 4000.0, np.float32)
    z_side = np.where(u > 0.15, 1500.0 / np.maximum(u, 0.15), np.inf)
    z = np.minimum(np.minimum(z_floor, z_wall), z_side).astype(np.float32)
    rng = np.random.default_rng(seed)
    z += rng.normal(scale=2.0, size=z.shape).astype(np.float32)
    return np.stack([u * z, v * z, z], axis=-1).reshape(-1, 3)


def time_fn(fn, pts, repeats):
    import jax
    import jax.numpy as jnp
    import numpy as np

    @functools.partial(jax.jit, static_argnames=("n",))
    def run(p, n):
        def body(i, acc):
            out = fn(p + acc * 0)   # serialize: input depends on carry
            out = jax.lax.optimization_barrier(out)
            return acc + jnp.max(out).astype(jnp.float32)

        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    # Differential fetched timing (bench.py protocol): np.asarray forces
    # completion, and the fixed dispatch + fetch cost cancels in
    # T(2n) - T(n). AGG records the aggregation so artifacts are only
    # compared within the same protocol.
    float(np.asarray(run(pts, repeats)))
    float(np.asarray(run(pts, 2 * repeats)))   # compile both sizes

    def med(n):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            float(np.asarray(run(pts, n)))
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    return max(med(2 * repeats) - med(repeats), 1e-12) / repeats * 1e6


AGG = "diff-median5"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["mesh", "gpu"], default="mesh")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    if args.mode == "mesh":
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit("spatial_bench.py --mode gpu: no GPU found")

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from deplex_tpu import Config
    from deplex_tpu.parallel.spatial import extract_planes_spatial
    from deplex_tpu.pipeline import extract_planes

    results = {"mode": args.mode, "device": str(jax.devices()[0]),
               "repeats": args.repeats, "agg": AGG, "configs": []}

    shapes = ([(720, 1280, Config(patch_size=8, max_planes=32))]
              if args.mode == "mesh"
              else [(480, 640, Config()),
                    (720, 1280, Config(patch_size=8, max_planes=32))])

    for H, W, cfg in shapes:
        pts = jnp.asarray(synthetic_cloud(H, W))
        single = time_fn(
            lambda p: extract_planes(p, image_height=H, image_width=W,
                                     config=cfg), pts, args.repeats)
        row = {"shape": f"{H}x{W}", "patch": cfg.patch_size,
               "single_device_us": round(single, 1), "spatial_us": {}}
        ndevs = [1, 2, 4, 8] if args.mode == "mesh" else [1, 2, 4]
        for nd in ndevs:
            if nd > len(jax.devices()):
                continue
            mesh = Mesh(np.array(jax.devices()[:nd]), axis_names=("space",))
            us = time_fn(
                lambda p: extract_planes_spatial(
                    p, image_height=H, image_width=W, config=cfg, mesh=mesh),
                pts, args.repeats)
            row["spatial_us"][str(nd)] = round(us, 1)
        results["configs"].append(row)
        print(row)

    base = results["configs"][0]
    over = {k: round(v / base["single_device_us"], 2)
            for k, v in base["spatial_us"].items()}
    results["conclusion"] = (
        "spatial/single ratios per shard count: " + json.dumps(over) + ". "
        "The spatial path adds halo-exchange + globally-synchronized "
        "fixpoint rounds; it can only win when a single frame's compute "
        "exceeds this overhead times the shard count — i.e. when no frame "
        "batch exists to data-parallelize. With batching available, "
        "data parallelism dominates at every measured size.")
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=2) + "\n")
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
