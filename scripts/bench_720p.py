"""720p stress-config throughput (BASELINE.json config 4) on one GPU.

Same device-resident serving protocol as bench.py (ring of distinct depth
buffers, full depth->labels pipeline per iteration, summaries folded into
the carry and validated), at 1280x720 with the fine cell grid
(patch 8 -> 90x160 cells).

Scene: the synthetic floor+walls room of tests/test_stress.py rendered to
uint16 depth (the repo ships no real 720p frame); per-frame validation is
the plane count + labeled coverage of that scene.

Writes the JSON line to --out as well when given.
"""

import argparse
import functools
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))

import jax
import jax.numpy as jnp
import numpy as np

from deplex_tpu import Config


def stress_depth(H=720, W=1280):
    """uint16 depth of the test_stress floor + back wall + side wall."""
    fx = fy = 1000.0
    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    u = (np.tile(np.arange(W, dtype=np.float32), (H, 1)) - cx) / fx
    v = (np.tile(np.arange(H, dtype=np.float32)[:, None], (1, W)) - cy) / fy
    z_floor = np.where(v > 0.15, 1000.0 / np.maximum(v, 0.15), np.inf)
    z_wall = np.full((H, W), 4000.0, np.float32)
    z_side = np.where(u > 0.15, 1500.0 / np.maximum(u, 0.15), np.inf)
    z = np.minimum(np.minimum(z_floor, z_wall), z_side).astype(np.float32)
    rng = np.random.default_rng(0)
    z += rng.normal(scale=2.0, size=z.shape).astype(np.float32)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return np.clip(np.round(z), 0, 65535).astype(np.uint16), K


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ring", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=256,
                    help="total frames per timed dispatch")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from deplex_tpu.parallel.batch import extract_depth_batch

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_720p.py: no GPU found; nothing was measured")

    H, W = 720, 1280
    B, G = args.batch, args.ring
    cfg = Config(patch_size=8, max_planes=32)
    depth, K = stress_depth(H, W)

    rng = np.random.default_rng(1)
    frames = np.stack([
        np.roll(depth, (int(rng.integers(0, 8)), int(rng.integers(0, 8))),
                (0, 1)) for _ in range(G * B)])
    ring = jax.device_put(jnp.asarray(frames.reshape(G, B, H, W)))
    Kd = jax.device_put(jnp.asarray(K))
    jax.block_until_ready((ring, Kd))

    @functools.partial(jax.jit, static_argnames=("n_iters",))
    def serve(ring_buf, intrinsics, n_iters):
        def body(i, carry):
            counts, labeled = carry
            labels = extract_depth_batch(ring_buf[i % G], intrinsics, cfg)
            labels = jax.lax.optimization_barrier(labels)
            counts = counts.at[i].set(jnp.max(labels, axis=1))
            labeled = labeled.at[i].set(jnp.sum(labels > 0, axis=1))
            return counts, labeled

        init = (jnp.zeros((n_iters, B), jnp.int32),
                jnp.zeros((n_iters, B), jnp.int32))
        return jax.lax.fori_loop(0, n_iters, body, init)

    n_iters = max(args.repeats // B, 1)
    counts0, labeled0 = serve(ring, Kd, n_iters=n_iters)
    c = np.asarray(counts0).reshape(-1)
    lb = np.asarray(labeled0).reshape(-1)
    assert (2 <= c).all() and (c <= 16).all(), c[:8]     # test_stress bound
    assert (lb > 0.5 * H * W).all(), lb[:8]              # coverage bound
    np.asarray(serve(ring, Kd, n_iters=2 * n_iters)[0])  # compile 2n

    # Differential fetched timing (bench.py protocol): the fixed dispatch
    # and fetch cost cancels in T(2n) - T(n); np.asarray forces completion.
    def timed(n):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            cc, ll = serve(ring, Kd, n_iters=n)
            np.asarray(cc), np.asarray(ll)
            best = min(best, time.perf_counter() - t0)
        return best

    dt = max(timed(2 * n_iters) - timed(n_iters), 1e-9)
    fps = n_iters * B / dt

    out = {
        "metric": "stress_720p_frames_per_sec_per_gpu",
        "value": round(fps, 1),
        "unit": "frames/s",
        "us_per_frame": round(1e6 / fps, 1),
        "batch": B,
        "config": "patch 8, max_planes 32 (BASELINE.json config 4)",
        "scene": "synthetic floor+walls room (tests/test_stress.py), "
                 "rolled ring of distinct buffers",
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(out))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=2) + "\n")


if __name__ == "__main__":
    main()
