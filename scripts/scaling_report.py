"""Multi-device scaling report: frames/s at each mesh size.

Runs the batched extraction pipeline with the frame axis sharded over 1, 2,
4, ... N devices and reports throughput + scaling efficiency (BASELINE.md's
1 device / 1 host / N hosts protocol). The serving loop runs under
shard_map, so each device extracts its own frames (XLA cannot partition the
growing kernel's custom call). On several hosts, launch one process per
host with jax.distributed configured (deplex_tpu.parallel.distributed.
initialize); on a single device this degenerates to the 1-device row.
Simulate a mesh on CPU with:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/scaling_report.py --frames-per-device 4 --repeats 5
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import json
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames-per-device", type=int, default=8)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--image", default=str(ROOT / "data/tum/1341848230.910894.png"))
    parser.add_argument("--intrinsics", default=str(ROOT / "data/configs/TUM_fr3_long_val.K"))
    parser.add_argument("--out", default=None,
                        help="write the JSON report artifact here")
    args = parser.parse_args()

    import jax

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from deplex_tpu import Config
    from deplex_tpu.parallel.distributed import initialize
    from deplex_tpu.utils import DepthImage, read_intrinsics

    initialize()
    devices = np.array(jax.devices())
    img = DepthImage(args.image)
    K = read_intrinsics(args.intrinsics)
    cfg = Config()

    sizes = []
    n = 1
    while n <= devices.size:
        sizes.append(n)
        n *= 2
    if sizes[-1] != devices.size:
        sizes.append(devices.size)

    import functools

    import jax.numpy as jnp

    from deplex_tpu.parallel.batch import extract_depth_batch

    Kd = jax.device_put(np.asarray(K, np.float32))

    # Device-side serving loop (bench.py protocol): n_iters batched
    # extractions inside one dispatch over a RING of distinct input buffers
    # (a loop-invariant input would let XLA hoist the extraction out of the
    # loop), per-iteration summaries folded into the carry so nothing can be
    # elided, ONE final summary fetch.
    G = 4  # ring depth

    def serve_local(ring, intrinsics, n_iters):
        def body(i, carry):
            labels = extract_depth_batch(ring[i % G], intrinsics, cfg)
            labels = jax.lax.optimization_barrier(labels)
            return carry + jnp.max(labels, axis=1)

        return jax.lax.fori_loop(0, n_iters, body,
                                 jnp.zeros(ring.shape[1], jnp.int32))

    base_fps = None
    rows = []
    for nd in sizes:
        mesh = Mesh(devices[:nd], axis_names=("data",))

        @functools.partial(jax.jit, static_argnames=("n_iters",))
        def serve(ring, intrinsics, n_iters, mesh=mesh):
            return jax.shard_map(
                functools.partial(serve_local, n_iters=n_iters), mesh=mesh,
                in_specs=(P(None, "data", None, None), P()),
                out_specs=P("data"), check_vma=False)(ring, intrinsics)

        B = args.frames_per_device * nd
        ring_np = np.broadcast_to(img.data, (G, B) + img.data.shape).copy()
        sharding = NamedSharding(mesh, P(None, "data", None, None))
        ring = jax.device_put(ring_np, sharding)
        counts = np.asarray(serve(ring, Kd, n_iters=args.repeats))  # warm
        assert (counts > 0).all()
        np.asarray(serve(ring, Kd, n_iters=2 * args.repeats))  # compile 2n

        # Differential fetched timing (bench.py protocol): the fetch forces
        # completion and the fixed dispatch + fetch cost cancels in
        # T(2n) - T(n).
        def timed(n):
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                np.asarray(serve(ring, Kd, n_iters=n))
                best = min(best, time.perf_counter() - t0)
            return best

        dt = max(timed(2 * args.repeats) - timed(args.repeats), 1e-9)
        fps = B * args.repeats / dt
        if base_fps is None:
            base_fps = fps
        eff = fps / (base_fps * nd)
        rows.append({"devices": nd, "batch": B, "frames_per_sec": round(fps, 1),
                     "scaling_efficiency": round(eff, 3)})
        print(json.dumps(rows[-1]))

    report = {
        "backend": jax.default_backend(),
        "device": str(devices.flat[0]),
        "processes": jax.process_count(),
        "frames_per_device": args.frames_per_device,
        "repeats": args.repeats,
        "rows": rows,
    }
    if jax.default_backend() == "cpu":
        report["caveat"] = (
            "NOT a hardware-scaling claim: the N 'devices' are "
            "xla_force_host_platform_device_count fakes sharing ONE CPU "
            "socket, so adding devices adds zero compute and the "
            "efficiency column measures host contention plus the fixed "
            "per-device dispatch overhead. What the artifact validates is "
            "STRUCTURAL: the sharded serving loop compiles and runs over "
            "the 'data' mesh with per-device-correct results. The "
            "extraction path contains ZERO collectives (each device "
            "computes its own frame shard end-to-end; scaling is pure data "
            "placement); real scaling is measured only on real devices.")
    if jax.process_index() == 0:
        print(json.dumps({"report": rows}))
        if args.out:
            out = pathlib.Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=2) + "\n")


if __name__ == "__main__":
    main()
