"""Streaming-sequence plane extraction example.

Parity with the reference sequence runner
(/root/reference/examples/process_sequence.cpp:10-55): process every *.png in
a directory in sorted order and report min/max/mean per-frame latency
including image load — plus the batched mode the reference lacks
(frames grouped into fixed batches and vmapped, amortizing dispatch).
"""

import argparse
import pathlib
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]

import sys

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_dir", nargs="?", default=str(ROOT / "data/tum"))
    parser.add_argument("max_frames", nargs="?", type=int, default=0)
    parser.add_argument("--config", default=str(ROOT / "data/configs/TUM_fr3_long_val.ini"))
    parser.add_argument("--intrinsics", default=str(ROOT / "data/configs/TUM_fr3_long_val.K"))
    parser.add_argument("--batch", type=int, default=0,
                        help="frames per dispatch (0 = streaming, like the reference)")
    args = parser.parse_args()

    from deplex_tpu import Config, PlaneExtractor
    from deplex_tpu.parallel.batch import BatchPlaneExtractor
    from deplex_tpu.utils import DepthImage, read_intrinsics

    config = Config.from_ini(args.config)
    K = read_intrinsics(args.intrinsics)
    paths = sorted(pathlib.Path(args.dataset_dir).glob("*.png"))
    if args.max_frames:
        paths = paths[: args.max_frames]
    if not paths:
        raise SystemExit(f"no *.png frames in {args.dataset_dir}")

    first = DepthImage(str(paths[0]))
    H, W = first.height, first.width

    latencies = []
    if args.batch <= 1:
        algorithm = PlaneExtractor(H, W, config)
        try:
            # Native threaded loader: PNG decode overlaps device compute.
            from deplex_tpu.native import SequenceLoader

            loader = SequenceLoader([str(p) for p in paths], W, H)
        except Exception:
            loader = None
        if loader is not None:
            algorithm.process_depth(first.data, K)  # compile
            while True:
                t0 = time.perf_counter()
                depth = loader.next_depth()
                if depth is None:
                    break
                labels = algorithm.process_depth(depth, K)
                latencies.append(time.perf_counter() - t0)
            loader.close()
        else:
            algorithm.process(first.transform_to_pcd(K))  # compile
            image = DepthImage()
            for p in paths:
                t0 = time.perf_counter()
                image.reset(str(p))
                labels = algorithm.process(image.transform_to_pcd(K))
                latencies.append(time.perf_counter() - t0)
    else:
        B = args.batch
        algorithm = BatchPlaneExtractor(H, W, config)
        probe = first.transform_to_pcd(K)
        algorithm.process(np.broadcast_to(probe, (B,) + probe.shape))  # compile
        image = DepthImage()
        for i in range(0, len(paths), B):
            chunk = paths[i : i + B]
            t0 = time.perf_counter()
            clouds = []
            for p in chunk:
                image.reset(str(p))
                clouds.append(image.transform_to_pcd(K))
            while len(clouds) < B:
                clouds.append(clouds[-1])
            algorithm.process(np.stack(clouds))
            dt = (time.perf_counter() - t0) / len(chunk)
            latencies.extend([dt] * len(chunk))

    lat = np.asarray(latencies) * 1e6
    print(f"Processed frames: {len(lat)}")
    print(f"Min elapsed time (mks): {lat.min():.0f}")
    print(f"Max elapsed time (mks): {lat.max():.0f}")
    print(f"Mean elapsed time (mks): {lat.mean():.0f}")
    print(f"FPS: {1e6 / lat.mean():.1f}")


if __name__ == "__main__":
    main()
