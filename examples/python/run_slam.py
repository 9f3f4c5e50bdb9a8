"""Plane-SLAM demo: track camera poses through a depth sequence.

Runs the full new-capability stack (extraction -> association -> odometry ->
mapping; deplex_tpu/slam/). With --synthetic (default, since the repo ships
only single frames per dataset) a camera trajectory is simulated inside a
textured box room and the estimated trajectory is compared against ground
truth (ATE). Point it at a directory of depth PNGs for real data.
"""

import argparse
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]

import sys

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def synthetic_sequence(n_frames, H, W, K, rng):
    """Depth frames of a 4m x 4m x 3m box room from a moving camera."""
    import jax
    import jax.numpy as jnp

    from deplex_tpu.slam.lie import so3_exp

    fx, cx = K[0, 0], K[0, 2]
    fy, cy = K[1, 1], K[1, 2]
    u = (np.arange(W, dtype=np.float32) - cx) / fx
    v = (np.arange(H, dtype=np.float32) - cy) / fy
    rays = np.stack([np.tile(u, (H, 1)), np.tile(v[:, None], (1, W)),
                     np.ones((H, W), np.float32)], axis=-1)  # camera rays, z=1

    # Room: 6 planes n.x + d = 0 (mm), camera starts at the center.
    planes_n = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                         [0, 0, 1], [0, 0, -1]], np.float32)
    planes_d = np.array([2000, 2000, 1500, 1500, 2000, 4000], np.float32)

    frames, poses = [], []
    # Look toward a room corner so three walls are visible at moderate
    # angles (frontal-only views leave the pose unobservable).
    from deplex_tpu.slam.lie import so3_exp as _exp
    R_wc = np.asarray(_exp(jnp.asarray([-0.5, 0.5, 0.0], jnp.float32)))
    t_wc = np.zeros(3, np.float32)
    for i in range(n_frames):
        # Ground-truth camera-from-world pose.
        R_cw = R_wc.T
        t_cw = -R_cw @ t_wc
        # Ray-cast: for each pixel, min positive depth over planes.
        dirs = rays @ R_wc.T                      # world-frame ray dirs
        denom = dirs @ planes_n.T                 # (H, W, 6)
        numer = -(t_wc @ planes_n.T + planes_d)   # (6,)
        z = numer[None, None, :] / np.where(np.abs(denom) > 1e-6, denom, 1e-6)
        z = np.where((denom < -1e-6) & (z > 100), z, np.inf)
        depth = z.min(axis=-1)
        depth = np.where(np.isfinite(depth), depth, 0.0)
        frames.append(depth.astype(np.float32))
        poses.append((R_cw, t_cw))
        # Move: slow arc.
        R_wc = np.asarray(so3_exp(jnp.asarray(rng.normal(size=3) * 0.004,
                                              jnp.float32))) @ R_wc
        t_wc = t_wc + R_wc @ np.array([15.0, 5.0, 25.0], np.float32)
    return frames, poses


def run_dataset(args):
    """Full stack on a directory of depth PNGs: native threaded loader ->
    tracking -> pose-graph optimization -> plane-landmark BA, with ATE vs
    the ground-truth trajectory (trajectory_gt.npz, camera-from-world) when
    present. Generate a ground-truthed sequence from the shipped TUM frame
    with scripts/make_sequence.py."""
    import json

    import jax.numpy as jnp

    from deplex_tpu import Config
    from deplex_tpu.native import SequenceLoader
    from deplex_tpu.pipeline import backproject_device
    from deplex_tpu.slam import PlaneSlam
    from deplex_tpu.utils import DepthImage, read_intrinsics

    root = pathlib.Path(args.dataset)
    paths = sorted(root.glob("*.png"))
    if args.frames > 0:
        paths = paths[:args.frames]
    if not paths:
        raise SystemExit(f"no *.png frames in {root}")
    probe = DepthImage(str(paths[0]))
    H, W = probe.height, probe.width
    K = np.asarray(read_intrinsics(args.intrinsics), np.float32)
    cfg = Config.from_ini(args.config) if args.config else Config()

    slam = PlaneSlam(H, W, cfg, max_landmarks=args.max_landmarks,
                     odom_iterations=10, window=args.window or None)
    loader = SequenceLoader([str(p) for p in paths], W, H)
    n = 0
    for depth in loader:
        pts = backproject_device(jnp.asarray(depth), jnp.asarray(K))
        res = slam.process_frame(pts)
        if n % 10 == 0:
            print(f"frame {n:4d}: matched={int(res.num_matched):2d} "
                  f"new={int(res.num_new):2d}")
        n += 1

    gt_file = root / "trajectory_gt.npz"

    def ate(traj):
        if not gt_file.exists():
            return None
        g = np.load(gt_file)
        errs = [np.linalg.norm(-R.T @ t - (-g["R"][i].T @ g["t"][i]))
                for i, (R, t) in enumerate(traj)]
        return round(float(np.sqrt(np.mean(np.square(errs)))), 3)

    # Each backend stage is evaluated INDEPENDENTLY from the tracked state
    # (chaining them double-counts corrections: the pose graph re-expresses
    # the map-anchored trajectory as relative edges, and BA re-anchors to
    # the landmark map — applying BA after the graph starts it from poses
    # inconsistent with the map it optimizes against).
    traj_len = None
    if gt_file.exists():
        g = np.load(gt_file)
        centers = np.einsum("kij,kj->ki", g["R"].transpose(0, 2, 1), -g["t"])
        traj_len = round(float(np.linalg.norm(np.diff(centers, axis=0),
                                              axis=1).sum()), 1)
    report = {"dataset": str(root), "frames": n,
              "protocol": "run_slam.py --dataset: native SequenceLoader -> "
                          "PlaneSlam tracking; BA (odometry + constant-"
                          "velocity motion priors, slam/ba.py) and pose-"
                          "graph (info-weighted edges + tracking priors + "
                          "cv priors, slam/pose_graph.py) each applied to "
                          "the tracked trajectory independently; sequence "
                          "from scripts/make_sequence.py (warped real "
                          "frame, exact ground truth)",
              "trajectory_length_mm": traj_len,
              "window": args.window or None,
              "args": {"frames": args.frames, "config": args.config,
                       "intrinsics": args.intrinsics,
                       "max_landmarks": args.max_landmarks},
              "sequence_manifest": (json.loads((root / "manifest.json").read_text())
                                    if (root / "manifest.json").exists() else None),
              "landmarks": int(np.asarray(slam.map.count)),
              "ate_rmse_mm": {"tracking": ate(slam.trajectory)}}
    tracked = list(slam.trajectory)
    slam.refine(iterations=10)
    report["ate_rmse_mm"]["ba"] = ate(slam.trajectory)
    slam.trajectory = tracked
    try:
        slam.optimize_trajectory(min_shared=args.min_shared)
        report["ate_rmse_mm"]["pose_graph"] = ate(slam.trajectory)
    except ValueError as e:
        report["pose_graph_skipped"] = str(e)
    print(json.dumps(report))
    if args.report:
        out = pathlib.Path(args.report)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2) + "\n")
    return report


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=20)
    parser.add_argument("--size", default="120x160",
                        help="HxW for the synthetic sequence")
    parser.add_argument("--dataset", default=None,
                        help="directory of depth PNGs (e.g. from "
                             "scripts/make_sequence.py); default: synthetic")
    parser.add_argument("--intrinsics",
                        default=str(ROOT / "data/configs/TUM_fr3_long_val.K"))
    parser.add_argument("--config", default=None, help="algorithm .ini")
    parser.add_argument("--max-landmarks", type=int, default=64)
    parser.add_argument("--window", type=int, default=0,
                        help="sliding keyframe window for the BA/pose-graph "
                             "backends (0 = unbounded); bounds backend "
                             "memory/cost at O(window) on long sequences")
    parser.add_argument("--min-shared", type=int, default=3)
    parser.add_argument("--report", default=None, help="write ATE report JSON")
    parser.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                        help="pin the JAX backend (the committed ATE "
                             "artifacts are generated with --platform cpu "
                             "for bit-reproducibility)")
    args = parser.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms",
                          "cuda" if args.platform == "gpu" else args.platform)
    if args.dataset:
        run_dataset(args)
        return

    from deplex_tpu import Config
    from deplex_tpu.pipeline import backproject_device
    from deplex_tpu.slam import PlaneSlam

    H, W = (int(x) for x in args.size.split("x"))
    K = np.array([[160.0, 0, W / 2 - 0.5], [0, 160.0, H / 2 - 0.5],
                  [0, 0, 1]], np.float32)
    rng = np.random.default_rng(0)
    frames, gt = synthetic_sequence(args.frames, H, W, K, rng)

    cfg = Config(patch_size=8, max_planes=16, max_region_growing_rounds=32,
                 min_region_growing_cells_activated=3,
                 min_region_growing_candidate_size=3,
                 # Synthetic walls at oblique view: adjacent-pixel depth
                 # steps legitimately exceed the TUM-tuned 160mm default.
                 depth_discontinuity_threshold=600.0,
                 min_cos_angle_merge=0.97)
    slam = PlaneSlam(H, W, cfg, max_landmarks=32)

    import jax.numpy as jnp
    errs = []
    for i, depth in enumerate(frames):
        pts = backproject_device(jnp.asarray(depth), jnp.asarray(K))
        res = slam.process_frame(pts)
        R_est, t_est = np.asarray(res.R), np.asarray(res.t)
        R_gt, t_gt = gt[i]
        # ATE on camera centers: c = -R^T t.
        c_est = -R_est.T @ t_est
        c_gt = -R_gt.T @ t_gt
        errs.append(np.linalg.norm(c_est - c_gt))
        print(f"frame {i:3d}: matched={int(res.num_matched):2d} "
              f"new={int(res.num_new):2d} ate={errs[-1]:8.2f}mm")
    ate = float(np.sqrt(np.mean(np.square(errs))))
    print(f"RMS ATE (odometry): {ate:.2f} mm over {len(frames)} frames "
          f"({int(np.asarray(slam.map.count))} landmarks)")

    # Global refinement: windowed plane-landmark BA over all keyframes.
    slam.refine(iterations=10)
    errs_ba = []
    for i, (R_est, t_est) in enumerate(slam.trajectory):
        R_gt, t_gt = gt[i]
        errs_ba.append(np.linalg.norm(-R_est.T @ t_est - (-R_gt.T @ t_gt)))
    ate_ba = float(np.sqrt(np.mean(np.square(errs_ba))))
    print(f"RMS ATE (after BA): {ate_ba:.2f} mm")


if __name__ == "__main__":
    main()
