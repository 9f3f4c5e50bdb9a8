"""Frontend integration: tracking + BA refine + pose-graph on a synthetic room."""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "examples" / "python"))


@pytest.fixture(scope="module")
def tracked_slam():
    import jax.numpy as jnp
    from run_slam import synthetic_sequence

    from deplex_tpu import Config
    from deplex_tpu.pipeline import backproject_device
    from deplex_tpu.slam import PlaneSlam

    H, W = 120, 160
    K = np.array([[160.0, 0, W / 2 - 0.5], [0, 160.0, H / 2 - 0.5],
                  [0, 0, 1]], np.float32)
    rng = np.random.default_rng(0)
    frames, gt = synthetic_sequence(10, H, W, K, rng)
    cfg = Config(patch_size=8, max_planes=16, max_region_growing_rounds=32,
                 min_region_growing_cells_activated=3,
                 min_region_growing_candidate_size=3,
                 depth_discontinuity_threshold=600.0,
                 min_cos_angle_merge=0.97)
    slam = PlaneSlam(H, W, cfg, max_landmarks=32)
    for depth in frames:
        slam.process_frame(backproject_device(jnp.asarray(depth), jnp.asarray(K)))
    return slam, gt


def _ate(trajectory, gt):
    errs = [np.linalg.norm(-R.T @ t - (-Rg.T @ tg))
            for (R, t), (Rg, tg) in zip(trajectory, gt)]
    return float(np.sqrt(np.mean(np.square(errs))))


def test_tracking_locks_on(tracked_slam):
    slam, gt = tracked_slam
    assert int(np.asarray(slam.map.count)) >= 3
    # Matched planes every frame after the first.
    assert _ate(slam.trajectory, gt) < 300.0


@pytest.mark.heavy
def test_ba_refine_runs_and_stays_sane(tracked_slam):
    slam, gt = tracked_slam
    before = _ate(slam.trajectory, gt)
    slam.refine(iterations=8)
    after = _ate(slam.trajectory, gt)
    assert np.isfinite(after)
    assert after < before * 1.5  # must not blow up; usually improves


def _restore(slam, snap):
    import jax.numpy as jnp

    from deplex_tpu.slam.frontend import MapState

    slam.map = MapState(*(jnp.asarray(x) for x in snap["map"]))
    slam.R = jnp.asarray(snap["R"])
    slam.t = jnp.asarray(snap["t"])
    K = snap["traj_R"].shape[0]
    slam.trajectory = [(snap["traj_R"][i].copy(), snap["traj_t"][i].copy())
                       for i in range(K)]
    slam._keyframes = [tuple(snap[f"kf_{n}"][i].copy()
                             for n in ("normal", "d", "weight", "lm"))
                       for i in range(K)]


def test_refine_sharded_is_the_product_path(tracked_slam):
    """Driver-level multi-device agreement: the DEFAULT
    PlaneSlam.refine() on a multi-device runtime runs the keyframe-sharded
    LM loop (ba.run_ba_sharded over the 8-device test mesh) and must match
    the single-device refine to GN accuracy."""
    import jax

    if jax.device_count() < 2:
        pytest.skip("needs a multi-device runtime")
    slam, gt = tracked_slam
    snap = slam._snapshot_state()

    slam.refine(iterations=6, mesh=False)          # forced single-device
    traj_dense = [(R.copy(), t.copy()) for R, t in slam.trajectory]
    ate_dense = _ate(traj_dense, gt)

    _restore(slam, snap)
    slam.refine(iterations=6)                      # default → sharded path
    traj_shard = [(R.copy(), t.copy()) for R, t in slam.trajectory]
    ate_shard = _ate(traj_shard, gt)
    _restore(slam, snap)

    # Collective reduction order differs from the dense sum, so agreement is
    # GN-accuracy, not bitwise.
    for (R1, t1), (R2, t2) in zip(traj_dense, traj_shard):
        np.testing.assert_allclose(R1, R2, atol=2e-3)
        np.testing.assert_allclose(t1, t2, atol=5.0)  # mm; scene spans ~4000
    assert abs(ate_shard - ate_dense) < max(5.0, 0.1 * ate_dense)


def test_pose_graph_builds_and_optimizes(tracked_slam):
    slam, gt = tracked_slam
    g = slam.build_pose_graph(min_shared=3)
    assert g.edge_a.shape[0] >= len(slam.trajectory) - 1  # odometry chain
    before = _ate(slam.trajectory, gt)
    slam.optimize_trajectory(iterations=10)
    after = _ate(slam.trajectory, gt)
    assert np.isfinite(after)
    assert after < before * 1.5


def test_checkpoint_roundtrip_frontend(tracked_slam, tmp_path):
    import jax.numpy as jnp

    from deplex_tpu.slam.checkpoint import load_checkpoint, save_checkpoint

    slam, _ = tracked_slam
    state = {"map": slam.map, "R": jnp.asarray(slam.R), "t": jnp.asarray(slam.t)}
    save_checkpoint(str(tmp_path / "slam_ck"), state)
    restored = load_checkpoint(str(tmp_path / "slam_ck"), state)
    np.testing.assert_allclose(np.asarray(restored["map"].d),
                               np.asarray(slam.map.d), rtol=1e-6)


def test_pose_graph_scales_to_50_keyframes():
    """build_pose_graph is one vmapped dispatch over all candidate edges —
    K=50 keyframes with dense co-observation (~1.2k edges) must build well
    under a time bound (the former per-pair eager loop walled here)."""
    import time

    import jax.numpy as jnp

    from deplex_tpu import Config
    from deplex_tpu.slam import PlaneSlam
    from deplex_tpu.slam.lie import so3_exp

    K, P, M = 50, 8, 16
    rng = np.random.default_rng(3)
    # Ground-truth landmark planes seen by every frame.
    n_w = rng.normal(size=(M, 3)).astype(np.float32)
    n_w /= np.linalg.norm(n_w, axis=1, keepdims=True)
    d_w = rng.uniform(500, 3000, size=M).astype(np.float32)

    slam = PlaneSlam(64, 64, Config(), max_landmarks=M)
    slam.trajectory = []
    slam._keyframes = []
    from deplex_tpu.slam.planes import transform_plane

    lm_ids = np.arange(P, dtype=np.int32)
    for k in range(K):
        Rk = np.asarray(so3_exp(jnp.asarray(
            (rng.normal(size=3) * 0.05).astype(np.float32))))
        tk = (rng.normal(size=3) * 20).astype(np.float32)
        n_c, d_c = transform_plane(jnp.asarray(Rk), jnp.asarray(tk),
                                   jnp.asarray(n_w[:P]), jnp.asarray(d_w[:P]))
        slam.trajectory.append((Rk, tk))
        slam._keyframes.append((np.asarray(n_c), np.asarray(d_c),
                                np.full(P, 100.0, np.float32), lm_ids.copy()))
    slam.map = slam.map._replace(
        normal=jnp.asarray(np.pad(n_w, ((0, 0), (0, 0)))),
        d=jnp.asarray(d_w),
        weight=jnp.full(M, 100.0), count=jnp.int32(M))

    t0 = time.perf_counter()
    g = slam.build_pose_graph(min_shared=3)
    dt = time.perf_counter() - t0
    n_edges = int(g.edge_a.shape[0])
    # All measured pairs plus the K-1 tracking-prior consecutive edges.
    assert n_edges == (K - 1) + (K - 1) * K // 2 - (K - 1) + (K - 1)
    # One compile + one vmapped dispatch; generous CI bound.
    assert dt < 120.0, dt
    # Edge measurements recover the true relative poses (exact observations).
    A = np.asarray(g.edge_a)
    B = np.asarray(g.edge_b)
    Rs = np.stack([R for R, _ in slam.trajectory])
    R_ab = np.einsum("eij,ekj->eik", Rs[A], Rs[B])
    err = np.abs(np.asarray(g.meas_R) - R_ab).max()
    assert err < 1e-3, err
