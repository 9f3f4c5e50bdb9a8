"""Multi-frame SLAM on a 30-frame warped-TUM sequence + checkpoint/resume.

The sequence is rendered from the shipped REAL TUM frame along an exact
ground-truth trajectory (deplex_tpu.utils.warp; same generator as
scripts/make_sequence.py), written as 16-bit PNGs, and streamed through the
NATIVE SequenceLoader — the full reference sequence protocol
(process_sequence.cpp:23-43) plus the new SLAM capability on top. Committed
ATE artifact: data/golden/slam_ate_tum30.json (examples/python/run_slam.py
--dataset --report).
"""

import pathlib

import numpy as np
import pytest

from deplex_tpu import Config
from deplex_tpu.slam import PlaneSlam

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


@pytest.fixture(scope="module")
def tum_sequence(tmp_path_factory):
    """30 warped frames at half resolution (runtime) + ground truth."""
    from PIL import Image

    from deplex_tpu.utils import DepthImage, read_intrinsics
    from deplex_tpu.utils.warp import render_sequence, smooth_trajectory

    img = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K = np.asarray(read_intrinsics(
        str(DATA / "configs" / "TUM_fr3_long_val.K")), np.float32)
    depth0 = img.data[::2, ::2]
    K2 = K.copy()
    K2[0] *= 0.5
    K2[1] *= 0.5
    poses = smooth_trajectory(30, seed=0)
    frames = render_sequence(depth0, K2, poses)
    out = tmp_path_factory.mktemp("tum_seq")
    for i, d in enumerate(frames):
        arr = np.clip(np.round(d), 0, 65535).astype(np.uint16)
        Image.fromarray(arr, mode="I;16").save(out / f"{i:06d}.png")
    return out, K2, poses, depth0.shape


def _track(seq_dir, K, shape, *, start=0, stop=None, slam=None):
    import jax.numpy as jnp

    from deplex_tpu.native import SequenceLoader
    from deplex_tpu.pipeline import backproject_device

    H, W = shape
    paths = sorted(seq_dir.glob("*.png"))[start:stop]
    if slam is None:
        # patch 5 at half resolution = the same physical cell size as the
        # default patch 10 at 640x480 (fewer, larger cells at half-res
        # starve the odometry of plane observations).
        slam = PlaneSlam(H, W, Config(patch_size=5), max_landmarks=64,
                         odom_iterations=10)
    loader = SequenceLoader([str(p) for p in paths], W, H)
    for depth in loader:
        slam.process_frame(backproject_device(jnp.asarray(depth),
                                              jnp.asarray(K)))
    return slam


def _ate(trajectory, poses):
    errs = [np.linalg.norm(-R.T @ t - (-Rg.T @ tg))
            for (R, t), (Rg, tg) in zip(trajectory, poses)]
    return float(np.sqrt(np.mean(np.square(errs))))


@pytest.mark.slow
def test_sequence_tracking_pose_graph_ba_ate(tum_sequence):
    seq_dir, K, poses, shape = tum_sequence
    slam = _track(seq_dir, K, shape)
    assert len(slam.trajectory) == 30

    ate_track = _ate(slam.trajectory, poses)
    # Trajectory spans ~430mm of motion; bound is ~1.5x the measured
    # half-res tracking RMS (catches divergence-class regressions while
    # tolerating tie-break noise).
    assert ate_track < 300.0, ate_track
    tracked = list(slam.trajectory)

    # The backends must be NET-POSITIVE: per-frame plane odometry jitters
    # along weakly-observed directions, and the BA/pose-graph motion priors
    # (odometry + constant-velocity factors) average that jitter out, so
    # each stage must land at or below tracking ATE (epsilon for f32
    # tie-break noise). Full-res artifact: data/golden/slam_ate_tum30.json.
    slam.refine(iterations=10)
    ate_ba = _ate(slam.trajectory, poses)
    assert ate_ba <= 1.05 * ate_track, (ate_ba, ate_track)

    slam.trajectory = tracked
    slam.optimize_trajectory(min_shared=3)
    ate_pg = _ate(slam.trajectory, poses)
    assert ate_pg <= 1.05 * ate_track, (ate_pg, ate_track)


@pytest.mark.slow
def test_checkpoint_resume_mid_sequence(tum_sequence, tmp_path):
    """Save at frame 15, resume in a FRESH PlaneSlam, finish the sequence:
    the resumed tracker must match the uninterrupted one exactly (the
    per-frame step is deterministic given state, and the snapshot is a
    bitwise f32 roundtrip)."""
    seq_dir, K, poses, shape = tum_sequence
    H, W = shape

    full = _track(seq_dir, K, shape)

    first = _track(seq_dir, K, shape, stop=15)
    ckpt = tmp_path / "slam_ckpt"
    first.save(str(ckpt))

    resumed = PlaneSlam(H, W, Config(patch_size=5), max_landmarks=64,
                        odom_iterations=10)
    resumed.load(str(ckpt))
    assert len(resumed.trajectory) == 15
    resumed = _track(seq_dir, K, shape, start=15, slam=resumed)

    assert len(resumed.trajectory) == len(full.trajectory) == 30
    for (Ra, ta), (Rb, tb) in zip(resumed.trajectory, full.trajectory):
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(np.asarray(resumed.map.normal),
                                  np.asarray(full.map.normal))
    np.testing.assert_array_equal(np.asarray(resumed.map.weight),
                                  np.asarray(full.map.weight))
    assert int(resumed.map.count) == int(full.map.count)


@pytest.mark.slow
def test_sliding_window_long_sequence(tmp_path_factory):
    """100-frame sequence with a 20-keyframe sliding window: backend state
    stays bounded at O(window) while the output trajectory keeps every
    pose, and windowed BA still does not degrade the tracked trajectory."""
    from PIL import Image

    from deplex_tpu.utils import DepthImage, read_intrinsics
    from deplex_tpu.utils.warp import render_sequence, smooth_trajectory

    img = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K = np.asarray(read_intrinsics(
        str(DATA / "configs" / "TUM_fr3_long_val.K")), np.float32)
    depth0 = img.data[::2, ::2]
    K2 = K.copy()
    K2[0] *= 0.5
    K2[1] *= 0.5
    N, W_KF = 100, 20
    poses = smooth_trajectory(N, seed=2)
    frames = render_sequence(depth0, K2, poses)
    out = tmp_path_factory.mktemp("tum_seq_long")
    for i, d in enumerate(frames):
        arr = np.clip(np.round(d), 0, 65535).astype(np.uint16)
        Image.fromarray(arr, mode="I;16").save(out / f"{i:06d}.png")

    H, W = depth0.shape
    slam = PlaneSlam(H, W, Config(patch_size=5), max_landmarks=64,
                     odom_iterations=10, window=W_KF)
    slam = _track(out, K2, depth0.shape, slam=slam)

    # Bounded backend state; full output trajectory.
    assert len(slam._keyframes) == W_KF
    assert len(slam.trajectory) == N
    assert slam._kf_offset == N - W_KF
    prob = slam.build_ba_problem()
    assert prob.obs_d.shape[0] == W_KF

    ate_track = _ate(slam.trajectory, poses)
    assert ate_track < 400.0, ate_track

    slam.refine(iterations=8)
    assert len(slam.trajectory) == N          # prefix poses retained
    ate_ba = _ate(slam.trajectory, poses)
    assert np.isfinite(ate_ba)
    assert ate_ba <= 1.05 * ate_track, (ate_ba, ate_track)
    # Windowed refine must leave pre-window poses untouched.
    pre = slam.trajectory[: N - W_KF]
    assert all(np.isfinite(R).all() and np.isfinite(t).all()
               for R, t in pre)

    # Checkpoint round-trips the offset (kf stacks shorter than trajectory).
    ck = tmp_path_factory.mktemp("ck") / "win_ck"
    slam.save(str(ck))
    fresh = PlaneSlam(H, W, Config(patch_size=5), max_landmarks=64,
                      odom_iterations=10, window=W_KF)
    fresh.load(str(ck))
    assert len(fresh.trajectory) == N
    assert len(fresh._keyframes) == W_KF
    assert fresh._kf_offset == N - W_KF


@pytest.fixture(scope="module")
def icl_sequence(tmp_path_factory):
    """30 warped ICL-NUIM frames at half resolution + ground truth
    (BASELINE.json config 3: the second dataset's sequence protocol)."""
    from PIL import Image

    from deplex_tpu.utils import DepthImage, read_intrinsics
    from deplex_tpu.utils.warp import render_sequence, smooth_trajectory

    img = DepthImage(str(DATA / "icl_nuim" / "0.png"))
    K = np.asarray(read_intrinsics(
        str(DATA / "configs" / "ICL_living_room.K")), np.float32)
    depth0 = img.data[::2, ::2]
    K2 = K.copy()
    K2[0] *= 0.5
    K2[1] *= 0.5
    poses = smooth_trajectory(30, seed=1)
    frames = render_sequence(depth0, K2, poses)
    out = tmp_path_factory.mktemp("icl_seq")
    for i, d in enumerate(frames):
        arr = np.clip(np.round(d), 0, 65535).astype(np.uint16)
        Image.fromarray(arr, mode="I;16").save(out / f"{i:06d}.png")
    return out, K2, poses, depth0.shape


@pytest.mark.slow
def test_icl_sequence_tracking_and_backends(icl_sequence):
    """ICL-NUIM warped sequence: tracking within bound, backends
    net-positive (artifact: data/golden/slam_ate_icl30.json)."""
    seq_dir, K, poses, shape = icl_sequence
    H, W = shape
    slam = PlaneSlam(H, W, Config.from_ini(
        str(DATA / "configs" / "ICL_living_room.ini")),
        max_landmarks=64, odom_iterations=10)
    slam = _track(seq_dir, K, shape, slam=slam)
    assert len(slam.trajectory) == 30

    ate_track = _ate(slam.trajectory, poses)
    assert ate_track < 300.0, ate_track
    tracked = list(slam.trajectory)

    slam.refine(iterations=10)
    ate_ba = _ate(slam.trajectory, poses)
    assert ate_ba <= 1.05 * ate_track, (ate_ba, ate_track)

    slam.trajectory = tracked
    slam.optimize_trajectory(min_shared=3)
    ate_pg = _ate(slam.trajectory, poses)
    assert ate_pg <= 1.05 * ate_track, (ate_pg, ate_track)
