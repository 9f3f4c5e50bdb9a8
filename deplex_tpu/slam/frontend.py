"""Plane-SLAM frontend: extraction -> association -> odometry -> mapping.

Drives the full new-capability stack (BASELINE.json north star): per frame,
extract planes with the device pipeline, associate them against the plane-
landmark map, refine the pose with Gauss-Newton odometry, then fuse matched
observations into the map and spawn landmarks for unmatched ones. The
per-frame device step (associate + odometry + map update) is one jitted
function of fixed shapes; keyframe snapshots accumulate the BA problem that
deplex_tpu.slam.ba refines (optionally sharded over a mesh).

Host/device split mirrors the framework's design rules: PNG decode and
back-projection on host (native C++ path), everything else on device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from deplex_tpu.config import Config
from deplex_tpu.ops.cellstats import compute_cell_stats
from deplex_tpu.ops.growing import grow_planes
from deplex_tpu.ops.merge import merge_planes_device
from deplex_tpu.precision import HIGHEST
from deplex_tpu.slam.association import AssociationParams, associate
from deplex_tpu.slam.odometry import estimate_pose
from deplex_tpu.slam.planes import (PlaneObs, from_segments, to_cp,
                                    untransform_plane)


class MapState(NamedTuple):
    """Fixed-capacity plane-landmark map (world frame)."""

    normal: jax.Array    # (M, 3)
    d: jax.Array         # (M,)
    weight: jax.Array    # (M,) accumulated observation weight; 0 = free slot
    count: jax.Array     # () int32 occupied slots


class FrameResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    num_matched: jax.Array
    num_new: jax.Array
    obs: PlaneObs
    matches_lm: jax.Array


def init_map(max_landmarks: int) -> MapState:
    return MapState(normal=jnp.zeros((max_landmarks, 3), jnp.float32),
                    d=jnp.zeros(max_landmarks, jnp.float32),
                    weight=jnp.zeros(max_landmarks, jnp.float32),
                    count=jnp.int32(0))


def extract_plane_obs(points: jax.Array, image_height: int, image_width: int,
                      config: Config) -> PlaneObs:
    """Run extraction stages 1-4 and return the merged plane parameters.

    Unlike pipeline.extract_planes this stops before rasterization: SLAM
    needs plane parameters, not per-pixel labels. Merged (absorbed) slots
    get weight 0 so each physical plane appears once.
    """
    stats = compute_cell_stats(points, image_height, image_width, config)
    labels_map, segments = grow_planes(stats, config)
    merge_labels, merged = merge_planes_device(labels_map, segments, config)
    obs = from_segments(merged)
    # Drop slots absorbed by the merge (representative != self).
    keep = merge_labels == jnp.arange(merge_labels.shape[0])
    return obs._replace(weight=jnp.where(keep, obs.weight, 0.0))


def slam_step(obs: PlaneObs, map_state: MapState, R_prior: jax.Array,
              t_prior: jax.Array, *, assoc: AssociationParams,
              odom_iterations: int, min_obs_weight: float):
    """Pure device step: associate -> pose GN -> map fuse/spawn."""
    usable = obs._replace(weight=jnp.where(obs.weight >= min_obs_weight,
                                           obs.weight, 0.0))
    matches = associate(usable, map_state.normal, map_state.d,
                        map_state.weight > 0, R_prior, t_prior, assoc)
    odo = estimate_pose(usable, map_state.normal, map_state.d,
                        matches.landmark, matches.valid, R_prior, t_prior,
                        iterations=odom_iterations)
    R, t = odo.R, odo.t

    # ---- fuse matched observations (weighted average in world frame) ----
    n_w_obs, d_w_obs = untransform_plane(R, t, usable.normal, usable.d)
    M = map_state.d.shape[0]
    onehot = ((matches.landmark[:, None] == jnp.arange(M)[None, :])
              & matches.valid[:, None]).astype(jnp.float32)
    w_obs = onehot * usable.weight[:, None]                  # (P, M)
    add_w = jnp.sum(w_obs, axis=0)                           # (M,)
    # Average the CP vectors (linear, handles normal+offset jointly).
    cp_obs = to_cp(n_w_obs, d_w_obs)                         # (P, 3)
    cp_map = to_cp(map_state.normal, map_state.d)            # (M, 3)
    tot_w = map_state.weight + add_w
    cp_new = (cp_map * map_state.weight[:, None]
              + jnp.einsum("pm,pi->mi", w_obs, cp_obs, precision=HIGHEST)
              ) / jnp.maximum(tot_w, 1.0)[:, None]
    cp_new = jnp.where((add_w > 0)[:, None], cp_new, cp_map)
    from deplex_tpu.slam.planes import from_cp
    n_new, d_new = from_cp(cp_new)
    fused = MapState(normal=n_new, d=d_new,
                     weight=jnp.where(add_w > 0, tot_w, map_state.weight),
                     count=map_state.count)

    # ---- spawn landmarks for unmatched observations ----
    # Suppress near-duplicates: an unmatched observation whose world-frame
    # plane is close to ANY existing landmark (even one another observation
    # matched) must not fork the map — duplicated landmarks bias later
    # association and odometry.
    dup_cos = jnp.einsum("pi,mi->pm", n_w_obs, fused.normal, precision=HIGHEST)
    dup_d = jnp.abs(d_w_obs[:, None] - fused.d[None, :])
    near_dup = jnp.any((dup_cos >= assoc.dup_cos_angle)
                       & (dup_d <= assoc.dup_offset_dist)
                       & (fused.weight > 0)[None, :], axis=1)
    unmatched = (usable.weight > 0) & ~matches.valid & ~near_dup
    order = jnp.cumsum(unmatched.astype(jnp.int32)) - 1       # rank per obs
    slot = fused.count + order                                # target slots
    can = unmatched & (slot < M)
    slot_c = jnp.clip(slot, 0, M - 1)
    spawn_onehot = ((slot_c[:, None] == jnp.arange(M)[None, :]) & can[:, None])
    sel = spawn_onehot.astype(jnp.float32)
    normal2 = jnp.where(jnp.any(spawn_onehot, 0)[:, None],
                        jnp.einsum("pm,pi->mi", sel, n_w_obs, precision=HIGHEST), fused.normal)
    d2 = jnp.where(jnp.any(spawn_onehot, 0),
                   jnp.einsum("pm,p->m", sel, d_w_obs, precision=HIGHEST), fused.d)
    w2 = jnp.where(jnp.any(spawn_onehot, 0),
                   jnp.einsum("pm,p->m", sel, usable.weight, precision=HIGHEST), fused.weight)
    new_count = fused.count + jnp.sum(can).astype(jnp.int32)

    out_map = MapState(normal=normal2, d=d2, weight=w2, count=new_count)
    result = FrameResult(R=R, t=t,
                         num_matched=jnp.sum(matches.valid).astype(jnp.int32),
                         num_new=jnp.sum(can).astype(jnp.int32),
                         obs=usable, matches_lm=jnp.where(matches.valid,
                                                          matches.landmark, -1))
    return result, out_map


class PlaneSlam:
    """Streaming plane-SLAM driver (host loop; one jitted device step/frame)."""

    def __init__(self, image_height: int, image_width: int,
                 config: Config | None = None, *, max_landmarks: int = 256,
                 assoc: AssociationParams | None = None,
                 odom_iterations: int = 8, min_obs_weight: float = 0.0,
                 window: int | None = None):
        self.height = int(image_height)
        self.width = int(image_width)
        self.config = config or Config()
        self.assoc = assoc or AssociationParams()
        self.map = init_map(max_landmarks)
        self.R = jnp.eye(3)
        self.t = jnp.zeros(3)
        self.trajectory: list[tuple[np.ndarray, np.ndarray]] = []
        self._keyframes: list = []
        # Sliding window (None = unbounded): keep at most `window` keyframe
        # observation tuples for the BA/pose-graph backends; older frames'
        # poses stay in `trajectory` (the output) but leave the optimization
        # problem. Their landmark information is NOT lost: tracking fuses
        # every observation into the map (slam_step), so the map the window
        # optimizes against already carries the marginal of everything that
        # slid out — the backend's memory and per-refine cost are O(window),
        # the always-on-backend requirement.
        self.window = int(window) if window else None
        self._kf_offset = 0  # trajectory index of _keyframes[0]

        extract = functools.partial(extract_plane_obs, image_height=self.height,
                                    image_width=self.width, config=self.config)
        step = functools.partial(slam_step, assoc=self.assoc,
                                 odom_iterations=odom_iterations,
                                 min_obs_weight=min_obs_weight)

        @jax.jit
        def frame_fn(points, map_state, R_prior, t_prior):
            obs = extract(points)
            return step(obs, map_state, R_prior, t_prior)

        self._frame_fn = frame_fn
        # Batched pose-graph edge measurement: Gauss-Newton vmapped over the
        # edge axis, one dispatch for all candidate pairs (build_pose_graph).
        self._pair_measure_fn = jax.jit(jax.vmap(
            functools.partial(estimate_pose, iterations=6)))

    def process_frame(self, points) -> FrameResult:
        pts = jnp.asarray(points, jnp.float32)
        result, self.map = self._frame_fn(pts, self.map, self.R, self.t)
        self.R, self.t = result.R, result.t
        self.trajectory.append((np.asarray(self.R), np.asarray(self.t)))
        self._keyframes.append((np.asarray(result.obs.normal),
                                np.asarray(result.obs.d),
                                np.asarray(result.obs.weight),
                                np.asarray(result.matches_lm)))
        if self.window is not None and len(self._keyframes) > self.window:
            del self._keyframes[: len(self._keyframes) - self.window]
            self._kf_offset = len(self.trajectory) - len(self._keyframes)
        return result

    @property
    def _window_traj(self):
        """The trajectory slice the retained keyframes correspond to."""
        return self.trajectory[self._kf_offset:]

    def build_ba_problem(self, odo_weight: float = 3.0,
                         cv_weight: float = 10000.0,
                         edge_cos_gate: float = 0.95,
                         edge_offset_gate: float = 300.0):
        """Assemble the accumulated keyframes into a BAProblem.

        Observations are the per-frame plane measurements matched to map
        landmarks during tracking; landmark initial values come from the
        current map. odo_weight > 0 adds consecutive-pose motion priors
        taken from the tracked trajectory (ba.BAProblem docstring: they
        carry the tracker's information into the problem so plane-null
        pose directions cannot wander). Refine with
        deplex_tpu.slam.ba.run_ba (or the sharded step over a mesh) and
        read refined poses/landmarks back.
        """
        from deplex_tpu.slam.ba import BAProblem
        from deplex_tpu.slam.planes import to_cp

        K = len(self._keyframes)
        P = self._keyframes[0][0].shape[0]
        obs_normal = np.stack([k[0] for k in self._keyframes])
        obs_d = np.stack([k[1] for k in self._keyframes])
        w = np.stack([k[2] for k in self._keyframes])
        lm = np.stack([k[3] for k in self._keyframes])
        # Support-weighted observations (sqrt, as odometry): a wall observed
        # by thousands of pixels constrains the pose more than a fragment.
        obs_w = np.where((lm >= 0) & (w > 0),
                         np.sqrt(np.maximum(w, 0.0)), 0.0).astype(np.float32)
        # BA edge gate: the 200 mm match gate keeps tracking
        # locked on under drift, and a misassociation it admits costs
        # tracking only one Huber-damped frame — but the same match becomes
        # a PERMANENT wrong factor in the BA problem. Re-check each
        # recorded match against the CURRENT fused map at the tracked pose
        # and drop GROSS outliers. The gate must stay LOOSE on offset
        # (300 mm): offset residuals of the order of the tracking drift are
        # exactly the information BA uses, and gating at 100 mm removed
        # informative edges and REGRESSED BA ATE 31.3 -> 50.0 mm on the
        # warped-TUM sweep (round-5 measurement); at cos 0.95 / 300 mm the
        # gate is a no-op on clean sequences and only fires on true
        # misassociations.
        R_all = np.stack([p[0] for p in self._window_traj])
        t_all = np.stack([p[1] for p in self._window_traj])
        n_map = np.asarray(self.map.normal)
        d_map = np.asarray(self.map.d)
        lm_c = np.maximum(lm, 0)
        n_pred = np.einsum("kij,kpj->kpi", R_all, n_map[lm_c])   # (K, P, 3)
        d_pred = d_map[lm_c] - np.einsum("kpi,ki->kp", n_pred, t_all)
        cosang = np.einsum("kpi,kpi->kp", obs_normal, n_pred)
        edge_ok = (cosang >= edge_cos_gate) & \
            (np.abs(obs_d - d_pred) <= edge_offset_gate)
        obs_w = np.where(edge_ok, obs_w, 0.0).astype(np.float32)
        # Landmarks seen in < 2 keyframes constrain nothing (their residual
        # is absorbed by the landmark update) but leave ill-conditioned
        # Schur blocks; drop their observations.
        M = int(self.map.d.shape[0])
        seen = np.bincount(lm[(lm >= 0) & (obs_w > 0)].ravel(), minlength=M)
        obs_w = np.where(seen[np.maximum(lm, 0)] >= 2, obs_w, 0.0)
        if (obs_w > 0).any():
            obs_w = obs_w / obs_w[obs_w > 0].mean()
        R = np.stack([p[0] for p in self._window_traj])
        t = np.stack([p[1] for p in self._window_traj])
        eta = np.asarray(to_cp(self.map.normal, self.map.d))
        odo = {}
        if odo_weight > 0.0 and K >= 2:
            odo_R = np.einsum("kij,klj->kil", R[:-1], R[1:])    # R_i R_{i+1}^T
            odo_t = t[:-1] - np.einsum("kij,kj->ki", odo_R, t[1:])
            odo = {"odo_R": jnp.asarray(odo_R.astype(np.float32)),
                   "odo_t": jnp.asarray(odo_t.astype(np.float32)),
                   "odo_w": jnp.full(K - 1, odo_weight, jnp.float32)}
        if cv_weight > 0.0 and K >= 3:
            odo["cv_w"] = jnp.full(K - 2, cv_weight, jnp.float32)
        return BAProblem(
            R=jnp.asarray(R), t=jnp.asarray(t), eta=jnp.asarray(eta),
            obs_normal=jnp.asarray(obs_normal), obs_d=jnp.asarray(obs_d),
            obs_lm=jnp.asarray(np.maximum(lm, 0), jnp.int32),
            obs_w=jnp.asarray(obs_w), **odo)

    def build_pose_graph(self, min_shared: int = 3,
                         tracking_prior_weight: float = 1.0,
                         cv_weight: float = 10000.0):
        """Pose graph over keyframes: odometry edges between consecutive
        frames plus loop-closure edges between any pair co-observing >=
        min_shared map landmarks. Edge measurements are estimated DIRECTLY
        from the shared plane observations (frame-to-frame Gauss-Newton,
        independent of the tracked trajectory), so graph optimization can
        correct accumulated drift. Edges are information-weighted by their
        co-observation count (a 3-plane loop closure must not count like an
        18-plane odometry edge), and tracking_prior_weight > 0 adds
        consecutive-pose prior edges taken from the TRACKED trajectory —
        frame-to-map tracking fuses every previous observation of a plane,
        so its relative poses carry strictly more information than the
        pairwise re-measurements; without them the graph replaces a fused
        trajectory with the integral of noisier two-frame estimates.

        All E candidate edges are measured in ONE vmapped device dispatch
        (batched Gauss-Newton over the edge axis); candidate selection is a
        single K x K co-observation count matrix on host. Scales to
        hundreds of keyframes where the former per-pair dispatch loop
        walled (O(K^2) eager estimate_pose calls).
        """
        from deplex_tpu.slam.planes import PlaneObs
        from deplex_tpu.slam.pose_graph import PoseGraph

        K = len(self._keyframes)
        P = self._keyframes[0][0].shape[0]
        n_kf = np.stack([kf[0] for kf in self._keyframes])     # (K, P, 3)
        d_kf = np.stack([kf[1] for kf in self._keyframes])     # (K, P)
        w_kf = np.stack([kf[2] for kf in self._keyframes])     # (K, P)
        l_kf = np.stack([kf[3] for kf in self._keyframes])     # (K, P) int

        # Candidate pairs from the co-observation count matrix (one int
        # matmul): consecutive edges first, then loop closures (b >= a+2).
        M = int(self.map.d.shape[0])
        occ = np.zeros((K, M), np.int32)
        kk, pp = np.nonzero(l_kf >= 0)
        occ[kk, l_kf[kk, pp]] = 1
        shared = occ @ occ.T                                    # (K, K)
        pairs = [(a, a + 1) for a in range(K - 1)
                 if shared[a, a + 1] >= min_shared]
        iu, ju = np.triu_indices(K, k=2)
        pairs += [(int(a), int(b)) for a, b in zip(iu, ju)
                  if shared[a, b] >= min_shared]
        if not pairs:
            raise ValueError("no pose-graph edges (no co-observed planes)")

        A = np.asarray([p[0] for p in pairs])
        B = np.asarray([p[1] for p in pairs])
        # match[e, i] = first j with l_b[j] == l_a[i] (>= 0), else -1 —
        # frame b's observations act as the "world" landmarks for the pair.
        la, lb = l_kf[A], l_kf[B]                               # (E, P)
        eq = (la[:, :, None] == lb[:, None, :]) & (la >= 0)[:, :, None]
        has = eq.any(-1)
        match = np.where(has, eq.argmax(-1), -1).astype(np.int32)

        Rs = np.stack([R for R, _ in self._window_traj])
        ts = np.stack([t for _, t in self._window_traj])
        R0 = np.einsum("eij,ekj->eik", Rs[A], Rs[B])            # Ra @ Rb^T
        t0 = ts[A] - np.einsum("eij,ej->ei", R0, ts[B])

        # Pad the edge axis so the jitted batched measure compiles for a few
        # bucket sizes instead of every E.
        E = len(pairs)
        Epad = max(8, 1 << (E - 1).bit_length())

        def pad(x, fill=0):
            return np.concatenate(
                [x, np.full((Epad - E,) + x.shape[1:], fill, x.dtype)])

        obs = PlaneObs(normal=jnp.asarray(pad(n_kf[A])),
                       d=jnp.asarray(pad(d_kf[A])),
                       weight=jnp.asarray(pad(w_kf[A])),
                       mean=jnp.zeros((Epad, P, 3), jnp.float32))
        eye = np.broadcast_to(np.eye(3, dtype=R0.dtype), (Epad - E, 3, 3))
        R0p = np.concatenate([R0, eye]).astype(np.float32)
        res = self._pair_measure_fn(
            obs, jnp.asarray(pad(n_kf[B])), jnp.asarray(pad(d_kf[B])),
            jnp.asarray(pad(match, fill=-1)), jnp.asarray(pad(has)),
            jnp.asarray(R0p), jnp.asarray(pad(t0.astype(np.float32))))
        meas_R = np.asarray(res.R)[:E]
        meas_t = np.asarray(res.t)[:E]

        # Edge-quality gate: a loop closure whose per-plane GN residual is
        # far above the consecutive-edge norm is a misassociation or
        # degenerate geometry — it would actively corrupt the graph. All
        # consecutive edges are kept (connectivity).
        per = (np.asarray(res.residual)[:E]
               / np.maximum(np.asarray(res.num_inliers)[:E], 1))
        consec = (B - A) == 1
        anchor = np.median(per[consec]) if consec.any() else np.median(per)
        keep = consec | (per <= 5.0 * max(float(anchor), 1e-9))
        A, B = A[keep], B[keep]
        meas_R, meas_t = meas_R[keep], meas_t[keep]
        # Information-proportional edge weights: co-observed plane count,
        # normalized so a typical consecutive edge weighs 1.
        n_shared = np.asarray([shared[a, b] for a, b in zip(A, B)], np.float32)
        consec_k = (B - A) == 1
        norm = np.median(n_shared[consec_k]) if consec_k.any() else \
            max(n_shared.max(), 1.0)
        w_edges = n_shared / max(float(norm), 1.0)

        # Nodes in world-from-camera convention so edge measurements compose
        # as T_ab = T_cw(a) o T_cw(b)^-1 (see slam/pose_graph.py residual).
        R_wc = np.stack([R.T for R, _ in self._window_traj])
        t_wc = np.stack([-R.T @ t for R, t in self._window_traj])

        if tracking_prior_weight > 0.0 and K >= 2:
            # Consecutive prior edges from the tracked trajectory itself
            # (world-from-camera convention: T_ab = T_wc(a)^-1 T_wc(b)).
            Ap = np.arange(K - 1)
            Bp = Ap + 1
            pR = np.einsum("kji,kjl->kil", R_wc[Ap], R_wc[Bp])   # Ra^T Rb
            pt = np.einsum("kji,kj->ki", R_wc[Ap],
                           t_wc[Bp] - t_wc[Ap])
            A = np.concatenate([A, Ap])
            B = np.concatenate([B, Bp])
            meas_R = np.concatenate([meas_R, pR.astype(np.float32)])
            meas_t = np.concatenate([meas_t, pt.astype(np.float32)])
            w_edges = np.concatenate(
                [w_edges, np.full(K - 1, tracking_prior_weight, np.float32)])

        return PoseGraph(
            R=jnp.asarray(R_wc), t=jnp.asarray(t_wc),
            edge_a=jnp.asarray(A, jnp.int32), edge_b=jnp.asarray(B, jnp.int32),
            meas_R=jnp.asarray(meas_R), meas_t=jnp.asarray(meas_t),
            weight=jnp.asarray(w_edges, jnp.float32),
            cv_w=(jnp.full(K - 2, cv_weight, jnp.float32)
                  if cv_weight > 0.0 and K >= 3 else None))

    def optimize_trajectory(self, iterations: int = 15, min_shared: int = 3,
                            tracking_prior_weight: float = 1.0,
                            cv_weight: float = 10000.0):
        """Pose-graph optimization over the keyframe trajectory (in place)."""
        from deplex_tpu.slam.pose_graph import optimize_pose_graph

        g = self.build_pose_graph(min_shared=min_shared,
                                  tracking_prior_weight=tracking_prior_weight,
                                  cv_weight=cv_weight)
        out = optimize_pose_graph(g, iterations=iterations)
        R_wc = np.asarray(out.R)
        t_wc = np.asarray(out.t)
        self.trajectory[self._kf_offset:] = [
            (R_wc[i].T, -R_wc[i].T @ t_wc[i]) for i in range(R_wc.shape[0])]
        self.R = jnp.asarray(self.trajectory[-1][0])
        self.t = jnp.asarray(self.trajectory[-1][1])
        return out

    def save(self, path: str) -> None:
        """Snapshot the FULL tracker state (map, current pose, trajectory,
        keyframe observations) mid-sequence; resume with PlaneSlam.load().
        Uses slam.checkpoint (orbax when available, npz fallback)."""
        from deplex_tpu.slam.checkpoint import save_checkpoint

        if not self._keyframes:
            raise ValueError("nothing to checkpoint: no frames processed")
        save_checkpoint(path, self._snapshot_state())

    def load(self, path: str) -> None:
        """Restore a snapshot written by save(); the tracker continues the
        sequence exactly where it left off (same map, pose, keyframes)."""
        from deplex_tpu.slam.checkpoint import load_checkpoint

        example = self._snapshot_state() if self._keyframes else \
            self._snapshot_example()
        state = load_checkpoint(path, example)
        self.map = MapState(*(jnp.asarray(x) for x in state["map"]))
        self.R = jnp.asarray(state["R"])
        self.t = jnp.asarray(state["t"])
        K = state["traj_R"].shape[0]
        self.trajectory = [(np.asarray(state["traj_R"][i]),
                            np.asarray(state["traj_t"][i])) for i in range(K)]
        Kk = state["kf_normal"].shape[0]     # <= K when a window was active
        self._keyframes = [(np.asarray(state["kf_normal"][i]),
                            np.asarray(state["kf_d"][i]),
                            np.asarray(state["kf_weight"][i]),
                            np.asarray(state["kf_lm"][i])) for i in range(Kk)]
        self._kf_offset = K - Kk

    def _snapshot_state(self) -> dict:
        return {
            "map": MapState(*(np.asarray(x) for x in self.map)),
            "R": np.asarray(self.R), "t": np.asarray(self.t),
            "traj_R": np.stack([R for R, _ in self.trajectory]),
            "traj_t": np.stack([t for _, t in self.trajectory]),
            "kf_normal": np.stack([k[0] for k in self._keyframes]),
            "kf_d": np.stack([k[1] for k in self._keyframes]),
            "kf_weight": np.stack([k[2] for k in self._keyframes]),
            "kf_lm": np.stack([k[3] for k in self._keyframes]),
        }

    def _snapshot_example(self) -> dict:
        """Zero-frame example tree (same structure) for load-before-track."""
        M = int(self.map.d.shape[0])
        P = int(self.config.max_planes)
        return {
            "map": MapState(*(np.asarray(x) for x in self.map)),
            "R": np.zeros((3, 3), np.float32), "t": np.zeros(3, np.float32),
            "traj_R": np.zeros((0, 3, 3), np.float32),
            "traj_t": np.zeros((0, 3), np.float32),
            "kf_normal": np.zeros((0, P, 3), np.float32),
            "kf_d": np.zeros((0, P), np.float32),
            "kf_weight": np.zeros((0, P), np.float32),
            "kf_lm": np.zeros((0, P), np.int32),
        }

    def refine(self, iterations: int = 10, damping: float = 1e-4,
               odo_weight: float = 3.0, cv_weight: float = 10000.0,
               mesh=None):
        """Run windowed BA over all keyframes; updates trajectory + map.

        The product path is DISTRIBUTED by default: whenever more than one
        device is visible (or a mesh is passed), the LM loop runs keyframe-
        sharded over the mesh (ba.run_ba_sharded — Schur blocks psum'd over
        the mesh); on a single device it is the identical dense loop. Pass
        mesh=False to force the single-device path.
        """
        from deplex_tpu.slam.ba import run_ba, run_ba_sharded
        from deplex_tpu.slam.planes import from_cp

        problem = self.build_ba_problem(odo_weight=odo_weight,
                                        cv_weight=cv_weight)
        if mesh is not False and (mesh is not None or jax.device_count() > 1):
            out = run_ba_sharded(problem, mesh if mesh is not None else None,
                                 iterations=iterations, damping=damping)
        else:
            out = run_ba(problem, iterations=iterations, damping=damping)
        # Only the windowed keyframes were optimized; poses that slid out
        # of the window keep their (already-refined-or-tracked) values.
        self.trajectory[self._kf_offset:] = [
            (np.asarray(out.R[i]), np.asarray(out.t[i]))
            for i in range(out.R.shape[0])]
        n, d = from_cp(out.eta)
        self.map = self.map._replace(normal=n, d=d)
        self.R = jnp.asarray(self.trajectory[-1][0])
        self.t = jnp.asarray(self.trajectory[-1][1])
        return out
