"""Plane-landmark bundle adjustment with Schur-complement reduction.

Jointly refines K keyframe poses and M plane landmarks from plane
observations — the distributed-backend capability named in BASELINE.json's
north star (absent from the reference, SURVEY.md §2.4 / §5.7).

Problem. Variables: poses T_i = (R_i, t_i) (camera-from-world, i < K, pose 0
gauge-fixed) and landmarks eta_j (closest-point vectors, j < M). Observation
(i, j): the frame-i extractor measured plane (n_obs, d_obs); residual is the
camera-frame closest-point error

    r_ij = cp(T_i * plane(eta_j)) - cp(n_obs, d_obs)        in R^3.

Structure. One Gauss-Newton step builds
    H = [H_pp  H_pl]        b = [b_p]
        [H_pl' H_ll]            [b_l]
with H_ll 3x3-block-diagonal (landmarks independent given poses), so the
landmark block is eliminated in closed form (Schur complement):
    S  = H_pp - H_pl H_ll^-1 H_pl'          (6K x 6K, small: K <= ~64)
    g  = b_p  - H_pl H_ll^-1 b_l
    dx_p = -S^-1 g ;  dx_l = -H_ll^-1 (b_l + H_pl' dx_p).

Distribution. Observations are stored per keyframe ((K, P) slots), so
sharding the KEYFRAME axis over the device mesh shards the expensive
per-observation Jacobian/outer-product work; the small S, g, and the
landmark-block accumulators are combined with psum over the mesh (NCCL on GPUs) —
see ba_step_sharded. The dense math is identical on 1 device.

All shapes static: K keyframes, P observation slots per frame, M landmarks;
invalid slots carry zero weight.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deplex_tpu.slam.lie import se3_exp, so3_log
from deplex_tpu.slam.planes import from_cp
from deplex_tpu.precision import HIGHEST


class BAProblem(NamedTuple):
    """Static-shape BA inputs.

    The optional odometry block (odo_*, None = absent) carries relative-pose
    motion priors between consecutive keyframes, taken from the tracker.
    Plane observations alone leave pose directions that no observed normal
    spans unconstrained (a plane constrains only 3 of 6 DOF), so a pure
    plane BA can wander along those null directions and DEGRADE a good
    tracked trajectory; the motion priors carry the tracker's information
    into the problem, making BA's solution a strict superset of what
    tracking knew. In the sharded step these arrays must be passed
    REPLICATED (they are (K-1)-sized and cross shard boundaries).
    """

    R: jax.Array          # (K, 3, 3) initial rotations (camera-from-world)
    t: jax.Array          # (K, 3) initial translations
    eta: jax.Array        # (M, 3) initial landmark CP vectors
    obs_normal: jax.Array  # (K, P, 3) measured plane normals (camera frame)
    obs_d: jax.Array      # (K, P) measured offsets
    obs_lm: jax.Array     # (K, P) int32 landmark index (clip-safe; weight 0 if none)
    obs_w: jax.Array      # (K, P) observation weights (0 = empty slot)
    odo_R: jax.Array | None = None   # (K-1, 3, 3) measured R_i R_{i+1}^T
    odo_t: jax.Array | None = None   # (K-1, 3) measured t_i - R_rel t_{i+1}
    odo_w: jax.Array | None = None   # (K-1,) motion-prior weights
    cv_w: jax.Array | None = None    # (K-2,) constant-velocity prior weights


class BAState(NamedTuple):
    R: jax.Array
    t: jax.Array
    eta: jax.Array
    cost: jax.Array


NORMAL_WEIGHT = 1000.0  # unitless normal residual vs raw-depth-unit offset
OFFSET_WEIGHT = 1.0     # (same balance as slam.odometry.estimate_pose)
HUBER_DELTA = 100.0     # robust scale on the weighted 4-residual norm
ODO_ROT_SCALE = 1000.0  # rad -> depth-unit-equivalent (as pose_graph)
ODO_TR_SCALE = 1.0


def _residual_and_jac(Ri, ti, eta_j, n_obs, d_obs):
    """r_ij (4,) plus Jacobians wrt pose twist (4,6) and landmark (4,3).

    Residual = [w_n * (n_pred - n_obs), w_d * (d_pred - d_obs)] — the same
    decoupled normal/offset weighting the odometry uses. (A closest-point
    (cp = -d*n) residual scales angular error by the plane distance d; with
    raw TUM depth units d reaches ~40k, so far planes would dominate the
    cost and BA would move poses meters to fix centimeter-scale angular
    noise.) Uses jax.jacfwd on the closed-form residual — the Jacobians are
    tiny; XLA fuses the forward-mode duals into the same kernels.
    """

    def res(xi, eta):
        dR, dt = se3_exp(xi)
        R = jnp.matmul(dR, Ri, precision=HIGHEST)
        t = jnp.einsum("ij,j->i", dR, ti, precision=HIGHEST) + dt
        n_w, d_w = from_cp(eta)
        n_c = jnp.matmul(R, n_w, precision=HIGHEST)
        d_c = d_w - jnp.dot(n_c, t, precision=HIGHEST)
        return jnp.concatenate([
            NORMAL_WEIGHT * (n_c - n_obs),
            (OFFSET_WEIGHT * (d_c - d_obs))[None],
        ])

    xi0 = jnp.zeros(6, dtype=Ri.dtype)
    r = res(xi0, eta_j)
    Jp = jax.jacfwd(res, argnums=0)(xi0, eta_j)   # (4, 6)
    Jl = jax.jacfwd(res, argnums=1)(xi0, eta_j)   # (4, 3)
    return r, Jp, Jl


def _accumulate(problem: BAProblem, M: int):
    """Per-device accumulation over this shard's keyframes.

    Returns (Hpp (K,K,6,6) — actually only diagonal blocks are nonzero per
    observation, but cross terms enter via the Schur product, so we keep the
    small dense form —, Hll (M,3,3), Hpl (K,M,6,3), bp (K,6), bl (M,3),
    cost ()). K here is the LOCAL shard size.
    """
    K, P = problem.obs_d.shape

    def per_frame(Ri, ti, n_obs, d_obs, lm, w):
        eta_sel = problem.eta[jnp.clip(lm, 0, M - 1)]      # (P, 3)
        r, Jp, Jl = jax.vmap(_residual_and_jac, in_axes=(None, None, 0, 0, 0))(
            Ri, ti, eta_sel, n_obs, d_obs)
        # Huber IRLS weight: observations whose weighted residual norm
        # exceeds the scale (misassociations, fragments) are downweighted
        # instead of dragging poses (same robustification as odometry).
        r_norm = jnp.sqrt(jnp.sum(r * r, -1) + 1e-12)
        w = w * jnp.minimum(1.0, HUBER_DELTA / r_norm)
        Hpp_i = jnp.einsum("p,pik,pil->kl", w, Jp, Jp, precision=HIGHEST)      # (6, 6)
        bp_i = jnp.einsum("p,pik,pi->k", w, Jp, r, precision=HIGHEST)          # (6,)
        # Landmark-indexed accumulations via one-hot contractions (exact
        # sums, no scatter with duplicate indices; M is small).
        onehot = (lm[:, None] == jnp.arange(M)[None, :]).astype(r.dtype) * w[:, None]
        Hll_i = jnp.einsum("pm,pik,pil->mkl", onehot, Jl, Jl, precision=HIGHEST)   # (M, 3, 3)
        bl_i = jnp.einsum("pm,pik,pi->mk", onehot, Jl, r, precision=HIGHEST)       # (M, 3)
        Hpl_i = jnp.einsum("pm,pik,pil->mkl", onehot, Jp, Jl, precision=HIGHEST)   # (M, 6, 3)
        cost_i = jnp.sum(w * jnp.sum(r * r, -1))
        return Hpp_i, bp_i, Hll_i, bl_i, Hpl_i, cost_i

    Hpp, bp, Hll, bl, Hpl, cost = jax.vmap(per_frame)(
        problem.R, problem.t, problem.obs_normal, problem.obs_d,
        problem.obs_lm, problem.obs_w)
    return Hpp, bp, jnp.sum(Hll, 0), jnp.sum(bl, 0), Hpl, jnp.sum(cost)


def _odo_residual(xi_a, xi_b, Ra, ta, Rb, tb, mR, mt):
    """Weighted 6-residual of one consecutive-pose motion prior."""
    dRa, dta = se3_exp(xi_a)
    dRb, dtb = se3_exp(xi_b)
    Ra2 = jnp.matmul(dRa, Ra, precision=HIGHEST)
    ta2 = jnp.einsum("ij,j->i", dRa, ta, precision=HIGHEST) + dta
    Rb2 = jnp.matmul(dRb, Rb, precision=HIGHEST)
    tb2 = jnp.einsum("ij,j->i", dRb, tb, precision=HIGHEST) + dtb
    R_rel = jnp.matmul(Ra2, Rb2.T, precision=HIGHEST)
    t_rel = ta2 - jnp.einsum("ij,j->i", R_rel, tb2, precision=HIGHEST)
    r_rot = so3_log(jnp.matmul(mR.T, R_rel, precision=HIGHEST)) * ODO_ROT_SCALE
    r_tr = (t_rel - mt) * ODO_TR_SCALE
    return jnp.concatenate([r_rot, r_tr])


def _cv_residual(xi_a, xi_b, xi_c, Ra, ta, Rb, tb, Rc, tc):
    """Constant-velocity 6-residual over a pose triple (i-1, i, i+1).

    Plane observations constrain only the 3 DOF their normals span; along
    the remaining directions per-frame estimates JITTER (they don't drift —
    each frame re-anchors to the map). A second-order smoothness prior —
    zero change in relative rotation and camera-center velocity — is the
    standard motion model that averages that jitter out; it is measurement-
    free, so it cannot bias the solution toward any particular trajectory,
    only toward smooth ones.
    """
    dRa, dta = se3_exp(xi_a)
    dRb, dtb = se3_exp(xi_b)
    dRc, dtc = se3_exp(xi_c)
    R_a = jnp.matmul(dRa, Ra, precision=HIGHEST)
    t_a = jnp.einsum("ij,j->i", dRa, ta, precision=HIGHEST) + dta
    R_b = jnp.matmul(dRb, Rb, precision=HIGHEST)
    t_b = jnp.einsum("ij,j->i", dRb, tb, precision=HIGHEST) + dtb
    R_c = jnp.matmul(dRc, Rc, precision=HIGHEST)
    t_c = jnp.einsum("ij,j->i", dRc, tc, precision=HIGHEST) + dtc
    ca = jnp.matmul(-R_a.T, t_a, precision=HIGHEST)
    cb = jnp.matmul(-R_b.T, t_b, precision=HIGHEST)
    cc = jnp.matmul(-R_c.T, t_c, precision=HIGHEST)
    A = jnp.matmul(R_c, R_b.T, precision=HIGHEST)
    B = jnp.matmul(R_b, R_a.T, precision=HIGHEST)
    r_rot = so3_log(jnp.matmul(A, B.T, precision=HIGHEST)) * ODO_ROT_SCALE
    r_tr = (cc - cb) - (cb - ca)
    return jnp.concatenate([r_rot, r_tr])


def _cv_blocks(R_all, t_all, cv_w):
    """GN blocks of the constant-velocity priors: triple e couples poses
    (e, e+1, e+2). Returns (J (E, 3, 6, 6) per-pose Jacobians, r (E, 6),
    cost ())."""
    zeros6 = jnp.zeros(6, dtype=t_all.dtype)

    def per_triple(Ra, ta, Rb, tb, Rc, tc, w):
        args = (zeros6, zeros6, zeros6, Ra, ta, Rb, tb, Rc, tc)
        r = _cv_residual(*args)
        Js = [jax.jacfwd(_cv_residual, argnums=i)(*args) for i in range(3)]
        return jnp.stack(Js), r, w * jnp.dot(r, r, precision=HIGHEST)

    J, r, cost = jax.vmap(per_triple)(
        R_all[:-2], t_all[:-2], R_all[1:-1], t_all[1:-1], R_all[2:],
        t_all[2:], cv_w)
    return J, r, jnp.sum(cost)


def _odo_blocks(R_all, t_all, odo_R, odo_t, odo_w):
    """Per-edge GN blocks of the motion priors: edge e couples poses e, e+1.

    Returns (Haa, Hab, Hbb (E, 6, 6), ga, gb (E, 6), cost ())."""
    zeros6 = jnp.zeros(6, dtype=t_all.dtype)

    def per_edge(Ra, ta, Rb, tb, mR, mt, w):
        r = _odo_residual(zeros6, zeros6, Ra, ta, Rb, tb, mR, mt)
        Ja = jax.jacfwd(_odo_residual, argnums=0)(
            zeros6, zeros6, Ra, ta, Rb, tb, mR, mt)
        Jb = jax.jacfwd(_odo_residual, argnums=1)(
            zeros6, zeros6, Ra, ta, Rb, tb, mR, mt)
        Haa = jnp.matmul(w * Ja.T, Ja, precision=HIGHEST)
        Hab = jnp.matmul(w * Ja.T, Jb, precision=HIGHEST)
        Hbb = jnp.matmul(w * Jb.T, Jb, precision=HIGHEST)
        ga = jnp.matmul(w * Ja.T, r, precision=HIGHEST)
        gb = jnp.matmul(w * Jb.T, r, precision=HIGHEST)
        return Haa, Hab, Hbb, ga, gb, w * jnp.dot(r, r, precision=HIGHEST)

    Haa, Hab, Hbb, ga, gb, cost = jax.vmap(per_edge)(
        R_all[:-1], t_all[:-1], R_all[1:], t_all[1:], odo_R, odo_t, odo_w)
    return Haa, Hab, Hbb, ga, gb, jnp.sum(cost)


def ba_step(problem: BAProblem, *, damping: float = 1e-4,
            gauge_fix_first: bool = True, axis_name: str | None = None) -> BAState:
    """One damped Gauss-Newton step with Schur elimination of landmarks.

    axis_name: if set, the step is running inside shard_map over that mesh
    axis with the KEYFRAME axis sharded; global reductions go over psum.
    """
    K, P = problem.obs_d.shape
    M = problem.eta.shape[0]

    Hpp_blk, bp, Hll, bl, Hpl, cost = _accumulate(problem, M)

    # The per-observation Jacobian work above is the expensive part and stays
    # sharded; the Schur assembly below is tiny (K <= ~64 poses), so in the
    # sharded case the per-frame blocks are gathered and assembled replicated
    # on every device — landmark blocks reduce with psum over the mesh.
    if axis_name is not None:
        Hll = jax.lax.psum(Hll, axis_name)
        bl = jax.lax.psum(bl, axis_name)
        cost = jax.lax.psum(cost, axis_name)
        Hpp_all = jax.lax.all_gather(Hpp_blk, axis_name, axis=0, tiled=True)
        bp_all = jax.lax.all_gather(bp, axis_name, axis=0, tiled=True)
        Hpl_all = jax.lax.all_gather(Hpl, axis_name, axis=0, tiled=True)
    else:
        Hpp_all, bp_all, Hpl_all = Hpp_blk, bp, Hpl
    Kg = bp_all.shape[0]

    # Invert the landmark blocks (regularized; unobserved landmarks stay put).
    Hll_reg = Hll + damping * jnp.eye(3, dtype=Hll.dtype)
    Hll_inv = jnp.linalg.inv(Hll_reg)

    # Schur complement:
    # S[a, b] = delta_ab Hpp[a] - sum_j Hpl[a, j] Hll_inv[j] Hpl[b, j]^T
    W = jnp.einsum("amkc,mcd->amkd", Hpl_all, Hll_inv, precision=HIGHEST)      # (Kg, M, 6, 3)
    U = jnp.einsum("amkd,bmld->abkl", W, Hpl_all, precision=HIGHEST)           # (Kg, Kg, 6, 6)
    g = bp_all - jnp.einsum("amkd,md->ak", W, bl, precision=HIGHEST)           # (Kg, 6)

    S = -U
    S = S.at[jnp.arange(Kg), jnp.arange(Kg)].add(Hpp_all)

    # Motion priors (odometry + constant-velocity factors): pose-only
    # terms, so they add straight into the Schur system. Poses are gathered
    # when sharded (the prior chains cross shard boundaries; odo_*/cv_w
    # arrays are replicated by contract).
    if problem.odo_R is not None or problem.cv_w is not None:
        if axis_name is not None:
            R_all = jax.lax.all_gather(problem.R, axis_name, axis=0, tiled=True)
            t_all = jax.lax.all_gather(problem.t, axis_name, axis=0, tiled=True)
        else:
            R_all, t_all = problem.R, problem.t
    if problem.odo_R is not None:
        Haa, Hab, Hbb, ga, gb, _ = _odo_blocks(
            R_all, t_all, problem.odo_R, problem.odo_t, problem.odo_w)
        idx = jnp.arange(Kg - 1)
        S = S.at[idx, idx].add(Haa)
        S = S.at[idx, idx + 1].add(Hab)
        S = S.at[idx + 1, idx].add(jnp.swapaxes(Hab, -1, -2))
        S = S.at[idx + 1, idx + 1].add(Hbb)
        g = g.at[idx].add(ga)
        g = g.at[idx + 1].add(gb)
    if problem.cv_w is not None:
        J, r, _ = _cv_blocks(R_all, t_all, problem.cv_w)
        idx = jnp.arange(Kg - 2)
        w = problem.cv_w
        for a in range(3):
            g = g.at[idx + a].add(
                jnp.einsum("e,eik,ei->ek", w, J[:, a], r, precision=HIGHEST))
            for b in range(3):
                S = S.at[idx + a, idx + b].add(
                    jnp.einsum("e,eik,eil->ekl", w, J[:, a], J[:, b], precision=HIGHEST))

    S = S + damping * jnp.eye(6, dtype=S.dtype)[None, None] * \
        (jnp.arange(Kg)[:, None, None, None] == jnp.arange(Kg)[None, :, None, None])
    if gauge_fix_first:
        # Pin pose 0: zero its rows/cols, identity diagonal, zero gradient.
        mask = (jnp.arange(Kg) != 0)
        S = S * mask[:, None, None, None] * mask[None, :, None, None]
        S = S.at[0, 0].set(jnp.eye(6, dtype=S.dtype))
        g = g * mask[:, None]
    Sd = S.transpose(0, 2, 1, 3).reshape(Kg * 6, Kg * 6)
    dxp_all = -jnp.linalg.solve(Sd, g.reshape(-1)).reshape(Kg, 6)

    if axis_name is not None:
        i0 = jax.lax.axis_index(axis_name) * K
        dxp = jax.lax.dynamic_slice_in_dim(dxp_all, i0, K, axis=0)
    else:
        dxp = dxp_all

    # Landmark back-substitution: dx_l = -Hll_inv (bl + sum_a Hpl[a]^T dxp_a).
    rhs_local = jnp.einsum("amkd,ak->md", Hpl, dxp, precision=HIGHEST)
    if axis_name is not None:
        rhs_local = jax.lax.psum(rhs_local, axis_name)
    dxl = -jnp.einsum("mcd,md->mc", Hll_inv, bl + rhs_local, precision=HIGHEST)

    dR, dt = se3_exp(dxp)
    R_new = jnp.matmul(dR, problem.R, precision=HIGHEST)
    t_new = jnp.einsum("kij,kj->ki", dR, problem.t, precision=HIGHEST) + dt
    eta_new = problem.eta + dxl
    return BAState(R=R_new, t=t_new, eta=eta_new, cost=cost)


def ba_cost(problem: BAProblem, *, axis_name: str | None = None) -> jax.Array:
    """Total robust cost at the current state (Huber on observations, plus
    the motion-prior quadratic when present) — the objective whose IRLS
    weights the GN step uses, so LM accept/reject is consistent with it.

    axis_name: as in ba_step — running inside shard_map with the keyframe
    axis sharded. The per-observation cost is summed locally then psum'd;
    the motion-prior chains cross shard boundaries, so poses are gathered
    and the (replicated, identical-on-every-device) prior cost added once.
    """
    M = problem.eta.shape[0]
    delta = jnp.float32(HUBER_DELTA)

    def per_frame(Ri, ti, n_obs, d_obs, lm, w):
        eta_sel = problem.eta[jnp.clip(lm, 0, M - 1)]
        r, _, _ = jax.vmap(_residual_and_jac, in_axes=(None, None, 0, 0, 0))(
            Ri, ti, eta_sel, n_obs, d_obs)
        s = jnp.sqrt(jnp.sum(r * r, -1) + 1e-12)
        huber = jnp.where(s <= delta, s * s, delta * (2.0 * s - delta))
        return jnp.sum(w * huber)

    cost = jnp.sum(jax.vmap(per_frame)(
        problem.R, problem.t, problem.obs_normal, problem.obs_d,
        problem.obs_lm, problem.obs_w))
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)
    if problem.odo_R is not None or problem.cv_w is not None:
        if axis_name is not None:
            R_all = jax.lax.all_gather(problem.R, axis_name, axis=0, tiled=True)
            t_all = jax.lax.all_gather(problem.t, axis_name, axis=0, tiled=True)
        else:
            R_all, t_all = problem.R, problem.t
    if problem.odo_R is not None:
        *_, odo_cost = _odo_blocks(R_all, t_all, problem.odo_R,
                                   problem.odo_t, problem.odo_w)
        cost = cost + odo_cost
    if problem.cv_w is not None:
        *_, cv_cost = _cv_blocks(R_all, t_all, problem.cv_w)
        cost = cost + cv_cost
    return cost


def _lm_loop(problem: BAProblem, iterations: int, damping: float,
             axis_name: str | None) -> BAState:
    """The Levenberg-Marquardt accept/reject loop, per-device body.

    With axis_name set this runs INSIDE shard_map: ba_step/ba_cost psum
    their global reductions, so new_cost (and hence the accept decision and
    the damping schedule) is identical on every device — the loop stays in
    lockstep without any extra synchronization."""

    def body(_, carry):
        prob, lam, cost = carry
        cand = ba_step(prob, damping=lam, axis_name=axis_name)
        cand_prob = prob._replace(R=cand.R, t=cand.t, eta=cand.eta)
        new_cost = ba_cost(cand_prob, axis_name=axis_name)
        accept = new_cost < cost
        prob = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), cand_prob, prob)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-8), lam * 10.0)
        return prob, lam, jnp.where(accept, new_cost, cost)

    init = (problem, jnp.float32(damping),
            ba_cost(problem, axis_name=axis_name))
    final, _, cost = jax.lax.fori_loop(0, iterations, body, init)
    return BAState(R=final.R, t=final.t, eta=final.eta, cost=cost)


def run_ba(problem: BAProblem, *, iterations: int = 10, damping: float = 1e-4):
    """Levenberg-Marquardt BA: Gauss-Newton steps with accept/reject damping.

    Each iteration computes the Schur-eliminated GN step at the current
    damping; the step is ACCEPTED only if it lowers the total cost
    (damping /= 3), otherwise rejected (damping *= 10). A plain
    fixed-damping GN loop diverges on poorly conditioned real problems
    (weak fragment landmarks, near-degenerate observation geometry); the
    reject path makes the iteration monotone in cost, which is what an
    always-on SLAM backend needs. Runs as one jitted fori_loop."""
    return _lm_loop(problem, iterations, damping, None)


def pad_problem_keyframes(problem: BAProblem, K_pad: int) -> BAProblem:
    """Pad the keyframe axis to K_pad with inert keyframes.

    Padded poses are identity with zero-weight observations; padded
    motion-prior edges/triples get weight 0, so they contribute nothing to
    any residual, Jacobian, or cost — only the damping term touches their
    Schur diagonal (keeping it invertible, step exactly 0). Used so the
    keyframe axis divides the mesh in run_ba_sharded."""
    K = problem.obs_d.shape[0]
    if K_pad == K:
        return problem
    if K_pad < K:
        raise ValueError(f"K_pad {K_pad} < K {K}")
    pk = K_pad - K
    P = problem.obs_d.shape[1]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=problem.R.dtype), (pk, 3, 3))
    out = problem._replace(
        R=jnp.concatenate([problem.R, eye]),
        t=jnp.concatenate([problem.t, jnp.zeros((pk, 3), problem.t.dtype)]),
        obs_normal=jnp.concatenate(
            [problem.obs_normal, jnp.zeros((pk, P, 3), problem.obs_normal.dtype)]),
        obs_d=jnp.concatenate(
            [problem.obs_d, jnp.zeros((pk, P), problem.obs_d.dtype)]),
        obs_lm=jnp.concatenate(
            [problem.obs_lm, jnp.zeros((pk, P), problem.obs_lm.dtype)]),
        obs_w=jnp.concatenate(
            [problem.obs_w, jnp.zeros((pk, P), problem.obs_w.dtype)]))
    if problem.odo_R is not None:
        odo_eye = jnp.broadcast_to(jnp.eye(3, dtype=problem.odo_R.dtype),
                                   (pk, 3, 3))
        out = out._replace(
            odo_R=jnp.concatenate([problem.odo_R, odo_eye]),
            odo_t=jnp.concatenate(
                [problem.odo_t, jnp.zeros((pk, 3), problem.odo_t.dtype)]),
            odo_w=jnp.concatenate(
                [problem.odo_w, jnp.zeros(pk, problem.odo_w.dtype)]))
    if problem.cv_w is not None:
        out = out._replace(cv_w=jnp.concatenate(
            [problem.cv_w, jnp.zeros(pk, problem.cv_w.dtype)]))
    return out


def run_ba_sharded(problem: BAProblem, mesh=None, *, axis: str = "kf",
                   iterations: int = 10, damping: float = 1e-4) -> BAState:
    """run_ba with the KEYFRAME axis sharded over a device mesh.

    The full LM accept/reject loop executes under shard_map: each device
    holds K/n keyframes' observations and does that shard's Jacobian /
    outer-product work; Schur blocks combine with psum/all_gather over the mesh
    (ba_step), and the psum'd cost keeps the damping schedule in lockstep
    (_lm_loop). Landmarks (eta) and the motion-prior chains are replicated
    — they are O(M + K) small; the per-observation work is the O(K*P)
    expensive part. The keyframe axis is padded to a multiple of the mesh
    size with inert keyframes (pad_problem_keyframes) and the result is
    sliced back, so any K works on any mesh.

    mesh=None builds a 1-D mesh over all visible devices. Semantics match
    run_ba to GN accuracy (collective reduction order differs from the
    dense sum, so agreement is not bitwise) — asserted driver-level in
    tests/test_slam_frontend.py and structurally in __graft_entry__.
    """
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from jax import shard_map

    if mesh is None:
        mesh = Mesh(np.array(jax.devices()), axis_names=(axis,))
    n = mesh.shape[axis]
    K = problem.obs_d.shape[0]
    Kp = ((K + n - 1) // n) * n
    if Kp != K and jax.process_count() > 1:
        # Host-side concatenation of globally-sharded arrays is not a
        # well-defined multi-process operation; the multi-host caller
        # (e.g. parallel/verify.py) places inputs with K already a
        # multiple of the mesh.
        raise ValueError(
            f"multi-process run_ba_sharded needs K ({K}) divisible by the "
            f"mesh ({n}); pad the problem before placing it")
    prob = pad_problem_keyframes(problem, Kp)

    kf = P(axis)
    rep = P()
    # None fields must stay None in the spec tree (empty pytree subtrees).
    in_spec = BAProblem(
        R=kf, t=kf, eta=rep, obs_normal=kf, obs_d=kf, obs_lm=kf, obs_w=kf,
        odo_R=None if prob.odo_R is None else rep,
        odo_t=None if prob.odo_t is None else rep,
        odo_w=None if prob.odo_w is None else rep,
        cv_w=None if prob.cv_w is None else rep)
    out_spec = BAState(R=kf, t=kf, eta=rep, cost=rep)

    fn = jax.jit(shard_map(
        lambda p: _lm_loop(p, iterations, damping, axis),
        mesh=mesh, in_specs=(in_spec,), out_specs=out_spec,
        # Scan carries start replicated and become device-varying; psum /
        # all_gather placement is validated by the agreement tests instead.
        check_vma=False))
    # Place inputs to match the specs (avoids a resharding copy per call).
    # Leaves the multi-host caller already placed (jax.Arrays with the
    # matching sharding, e.g. via make_array_from_process_local_data) pass
    # through — device_put cannot place host data onto non-addressable
    # devices.
    def place(x, s):
        target = NamedSharding(mesh, s)
        if isinstance(x, jax.Array) and x.sharding == target:
            return x
        return jax.device_put(x, target)

    prob = jax.tree.map(place, prob, in_spec)
    out = fn(prob)
    if Kp == K:
        # No padding: return as-is (multi-process outputs stay globally
        # sharded; slicing them eagerly would require full addressability).
        return out
    return BAState(R=out.R[:K], t=out.t[:K], eta=out.eta, cost=out.cost)
