"""Pose-graph optimization over SE(3) relative-pose constraints.

Backend counterpart to ba.py for loop-closure style problems: nodes are
keyframe poses, edges carry measured relative transforms. Residual for edge
(a, b) with measurement (R_ab, t_ab):

    r = log_se3( (T_a^-1 T_b)^-1 * T_ab^meas )   in R^6 (approximated by
        the first-order split: so3_log of the rotation part + translation
        difference — standard chordal-style GN that converges for the
        small-error regime of odometry chains with loop closures).

Gauss-Newton with Jacobians from jax.jacfwd, fixed iterations, dense
(6K x 6K) solve — K is a keyframe window (<= a few hundred), so the solve
is tiny. Edges are stored as fixed-capacity arrays with weights
(0 = padding); sharding the EDGE axis over a mesh and psum-ing H and b
distributes the Jacobian work (pose_graph_step's axis_name, same pattern
as ba.ba_step).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deplex_tpu.slam.lie import se3_exp, so3_log
from deplex_tpu.precision import HIGHEST


class PoseGraph(NamedTuple):
    R: jax.Array        # (K, 3, 3) node rotations (world-from-key or any fixed convention)
    t: jax.Array        # (K, 3)
    edge_a: jax.Array   # (E,) int32 source node
    edge_b: jax.Array   # (E,) int32 target node
    meas_R: jax.Array   # (E, 3, 3) measured R_a^-1 R_b
    meas_t: jax.Array   # (E, 3) measured t in a's frame
    weight: jax.Array   # (E,) edge weights, 0 = padding
    cv_w: jax.Array | None = None  # (K-2,) constant-velocity prior weights


# Rotation residuals are radians, translations are depth units (mm for
# TUM); unscaled, a 1-degree edge rotation error (0.017^2) is invisible
# next to a 10 mm translation error (100), so the optimizer would trade
# large rotation drift for tiny translation gains — and rotation drift
# integrates into position error over the chain. 1000 equates 1 rad to
# 1000 mm of error: the position displacement that rotating a typical
# indoor scene (~meters deep) induces.
ROT_SCALE = 1000.0
# Huber scale on the scaled 6-residual norm (same units as translation).
HUBER_DELTA = 50.0


def _edge_residual(Ra, ta, Rb, tb, mR, mt):
    """Scaled 6-residual of one edge given node poses."""
    R_ab = jnp.matmul(Ra.T, Rb, precision=HIGHEST)
    t_ab = jnp.matmul(Ra.T, tb - ta, precision=HIGHEST)
    r_rot = so3_log(jnp.matmul(mR.T, R_ab, precision=HIGHEST)) * ROT_SCALE
    r_tr = t_ab - mt
    return jnp.concatenate([r_rot, r_tr])


def pose_graph_step(g: PoseGraph, *, damping: float = 1e-5,
                    axis_name: str | None = None) -> PoseGraph:
    """One damped GN step; node 0 gauge-fixed. Edge axis may be sharded."""
    K = g.R.shape[0]

    def residual_wrt_updates(xi_a, xi_b, Ra, ta, Rb, tb, mR, mt):
        dRa, dta = se3_exp(xi_a)
        dRb, dtb = se3_exp(xi_b)
        return _edge_residual(jnp.matmul(dRa, Ra, precision=HIGHEST),
                              jnp.matmul(dRa, ta, precision=HIGHEST) + dta,
                              jnp.matmul(dRb, Rb, precision=HIGHEST),
                              jnp.matmul(dRb, tb, precision=HIGHEST) + dtb, mR, mt)

    zeros6 = jnp.zeros(6, dtype=g.t.dtype)

    def per_edge(a, b, mR, mt, w):
        Ra, ta = g.R[a], g.t[a]
        Rb, tb = g.R[b], g.t[b]
        r = residual_wrt_updates(zeros6, zeros6, Ra, ta, Rb, tb, mR, mt)
        # Huber IRLS: an edge whose current residual is far off (bad loop
        # closure that survived the frontend gate) is downweighted each
        # iteration instead of bending the whole chain toward it.
        r_norm = jnp.sqrt(jnp.sum(r * r) + 1e-12)
        w = w * jnp.minimum(1.0, HUBER_DELTA / r_norm)
        Ja = jax.jacfwd(residual_wrt_updates, argnums=0)(
            zeros6, zeros6, Ra, ta, Rb, tb, mR, mt)
        Jb = jax.jacfwd(residual_wrt_updates, argnums=1)(
            zeros6, zeros6, Ra, ta, Rb, tb, mR, mt)
        return r * w, Ja * w, Jb * w

    r, Ja, Jb = jax.vmap(per_edge)(g.edge_a, g.edge_b, g.meas_R, g.meas_t,
                                   g.weight)

    # Dense assembly via one-hot node selectors (K small).
    onehot_a = (g.edge_a[:, None] == jnp.arange(K)[None, :]).astype(r.dtype)
    onehot_b = (g.edge_b[:, None] == jnp.arange(K)[None, :]).astype(r.dtype)
    # J_e stacked into global column space: J_global[e] = 1_a(x)Ja + 1_b(x)Jb.
    H = (jnp.einsum("ea,eik,eb,eil->akbl", onehot_a, Ja, onehot_a, Ja, precision=HIGHEST)
         + jnp.einsum("ea,eik,eb,eil->akbl", onehot_a, Ja, onehot_b, Jb, precision=HIGHEST)
         + jnp.einsum("ea,eik,eb,eil->akbl", onehot_b, Jb, onehot_a, Ja, precision=HIGHEST)
         + jnp.einsum("ea,eik,eb,eil->akbl", onehot_b, Jb, onehot_b, Jb, precision=HIGHEST))
    b_vec = (jnp.einsum("ea,eik,ei->ak", onehot_a, Ja, r, precision=HIGHEST)
             + jnp.einsum("ea,eik,ei->ak", onehot_b, Jb, r, precision=HIGHEST))

    if axis_name is not None:
        H = jax.lax.psum(H, axis_name)
        b_vec = jax.lax.psum(b_vec, axis_name)

    # Constant-velocity priors over node triples (same motion model as
    # ba._cv_residual, in this module's world-from-camera convention:
    # camera center IS t). Measurement-free second-order smoothness that
    # averages per-frame jitter along weakly-observed directions.
    if g.cv_w is not None:
        def cv_residual(xi_a, xi_b, xi_c, Ra, ta, Rb, tb, Rc, tc):
            dRa, dta = se3_exp(xi_a)
            dRb, dtb = se3_exp(xi_b)
            dRc, dtc = se3_exp(xi_c)
            def mm(a, b):
                return jnp.matmul(a, b, precision=HIGHEST)

            R_a, t_a = mm(dRa, Ra), mm(dRa, ta) + dta
            R_b, t_b = mm(dRb, Rb), mm(dRb, tb) + dtb
            R_c, t_c = mm(dRc, Rc), mm(dRc, tc) + dtc
            r_rot = so3_log(mm(mm(R_b.T, R_c), mm(R_a.T, R_b).T)) * ROT_SCALE
            r_tr = (t_c - t_b) - (t_b - t_a)
            return jnp.concatenate([r_rot, r_tr])

        def per_triple(Ra, ta, Rb, tb, Rc, tc, w):
            args = (zeros6, zeros6, zeros6, Ra, ta, Rb, tb, Rc, tc)
            r = cv_residual(*args)
            Js = [jax.jacfwd(cv_residual, argnums=i)(*args) for i in range(3)]
            return jnp.stack(Js), r

        J, r_cv = jax.vmap(per_triple)(
            g.R[:-2], g.t[:-2], g.R[1:-1], g.t[1:-1], g.R[2:], g.t[2:],
            g.cv_w)
        idx = jnp.arange(K - 2)
        w = g.cv_w
        for a in range(3):
            b_vec = b_vec.at[idx + a].add(
                jnp.einsum("e,eik,ei->ek", w, J[:, a], r_cv, precision=HIGHEST))
            for c in range(3):
                H = H.at[idx + a, :, idx + c, :].add(
                    jnp.einsum("e,eik,eil->ekl", w, J[:, a], J[:, c], precision=HIGHEST))

    # Gauge fix node 0.
    mask = (jnp.arange(K) != 0).astype(H.dtype)
    H = H * mask[:, None, None, None] * mask[None, None, :, None]
    H = H.at[0, :, 0, :].set(jnp.eye(6, dtype=H.dtype))
    b_vec = b_vec * mask[:, None]

    Hd = H.reshape(K * 6, K * 6)
    # Marquardt diagonal damping + absolute floor (disconnected nodes).
    diag = jnp.diagonal(Hd)
    Hd = Hd + jnp.diag(damping * diag + 1e-8 * jnp.maximum(jnp.max(diag), 1.0))
    dx = -jnp.linalg.solve(Hd, b_vec.reshape(-1)).reshape(K, 6)
    dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
    # Trust region: Gauss-Newton on SO(3) residuals diverges on overshoot
    # (so3_log is only valid below pi); clamp per-node step norms.
    rot_n = jnp.linalg.norm(dx[:, :3], axis=1, keepdims=True)
    dx = dx.at[:, :3].multiply(jnp.minimum(1.0, 0.5 / jnp.maximum(rot_n, 1e-12)))
    tr_n = jnp.linalg.norm(dx[:, 3:], axis=1, keepdims=True)
    max_t = 10.0 * jnp.maximum(jnp.max(jnp.abs(g.meas_t)), 1.0)
    dx = dx.at[:, 3:].multiply(jnp.minimum(1.0, max_t / jnp.maximum(tr_n, 1e-12)))
    dR, dt = se3_exp(dx)
    return g._replace(R=jnp.matmul(dR, g.R, precision=HIGHEST),
                      t=jnp.einsum("kij,kj->ki", dR, g.t, precision=HIGHEST) + dt)


def optimize_pose_graph(g: PoseGraph, *, iterations: int = 20,
                        damping: float = 1e-5) -> PoseGraph:
    def body(_, graph):
        return pose_graph_step(graph, damping=damping)

    return jax.lax.fori_loop(0, iterations, body, g)


def graph_cost(g: PoseGraph) -> jax.Array:
    def per_edge(a, b, mR, mt, w):
        return w * jnp.sum(_edge_residual(g.R[a], g.t[a], g.R[b], g.t[b], mR, mt) ** 2)

    return jnp.sum(jax.vmap(per_edge)(g.edge_a, g.edge_b, g.meas_R, g.meas_t,
                                      g.weight))
