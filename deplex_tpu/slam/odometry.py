"""Plane-based pose estimation (frame-to-map odometry).

Given associated (observation, landmark) plane pairs, estimate the camera
pose T_cw = (R, t) by Gauss-Newton on the plane residual

    r = [ w_n * (R n_w - n_obs) ;  w_d * (d_w - (R n_w).t - d_obs) ]

(the direct linearization of the transform convention in slam/planes.py).
Fixed-iteration lax.fori_loop, damped normal equations via 6x6 solve —
all dense, jit/vmap-friendly. This is a new capability: the reference has
no pose estimation at all (SURVEY.md §2.4: per-frame extraction only).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deplex_tpu.slam.lie import se3_exp, so3_exp
from deplex_tpu.slam.planes import PlaneObs
from deplex_tpu.precision import HIGHEST


class OdometryResult(NamedTuple):
    R: jax.Array          # (3, 3) camera-from-world rotation
    t: jax.Array          # (3,) camera-from-world translation
    num_inliers: jax.Array
    residual: jax.Array   # final weighted squared residual


def estimate_pose(obs: PlaneObs, lm_normal: jax.Array, lm_d: jax.Array,
                  match_lm: jax.Array, match_valid: jax.Array,
                  R0: jax.Array, t0: jax.Array, *, iterations: int = 8,
                  damping: float = 1e-3, normal_weight: float = 1000.0,
                  offset_weight: float = 1.0) -> OdometryResult:
    """Gauss-Newton refinement of (R0, t0) from matched planes.

    obs: frame observations; lm_*: (M,) world landmarks; match_lm (MAXP,)
    landmark index per observation (-1 = none), match_valid (MAXP,) bool.
    normal_weight balances the unitless normal residual against the
    depth-unit offset residual.
    """
    idx = jnp.clip(match_lm, 0, lm_d.shape[0] - 1)
    n_w = lm_normal[idx]                                   # (P, 3)
    d_w = lm_d[idx]                                        # (P,)
    # Support-weighted: a plane observed by many pixels constrains the pose
    # more than a small fragment (sqrt keeps one huge plane from dominating).
    w = jnp.where(match_valid & (obs.weight > 0),
                  jnp.sqrt(jnp.maximum(obs.weight, 0.0)), 0.0)
    # Normalize so H's scale is O(1): keeps the relative damping meaningful
    # and the 6x6 f32 solve well-conditioned.
    w = w / jnp.maximum(jnp.sum(w), 1e-6)

    wn = jnp.float32(normal_weight)
    wd = jnp.float32(offset_weight)

    def residuals(R, t):
        n_pred = jnp.matmul(n_w, R.T, precision=HIGHEST)                                 # (P, 3)
        d_pred = d_w - jnp.matmul(n_pred, t, precision=HIGHEST)                          # (P,)
        rn = (n_pred - obs.normal) * wn                    # (P, 3)
        rd = (d_pred - obs.d) * wd                         # (P,)
        return rn, rd, n_pred

    def body(_, state):
        R, t = state
        rn, rd, n_pred = residuals(R, t)
        # Huber robustification: matches whose residual exceeds the scale
        # (likely misassociations) get downweighted instead of dragging the
        # solution (delta in the combined normal+offset residual norm).
        r_norm = jnp.sqrt(jnp.sum(rn * rn, -1) + rd * rd + 1e-12)
        delta = jnp.float32(100.0)
        w_rob = w * jnp.minimum(1.0, delta / r_norm)
        # Jacobians wrt xi = (phi, rho), update on the left: R' = exp(phi) R.
        # d(n_pred)/dphi = -[n_pred]x ; d(d_pred)/dphi = ([n_pred]x t) . (.)
        # d(d_pred)/drho = -n_pred
        px, py, pz = n_pred[:, 0], n_pred[:, 1], n_pred[:, 2]
        zeros = jnp.zeros_like(px)
        # -hat(n_pred): (P, 3, 3)
        Jn_phi = jnp.stack([
            jnp.stack([zeros, pz, -py], -1),
            jnp.stack([-pz, zeros, px], -1),
            jnp.stack([py, -px, zeros], -1),
        ], -2) * wn
        cross_pt = jnp.cross(n_pred, jnp.broadcast_to(t, n_pred.shape))
        Jd_phi = cross_pt * wd                             # (P, 3)
        Jd_rho = -n_pred * wd                              # (P, 3)

        # Accumulate H (6x6) and b (6,) with per-match weights.
        Jn = jnp.concatenate([Jn_phi, jnp.zeros_like(Jn_phi)], axis=-1)  # (P,3,6)
        Jd = jnp.concatenate([Jd_phi, Jd_rho], axis=-1)                  # (P,6)
        H = (jnp.einsum("p,pik,pil->kl", w_rob, Jn, Jn, precision=HIGHEST)
             + jnp.einsum("p,pk,pl->kl", w_rob, Jd, Jd, precision=HIGHEST))
        b = (jnp.einsum("p,pik,pi->k", w_rob, Jn, rn, precision=HIGHEST)
             + jnp.einsum("p,pk,p->k", w_rob, Jd, rd, precision=HIGHEST))
        # Marquardt diagonal damping: each parameter is damped relative to
        # its own curvature, so the (unit-scale) rotation block can't crush
        # the (mm-scale) translation block; a tiny absolute floor keeps
        # fully unobserved directions at zero update.
        diag = jnp.diagonal(H)
        H = H + jnp.diag(damping * diag + 1e-8 * jnp.maximum(jnp.max(diag), 1.0))
        xi = -jnp.linalg.solve(H, b)
        xi = jnp.where(jnp.isfinite(xi), xi, 0.0)
        dR, dt = se3_exp(xi)
        return (jnp.matmul(dR, R, precision=HIGHEST),
                jnp.einsum("ij,j->i", dR, t, precision=HIGHEST) + dt)

    R, t = jax.lax.fori_loop(0, iterations, body, (R0, t0))
    rn, rd, _ = residuals(R, t)
    res = jnp.sum(w * (jnp.sum(rn * rn, -1) + rd * rd))
    n_used = jnp.sum((w > 0).astype(jnp.int32))
    return OdometryResult(R=R, t=t, num_inliers=n_used, residual=res)
