"""SO(3)/SE(3) Lie-group operations, batched and jit-friendly.

The SLAM backend (new capability; the reference library is
stateless per-frame extraction only — SURVEY.md §5.7) parameterizes pose
updates in the se(3) tangent space. Everything here is closed-form,
branch-free (Taylor fallbacks via jnp.where), and batch-broadcastable.

Convention: xi = (rho, phi) with translation part first is NOT used; we use
xi[..., :3] = phi (rotation), xi[..., 3:] = t update applied as
T' = exp(xi) @ T with exp acting on (R, t) pairs.
"""

from __future__ import annotations

import jax.numpy as jnp
from deplex_tpu.precision import HIGHEST


def hat(phi: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack([
        jnp.stack([zero, -z, y], -1),
        jnp.stack([z, zero, -x], -1),
        jnp.stack([-y, x, zero], -1),
    ], -2)


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2)
    small = theta2 < 1e-12
    # sin(t)/t and (1-cos t)/t^2 with series fallbacks near 0.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2))
    K = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a * K + b * (jnp.matmul(K, K, precision=HIGHEST))


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) rotation -> (..., 3) axis-angle (|phi| < pi).

    Derivative-safe at theta -> 0 (the fixed point GN converges to):
    arccos has an infinite tangent at cos = 1, so near identity every term
    is computed from the skew vector w (|w| = 2 sin theta) instead — both
    value and jacfwd/jacrev tangents stay finite. theta ~ pi is outside the
    supported range (plane-SLAM residual rotations are small).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = (trace - 1.0) / 2.0
    w = jnp.stack([R[..., 2, 1] - R[..., 1, 2],
                   R[..., 0, 2] - R[..., 2, 0],
                   R[..., 1, 0] - R[..., 0, 1]], -1)
    small = cos_t > 1.0 - 1e-6
    # Exact branch with arccos input bounded away from +-1 where selected.
    cos_safe = jnp.clip(jnp.where(small, 0.0, cos_t), -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_safe)
    scale_exact = theta / (2.0 * jnp.sin(theta))
    # Small branch: theta^2 ~ |w|^2/4 (NaN-free tangents through sqrt-free path).
    s2 = jnp.sum(w * w, axis=-1) / 4.0
    scale_small = 0.5 + s2 / 12.0
    scale = jnp.where(small, scale_small, scale_exact)
    return w * scale[..., None]


def se3_exp(xi: jnp.ndarray):
    """(..., 6) twist (phi, rho) -> (R (...,3,3), t (...,3))."""
    phi, rho = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)[..., None]
    theta = jnp.sqrt(theta2)
    small = theta2 < 1e-12
    K = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), K.shape)
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2))
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - jnp.sin(theta)) / jnp.where(small, 1.0, theta2 * theta))
    V = eye + b * K + c * (jnp.matmul(K, K, precision=HIGHEST))
    t = jnp.einsum("...ij,...j->...i", V, rho, precision=HIGHEST)
    return R, t


def se3_apply(R: jnp.ndarray, t: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply (R, t) to points p (..., 3)."""
    return jnp.einsum("...ij,...j->...i", R, p, precision=HIGHEST) + t


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) ∘ (Rb, tb): first apply b, then a."""
    return (jnp.matmul(Ra, Rb, precision=HIGHEST),
            jnp.einsum("...ij,...j->...i", Ra, tb, precision=HIGHEST) + ta)


def se3_inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision=HIGHEST)
