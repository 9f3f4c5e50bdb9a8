"""Plane-landmark parameterizations and frame transforms.

New capability (the reference extracts planes per frame and
discards them; its `deplex.association` namespace is an empty stub —
/root/reference/python/deplex/association/foo.py:4-5). The SLAM stack
represents an infinite plane as either

  * (n, d):  n . x + d = 0 with |n| = 1, d >= 0 (the extractor's output
    convention, cell_segment_stat.cpp:74-77), or
  * the closest-point (CP) vector  eta = -d * n  (the point on the plane
    nearest the origin) — a minimal 3-parameter encoding used by the BA
    backend (standard pi-SLAM parameterization; avoids the unit-norm
    constraint during Gauss-Newton).

Transform convention: T_cw = (R, t) maps world points into the camera,
x_c = R x_w + t. For planes: n_c = R n_w, d_c = d_w - n_c . t.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from deplex_tpu.precision import HIGHEST


class PlaneObs(NamedTuple):
    """Fixed-capacity per-frame plane observations (camera frame)."""

    normal: jax.Array   # (MAXP, 3) unit normals
    d: jax.Array        # (MAXP,) offsets (n.x + d = 0)
    weight: jax.Array   # (MAXP,) point-count weights; 0 = empty slot
    mean: jax.Array     # (MAXP, 3) centroids (for association gating)


def from_segments(segments) -> PlaneObs:
    """PlaneSegments (ops.growing) -> PlaneObs; empty slots get weight 0."""
    occupied = jnp.arange(segments.n.shape[0]) < segments.nr_planes
    w = jnp.where(occupied, segments.n, 0.0)
    return PlaneObs(normal=segments.normal, d=segments.d, weight=w,
                    mean=segments.mean)


def to_cp(normal: jax.Array, d: jax.Array) -> jax.Array:
    """(n, d) -> closest-point vector eta = -d n."""
    return -d[..., None] * normal


def from_cp(eta: jax.Array):
    """eta -> (n, d) with d = |eta| >= 0, n = -eta/|eta|.

    Degenerate eta ~ 0 (plane through origin) is guarded to +z; callers
    keep such landmarks masked out.
    """
    d = jnp.linalg.norm(eta, axis=-1)
    safe = d > 1e-12
    n = jnp.where(safe[..., None], -eta / jnp.where(safe, d, 1.0)[..., None],
                  jnp.array([0.0, 0.0, 1.0], eta.dtype))
    return n, d


def transform_plane(R: jax.Array, t: jax.Array, n_w: jax.Array, d_w: jax.Array):
    """World plane -> camera plane under x_c = R x_w + t (batched)."""
    n_c = jnp.einsum("...ij,...j->...i", R, n_w, precision=HIGHEST)
    d_c = d_w - jnp.sum(n_c * t, axis=-1)
    return n_c, d_c


def untransform_plane(R: jax.Array, t: jax.Array, n_c: jax.Array, d_c: jax.Array):
    """Camera plane -> world plane (inverse of transform_plane)."""
    n_w = jnp.einsum("...ji,...j->...i", R, n_c, precision=HIGHEST)
    d_w = d_c + jnp.sum(n_c * t, axis=-1)
    return n_w, d_w
