"""Cylinder extraction (CAPE's second primitive — beyond reference parity).

The cited CAPE paper (Proenca & Gao, IROS 2018) extracts cylinders as well
as planes, but the reference implements planes only (SURVEY.md: "cylinder"
appears nowhere in its code). deplex-tpu adds the cylinder stage,
reusing the growing machinery:

  * Candidate regions are growing ROUNDS that passed the size gate but
    FAILED the planarity-score gate (finalize_rounds rejects them for
    planes) — i.e. smooth-but-curved surfaces, exactly CAPE's candidates.
  * Per candidate (vectorized over ALL rounds at once):
      - axis = eigenvector of the smallest eigenvalue of the region's
        normal covariance (cylinder surface normals are orthogonal to the
        axis, so they span a disc perpendicular to it);
      - cell centroids are projected onto the plane orthogonal to the
        axis and a circle is fitted by the Kasa algebraic least-squares
        (one 3x3 solve per round);
      - acceptance: enough cells, RMSE of (radial distance - r) under a
        radius-relative tolerance, and plausible radius.
  * Labels: cells of accepted cylinders get cylinder ids 1..C in a label
    map of their own (planes and cylinders stay separate label spaces,
    mirroring CAPE's output).

Everything is fixed-shape: max_cylinders slots, rounds bound by
max_region_growing_rounds.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deplex_tpu.config import Config
from deplex_tpu.ops.cellstats import CellStats
from deplex_tpu.ops.eigh3x3 import eigh3x3_min
from deplex_tpu.ops.growing import RoundData, _SIZE, _N
from deplex_tpu.precision import HIGHEST


class CylinderSegments(NamedTuple):
    """Fixed-capacity cylinder slots (index 0 = cylinder 1)."""

    nr_cylinders: jax.Array   # () int32
    axis: jax.Array           # (MAXC, 3) unit axis direction
    center: jax.Array         # (MAXC, 3) a point on the axis
    radius: jax.Array         # (MAXC,)
    rmse: jax.Array           # (MAXC,) radial RMSE
    size: jax.Array           # (MAXC,) member cell count


def extract_cylinders(stats: CellStats, rounds: RoundData, config: Config):
    """Fit cylinders to plane-rejected rounds.

    Returns (cyl_labels_map (gh, gw) int32, CylinderSegments). Label 0 =
    no cylinder.
    """
    gh, gw = stats.planar.shape
    R_MAX = rounds.sums.shape[0]
    MAXC = config.max_cylinders

    # Recompute the plane gates to find candidates (cheap; avoids coupling
    # to finalize_rounds internals).
    from deplex_tpu.ops.growing import _fit_plane, _SX, _XX

    sums = rounds.sums
    n = jnp.maximum(sums[:, _N], 1.0)
    coord_sum = sums[:, _SX:_SX + 3]
    sc = sums[:, _XX:_XX + 6]
    scatter = jnp.stack([
        jnp.stack([sc[:, 0], sc[:, 1], sc[:, 2]], -1),
        jnp.stack([sc[:, 1], sc[:, 3], sc[:, 4]], -1),
        jnp.stack([sc[:, 2], sc[:, 4], sc[:, 5]], -1),
    ], -2)
    size = sums[:, _SIZE]
    _, mean_r, _, mse_r, score = _fit_plane(scatter, coord_sum, n)
    live = jnp.arange(R_MAX) < rounds.nr_rounds
    # CAPE's candidate rule: a smooth region is tried as a cylinder when it
    # is a POOR plane — low planarity score (not elongated enough) or plane
    # MSE above the depth-adaptive sensor band (an extended curved surface
    # can still score high on elongation but fits a plane badly).
    sigma = (config.depth_sigma_coeff * mean_r[:, 2] ** 2
             + config.depth_sigma_margin)
    bad_plane = ((score <= config.min_region_planarity_score)
                 | (mse_r > sigma * sigma))
    candidate = live & (size >= config.min_cylinder_cells) & bad_plane

    # Per-round one-hot over cells: (R_MAX, gh*gw).
    rm = rounds.round_map.reshape(-1)
    onehot = (rm[None, :] == jnp.arange(R_MAX)[:, None]).astype(jnp.float32)

    normals = stats.normal.reshape(-1, 3)
    means = stats.mean.reshape(-1, 3)

    # --- axis: smallest-eigenvalue direction of the normal covariance ---
    ncov = jnp.einsum("rc,ci,cj->rij", onehot, normals, normals, precision=HIGHEST)
    _, axis = eigh3x3_min(ncov)                             # (R_MAX, 3)

    # --- orthonormal basis (u, v) of the plane orthogonal to axis ---
    ref = jnp.where(jnp.abs(axis[:, :1]) < 0.9,
                    jnp.array([1.0, 0.0, 0.0]), jnp.array([0.0, 1.0, 0.0]))
    u = jnp.cross(axis, ref)
    u = u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-12)
    v = jnp.cross(axis, u)

    # --- project member centroids, Kasa circle fit per round ---
    px = jnp.einsum("ci,ri->rc", means, u, precision=HIGHEST)                  # (R_MAX, cells)
    py = jnp.einsum("ci,ri->rc", means, v, precision=HIGHEST)
    w = onehot
    cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    # Center per round before forming the normal equations: raw projected
    # coordinates are O(1e3) mm, so uncentered moments reach 1e12 and the
    # f32 3x3 solve loses the circle entirely.
    mx_c = jnp.sum(w * px, axis=1) / cnt
    my_c = jnp.sum(w * py, axis=1) / cnt
    px = (px - mx_c[:, None]) * w
    py = (py - my_c[:, None]) * w
    b = px * px + py * py
    # Normal equations for [2cx, 2cy, r^2 - |c|^2] with design [x, y, 1].
    Sxx = jnp.einsum("rc,rc,rc->r", w, px, px, precision=HIGHEST)
    Sxy = jnp.einsum("rc,rc,rc->r", w, px, py, precision=HIGHEST)
    Syy = jnp.einsum("rc,rc,rc->r", w, py, py, precision=HIGHEST)
    Sx = jnp.einsum("rc,rc->r", w, px, precision=HIGHEST)
    Sy = jnp.einsum("rc,rc->r", w, py, precision=HIGHEST)
    Sb = jnp.einsum("rc,rc->r", w, b, precision=HIGHEST)
    Sxb = jnp.einsum("rc,rc,rc->r", w, px, b, precision=HIGHEST)
    Syb = jnp.einsum("rc,rc,rc->r", w, py, b, precision=HIGHEST)
    A = jnp.stack([
        jnp.stack([Sxx, Sxy, Sx], -1),
        jnp.stack([Sxy, Syy, Sy], -1),
        jnp.stack([Sx, Sy, cnt], -1),
    ], -2)                                                   # (R_MAX, 3, 3)
    rhs = jnp.stack([Sxb, Syb, Sb], -1)
    A = A + 1e-6 * jnp.eye(3) * jnp.maximum(
        jnp.trace(A, axis1=-2, axis2=-1), 1.0)[:, None, None] / 3.0
    sol = jnp.linalg.solve(A, rhs[..., None])[..., 0]        # (R_MAX, 3)
    cx, cy = sol[:, 0] / 2.0, sol[:, 1] / 2.0
    r2 = sol[:, 2] + cx * cx + cy * cy
    radius = jnp.sqrt(jnp.maximum(r2, 0.0))

    # --- radial residual ---
    dist = jnp.sqrt(jnp.maximum((px - cx[:, None]) ** 2
                                + (py - cy[:, None]) ** 2, 1e-12))
    res = (dist - radius[:, None]) ** 2
    rmse = jnp.sqrt(jnp.einsum("rc,rc->r", w, res, precision=HIGHEST) / cnt)

    ok = (candidate & jnp.isfinite(radius) & (radius > 0)
          & (rmse <= jnp.maximum(config.cylinder_rmse_max,
                                 config.cylinder_rmse_rel * radius))
          # The cylinder must explain the region decisively better than the
          # plane fit did (CAPE prefers the lower-residual primitive).
          & (rmse * rmse < mse_r))

    slot = jnp.cumsum(ok.astype(jnp.int32)) - 1
    ok = ok & (slot < MAXC)
    nr = jnp.sum(ok).astype(jnp.int32)

    # Cylinder center in 3D: axis point closest to the projected center
    # (undo the per-round centering shift).
    center3d = (cx + mx_c)[:, None] * u + (cy + my_c)[:, None] * v

    # Labels per cell.
    label_of_round = jnp.where(ok, slot + 1, 0).astype(jnp.int32)
    lut = jnp.concatenate([jnp.zeros(1, jnp.int32), label_of_round])
    cyl_labels_map = lut[rounds.round_map + 1]

    sel = (ok[:, None] & (slot[:, None] == jnp.arange(MAXC)[None, :])
           ).astype(jnp.float32)                             # (R_MAX, MAXC)
    seg = CylinderSegments(
        nr_cylinders=nr,
        axis=jnp.einsum("rm,ri->mi", sel, axis, precision=HIGHEST),
        center=jnp.einsum("rm,ri->mi", sel, center3d, precision=HIGHEST),
        radius=jnp.einsum("rm,r->m", sel, radius, precision=HIGHEST),
        rmse=jnp.einsum("rm,r->m", sel, rmse, precision=HIGHEST),
        size=jnp.einsum("rm,r->m", sel, size, precision=HIGHEST),
    )
    return cyl_labels_map, seg
