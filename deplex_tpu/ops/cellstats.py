"""Stage 1 — batched cell-grid statistics (planarity estimation).

Batched equivalent of the reference's per-cell serial loop
(cell_grid.cpp:36-43 + cell_segment.cpp:21-110 + cell_segment_stat.cpp:29-81):
instead of constructing a CellSegment object per cell, every gate and the PCA
plane fit are computed for ALL cells of the frame simultaneously as dense
(gh, gw)-shaped tensor ops, and the per-cell dsyevh3 calls become one batched
closed-form eigensolve.

Layout note: all per-cell reductions use the free reshape
(H, W) -> (gh, P, gw, P) (row-major compatible — a view, not a copy) and
reduce over the in-cell axes; the cell-contiguous transpose the reference
materializes (cell_grid.cpp:69-83, and an earlier version of this file)
never exists on device. In-cell pixel walks (depth continuity, cell
diameter) become strided image slices.

Semantics notes (kept bit-faithful to the reference):
  * Cell statistics count ALL patch pixels, including invalid (z == 0) points
    which back-project to (0,0,0) (cell_segment_stat.cpp:29-35 uses every row).
  * The valid-point gate is  count(z>0) >= (P*P*3) // min_pts_per_cell
    because MatrixX3f::size() is rows*cols (cell_segment.cpp:24).
  * Depth continuity walks LINEAR in-cell indices [P*P//2, P*P//2+P) and
    [P//2 :: P], carrying `prev` only across continuous valid pixels
    (cell_segment.cpp:62-97). For odd P the mid-row walk wraps into the next
    in-cell row exactly like the reference's flat indexing.
  * The covariance is the scatter matrix  X'X - s s'/n  (not divided by n);
    MSE = lambda_min/n, score = lambda_max/sum(lambda)
    (cell_segment_stat.cpp:56-80). We compute the scatter in centered form
    (exactly equal in exact arithmetic, far better conditioned in f32).
  * Merge tolerance = clamp(diam * sin(angle), 20, max_merge_dist)^2 with the
    20.0 lower bound hardcoded as in the reference (cell_segment.cpp:33,104-110).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deplex_tpu.config import Config
from deplex_tpu.ops.eigh3x3 import eigh3x3_min


class CellStats(NamedTuple):
    """Per-cell quantities, all shaped (gh, gw, ...)."""

    planar: jax.Array        # (gh, gw) bool
    normal: jax.Array        # (gh, gw, 3) unit normal, oriented so d >= 0
    mean: jax.Array          # (gh, gw, 3) mean over all P*P points
    d: jax.Array             # (gh, gw) plane offset, >= 0
    mse: jax.Array           # (gh, gw) lambda_min / n
    tol: jax.Array           # (gh, gw) squared merge tolerance
    nr_pts: jax.Array        # () scalar: points per cell (P*P)
    coord_sum: jax.Array     # (gh, gw, 3) sum of points
    scatter: jax.Array       # (gh, gw, 3, 3) centered second-moment matrix


class CellMoments(NamedTuple):
    """Raw per-cell moments, the intermediate between the pixel-level block
    reductions and the gate/eigensolve finalization. All shaped
    (gh, gw, ...)."""

    nr_valid: jax.Array      # (gh, gw) count of z > 0 points
    disc_h: jax.Array        # (gh, gw) mid-row depth discontinuities
    disc_v: jax.Array        # (gh, gw) mid-column depth discontinuities
    coord_sum: jax.Array     # (gh, gw, 3) sum of points (zeros included)
    scatter: jax.Array       # (gh, gw, 3, 3) centered second moments
    diam: jax.Array          # (gh, gw) first-to-last pixel distance


def finalize_cell_stats(m: CellMoments, P: int, config: Config) -> CellStats:
    """Shared tail: PCA eigensolve + all validity gates on (gh, gw) planes.

    Mirrors cell_segment.cpp:57-110 + cell_segment_stat.cpp:55-81 exactly
    (see the module docstring for the bit-faithfulness notes).
    """
    n = jnp.float32(P * P)
    valid_thr = (P * P * 3) // config.min_pts_per_cell
    has_valid = m.nr_valid >= valid_thr
    max_disc = config.max_number_depth_discontinuity
    continuous = (m.disc_h < max_disc) & (m.disc_v < max_disc)

    mean = m.coord_sum / n
    w, v = eigh3x3_min(m.scatter)
    d_raw = -jnp.sum(mean * v, axis=-1)
    flip = d_raw > 0
    normal = jnp.where(flip[..., None], v, -v)
    d = jnp.abs(d_raw)
    mse = w[..., 0] / n

    sigma = config.depth_sigma_coeff * mean[..., 2] ** 2 + config.depth_sigma_margin
    small_error = mse <= sigma * sigma
    planar = has_valid & continuous & small_error

    import math
    sin_angle = math.sqrt(max(0.0, 1.0 - min(config.min_cos_angle_merge, 1.0) ** 2))
    tol = jnp.clip(m.diam * sin_angle, 20.0, config.max_merge_dist) ** 2

    # Non-planar cells keep +inf MSE so they never win seed selection
    # (CellSegmentStat default, cell_segment_stat.cpp:27).
    mse = jnp.where(planar, mse, jnp.float32(jnp.finfo(jnp.float32).max))

    return CellStats(planar=planar, normal=normal, mean=mean, d=d, mse=mse,
                     tol=tol, nr_pts=n, coord_sum=m.coord_sum, scatter=m.scatter)


def compute_cell_stats(points: jax.Array, image_height: int, image_width: int,
                       config: Config) -> CellStats:
    """points: (H*W, 3) organized cloud -> per-cell statistics.

    All arithmetic in float32 on device; fully parallel over cells.
    """
    P = min(config.patch_size, min(image_height, image_width))
    return finalize_cell_stats(
        compute_cell_moments(points, image_height, image_width, config), P, config)


def compute_cell_moments(points: jax.Array, image_height: int, image_width: int,
                         config: Config) -> CellMoments:
    """points: (H*W, 3) organized cloud -> raw per-cell moments and gate
    counts (the pixel-level half of compute_cell_stats)."""
    H, W = image_height, image_width
    P = min(config.patch_size, min(H, W))
    gh, gw = H // P, W // P

    pts = jnp.asarray(points).reshape(H, W, 3)[: gh * P, : gw * P, :].astype(jnp.float32)
    x_img, y_img, z_img = pts[..., 0], pts[..., 1], pts[..., 2]

    def blocks(a):
        """(gh*P, gw*P) -> per-cell sum (gh, gw); reshape is a free view."""
        return jnp.sum(a.reshape(gh, P, gw, P), axis=(1, 3))

    # --- validity gate count ---
    nr_valid = blocks((z_img > 0).astype(jnp.float32))

    # --- depth continuity (carried-prev scans over strided slices) ---
    thr = jnp.float32(config.depth_discontinuity_threshold)
    mid = P * P // 2

    def scan_discontinuities(in_cell_indices):
        """Walk the given linear in-cell indices; count depth jumps."""

        def cell_slice(i):
            r, c = i // P, i % P
            return z_img[r::P, c::P]                     # (gh, gw)

        def body(carry, i):
            prev, disc = carry
            curr = cell_slice(i)
            pos = curr > 0
            cont = pos & (jnp.abs(curr - prev) < thr)
            prev = jnp.where(cont, curr, prev)
            disc = disc + (pos & ~cont)
            return (prev, disc), None

        init = (cell_slice(in_cell_indices[0]),
                jnp.zeros((gh, gw), dtype=jnp.int32))
        carry = init
        for i in in_cell_indices:
            carry, _ = body(carry, i)
        return carry[1]

    disc_h = scan_discontinuities([mid + t for t in range(P)])
    disc_v = scan_discontinuities([P // 2 + t * P for t in range(P)])

    # --- PCA plane fit over ALL P*P points (zeros included) ---
    coord_sum, scatter = cell_moments(x_img, y_img, z_img, P)

    # --- merge tolerance (cell diameter = first vs last pixel) ---
    first = pts[::P, ::P, :]
    last = pts[P - 1::P, P - 1::P, :]
    dd = first - last
    diam = jnp.sqrt(dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]
                    + dd[..., 2] * dd[..., 2])

    return CellMoments(nr_valid=nr_valid, disc_h=disc_h, disc_v=disc_v,
                       coord_sum=coord_sum, scatter=scatter, diam=diam)


def cell_moments(x_img, y_img, z_img, P: int):
    """Per-cell (coord_sum, scatter) as plain (gh, P, gw, P) block sums.

    Each cell's coordinates are anchored to its first pixel before the
    centered second moments: the scatter matrix is translation-invariant in
    exact arithmetic, and summing cell-local-small values instead of
    absolute coordinates shrinks the f32 rounding noise in λ_min (and the
    fitted normal) by ~2 orders of magnitude. On noiseless data (ICL-NUIM)
    λ_min is pure rounding noise, so this is what stabilizes seed selection
    — the P=4 conformance fix.

    The mean-centering is folded algebraically:
    Σ(xs-mx)(ys-my) = Σxs·ys - Σxs·Σys/n with mx = Σxs/n, so the pixels are
    read once. The subtrahend is O(mean²/extent²) ~ 4x the result, which
    costs ~2 of the bits the anchoring buys; the folded diagonal entries
    are clamped at 0, where that rounding could otherwise leave them
    slightly negative.
    """
    Hc, Wc = x_img.shape
    gh, gw = Hc // P, Wc // P
    n = jnp.float32(P * P)

    def cells(a):                  # (gh*P, gw*P) -> (gh, P, gw, P), a view
        return a.reshape(gh, P, gw, P)

    def bsum(a):                   # (gh, P, gw, P) -> (gh, gw)
        return jnp.sum(a, axis=(1, 3))

    x4, y4, z4 = cells(x_img), cells(y_img), cells(z_img)
    xs = x4 - x4[:, :1, :, :1]
    ys = y4 - y4[:, :1, :, :1]
    zs = z4 - z4[:, :1, :, :1]
    sxs, sys_, szs = bsum(xs), bsum(ys), bsum(zs)
    zero = jnp.float32(0)
    sxx = jnp.maximum(bsum(xs * xs) - sxs * (sxs / n), zero)
    sxy = bsum(xs * ys) - sxs * (sys_ / n)
    sxz = bsum(xs * zs) - sxs * (szs / n)
    syy = jnp.maximum(bsum(ys * ys) - sys_ * (sys_ / n), zero)
    syz = bsum(ys * zs) - sys_ * (szs / n)
    szz = jnp.maximum(bsum(zs * zs) - szs * (szs / n), zero)
    coord_sum = jnp.stack([bsum(x4), bsum(y4), bsum(z4)], -1)
    scatter = jnp.stack([
        jnp.stack([sxx, sxy, sxz], -1),
        jnp.stack([sxy, syy, syz], -1),
        jnp.stack([sxz, syz, szz], -1),
    ], -2)
    return coord_sum, scatter
