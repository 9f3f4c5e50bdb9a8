"""Stage 4 — merging of adjacent compatible plane segments.

Data-parallel equivalent of findMergedLabels + getConnectedComponents
(plane_extractor.cpp:394-453). The adjacency matrix is built with two
shifted comparisons of the cell label map (the exact stencil of
getConnectedComponents — note the reference scans rows [0, R-2] and columns
[0, C-2] for BOTH the right- and down-neighbor checks, so the last row and
column never contribute; reproduced here).

The reference's greedy merge is a sequential double loop, but within one row
the compatibility tests use the representative plane's stats as of the START
of the row (normal_/d_ are only refit after the row completes,
plane_extractor.cpp:422) and absorbed columns' stats are never re-read in the
same row — so the inner loop vectorizes exactly: one masked reduction per
row. Only the MAXP-row outer loop stays sequential (it is tiny).

`merge_planes` is the plain XLA loop (the reference, and the CPU path); on a
GPU `merge_planes_device` runs the Triton kernel of ops/merge_triton.py, one
program per frame, which computes the same rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from deplex_tpu.config import Config
from deplex_tpu.ops.growing import PlaneSegments, _fit_plane
from deplex_tpu.precision import HIGHEST


def pair_adjacency(x: jax.Array, y: jax.Array, max_planes: int) -> jax.Array:
    """(MAXP, MAXP) bool: A[i, j] = any position with (x == i+1, y == j+1).

    Dense one-hot contraction (exact: 0/1 products, integer counts); label 0
    and x == y pairs are excluded.
    """
    ids = jnp.arange(1, max_planes + 1, dtype=x.dtype)
    m = (x > 0) & (y > 0) & (x != y)
    xf = jnp.where(m, x, 0).reshape(-1)
    yf = jnp.where(m, y, 0).reshape(-1)
    ox = (xf[:, None] == ids).astype(jnp.float32)
    oy = (yf[:, None] == ids).astype(jnp.float32)
    return jnp.matmul(ox.T, oy, precision=HIGHEST) > 0


def plane_adjacency(labels_map: jax.Array, max_planes: int) -> jax.Array:
    """(MAXP, MAXP) bool symmetric adjacency from the (gh, gw) cell labels."""
    lm = labels_map
    a = lm[:-1, :-1]
    right = lm[:-1, 1:]
    down = lm[1:, :-1]
    A = (pair_adjacency(a, right, max_planes)
         | pair_adjacency(a, down, max_planes))
    return A | A.T


def merge_planes(labels_map: jax.Array, segments: PlaneSegments, config: Config):
    """Returns (merge_labels (MAXP,) int32, merged segments).

    merge_labels[i] = representative slot of plane i (identity if unmerged).
    """
    assoc = plane_adjacency(labels_map, config.max_planes)
    return merge_planes_from_adjacency(assoc, segments, config)


def merge_planes_device(labels_map: jax.Array, segments: PlaneSegments,
                        config: Config):
    """`merge_planes` for the platform it is lowered for: the Triton kernel
    on a GPU, the XLA loop elsewhere."""
    from deplex_tpu.ops.merge_triton import merge_planes_triton

    return jax.lax.platform_dependent(
        labels_map, segments,
        cuda=lambda lm, sg: merge_planes_triton(lm, sg, config),
        default=lambda lm, sg: merge_planes(lm, sg, config))


def merge_planes_from_adjacency(assoc: jax.Array, segments: PlaneSegments,
                                config: Config):
    """Greedy merge given a precomputed (MAXP, MAXP) adjacency.

    Split out of merge_planes so the spatially-sharded pipeline
    (parallel/spatial.py) can psum per-shard adjacency contributions across
    the mesh and then run this replicated tail identically on every shard.
    """
    MAXP = config.max_planes
    col_ids = jnp.arange(MAXP)
    min_cos = jnp.float32(config.min_cos_angle_merge)
    max_dist = jnp.float32(config.max_merge_dist)

    def body(row, carry):
        (merge_labels, n, coord_sum, scatter, normal, mean, d) = carry
        pid = merge_labels[row]
        n_pid = normal[pid]
        d_pid = d[pid]
        # Columns beyond the occupied slots have assoc False (labels_map never
        # references them), so they can't pass.
        cand = assoc[row] & (col_ids > row)
        cos = jnp.sum(normal * n_pid, axis=-1)
        dist = (jnp.sum(mean * n_pid, axis=-1) + d_pid) ** 2
        passing = cand & (cos > min_cos) & (dist < max_dist)
        # Guard: a column that IS the current representative must not be
        # absorbed into itself (cannot happen: assoc diag False, pid <= row).
        expanded = jnp.any(passing)

        w = passing.astype(jnp.float32)
        add_n = jnp.sum(w * n)
        add_sum = jnp.einsum("p,pi->i", w, coord_sum, precision=HIGHEST)
        new_n = n[pid] + add_n
        new_sum = coord_sum[pid] + add_sum
        mu = new_sum / jnp.maximum(new_n, 1.0)
        # Chan k-way combine about the new global mean (exact, stable):
        # members = representative + passing columns.
        w_all = w.at[pid].add(1.0)
        dmu = coord_sum / jnp.maximum(n, 1.0)[:, None] - mu
        new_scatter = (jnp.einsum("p,pij->ij", w_all, scatter, precision=HIGHEST)
                       + jnp.einsum("p,p,pi,pj->ij", w_all, n, dmu, dmu,
                                    precision=HIGHEST))

        n = jnp.where(expanded, n.at[pid].set(new_n), n)
        coord_sum = jnp.where(expanded, coord_sum.at[pid].set(new_sum), coord_sum)
        scatter = jnp.where(expanded, scatter.at[pid].set(new_scatter), scatter)
        merge_labels = jnp.where(passing, pid, merge_labels)
        # Mean is updated by operator+= immediately (cell_segment_stat.cpp:42);
        # normal/d only at end-of-row refit (plane_extractor.cpp:422).
        mean = jnp.where(expanded, mean.at[pid].set(mu), mean)
        fit_normal, fit_mean, fit_d, _, _ = _fit_plane(new_scatter[None], new_sum[None],
                                                       jnp.maximum(new_n, 1.0)[None])
        normal = jnp.where(expanded, normal.at[pid].set(fit_normal[0]), normal)
        d = jnp.where(expanded, d.at[pid].set(fit_d[0]), d)
        return (merge_labels, n, coord_sum, scatter, normal, mean, d)

    carry0 = (col_ids.astype(jnp.int32), segments.n, segments.coord_sum,
              segments.scatter, segments.normal, segments.mean, segments.d)
    # Rows >= nr_planes have no adjacency (labels_map never references
    # them), so bounding the sequential loop at the occupied slot count is
    # exact and skips the empty tail of the MAXP-row table.
    nrows = jnp.minimum(segments.nr_planes, MAXP)

    def wcond(state):
        row, _ = state
        return row < nrows

    def wbody(state):
        row, carry = state
        return row + 1, body(row, carry)

    _, (merge_labels, n, coord_sum, scatter, normal, mean, d) = jax.lax.while_loop(
        wcond, wbody, (jnp.int32(0), carry0))

    merged = PlaneSegments(
        nr_planes=segments.nr_planes, n=n, coord_sum=coord_sum, scatter=scatter,
        normal=normal, mean=mean, d=d, mse=segments.mse, score=segments.score)
    return merge_labels, merged


def apply_label_lut(labels_map: jax.Array, merge_labels: jax.Array) -> jax.Array:
    """(gh, gw) cell labels -> merged cell labels, 0 preserved.

    A (gh*gw, MAXP+1) one-hot matvec. Exact: labels <= MAXP are integers
    well under f32's 2^24.
    """
    maxp = merge_labels.shape[0]
    lut = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), merge_labels.astype(jnp.int32) + 1]
    ).astype(jnp.float32)
    oh = (labels_map[..., None] == jnp.arange(maxp + 1, dtype=labels_map.dtype))
    return jnp.einsum("ghk,k->gh", oh.astype(jnp.float32), lut,
                      precision=HIGHEST).astype(jnp.int32)


def rasterize_labels(labels_map: jax.Array, merge_labels: jax.Array,
                     image_height: int, image_width: int, patch_size: int) -> jax.Array:
    """Stage 5 — per-pixel labels (toImageLabels, plane_extractor.cpp:455-470).

    labels[pixel] = merge_labels[cell_label - 1] + 1, or 0 for non-planar.
    Remainder pixels (beyond gh*P, gw*P) get label 0 — the reference indexes
    out of bounds there (UB); all shipped data is exactly divisible.

    The patch expansion runs as two one-hot matmuls in bf16. That is exact
    for labels <= 255: every product is a one-hot 0/1 times an integer that
    bf16 holds exactly, and each output sums exactly one such product, so no
    precision setting is needed.
    """
    gh, gw = labels_map.shape
    P = patch_size
    lm = apply_label_lut(labels_map, merge_labels)
    # bf16 is exact for integers <= 256; fall back to f32 for huge tables.
    mm_dtype = jnp.bfloat16 if merge_labels.shape[0] + 1 <= 256 else jnp.float32
    rows = jnp.minimum(jnp.arange(image_height) // P, gh - 1)
    cols = jnp.minimum(jnp.arange(image_width) // P, gw - 1)
    expand_r = (rows[:, None] == jnp.arange(gh)[None, :]).astype(mm_dtype)
    expand_c = (jnp.arange(gw)[:, None] == cols[None, :]).astype(mm_dtype)
    valid_r = (jnp.arange(image_height) < gh * P)[:, None]
    valid_c = (jnp.arange(image_width) < gw * P)[None, :]
    img = expand_r @ lm.astype(mm_dtype) @ expand_c
    out = jnp.where(valid_r & valid_c, img.astype(jnp.int32), 0)
    return out.reshape(-1)
