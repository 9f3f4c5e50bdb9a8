"""Stage 3 — region growing as data-parallel label propagation.

The reference implements this as a serial loop of BFS flood fills with a
mutable histogram (plane_extractor.cpp:297-392). The key observation that
makes a data-parallel recast exact (not an approximation): the grown region of a seed
equals directed reachability from the seed over "admissibility" edges
    b -> c  admissible  iff  n_b . n_c >= min_cos
                        and (n_b . mu_c + d_b)^2 <= tol_c
restricted to unassigned planar cells — BFS order does not change this set,
because a cell that fails the test from one popped neighbor is re-tested by
every other popped neighbor (plane_extractor.cpp:372-387).

Structure:

  1. The rounds loop: each round picks the dominant histogram bin, seeds at
     its min-MSE cell, flood-fills, and CONSUMES the region. Its outputs are
     a per-cell `round_map` (which round consumed the cell), each round's
     seed and the round count; `region_sums` then recovers the per-round
     sufficient statistics outside the loop — deliberately NO eigensolves
     or gating inside it. `grow_rounds` is the plain XLA loop (the
     reference, and the CPU path); on a GPU `grow_rounds_device` runs the
     CUDA kernel of deplex_tpu/cuda/growing.cu, one thread block per frame,
     which makes the same integer decisions.
  2. `finalize_rounds` — everything order-independent, vectorized over all
     rounds at once: batched plane fits, size/planarity gates, slot
     assignment by accept order (prefix sum), per-cell labels via one
     gather, and the PlaneSegments table via a one-hot contraction.

This split is semantics-preserving: the reference also consumes cells
regardless of whether the region passes its gates (plane_extractor.cpp:
322-343), so acceptance never feeds back into the growing loop.

Plane slots are fixed at config.max_planes for static shapes; the reference
has no cap (observed plane counts: TUM 34, ICL 45; default cap 64).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deplex_tpu.config import Config
from deplex_tpu.ops.cellstats import CellStats
from deplex_tpu.ops.eigh3x3 import eigh3x3_min
from deplex_tpu.ops.histogram import histogram_counts, normal_bins
from deplex_tpu.precision import HIGHEST


class PlaneSegments(NamedTuple):
    """Fixed-capacity (max_planes) plane-segment slots, index 0 = plane 1."""

    nr_planes: jax.Array     # () int32 — number of occupied slots
    n: jax.Array             # (MAXP,) f32 — point counts
    coord_sum: jax.Array     # (MAXP, 3)
    scatter: jax.Array       # (MAXP, 3, 3) centered second moments
    normal: jax.Array        # (MAXP, 3)
    mean: jax.Array          # (MAXP, 3)
    d: jax.Array             # (MAXP,)
    mse: jax.Array           # (MAXP,)
    score: jax.Array         # (MAXP,)


class RoundData(NamedTuple):
    """Output contract of a growing loop (XLA or CUDA)."""

    round_map: jax.Array     # (gh, gw) int32 — round that consumed the cell, -1
    sums: jax.Array          # (R_MAX, 16) f32 — packed per-round statistics
    nr_rounds: jax.Array     # () int32
    seeds: jax.Array         # (R_MAX,) int32 — flat seed cell per round, gh*gw

# sums row layout: [n_pts, sum_x, sum_y, sum_z,
#                   sc_xx, sc_xy, sc_xz, sc_yy, sc_yz, sc_zz,
#                   size_cells, 0...]
_N, _SX, _SY, _SZ = 0, 1, 2, 3
_XX, _XY, _XZ, _YY, _YZ, _ZZ = 4, 5, 6, 7, 8, 9
_SIZE = 10


def _fit_plane(scatter, coord_sum, n):
    """fitPlane (cell_segment_stat.cpp:55-80) on (possibly batched) stats."""
    w, v = eigh3x3_min(scatter)
    mean = coord_sum / n[..., None]
    d_raw = -jnp.sum(mean * v, axis=-1)
    normal = jnp.where((d_raw > 0)[..., None], v, -v)
    d = jnp.abs(d_raw)
    mse = w[..., 0] / n
    wsum = jnp.sum(w, axis=-1)
    score = jnp.where(wsum != 0, w[..., 2] / wsum, 0.0)
    return normal, mean, d, mse, score


def region_sums(round_map: jax.Array, seed_flat: jax.Array, stats: CellStats,
                r_max: int) -> jax.Array:
    """Per-round sufficient statistics recovered from the consumption map.

    The growing loop (XLA or CUDA) only needs to decide WHICH cells each
    round consumed; the per-round moment sums are order-independent given
    `round_map`, so they are computed here OUTSIDE the sequential loop as
    one-hot contractions over all rounds at once.

    round_map: (gh, gw) int32 — round that consumed each cell, -1 for none.
    seed_flat: (r_max,) int32 — flat (row*gw+col) id of each round's seed
        (any out-of-range value for rounds that consumed nothing). The seed
        is weighted twice, reproducing the reference's accumulator seeding
        (plane_extractor.cpp:318-323).
    Returns (r_max, 16) f32 rows in the RoundData.sums layout.

    Numerics mirror the former in-loop computation exactly: per-cell second
    moments are Chan-recentered about their round's mean BEFORE the weighted
    reduction, so there is no catastrophic cancellation.
    """
    gh, gw = round_map.shape
    N = gh * gw
    f32 = jnp.float32
    rm = round_map.reshape(N)
    rids = jnp.arange(r_max, dtype=jnp.int32)
    onehot = rm[None, :] == rids[:, None]                      # (R, N)
    # Seed double-weight fused into the one (R, N) f32 operand the matmuls
    # need anyway (values exactly 0/1/2).
    is_seed = seed_flat[:, None] == jnp.arange(N, dtype=jnp.int32)[None, :]
    w = jnp.where(onehot, jnp.where(is_seed, f32(2.0), f32(1.0)), f32(0.0))
    size = jnp.sum(onehot, axis=1).astype(f32)

    nr_pts = jnp.asarray(stats.nr_pts, f32)
    cs = stats.coord_sum.reshape(N, 3).astype(f32)
    mean = stats.mean.reshape(N, 3).astype(f32)
    n_tot = jnp.sum(w, axis=1) * nr_pts                        # (R,)
    sum_tot = jnp.matmul(w, cs, precision=HIGHEST)                  # (R, 3)
    mu = sum_tot / jnp.maximum(n_tot, 1.0)[:, None]
    # Broadcast each cell's round mean back to the cell (transpose one-hot);
    # unconsumed cells get 0 but carry zero weight everywhere.
    mu_cell = jnp.matmul(onehot.astype(f32).T, mu, precision=HIGHEST)   # (N, 3)
    dmu = mean - mu_cell
    sc = stats.scatter.reshape(N, 3, 3).astype(f32)
    feat = jnp.stack([
        sc[:, 0, 0] + nr_pts * dmu[:, 0] * dmu[:, 0],
        sc[:, 0, 1] + nr_pts * dmu[:, 0] * dmu[:, 1],
        sc[:, 0, 2] + nr_pts * dmu[:, 0] * dmu[:, 2],
        sc[:, 1, 1] + nr_pts * dmu[:, 1] * dmu[:, 1],
        sc[:, 1, 2] + nr_pts * dmu[:, 1] * dmu[:, 2],
        sc[:, 2, 2] + nr_pts * dmu[:, 2] * dmu[:, 2],
    ], axis=1)                                                 # (N, 6)
    sc_tot = jnp.matmul(w, feat, precision=HIGHEST)                 # (R, 6)

    return jnp.concatenate([
        n_tot[:, None], sum_tot, sc_tot, size[:, None],
        jnp.zeros((r_max, 5), f32)], axis=1)


def admissibility_edges(stats: CellStats, config: Config):
    """Directed edge masks b->c for the four in-neighbor directions.

    Returns dict with keys 'from_up', 'from_down', 'from_left', 'from_right';
    mask[r, c] == True iff the neighbor of (r, c) in that direction may
    activate (r, c). Shapes (gh, gw); border entries are False.
    """
    n_c = stats.normal
    mu_c = stats.mean
    tol_c = stats.tol
    min_cos = jnp.float32(config.min_cos_angle_merge)

    def pred(nb_normal, nb_d):
        cos = jnp.sum(nb_normal * n_c, axis=-1)
        dist = (jnp.sum(nb_normal * mu_c, axis=-1) + nb_d) ** 2
        return (cos >= min_cos) & (dist <= tol_c)

    def shift(x, dr, dc):
        """x shifted so result[r,c] = x[r-dr, c-dc], zero/False padded."""
        return jnp.roll(x, (dr, dc), axis=(0, 1))

    gh, gw = tol_c.shape
    row = jnp.arange(gh)[:, None]
    col = jnp.arange(gw)[None, :]

    edges = {}
    for name, (dr, dc) in (("from_up", (1, 0)), ("from_down", (-1, 0)),
                           ("from_left", (0, 1)), ("from_right", (0, -1))):
        nb_normal = shift(n_c, dr, dc)
        nb_d = shift(stats.d, dr, dc)
        ok = pred(nb_normal, nb_d)
        # Invalidate wrapped borders.
        if dr == 1:
            ok = ok & (row >= 1)
        elif dr == -1:
            ok = ok & (row < gh - 1)
        if dc == 1:
            ok = ok & (col >= 1)
        elif dc == -1:
            ok = ok & (col < gw - 1)
        edges[name] = ok
    return edges


def flood_fill(seed_mask: jax.Array, allowed: jax.Array, edges, hops_per_step: int = 8):
    """Directed reachability from seed_mask within `allowed` cells.

    One while-loop iteration performs `hops_per_step` propagation hops to
    amortize loop overhead; terminates at fixpoint.
    """

    def one_hop(active):
        up = jnp.roll(active, 1, axis=0) & edges["from_up"]
        down = jnp.roll(active, -1, axis=0) & edges["from_down"]
        left = jnp.roll(active, 1, axis=1) & edges["from_left"]
        right = jnp.roll(active, -1, axis=1) & edges["from_right"]
        return active | (allowed & (up | down | left | right))

    def cond(state):
        active, prev_count = state
        return jnp.sum(active) > prev_count

    def body(state):
        active, _ = state
        prev_count = jnp.sum(active)
        for _ in range(hops_per_step):
            active = one_hop(active)
        return active, prev_count

    active, _ = jax.lax.while_loop(cond, body, (seed_mask, jnp.int32(-1)))
    return active


def grow_decisions(bins0: jax.Array, mse: jax.Array, edges, planar: jax.Array,
                   config: Config):
    """The sequential consume-the-histogram loop on its raw inputs.

    bins0: (gh, gw) int32 histogram bin per cell, -1 for non-planar;
    mse: (gh, gw) f32 seed priority; edges: admissibility_edges' dict;
    planar: (gh, gw) bool. Returns (round_map, seeds, nr_rounds) — the
    integer decisions the CUDA kernel reproduces bit for bit.
    """
    gh, gw = planar.shape
    R_MAX = config.max_region_growing_rounds
    nbins = config.histogram_bins_per_coord
    cell_flat = jnp.arange(gh * gw).reshape(gh, gw)

    class LoopState(NamedTuple):
        bins: jax.Array          # (gh, gw) int32, -1 = consumed/non-planar
        unassigned: jax.Array    # (gh, gw) bool
        round_map: jax.Array     # (gh, gw) int32
        seeds: jax.Array         # (R_MAX,) int32 flat seed id per round
        remaining: jax.Array     # () int32
        stop: jax.Array          # () bool
        rounds: jax.Array        # () int32

    state0 = LoopState(
        bins=bins0,
        unassigned=planar,
        round_map=jnp.full((gh, gw), -1, jnp.int32),
        seeds=jnp.full((R_MAX,), gh * gw, jnp.int32),
        remaining=jnp.sum(planar).astype(jnp.int32),
        stop=jnp.bool_(False),
        rounds=jnp.int32(0),
    )

    def cond(s: LoopState):
        return (s.remaining > 0) & (~s.stop) & (s.rounds < R_MAX)

    def body(s: LoopState):
        # 1. Dominant bin of live cells (first-max tie-break = argmax).
        hist = histogram_counts(s.bins, nbins)
        mf_bin = jnp.argmax(hist)
        candidates = s.bins == mf_bin
        stop = hist[mf_bin] < config.min_region_growing_candidate_size

        # 2. Seed: min cell MSE among candidates (first-min tie-break).
        seed_mse = jnp.where(candidates, mse, jnp.inf)
        seed_id = jnp.argmin(seed_mse.reshape(-1))
        seed_mask = cell_flat == seed_id.reshape(())

        # 3. Grow.
        region = flood_fill(seed_mask & s.unassigned, s.unassigned, edges)
        region = region & ~stop  # a stopped round consumes nothing
        size = jnp.sum(region).astype(jnp.int32)

        # 4. Consume. The seed id is recorded so the post-loop sums pass
        # (region_sums) can weight it twice — the reference seeds the
        # accumulator with a COPY of the seed cell and then adds every
        # region cell including the seed (plane_extractor.cpp:318-323).
        bins = jnp.where(region, -1, s.bins)
        unassigned = s.unassigned & ~region
        remaining = s.remaining - size
        round_map = jnp.where(region, s.rounds, s.round_map)
        seeds = s.seeds.at[s.rounds].set(seed_id.astype(jnp.int32))

        return LoopState(bins=bins, unassigned=unassigned, round_map=round_map,
                         seeds=seeds, remaining=remaining, stop=stop,
                         rounds=s.rounds + 1)

    final = jax.lax.while_loop(cond, body, state0)
    return final.round_map, final.seeds, final.rounds


def grow_rounds(stats: CellStats, config: Config) -> RoundData:
    """The rounds loop in plain XLA (the reference path)."""
    bins0 = normal_bins(stats.normal, stats.planar, config.histogram_bins_per_coord)
    round_map, seeds, nr_rounds = grow_decisions(
        bins0, stats.mse, admissibility_edges(stats, config), stats.planar, config)
    sums = region_sums(round_map, seeds, stats, config.max_region_growing_rounds)
    return RoundData(round_map=round_map, sums=sums, nr_rounds=nr_rounds,
                     seeds=seeds)


def finalize_rounds(rounds: RoundData, config: Config):
    """Order-independent post-pass: batched fits, gates, slots, labels.

    Returns (labels_map (gh, gw) int32, PlaneSegments) — same contract as
    the old fused loop; vectorized over all rounds at once (one batched
    eigensolve instead of one per round).
    """
    R_MAX, MAXP = rounds.sums.shape[0], config.max_planes
    sums = rounds.sums
    n = jnp.maximum(sums[:, _N], 1.0)
    coord_sum = sums[:, _SX:_SX + 3]
    sc = sums[:, _XX:_XX + 6]
    scatter = jnp.stack([
        jnp.stack([sc[:, 0], sc[:, 1], sc[:, 2]], -1),
        jnp.stack([sc[:, 1], sc[:, 3], sc[:, 4]], -1),
        jnp.stack([sc[:, 2], sc[:, 4], sc[:, 5]], -1),
    ], -2)                                                   # (R_MAX, 3, 3)
    size = sums[:, _SIZE]

    normal, mean, d, mse, score = _fit_plane(scatter, coord_sum, n)

    live = jnp.arange(R_MAX) < rounds.nr_rounds
    accept = (live & (size >= config.min_region_growing_cells_activated)
              & (score > config.min_region_planarity_score))
    slot = jnp.cumsum(accept.astype(jnp.int32)) - 1          # accept-order slot
    accept = accept & (slot < MAXP)
    nr_planes = jnp.sum(accept).astype(jnp.int32)

    # Per-cell labels: round -> slot+1 (0 for rejected/unconsumed), as a
    # one-hot contraction (exact: labels are small integers).
    label_of_round = jnp.where(accept, slot + 1, 0).astype(jnp.int32)
    lut = jnp.concatenate([jnp.zeros(1, jnp.int32), label_of_round]).astype(jnp.float32)
    oh = (rounds.round_map[..., None] + 1 == jnp.arange(R_MAX + 1, dtype=jnp.int32))
    labels_map = jnp.einsum("ghk,k->gh", oh.astype(jnp.float32), lut,
                            precision=HIGHEST).astype(jnp.int32)

    # Segment table via one-hot round->slot contraction (dup-free scatter).
    onehot = (accept[:, None] & (slot[:, None] == jnp.arange(MAXP)[None, :])
              ).astype(jnp.float32)                          # (R_MAX, MAXP)
    seg_n = jnp.einsum("rm,r->m", onehot, sums[:, _N], precision=HIGHEST)
    seg_sum = jnp.einsum("rm,ri->mi", onehot, coord_sum, precision=HIGHEST)
    seg_scatter = jnp.einsum("rm,rij->mij", onehot, scatter, precision=HIGHEST)
    seg_normal = jnp.einsum("rm,ri->mi", onehot, normal, precision=HIGHEST)
    seg_mean = jnp.einsum("rm,ri->mi", onehot, mean, precision=HIGHEST)
    seg_d = jnp.einsum("rm,r->m", onehot, d, precision=HIGHEST)
    seg_mse = jnp.einsum("rm,r->m", onehot, mse, precision=HIGHEST)
    seg_score = jnp.einsum("rm,r->m", onehot, score, precision=HIGHEST)

    segments = PlaneSegments(nr_planes=nr_planes, n=seg_n, coord_sum=seg_sum,
                             scatter=seg_scatter, normal=seg_normal,
                             mean=seg_mean, d=seg_d, mse=seg_mse,
                             score=seg_score)
    return labels_map, segments


def pack_flags(edges, planar: jax.Array) -> jax.Array:
    """Per-cell uint8 flags for the CUDA kernel: bits 0-3 are the
    admissibility edges from up, down, left and right, bit 4 is `planar`."""
    f = planar.astype(jnp.uint8) << 4
    for bit, name in enumerate(("from_up", "from_down", "from_left", "from_right")):
        f = f | (edges[name].astype(jnp.uint8) << bit)
    return f


def _grow_rounds_call(bins, mse, flags, config: Config):
    """The CUDA kernel as a JAX operation: (round_map, seeds, nr_rounds).

    Leading batch axes are the kernel's own (one thread block per frame),
    so under vmap the call is made once for the whole batch."""
    from deplex_tpu import cuda

    if cuda.has_gpu():
        cuda.register()
    gh, gw = bins.shape
    r_max = config.max_region_growing_rounds
    i32 = jnp.int32
    round_map, seeds, nr_rounds, _ = jax.ffi.ffi_call(
        "deplex_grow_rounds",
        (jax.ShapeDtypeStruct((gh, gw), i32),
         jax.ShapeDtypeStruct((r_max,), i32),
         jax.ShapeDtypeStruct((), i32),
         jax.ShapeDtypeStruct((gh * gw,), jnp.uint16)),   # BFS queue scratch
        vmap_method="broadcast_all",
    )(bins.astype(i32), mse.astype(jnp.float32), flags,
      r_max=r_max, nbins2=config.histogram_bins_per_coord ** 2,
      min_candidates=config.min_region_growing_candidate_size)
    return round_map, seeds, nr_rounds


def grow_rounds_cuda(stats: CellStats, config: Config) -> RoundData:
    """`grow_rounds` on the CUDA kernel; the same RoundData, bit for bit in
    round_map, seeds and nr_rounds. The edges, the bins and region_sums
    stay in XLA."""
    nbins = config.histogram_bins_per_coord
    bins = normal_bins(stats.normal, stats.planar, nbins)
    flags = pack_flags(admissibility_edges(stats, config), stats.planar)
    round_map, seeds, nr_rounds = _grow_rounds_call(bins, stats.mse, flags, config)
    sums = region_sums(round_map, seeds, stats, config.max_region_growing_rounds)
    return RoundData(round_map=round_map, sums=sums, nr_rounds=nr_rounds,
                     seeds=seeds)


def grow_rounds_device(stats: CellStats, config: Config) -> RoundData:
    """The rounds loop for the platform it is lowered for: the CUDA kernel
    on a GPU, the XLA loop elsewhere."""
    return jax.lax.platform_dependent(
        stats, cuda=lambda s: grow_rounds_cuda(s, config),
        default=lambda s: grow_rounds(s, config))


def grow_planes(stats: CellStats, config: Config):
    """Full region-growing stage: rounds loop + vectorized finalize.

    labels_map value k > 0 means plane slot k-1 in the returned PlaneSegments.
    """
    return finalize_rounds(grow_rounds_device(stats, config), config)
