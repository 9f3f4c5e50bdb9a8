"""TP-analog spatial sharding: ONE frame's cell grid split across a mesh axis.

SURVEY.md §2.4 row 3: the reference has no tensor-parallel analog (it is a
serial single-frame C++ library); the analog here is sharding a single
frame's cell grid across devices — useful when one frame is large (the
1280x720 stress config) and latency of that single frame matters more than
batch throughput.

Design (all inside one `jax.shard_map` over a 1-D mesh axis, default
"space"), sharding the image by ROWS at cell-row granularity:

  stage 1  cell stats      — embarrassingly local (cells never straddle the
                             shard boundary; the wrapper pads the cell-row
                             count up to a multiple of the axis size with
                             zero rows, which are non-planar by the validity
                             gate and thus inert).
  stage 2  histogram       — local bincount + `psum` (exact: integer sum).
  stage 3  region growing  — the admissibility edges at the two boundary
                             rows are completed with ONE stats halo exchange
                             (`ppermute` of each shard's first/last row of
                             normals/d); the flood fill then exchanges its
                             boundary *active* rows every relaxation step and
                             runs to a GLOBAL fixpoint (`psum` of the active
                             count). Seed selection reproduces the reference's
                             first-min tie-break exactly: per-shard argmin,
                             then `pmin` over (mse, global row-major cell id).
  stage 4  merge           — per-shard adjacency stencil contributions
                             (with a labels halo row) are `psum`-reduced into
                             the replicated (MAXP, MAXP) matrix; the greedy
                             merge loop then runs replicated on every shard.
  stage 5  rasterize       — local.

Collectives are O(rounds) small psums/ppermutes (a few KB each) — they ride
NVLink between GPUs of a host. Region sufficient statistics cross the shard boundary
as float psums, so labels can differ from the single-device pipeline by
reduction-order ulps when a gate sits exactly on a threshold; tests assert
label agreement, not bit equality (tests/test_spatial.py).

Reference anchors: the per-stage semantics are identical to the single-device
pipeline (ops/growing.py, ops/merge.py), which cites the reference's
plane_extractor.cpp lines; this module only changes WHERE each cell row lives.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as Ps

from deplex_tpu.config import Config
from deplex_tpu.ops.cellstats import CellStats, compute_cell_stats
from deplex_tpu.ops.growing import (_N, _SIZE, _SX, _XX, RoundData,
                                    admissibility_edges, finalize_rounds)
from deplex_tpu.ops.histogram import histogram_counts, normal_bins
from deplex_tpu.precision import HIGHEST
from deplex_tpu.ops.merge import (merge_planes_from_adjacency, pair_adjacency,
                                  rasterize_labels)


def _from_prev(x: jax.Array, axis: str, ntp: int) -> jax.Array:
    """On shard i: shard i-1's x (zeros on shard 0)."""
    return jax.lax.ppermute(x, axis, [(i, i + 1) for i in range(ntp - 1)])


def _from_next(x: jax.Array, axis: str, ntp: int) -> jax.Array:
    """On shard i: shard i+1's x (zeros on the last shard)."""
    return jax.lax.ppermute(x, axis, [(i + 1, i) for i in range(ntp - 1)])


def sharded_edges(stats: CellStats, config: Config, axis: str, ntp: int):
    """Admissibility edges on the local grid, boundary rows completed with a
    one-time stats halo exchange (ops/growing.py:admissibility_edges plus
    cross-shard rows)."""
    edges = admissibility_edges(stats, config)
    idx = jax.lax.axis_index(axis)
    min_cos = jnp.float32(config.min_cos_angle_merge)

    def pred(nb_normal, nb_d, row):
        cos = jnp.sum(nb_normal * stats.normal[row], axis=-1)
        dist = (jnp.sum(nb_normal * stats.mean[row], axis=-1) + nb_d) ** 2
        return (cos >= min_cos) & (dist <= stats.tol[row])

    ok_up = pred(_from_prev(stats.normal[-1], axis, ntp),
                 _from_prev(stats.d[-1], axis, ntp), 0)
    edges["from_up"] = edges["from_up"].at[0].set(ok_up & (idx > 0))

    ok_dn = pred(_from_next(stats.normal[0], axis, ntp),
                 _from_next(stats.d[0], axis, ntp), -1)
    edges["from_down"] = edges["from_down"].at[-1].set(ok_dn & (idx < ntp - 1))
    return edges


def flood_fill_sharded(seed_mask, allowed, edges, axis: str, ntp: int,
                       hops_per_step: int = 8):
    """Directed reachability to the GLOBAL fixpoint across row shards.

    Each outer iteration exchanges the boundary active rows once and then
    performs `hops_per_step` local hops reusing that (stale but monotone-safe)
    halo; the loop exits only when a full exchange+relax round adds no cell
    anywhere (psum of the active count), which is the true global fixpoint.
    """

    def one_hop(active, up_halo, down_halo):
        up = jnp.roll(active, 1, axis=0).at[0].set(up_halo) & edges["from_up"]
        down = (jnp.roll(active, -1, axis=0).at[-1].set(down_halo)
                & edges["from_down"])
        left = jnp.roll(active, 1, axis=1) & edges["from_left"]
        right = jnp.roll(active, -1, axis=1) & edges["from_right"]
        return active | (allowed & (up | down | left | right))

    def gcount(a):
        return jax.lax.psum(jnp.sum(a.astype(jnp.int32)), axis)

    def cond(state):
        active, prev = state
        return gcount(active) > prev

    def body(state):
        active, _ = state
        prev = gcount(active)
        up_halo = _from_prev(active[-1], axis, ntp)
        down_halo = _from_next(active[0], axis, ntp)
        for _ in range(hops_per_step):
            active = one_hop(active, up_halo, down_halo)
        return active, prev

    active, _ = jax.lax.while_loop(cond, body, (seed_mask, jnp.int32(-1)))
    return active


def grow_rounds_spatial(stats: CellStats, config: Config, axis: str,
                        ntp: int) -> RoundData:
    """ops/growing.py:grow_rounds with every global reduction replaced by a
    collective; sums/round counters end replicated, round_map stays sharded."""
    gh_l, gw = stats.planar.shape
    R_MAX = config.max_region_growing_rounds
    nbins = config.histogram_bins_per_coord
    edges = sharded_edges(stats, config, axis, ntp)
    bins0 = normal_bins(stats.normal, stats.planar, nbins)

    idx = jax.lax.axis_index(axis)
    base = idx.astype(jnp.int32) * jnp.int32(gh_l * gw)
    cell_flat_g = base + jnp.arange(gh_l * gw, dtype=jnp.int32).reshape(gh_l, gw)

    class LoopState(NamedTuple):
        bins: jax.Array
        unassigned: jax.Array
        round_map: jax.Array
        sums: jax.Array
        seeds: jax.Array
        remaining: jax.Array
        stop: jax.Array
        rounds: jax.Array

    state0 = LoopState(
        bins=bins0,
        unassigned=stats.planar,
        round_map=jnp.full((gh_l, gw), -1, jnp.int32),
        sums=jnp.zeros((R_MAX, 16), jnp.float32),
        seeds=jnp.full((R_MAX,), ntp * gh_l * gw, jnp.int32),
        remaining=jax.lax.psum(jnp.sum(stats.planar).astype(jnp.int32), axis),
        stop=jnp.bool_(False),
        rounds=jnp.int32(0),
    )

    def cond(s: LoopState):
        return (s.remaining > 0) & (~s.stop) & (s.rounds < R_MAX)

    def body(s: LoopState):
        # 1. Dominant bin of live cells (integer psum: exact, replicated).
        hist = jax.lax.psum(histogram_counts(s.bins, nbins), axis)
        mf_bin = jnp.argmax(hist)
        candidates = s.bins == mf_bin
        stop = hist[mf_bin] < config.min_region_growing_candidate_size

        # 2. Seed: global first-min over (mse, row-major cell id) — exactly
        # the single-device argmin tie-break (growing.py body step 2).
        seed_mse = jnp.where(candidates, stats.mse, jnp.inf)
        lmin = jnp.min(seed_mse)
        larg = jnp.argmin(seed_mse.reshape(-1)).astype(jnp.int32)
        gmin = jax.lax.pmin(lmin, axis)
        cand_id = jnp.where(lmin == gmin, base + larg, jnp.int32(2**31 - 1))
        seed_id = jax.lax.pmin(cand_id, axis)
        seed_mask = cell_flat_g == seed_id

        # 3. Grow to the global fixpoint.
        region = flood_fill_sharded(seed_mask & s.unassigned, s.unassigned,
                                    edges, axis, ntp)
        region = region & ~stop
        size = jax.lax.psum(jnp.sum(region).astype(jnp.int32), axis)

        # 4. Consume.
        bins = jnp.where(region, -1, s.bins)
        unassigned = s.unassigned & ~region
        remaining = s.remaining - size
        round_map = jnp.where(region, s.rounds, s.round_map)

        # 5. Region sufficient statistics (seed double-count as in
        # plane_extractor.cpp:318-323); two small psum phases because the
        # Chan combine centers on the global mean.
        wgt = (region.astype(jnp.float32)
               + (seed_mask & region).astype(jnp.float32))
        n_tot = jax.lax.psum(jnp.sum(wgt) * stats.nr_pts, axis)
        sum_tot = jax.lax.psum(
            jnp.einsum("gh,ghi->i", wgt, stats.coord_sum, precision=HIGHEST), axis)
        mu = sum_tot / jnp.maximum(n_tot, 1.0)
        dmu = stats.mean - mu
        sc_tot = jax.lax.psum(
            jnp.einsum("gh,ghij->ij", wgt, stats.scatter, precision=HIGHEST)
            + stats.nr_pts * jnp.einsum("gh,ghi,ghj->ij", wgt, dmu, dmu,
                                        precision=HIGHEST), axis)

        row = jnp.zeros(16, jnp.float32)
        row = row.at[_N].set(n_tot)
        row = jax.lax.dynamic_update_slice(row, sum_tot, (_SX,))
        packed = jnp.stack([sc_tot[0, 0], sc_tot[0, 1], sc_tot[0, 2],
                            sc_tot[1, 1], sc_tot[1, 2], sc_tot[2, 2]])
        row = jax.lax.dynamic_update_slice(row, packed, (_XX,))
        row = row.at[_SIZE].set(size.astype(jnp.float32))
        sums = jax.lax.dynamic_update_slice(s.sums, row[None], (s.rounds, 0))
        seeds = s.seeds.at[s.rounds].set(seed_id)

        return LoopState(bins=bins, unassigned=unassigned, round_map=round_map,
                         sums=sums, seeds=seeds, remaining=remaining, stop=stop,
                         rounds=s.rounds + 1)

    final = jax.lax.while_loop(cond, body, state0)
    return RoundData(round_map=final.round_map, sums=final.sums,
                     nr_rounds=final.rounds, seeds=final.seeds)


def plane_adjacency_spatial(labels_map: jax.Array, max_planes: int, axis: str,
                            ntp: int) -> jax.Array:
    """Per-shard contribution to the getConnectedComponents stencil
    (ops/merge.py:plane_adjacency), psum-reduced to the replicated matrix.

    The single-device stencil pairs rows [0, R-2] with their right/down
    neighbors; here each shard pairs ALL its local rows (the missing
    down-neighbor of the local last row arrives as a halo), except that the
    GLOBAL last row is zeroed on the 'a' side to reproduce the reference's
    last-row exclusion.
    """
    idx = jax.lax.axis_index(axis)
    gh_l, _ = labels_map.shape
    halo = _from_next(labels_map[0], axis, ntp)  # zeros (=no pair) on last shard
    lm_ext = jnp.concatenate([labels_map, halo[None]], axis=0)

    last_ok = jnp.where(idx == ntp - 1, gh_l - 1, gh_l)
    a_rows = jnp.where((jnp.arange(gh_l) < last_ok)[:, None], labels_map, 0)
    a = a_rows[:, :-1]
    right = labels_map[:, 1:]
    down = lm_ext[1:, :-1]
    A = pair_adjacency(a, right, max_planes) | pair_adjacency(a, down, max_planes)
    A = A | A.T
    return jax.lax.psum(A.astype(jnp.float32), axis) > 0


def _spatial_body(pts_img: jax.Array, *, config: Config, patch: int, axis: str,
                  ntp: int) -> jax.Array:
    """Per-shard pipeline body (runs under shard_map). pts_img: the shard's
    (H_pad/ntp, W, 3) row block -> (H_pad/ntp, W) int32 labels."""
    H_loc, W, _ = pts_img.shape
    stats = compute_cell_stats(pts_img.reshape(-1, 3), H_loc, W, config)
    rounds = grow_rounds_spatial(stats, config, axis, ntp)
    labels_map, segments = finalize_rounds(rounds, config)
    assoc = plane_adjacency_spatial(labels_map, config.max_planes, axis, ntp)
    merge_labels, _ = merge_planes_from_adjacency(assoc, segments, config)
    return rasterize_labels(labels_map, merge_labels, H_loc, W,
                            patch).reshape(H_loc, W)


def extract_planes_spatial(points: jax.Array, *, image_height: int,
                           image_width: int, config: Config, mesh: Mesh,
                           axis: str = "space") -> jax.Array:
    """Single-frame extraction with the cell grid row-sharded over mesh[axis].

    points: (H*W, 3) organized cloud -> (H*W,) int32 labels, same contract as
    pipeline.extract_planes. RANSAC refinement is a global per-plane pass and
    is not supported under spatial sharding (use the data-parallel path).
    Jit-compatible; call under jax.jit for production use.
    """
    H, W = image_height, image_width
    ntp = mesh.shape[axis]
    P = min(config.patch_size, min(H, W))
    if P == 0:
        raise ValueError(
            f"Error! Invalid config parameter: patchSize({config.patch_size})."
            " patchSize has to be positive.")
    if config.ransac_refinement:
        raise ValueError("spatial sharding does not support ransac_refinement;"
                         " use the data-parallel path (parallel/batch.py)")
    gh0 = H // P
    if gh0 < ntp:
        raise ValueError(f"grid has {gh0} cell rows < {ntp} shards on "
                         f"mesh axis '{axis}'")

    gh = -(-gh0 // ntp) * ntp          # pad cell rows to a shard multiple
    H_pad = gh * P
    pts_img = jnp.asarray(points, jnp.float32).reshape(H, W, 3)[: gh0 * P]
    if H_pad > gh0 * P:
        # Zero rows -> zero valid points -> non-planar cells (inert).
        pts_img = jnp.pad(pts_img, ((0, H_pad - gh0 * P), (0, 0), (0, 0)))

    body = shard_map(
        functools.partial(_spatial_body, config=config, patch=P, axis=axis,
                          ntp=ntp),
        mesh=mesh, in_specs=Ps(axis, None, None), out_specs=Ps(axis, None),
        check_vma=False)
    out_img = body(pts_img)                                   # (H_pad, W)
    rows = min(H, H_pad)
    out = jnp.zeros((H, W), jnp.int32).at[:rows].set(out_img[:rows])
    return out.reshape(-1)
