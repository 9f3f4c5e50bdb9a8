"""Stage 6 — batched RANSAC plane refinement.

Batched equivalent of RTL::PlaneRANSAC (libs/rtl/include/rtl/RANSAC.hpp:25-98,
Plane.hpp:13-56): ALL ransac_max_iterations hypotheses per plane are
generated and scored in one shot (two matmuls per plane), then the
reference's sequential stopping rule is reproduced exactly on the score
vector — no serial loop ever runs on device.

Per plane p:
  models: 3 random in-plane points -> exact plane through them (the
          reference's closed-form determinant expressions reduce to the
          normalized cross-product plane; computed that way here)
  loss[k] = #{ i in plane p : |n_k . x_i + d_k| >= threshold }
  winner  = the reference's early-exit selection (RANSAC.hpp:77-79):
          iterate hypotheses in order, keep the running best, stop once the
          running best's inlier count reaches ransac_inliers_ratio * n_p.
          Vectorized: s = first k whose running-max inlier count meets the
          target, winner = argmin loss over the prefix [0..s] (the whole
          sweep when no prefix reaches the target). ransac_inliers_ratio=1
          (RTL's default) degenerates to argmin over all K.
Pixels of p that are outliers of the winning model are relabeled 0
(plane_extractor.cpp:497-507).

Randomness: jax PRNG (fixed seed by default) replaces the reference's
default-seeded mt19937 — deterministic across runs either way, but the
sampled hypotheses differ; conformance is property-based (refined MSE <=
coarse MSE), matching the reference's own test strategy
(cpp/tests/test_refinement.cpp:43-77).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from deplex_tpu.config import Config
from deplex_tpu.precision import HIGHEST


def reference_stop_winner(loss: jax.Array, n_points: jax.Array,
                          ratio: jax.Array) -> jax.Array:
    """Index of the reference's early-exit winner given all hypothesis losses.

    RTL::PlaneRANSAC::FindBest (RANSAC.hpp:34-51, IsContinued :77-79)
    iterates hypotheses in order keeping the running best and stops once the
    running best's inlier count reaches ratio * n_points; the returned model
    is the best of the hypotheses evaluated so far. Vectorized over the
    precomputed loss vector: stop = first index whose running-max inlier
    count meets the target (last index when never reached), winner = argmin
    loss over the prefix [0..stop]. ratio=1 (RTL's default) degenerates to
    the global argmin.
    """
    K = loss.shape[0]
    inliers = n_points - loss
    run_best = jax.lax.associative_scan(jnp.maximum, inliers)
    reached = run_best >= ratio * n_points
    stop = jnp.where(jnp.any(reached), jnp.argmax(reached), K - 1)
    prefix_loss = jnp.where(jnp.arange(K) <= stop, loss, jnp.inf)
    return jnp.argmin(prefix_loss)


def _fit_3pt_plane(p0, p1, p2):
    """Unit plane (n, d) through 3 points; NaN-safe on degeneracy.

    Equivalent to PlaneEstimator::ComputeModel (Plane.hpp:13-50): those
    determinant expressions are the plane through the 3 points with c = -1
    before normalization; the cross-product form is the same plane.
    """
    n = jnp.cross(p1 - p0, p2 - p0)
    nrm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / nrm  # degenerate triples -> nan -> model never wins
    d = -jnp.sum(n * p0, axis=-1)
    return n, d


def refine_labels(points: jax.Array, labels: jax.Array, config: Config,
                  key: jax.Array | None = None, *,
                  cell_labels: jax.Array | None = None,
                  image_width: int | None = None,
                  patch_size: int | None = None,
                  chunk_size: int | None = None) -> jax.Array:
    """points: (N, 3), labels: (N,) int32 -> refined labels.

    cell_labels (optional, with image_width + patch_size): the (gh, gw)
    final per-cell plane ids. Stage 5 rasterizes whole cells
    (merge.rasterize_labels), so before refinement every pixel of plane p
    lies in a cell wholly labeled p — sampling a uniform plane pixel is
    EXACTLY sampling (uniform plane cell, uniform in-cell pixel). The
    pipeline passes the cell map so the per-plane sample gather runs over
    the ~3k-cell grid; without it (standalone callers with arbitrary pixel
    labels) the grouping falls back to an argsort of all N pixels — a
    300k-element sort, the kind of op this repo avoids on the hot path
    (see histogram.py / merge.py notes on serializing patterns).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    N = points.shape[0]
    MAXP = config.max_planes
    K = config.ransac_max_iterations
    thr = jnp.float32(config.ransac_threshold)

    pts = points.astype(jnp.float32)
    plane_ids = jnp.arange(1, MAXP + 1)
    keys = jax.random.split(key, MAXP)

    if cell_labels is not None:
        # --- cell-grid sampling (hot path) ---
        gh, gw = cell_labels.shape
        P = patch_size
        W = image_width
        PP = P * P
        G = gh * gw
        cl = cell_labels.reshape(-1)
        cell_order = jnp.argsort(cl, stable=True)
        sorted_cl = cl[cell_order]
        bounds = jnp.searchsorted(sorted_cl, jnp.arange(MAXP + 2))
        ccounts = jnp.diff(bounds)
        coffsets = bounds[:-1]

        def per_plane(p, k):
            cnt = ccounts[p] * PP               # pixels in plane p
            # 3 sample indices per hypothesis; collisions de-duplicated by
            # shift (the reference insists on distinct indices via std::set,
            # RANSAC.hpp:87-90).
            u = jax.random.randint(k, (K, 3), 0, jnp.maximum(cnt, 1))
            u1 = u[:, 1] + (u[:, 1] == u[:, 0])
            u2 = u[:, 2] + (u[:, 2] == u[:, 0]) + (u[:, 2] == u1)
            idx = jnp.stack([u[:, 0], u1 % jnp.maximum(cnt, 1),
                             u2 % jnp.maximum(cnt, 1)], 1)   # (K, 3)
            crank, t = idx // PP, idx % PP
            cell = cell_order[jnp.clip(coffsets[p] + crank, 0, G - 1)]
            ci, cj = cell // gw, cell % gw
            pix = (ci * P + t // P) * W + (cj * P + t % P)
            tri = pts[pix]                                   # (K, 3, 3)
            n, d = _fit_3pt_plane(tri[:, 0], tri[:, 1], tri[:, 2])
            return n, d
    else:
        # --- pixel-level fallback: stable sort puts plane-p pixels at
        # [offset[p], offset[p] + count[p]); per-label counts come from
        # binary searches on the sorted vector (no duplicate-index scatter).
        order = jnp.argsort(labels, stable=True)
        sorted_labels = labels[order]
        bounds = jnp.searchsorted(sorted_labels, jnp.arange(MAXP + 2))
        counts = jnp.diff(bounds)
        offsets = bounds[:-1]

        def per_plane(p, k):
            cnt = counts[p]
            off = offsets[p]
            u = jax.random.randint(k, (K, 3), 0, jnp.maximum(cnt, 1))
            u1 = u[:, 1] + (u[:, 1] == u[:, 0])
            u2 = u[:, 2] + (u[:, 2] == u[:, 0]) + (u[:, 2] == u1)
            idx = jnp.stack([u[:, 0], u1 % jnp.maximum(cnt, 1),
                             u2 % jnp.maximum(cnt, 1)], 1)
            pix = order[jnp.clip(off + idx, 0, N - 1)]      # (K, 3) pixel ids
            tri = pts[pix]                                  # (K, 3, 3)
            n, d = _fit_3pt_plane(tri[:, 0], tri[:, 1], tri[:, 2])
            return n, d

    ratio = jnp.float32(config.ransac_inliers_ratio)
    # Hypotheses are scored in CHUNKS inside a while_loop that stops once
    # the reference's inlier-ratio rule fires — the winner is identical to
    # reference_stop_winner over the full loss vector (the stopping rule
    # is prefix-determined), but (a) peak memory is bounded by the chunk
    # width — the all-at-once (N, K) form at K=1000/VGA is 1.2 GB per
    # in-flight frame and OOMs serving batches — and (b) with the shipped
    # ratio 0.15 most planes stop in the first chunk, skipping most work.
    # All losses are exact small-integer counts in f32 (products of {0,1}
    # indicators; f32 addition of integers <= N is exact), so every
    # evaluation order below yields bit-identical losses and winners.
    Kc = min(K, chunk_size or 128)
    S = (K + Kc - 1) // Kc

    def pad_hyp(n, d):
        pad = S * Kc - K
        if pad:
            n = jnp.concatenate([n, jnp.full((pad, 3), jnp.nan, n.dtype)])
            d = jnp.concatenate([d, jnp.full((pad,), jnp.nan, d.dtype)])
        # Degenerate 3-point models (NaN from the zero cross product) and
        # padded slots are SANITIZED to an all-outlier finite model
        # (n=0, d=huge -> every |err| >= thr, loss = n_p, can never win;
        # if every model of a plane is degenerate the final inlier pass
        # zeroes it, as the NaN form did). Finite values are required
        # because the cell path selects params through a one-hot einsum
        # and 0 * NaN = NaN would poison that hypothesis slot for EVERY
        # plane, not just the degenerate one.
        bad = ~(jnp.isfinite(d) & jnp.all(jnp.isfinite(n), axis=-1))
        n = jnp.where(bad[:, None], 0.0, n)
        d = jnp.where(bad, jnp.float32(1e30), d)
        return n, d

    if cell_labels is not None:
        # --- pixel-parallel scoring over the cell grid (hot path) ---
        # Each pixel is scored ONLY against its own plane's hypotheses
        # (like the reference, which hands RANSAC the plane's point set —
        # RANSAC.hpp:34) by expanding per-cell hypothesis params over the
        # free (gh, P, gw, P) view: one elementwise pass of N*Kc work per
        # chunk covers ALL planes, vs the per-plane form's MAXP passes of
        # N*Kc each. The elementwise form is also exact f32, where a
        # (N,3)x(3,Kc) product at reduced precision could not rank
        # |err| < 1-unit thresholds of 5e4-scale inputs.
        n_all, d_all = jax.vmap(per_plane)(plane_ids, keys)  # (MAXP,K,3)
        n_all, d_all = jax.vmap(pad_hyp)(n_all, d_all)
        n_r = n_all.reshape(MAXP, S, Kc, 3)
        d_r = d_all.reshape(MAXP, S, Kc)

        Hh = N // W
        img = pts.reshape(Hh, W, 3)[: gh * P, : gw * P]
        x4 = img[..., 0].reshape(gh, P, gw, P)
        y4 = img[..., 1].reshape(gh, P, gw, P)
        z4 = img[..., 2].reshape(gh, P, gw, P)

        # (gh, gw, MAXP) one-hot of each cell's plane id (0 = none).
        oh = (cell_labels[..., None] == plane_ids[None, None, :]
              ).astype(jnp.float32)
        cells_per_plane = jnp.einsum("ghp->p", oh, precision=HIGHEST)
        n_pts_plane = cells_per_plane * PP                   # (MAXP,)
        target = ratio * n_pts_plane

        def chunk_losses(s):
            nck = n_r[:, s]                                  # (MAXP,Kc,3)
            dck = d_r[:, s]                                  # (MAXP,Kc)
            nsel = jnp.einsum("ghp,pki->ghki", oh, nck, precision=HIGHEST)
            dsel = jnp.einsum("ghp,pk->ghk", oh, dck, precision=HIGHEST)
            # err over (gh, P, gw, P, Kc); sanitized degenerate models
            # (pad_hyp) give |err| ~ 1e30 -> outlier everywhere.
            e = (x4[..., None] * nsel[:, None, :, None, :, 0]
                 + y4[..., None] * nsel[:, None, :, None, :, 1]
                 + z4[..., None] * nsel[:, None, :, None, :, 2]
                 + dsel[:, None, :, None, :])
            out = (~(jnp.abs(e) < thr)).astype(jnp.float32)
            cell_out = jnp.sum(out, axis=(1, 3))             # (gh,gw,Kc)
            # Cells of label 0 carry no one-hot row: excluded exactly.
            return jnp.einsum("ghp,ghk->pk", oh, cell_out, precision=HIGHEST)

        def cond(c):
            s, reached, *_ = c
            return (~jnp.all(reached)) & (s < S)

        def body(c):
            s, reached, run_best, best_loss, best_k = c
            loss = chunk_losses(s)                           # (MAXP,Kc)
            inliers = n_pts_plane[:, None] - loss
            run = jax.lax.associative_scan(
                jnp.maximum, jnp.maximum(inliers, run_best[:, None]),
                axis=1)
            hit = run >= target[:, None]
            stop = jnp.where(jnp.any(hit, 1), jnp.argmax(hit, 1), Kc - 1)
            prefix = jnp.where(jnp.arange(Kc)[None, :] <= stop[:, None],
                               loss, jnp.inf)
            j = jnp.argmin(prefix, axis=1)
            pl = jnp.take_along_axis(prefix, j[:, None], 1)[:, 0]
            # Planes that stopped in an EARLIER chunk are frozen; strict <
            # keeps the first global minimum (argmin tie rule).
            upd = (~reached) & (pl < best_loss)
            best_loss = jnp.where(upd, pl, best_loss)
            best_k = jnp.where(upd, s * Kc + j, best_k)
            reached = reached | jnp.any(hit, 1)
            run_best = jnp.maximum(run_best, run[:, -1])
            return (s + 1, reached, run_best, best_loss, best_k)

        init = (jnp.int32(0), jnp.zeros(MAXP, bool),
                jnp.full(MAXP, -jnp.inf, jnp.float32),
                jnp.full(MAXP, jnp.inf, jnp.float32),
                jnp.zeros(MAXP, jnp.int32))
        *_, best_k_all = jax.lax.while_loop(cond, body, init)
        best_n = jnp.take_along_axis(
            n_all, best_k_all[:, None, None], axis=1)[:, 0]  # (MAXP,3)
        best_d = jnp.take_along_axis(d_all, best_k_all[:, None], 1)[:, 0]
    else:
        # --- per-plane scanned scoring (pixel fallback path) ---
        def score_plane(carry, inp):
            p, k = inp
            n, d = pad_hyp(*per_plane(p, k))
            n_ch = n.reshape(S, Kc, 3)
            d_ch = d.reshape(S, Kc)
            mask = (labels == p).astype(jnp.float32)        # (N,)
            n_p = jnp.sum(mask)
            target = ratio * n_p

            def chunk_loss(s):
                # (N, Kc) distances via one matmul (HIGHEST: a reduced
                # precision cannot rank |err| < 1-unit thresholds of
                # 5e4-scale coordinates), outliers counted by a second.
                # The negated-< form keeps any non-finite distance an
                # outlier (defense in depth on top of pad_hyp's
                # sanitization).
                err = jax.lax.dot(pts, n_ch[s].T,
                                  precision=HIGHEST) \
                    + d_ch[s][None, :]
                outlier = (~(jnp.abs(err) < thr)).astype(jnp.float32)
                return jnp.matmul(mask, outlier, precision=HIGHEST)  # (Kc,)

            def cond(c):
                s, reached, run_best, best_loss, best_k = c
                return (~reached) & (s < S)

            def body(c):
                s, reached, run_best, best_loss, best_k = c
                loss = chunk_loss(s)
                inliers = n_p - loss
                run = jax.lax.associative_scan(
                    jnp.maximum, jnp.maximum(inliers, run_best))
                hit = run >= target
                stop = jnp.where(jnp.any(hit), jnp.argmax(hit), Kc - 1)
                prefix_loss = jnp.where(jnp.arange(Kc) <= stop, loss,
                                        jnp.inf)
                j = jnp.argmin(prefix_loss)
                better = prefix_loss[j] < best_loss
                best_loss = jnp.where(better, prefix_loss[j], best_loss)
                best_k = jnp.where(better, s * Kc + j, best_k)
                return (s + 1, jnp.any(hit), run[-1], best_loss, best_k)

            init = (jnp.int32(0), jnp.bool_(False),
                    jnp.float32(-jnp.inf), jnp.float32(jnp.inf),
                    jnp.int32(0))
            *_, best = jax.lax.while_loop(cond, body, init)
            return carry, (n[best], d[best])

        _, (best_n, best_d) = jax.lax.scan(score_plane, None,
                                           (plane_ids, keys))

    # Final inlier pass: each labeled pixel keeps its label iff it is an
    # inlier of its plane's best model (FindInliers, RANSAC.hpp:53-62).
    lbl_idx = jnp.clip(labels - 1, 0, MAXP - 1)
    n_pix = best_n[lbl_idx]                                 # (N, 3)
    d_pix = best_d[lbl_idx]
    err = jnp.sum(pts * n_pix, axis=-1) + d_pix
    keep = jnp.abs(err) < thr
    return jnp.where((labels > 0) & ~keep, 0, labels)
