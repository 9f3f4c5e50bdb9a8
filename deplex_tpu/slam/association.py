"""Frame-to-map plane association.

Matches the MAXP plane observations of a frame against the M map landmarks:
landmarks are transformed into the camera with the pose prior, then each
observation picks the best landmark by a gated score (normal angle +
offset distance + centroid-to-plane distance). Greedy one-to-one
resolution is done with a fixed MAXP-round fori_loop (MAXP is small), all
dense — no data-dependent shapes.

This implements the capability the reference only stubs out
(/root/reference/python/deplex/association/foo.py) as a real batched
module.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from deplex_tpu.slam.planes import PlaneObs, transform_plane
from deplex_tpu.precision import HIGHEST


class AssociationParams(NamedTuple):
    min_cos_angle: float = 0.95      # normal agreement gate
    # Distance gates must absorb (tracking drift + plane-fit noise), not
    # just noise: at 100 mm a ~35 mm pose drift collapsed the match set on
    # the warped-TUM sequence (23 -> 13 matches) and tracking diverged 4x;
    # at 200 mm the match set stays intact and the Huber loss in
    # estimate_pose downweights any misassociation the looser gate admits.
    max_offset_dist: float = 200.0   # |d_obs - d_pred| gate (depth units, mm)
    max_point_dist: float = 200.0    # centroid-to-predicted-plane gate (mm)
    # Landmark-spawn suppression gates — deliberately LOOSER than the match
    # gates. An observation that barely fails the match gate (cos 0.94,
    # offset 110 mm) is far likelier to be a drifted/noisy view of an
    # existing landmark than a new plane; spawning it forks the map, and
    # duplicated landmarks then compete in the one-to-one association and
    # drag odometry (measured on the warped-TUM sequence: symmetric gates
    # spawned 14 duplicates in 2 frames and tracking diverged 4x).
    dup_cos_angle: float = 0.85      # near-dup normal gate for spawning
    dup_offset_dist: float = 300.0   # near-dup offset gate for spawning


class Matches(NamedTuple):
    landmark: jax.Array   # (MAXP,) int32 landmark index, -1 = unmatched
    valid: jax.Array      # (MAXP,) bool — observation has a match


def associate(obs: PlaneObs, lm_normal: jax.Array, lm_d: jax.Array,
              lm_valid: jax.Array, R: jax.Array, t: jax.Array,
              params: AssociationParams = AssociationParams()) -> Matches:
    """Greedy one-to-one association, best-score-first.

    obs: PlaneObs in camera frame; lm_*: (M,) landmarks in world frame;
    (R, t): camera-from-world pose prior.
    """
    MAXP = obs.d.shape[0]
    n_pred, d_pred = transform_plane(R, t, lm_normal, lm_d)       # (M, 3), (M,)

    cos = jnp.einsum("pi,mi->pm", obs.normal, n_pred, precision=HIGHEST)
    d_diff = jnp.abs(obs.d[:, None] - d_pred[None, :])
    pt_dist = jnp.abs(jnp.einsum("pi,mi->pm", obs.mean, n_pred, precision=HIGHEST)
                      + d_pred[None, :])

    ok = ((cos >= params.min_cos_angle)
          & (d_diff <= params.max_offset_dist)
          & (pt_dist <= params.max_point_dist)
          & (obs.weight > 0)[:, None]
          & lm_valid[None, :])
    # Score: lower is better — combined normalized distance.
    score = jnp.where(
        ok,
        (1.0 - cos) / max(1.0 - params.min_cos_angle, 1e-6)
        + d_diff / params.max_offset_dist + pt_dist / params.max_point_dist,
        jnp.inf)

    def body(_, carry):
        score_m, lm_of_obs = carry
        flat = jnp.argmin(score_m)
        p, m = flat // score_m.shape[1], flat % score_m.shape[1]
        have = jnp.isfinite(score_m[p, m])
        lm_of_obs = jnp.where(have, lm_of_obs.at[p].set(m), lm_of_obs)
        score_m = jnp.where(have, score_m.at[p, :].set(jnp.inf), score_m)
        score_m = jnp.where(have, score_m.at[:, m].set(jnp.inf), score_m)
        return score_m, lm_of_obs

    _, lm_of_obs = jax.lax.fori_loop(
        0, MAXP, body, (score, jnp.full((MAXP,), -1, jnp.int32)))
    return Matches(landmark=lm_of_obs, valid=lm_of_obs >= 0)
