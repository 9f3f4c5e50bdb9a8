"""Greedy plane merge (stage 4) as a Pallas kernel through Triton.

One program per frame holds the frame's plane slots as one block of lanes
(MAXP rounded up to a power of two, 64 by default) and runs the sequential
row loop of ops/merge.py:merge_planes_from_adjacency in registers: per row,
a handful of masked reductions over the block and one scalar 3x3 refit.
The XLA loop pays kernel launches for each of its ~40 rows of tiny work; here
a frame's whole loop is one program.

The arithmetic is the XLA loop's, row for row: the same candidate tests, the
same Chan combination about the new mean, and the same eigensolver
(ops/eigh3x3.py, called on scalars). Only the order of the block sums
differs, so merge labels are equal and the merged float statistics agree to
f32 reduction-order tolerance (tests/test_merge_triton.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from deplex_tpu.config import Config
from deplex_tpu.ops.eigh3x3 import eigh3x3_min_soa
from deplex_tpu.ops.growing import PlaneSegments

# Rows of the packed per-slot state block.
_ROWS = ("n", "cx", "cy", "cz", "mx", "my", "mz", "nx", "ny", "nz", "d",
         "xx", "xy", "xz", "yy", "yz", "zz")
_STATE_ROWS = 32          # _ROWS padded to a power of two


def _slots(max_planes: int) -> int:
    return max(16, pl.next_power_of_2(max_planes))


def _merge_kernel(assoc_ref, nrows_ref, state_ref, ml_ref, out_ref, *,
                  slots: int, min_cos: float, max_dist: float):
    f32 = jnp.float32
    lane = jax.lax.broadcasted_iota(jnp.int32, (slots,), 0)
    st = {k: state_ref[i, :] for i, k in enumerate(_ROWS)}
    nrows = jnp.max(nrows_ref[...])

    def body(row, carry):
        ml, st = carry
        pid = jnp.sum(jnp.where(lane == row, ml, 0))
        sel = lane == pid

        def at_pid(x):
            return jnp.sum(jnp.where(sel, x, f32(0)))

        npx, npy, npz = at_pid(st["nx"]), at_pid(st["ny"]), at_pid(st["nz"])
        d_pid = at_pid(st["d"])
        cand = (assoc_ref[row, :] != 0) & (lane > row)
        cos = st["nx"] * npx + st["ny"] * npy + st["nz"] * npz
        dist = (st["mx"] * npx + st["my"] * npy + st["mz"] * npz + d_pid) ** 2
        passing = cand & (cos > f32(min_cos)) & (dist < f32(max_dist))
        expanded = jnp.sum(passing.astype(jnp.int32)) > 0

        w = passing.astype(f32)
        n = st["n"]
        new_n = at_pid(n) + jnp.sum(w * n)
        new_s = [at_pid(st[c]) + jnp.sum(w * st[c]) for c in ("cx", "cy", "cz")]
        n_div = jnp.maximum(new_n, f32(1))
        mu = [s / n_div for s in new_s]
        # Chan k-way combination about the new mean: members are the
        # representative and the passing columns.
        w_all = w + sel.astype(f32)
        n_safe = jnp.maximum(n, f32(1))
        dmu = [st[c] / n_safe - m for c, m in zip(("cx", "cy", "cz"), mu)]
        new_sc = {}
        for k, (i, j) in zip(("xx", "xy", "xz", "yy", "yz", "zz"),
                             ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
            new_sc[k] = (jnp.sum(w_all * st[k])
                         + jnp.sum(w_all * n * dmu[i] * dmu[j]))
        # End-of-row refit of the representative (growing._fit_plane).
        _, (vx, vy, vz) = eigh3x3_min_soa(new_sc["xx"], new_sc["xy"],
                                          new_sc["xz"], new_sc["yy"],
                                          new_sc["yz"], new_sc["zz"])
        d_raw = -(mu[0] * vx + mu[1] * vy + mu[2] * vz)
        sign = jnp.where(d_raw > 0, f32(1), f32(-1))
        new = {"n": new_n, "cx": new_s[0], "cy": new_s[1], "cz": new_s[2],
               "mx": mu[0], "my": mu[1], "mz": mu[2],
               "nx": sign * vx, "ny": sign * vy, "nz": sign * vz,
               "d": jnp.abs(d_raw), **new_sc}
        upd = sel & expanded
        st = {k: jnp.where(upd, new[k], v) for k, v in st.items()}
        return jnp.where(passing, pid, ml), st

    ml, st = jax.lax.fori_loop(0, nrows, body, (lane, st))
    ml_ref[...] = ml
    out_ref[...] = jnp.zeros(out_ref.shape, f32)
    for i, k in enumerate(_ROWS):
        out_ref[i, :] = st[k]


def merge_planes_triton(labels_map: jax.Array, segments: PlaneSegments,
                        config: Config, *, interpret: bool = False):
    """Same contract as merge.merge_planes for one frame:
    (merge_labels (MAXP,) int32, merged PlaneSegments). Under vmap the frames
    become the kernel's grid."""
    from deplex_tpu.ops.merge import plane_adjacency

    maxp = config.max_planes
    slots = _slots(maxp)
    f32 = jnp.float32
    pad = slots - maxp

    assoc = jnp.pad(plane_adjacency(labels_map, maxp).astype(jnp.int32),
                    ((0, pad), (0, pad)))
    nrows = jnp.full((slots,), jnp.minimum(segments.nr_planes, maxp), jnp.int32)
    sc = segments.scatter
    cols = {"n": segments.n, "d": segments.d,
            "cx": segments.coord_sum[:, 0], "cy": segments.coord_sum[:, 1],
            "cz": segments.coord_sum[:, 2], "mx": segments.mean[:, 0],
            "my": segments.mean[:, 1], "mz": segments.mean[:, 2],
            "nx": segments.normal[:, 0], "ny": segments.normal[:, 1],
            "nz": segments.normal[:, 2], "xx": sc[:, 0, 0], "xy": sc[:, 0, 1],
            "xz": sc[:, 0, 2], "yy": sc[:, 1, 1], "yz": sc[:, 1, 2],
            "zz": sc[:, 2, 2]}
    state = jnp.stack([cols[k].astype(f32) for k in _ROWS])
    state = jnp.pad(state, ((0, _STATE_ROWS - len(_ROWS)), (0, pad)))

    kernel = functools.partial(
        _merge_kernel, slots=slots, min_cos=float(config.min_cos_angle_merge),
        max_dist=float(config.max_merge_dist))
    ml, out = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((slots,), jnp.int32),
                   jax.ShapeDtypeStruct((_STATE_ROWS, slots), f32)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=2, num_stages=1),
        interpret=interpret,
        name="deplex_merge_planes",
    )(assoc, nrows, state)

    r = {k: out[i, :maxp] for i, k in enumerate(_ROWS)}
    merged = PlaneSegments(
        nr_planes=segments.nr_planes, n=r["n"],
        coord_sum=jnp.stack([r["cx"], r["cy"], r["cz"]], -1),
        scatter=jnp.stack([
            jnp.stack([r["xx"], r["xy"], r["xz"]], -1),
            jnp.stack([r["xy"], r["yy"], r["yz"]], -1),
            jnp.stack([r["xz"], r["yz"], r["zz"]], -1)], -2),
        normal=jnp.stack([r["nx"], r["ny"], r["nz"]], -1),
        mean=jnp.stack([r["mx"], r["my"], r["mz"]], -1),
        d=r["d"], mse=segments.mse, score=segments.score)
    return ml[:maxp], merged
