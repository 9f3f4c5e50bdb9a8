"""Stage 2 — spherical normals histogram for seed selection.

Vectorized equivalent of NormalsHistogram (normals_histogram.cpp:21-72):
the per-cell bin assignment is one vectorized pass; the mutable histogram of
the serial code (decremented as cells are consumed) is represented by the
per-cell `bins` array alone — a round's histogram is recomputed as a cheap
scatter-add over live cells, which keeps the while-loop state minimal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def normal_bins(normal: jax.Array, planar: jax.Array, nr_bins: int) -> jax.Array:
    """Bin index per cell; -1 for non-planar cells.

    normal: (..., 3) oriented unit normals; planar: (...) bool.
    Mirrors normals_histogram.cpp:27-48: polar = acos(-nz) in [0, pi],
    azimuth = atan2(nx/rho, ny/rho) in [-pi, pi], quantized to
    (nr_bins-1) steps, azimuth bin forced to 0 when the polar bin is 0.
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    rho = jnp.sqrt(nx * nx + ny * ny)
    polar = jnp.arccos(jnp.clip(-nz, -1.0, 1.0))
    # Reference divides by rho unguarded (NaN when rho == 0); we define the
    # azimuth as 0 there — such normals land in polar bin 0 or nr_bins-1 and
    # for bin 0 the azimuth is ignored anyway.
    safe_rho = jnp.where(rho > 0, rho, 1.0)
    azimuth = jnp.arctan2(nx / safe_rho, ny / safe_rho)
    azimuth = jnp.where(rho > 0, azimuth, 0.0)

    xq = ((nr_bins - 1) * polar / jnp.pi).astype(jnp.int32)
    yq = ((nr_bins - 1) * (azimuth + jnp.pi) / (2 * jnp.pi)).astype(jnp.int32)
    yq = jnp.where(xq > 0, yq, 0)
    bins = yq * nr_bins + xq
    return jnp.where(planar, bins, -1)


def histogram_counts(bins: jax.Array, nr_bins: int) -> jax.Array:
    """Histogram over live (bin >= 0) cells -> (nr_bins^2,) int32.

    A dense (cells, bins) equality mask + sum, which XLA fuses into one
    reduction; this is the XLA reference loop's histogram (the CUDA kernel
    keeps its histogram in shared memory and decrements it as cells are
    consumed).
    """
    flat = bins.reshape(-1)
    size = nr_bins * nr_bins
    eq = flat[:, None] == jnp.arange(size, dtype=bins.dtype)[None, :]
    return jnp.sum(eq, axis=0, dtype=jnp.int32)
