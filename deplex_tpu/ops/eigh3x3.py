"""Batched closed-form symmetric 3x3 eigendecomposition.

Batched replacement for the reference's scalar dsyevh3 C routine
(/root/reference/libs/dsyev/src/dsyevh3.c:31-130, dsyevc3.c:31-80): Cardano's
analytic eigenvalues plus cross-product eigenvectors, vectorized over an
arbitrary batch of 3x3 covariance matrices so every cell of the grid is
solved simultaneously instead of one dsyevh3 call per cell.

Differences from the reference, by design:
  * Batched over N matrices (leading axes arbitrary).
  * Works in float32; matrices are pre-scaled by their max |entry| for
    conditioning (scale-invariant for eigenvectors, eigenvalues rescaled).
  * The reference's iterative QL fallback (dsyevq3.c) for ill-conditioned
    cross products is replaced by choosing the best of the three available
    column cross-products of (A - lambda I) — branch-free and batched.

The plane-fit consumer only needs: the eigenvector of the smallest
eigenvalue (plane normal), lambda_min (-> MSE), and lambda_max / trace
(-> planarity score).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _eigvals_soa(a, b, c, d, e, f):
    """Cardano eigenvalues from the 6 distinct entries, ascending.

    SoA core: every operand/intermediate is a batch-major plane (no
    trailing size-3 axes), so the whole computation is elementwise and
    fuses; no intermediate carries a 3-wide minor dimension. The ascending
    order is an explicit min/mid/max network instead of jnp.sort (which
    lowers a 3-long sort to a real device sort). The same code runs on
    scalars inside the Triton merge kernel (ops/merge_triton.py).

    Mirrors dsyevc3.c:31-80 (same characteristic-polynomial formulation).
    """
    de = d * e
    dd = d * d
    ee = e * e
    ff = f * f
    m = a + b + c
    c1 = (a * b + a * c + b * c) - (dd + ee + ff)
    c0 = c * dd + a * ee + b * ff - a * b * c - 2.0 * f * de

    p = m * m - 3.0 * c1
    q = m * (p - 1.5 * c1) - 13.5 * c0
    sqrt_p = jnp.sqrt(jnp.abs(p))

    phi = 27.0 * (0.25 * c1 * c1 * (p - c1) + c0 * (q + 6.75 * c0))
    phi = (1.0 / 3.0) * jnp.arctan2(jnp.sqrt(jnp.abs(phi)), q)

    cphi = sqrt_p * jnp.cos(phi)
    sphi = (1.0 / jnp.sqrt(3.0)) * sqrt_p * jnp.sin(phi)

    wc = (1.0 / 3.0) * (m - cphi)
    w0 = wc + cphi
    w1 = wc - sphi
    w2 = wc + sphi

    lo = jnp.minimum(jnp.minimum(w0, w1), w2)
    hi = jnp.maximum(jnp.maximum(w0, w1), w2)
    # Median via a min/max swap network: returns one of the three computed
    # roots EXACTLY (a sum-minus-extremes form can be off by ulps and even
    # land outside [lo, hi]), still sort/gather-free.
    mid = jnp.maximum(jnp.minimum(w0, w1),
                      jnp.minimum(jnp.maximum(w0, w1), w2))
    return lo, mid, hi


def _cross_soa(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def _eigvec_min_soa(a, b, c, d, e, f, lam):
    """Unit eigenvector for eigenvalue lam, SoA, branch-free.

    Takes the largest-norm cross product among the three column pairs of
    M = A - lam*I (all three are parallel to the eigenvector in exact
    arithmetic; picking the largest is the numerically best-conditioned one
    — this subsumes the reference's QL fallback, dsyevh3.c:102-118). The
    argmax is a pair of elementwise where-selections, not a gather.
    """
    # Columns of M = A - lam I (symmetric storage).
    c0x, c0y, c0z = a - lam, d, f
    c1x, c1y, c1z = d, b - lam, e
    c2x, c2y, c2z = f, e, c - lam
    v01 = _cross_soa(c0x, c0y, c0z, c1x, c1y, c1z)
    v12 = _cross_soa(c1x, c1y, c1z, c2x, c2y, c2z)
    v20 = _cross_soa(c2x, c2y, c2z, c0x, c0y, c0z)
    n01 = v01[0] * v01[0] + v01[1] * v01[1] + v01[2] * v01[2]
    n12 = v12[0] * v12[0] + v12[1] * v12[1] + v12[2] * v12[2]
    n20 = v20[0] * v20[0] + v20[1] * v20[1] + v20[2] * v20[2]
    # First-max tie-break in candidate order (01, 12, 20), matching the
    # previous argmax-over-stack semantics exactly.
    use12 = n12 > jnp.maximum(n01, n20)
    use01 = (~use12) & (n01 >= n20)
    vx = jnp.where(use12, v12[0], jnp.where(use01, v01[0], v20[0]))
    vy = jnp.where(use12, v12[1], jnp.where(use01, v01[1], v20[1]))
    vz = jnp.where(use12, v12[2], jnp.where(use01, v01[2], v20[2]))
    nrm = jnp.sqrt(vx * vx + vy * vy + vz * vz)
    safe = nrm > 0
    inv = 1.0 / jnp.where(safe, nrm, 1.0)
    # Degenerate (isotropic) matrices: fall back to e_z.
    return (jnp.where(safe, vx * inv, 0.0),
            jnp.where(safe, vy * inv, 0.0),
            jnp.where(safe, vz * inv, 1.0))


def eigh3x3_min_soa(xx, xy, xz, yy, yz, zz):
    """Smallest-eigenpair from the 6 distinct entries (batch-major planes).

    Returns ((w0, w1, w2), (vx, vy, vz)) — ascending eigenvalues and the
    unit eigenvector of w0, all shaped like the inputs. The (..., 3, 3)
    wrappers below pack/unpack at the boundary only.
    """
    scale = jnp.maximum(
        jnp.maximum(jnp.maximum(jnp.abs(xx), jnp.abs(yy)),
                    jnp.maximum(jnp.abs(zz), jnp.abs(xy))),
        jnp.maximum(jnp.abs(yz), jnp.abs(xz)))
    scale = jnp.where(scale > 0, scale, 1.0)
    inv = 1.0 / scale
    a, b, c = xx * inv, yy * inv, zz * inv
    d, e, f = xy * inv, yz * inv, xz * inv
    w0, w1, w2 = _eigvals_soa(a, b, c, d, e, f)
    v = _eigvec_min_soa(a, b, c, d, e, f, w0)
    return (w0 * scale, w1 * scale, w2 * scale), v


def eigvals3x3_sym(A: jax.Array) -> jax.Array:
    """Cardano eigenvalues of symmetric 3x3 matrices, ascending order.

    A: (..., 3, 3) symmetric. Returns (..., 3) eigenvalues sorted ascending.
    """
    lo, mid, hi = _eigvals_soa(A[..., 0, 0], A[..., 1, 1], A[..., 2, 2],
                               A[..., 0, 1], A[..., 1, 2], A[..., 0, 2])
    return jnp.stack([lo, mid, hi], axis=-1)


def _eigvec_for(A: jax.Array, lam: jax.Array) -> jax.Array:
    """Eigenvector of symmetric A for eigenvalue lam, batched, robust."""
    vx, vy, vz = _eigvec_min_soa(A[..., 0, 0], A[..., 1, 1], A[..., 2, 2],
                                 A[..., 0, 1], A[..., 1, 2], A[..., 0, 2],
                                 lam)
    return jnp.stack([vx, vy, vz], axis=-1)


def eigh3x3_min(A: jax.Array):
    """Smallest-eigenpair + spectrum summary for symmetric 3x3 batches.

    Returns (w, v_min): w = (..., 3) ascending eigenvalues, v_min = (..., 3)
    unit eigenvector of w[..., 0].
    Matrices are normalized by max|entry| for float32 conditioning.
    """
    (w0, w1, w2), (vx, vy, vz) = eigh3x3_min_soa(
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])
    return jnp.stack([w0, w1, w2], axis=-1), jnp.stack([vx, vy, vz], axis=-1)


def eigh3x3(A: jax.Array):
    """Full decomposition: ascending eigenvalues and all three eigenvectors.

    Returns (w, V) with V[..., :, k] the eigenvector for w[..., k] (matching
    numpy.linalg.eigh's column convention).
    """
    scale = jnp.max(jnp.abs(A), axis=(-2, -1), keepdims=True)
    scale = jnp.where(scale > 0, scale, 1.0)
    As = A / scale
    w = eigvals3x3_sym(As)
    v0 = _eigvec_for(As, w[..., 0])
    v2 = _eigvec_for(As, w[..., 2])
    v1 = jnp.cross(v2, v0)
    V = jnp.stack([v0, v1, v2], axis=-1)
    return w * scale[..., 0], V


# ---------------------------------------------------------------------------
# numpy twin (used by the serial oracle so oracle and device pipeline share the
# exact same eigensolver semantics; also handy for unit tests).
# ---------------------------------------------------------------------------

def eigh3x3_min_np(A: np.ndarray):
    A = np.asarray(A)
    scale = np.max(np.abs(A), axis=(-2, -1), keepdims=True)
    scale = np.where(scale > 0, scale, 1.0)
    As = A / scale

    a = As[..., 0, 0]; b = As[..., 1, 1]; c = As[..., 2, 2]
    d = As[..., 0, 1]; e = As[..., 1, 2]; f = As[..., 0, 2]
    de = d * e; dd = d * d; ee = e * e; ff = f * f
    m = a + b + c
    c1 = (a * b + a * c + b * c) - (dd + ee + ff)
    c0 = c * dd + a * ee + b * ff - a * b * c - 2.0 * f * de
    p = m * m - 3.0 * c1
    q = m * (p - 1.5 * c1) - 13.5 * c0
    sqrt_p = np.sqrt(np.abs(p))
    phi = 27.0 * (0.25 * c1 * c1 * (p - c1) + c0 * (q + 6.75 * c0))
    phi = (1.0 / 3.0) * np.arctan2(np.sqrt(np.abs(phi)), q)
    cphi = sqrt_p * np.cos(phi)
    sphi = (1.0 / np.sqrt(3.0)) * sqrt_p * np.sin(phi)
    w1 = (1.0 / 3.0) * (m - cphi)
    w = np.stack([w1 + cphi, w1 - sphi, w1 + sphi], axis=-1)
    w = np.sort(w, axis=-1)

    M = As - w[..., 0, None, None] * np.eye(3, dtype=As.dtype)
    c0v = M[..., :, 0]; c1v = M[..., :, 1]; c2v = M[..., :, 2]
    cands = np.stack([np.cross(c0v, c1v), np.cross(c1v, c2v), np.cross(c2v, c0v)], axis=-2)
    norms = np.sum(cands * cands, axis=-1)
    best = np.argmax(norms, axis=-1)
    v = np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    nrm = np.sqrt(np.sum(v * v, axis=-1, keepdims=True))
    safe = nrm > 0
    v = np.where(safe, v / np.where(safe, nrm, 1.0), np.array([0.0, 0.0, 1.0], dtype=As.dtype))
    return w * scale[..., 0], v
