"""Stage-1 cell moments: plain block sums against float64 numpy.

The moments are anchored at each cell's first pixel and the centering is
folded, which costs ~2 bits: coord_sum holds to rtol 1e-5, the scatter
matrix to 1e-3 of its trace. Gate counts are integers and exact.
"""

import numpy as np
import pytest

from deplex_tpu import Config
from deplex_tpu.ops.cellstats import cell_moments, compute_cell_moments
from deplex_tpu.oracle.reference_impl import cell_moments_oracle


def _hires_points():
    """The synthetic 720p scene of tests/test_stress.py."""
    H, W = 720, 1280
    u = (np.arange(W, dtype=np.float32)[None, :] - (W / 2 - 0.5)) / 1000.0
    v = (np.arange(H, dtype=np.float32)[:, None] - (H / 2 - 0.5)) / 1000.0
    z = np.minimum(np.minimum(np.where(v > 0.15, 1000.0 / np.maximum(v, 0.15), np.inf),
                              np.float32(4000.0)),
                   np.where(u > 0.15, 1500.0 / np.maximum(u, 0.15), np.inf))
    z = (z + np.random.default_rng(0).normal(scale=2.0, size=z.shape)).astype(np.float32)
    u, v = np.broadcast_to(u, (H, W)), np.broadcast_to(v, (H, W))
    return np.stack([u * z, v * z, z], -1).reshape(-1, 3), H, W


@pytest.fixture(scope="module")
def frames(tum_cloud, icl_cloud):
    pts, h, w = tum_cloud
    crop = pts.reshape(h, w, 3)[:237, :301].reshape(-1, 3)
    return {
        "tum_p10": (tum_cloud, Config()),
        "icl_p4": (icl_cloud, Config(patch_size=4)),
        "synth720p_p8": (_hires_points(), Config(patch_size=8)),
        "nondivisible_p7": ((crop, 237, 301), Config(patch_size=7)),
    }


CASES = ["tum_p10", "icl_p4", "synth720p_p8", "nondivisible_p7"]


@pytest.mark.parametrize("case", CASES)
def test_moments_match_float64(frames, case):
    (pts, h, w), cfg = frames[case]
    got = compute_cell_moments(pts, h, w, cfg)
    ref = cell_moments_oracle(pts, h, w, cfg)
    cs = np.asarray(got.coord_sum, np.float64)
    assert cs.shape == ref["coord_sum"].shape
    assert (np.abs(cs - ref["coord_sum"])
            <= 1e-5 * np.abs(ref["coord_sum"]) + 1e-3).all()
    tr = np.trace(ref["scatter"], axis1=-2, axis2=-1)[..., None, None]
    err = np.abs(np.asarray(got.scatter, np.float64) - ref["scatter"])
    assert (err <= 1e-3 * tr + 1e-3).all(), float((err / np.maximum(tr, 1e-9)).max())
    np.testing.assert_allclose(np.asarray(got.diam), ref["diam"], rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("case", CASES)
def test_gate_counts_exact(frames, case):
    """Valid-point counts and both continuity walks are integer-exact."""
    (pts, h, w), cfg = frames[case]
    got = compute_cell_moments(pts, h, w, cfg)
    ref = cell_moments_oracle(pts, h, w, cfg)
    for field in ("nr_valid", "disc_h", "disc_v"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)), ref[field],
                                      err_msg=field)


def test_folded_diagonal_clamped_at_zero():
    """A cell of one repeated point has zero scatter; the folded form's
    rounding must not leave a negative diagonal entry."""
    P = 10
    rng = np.random.default_rng(1)
    x = np.repeat(np.repeat(rng.uniform(-5e3, 5e3, (4, 4)), P, 0), P, 1).astype(np.float32)
    y = np.repeat(np.repeat(rng.uniform(-5e3, 5e3, (4, 4)), P, 0), P, 1).astype(np.float32)
    z = np.repeat(np.repeat(rng.uniform(1e3, 6e4, (4, 4)), P, 0), P, 1).astype(np.float32)
    # Not-quite-constant cells: anchoring makes most terms exactly zero.
    x += rng.normal(scale=1e-3, size=x.shape).astype(np.float32)
    _, scatter = cell_moments(x, y, z, P)
    diag = np.diagonal(np.asarray(scatter), axis1=-2, axis2=-1)
    assert (diag >= 0).all()
