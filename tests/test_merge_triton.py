"""Triton merge kernel against the XLA greedy loop (interpret mode on CPU).

The kernel runs merge_planes_from_adjacency's rows with the same arithmetic;
only the order of its block sums differs. Merge labels must be equal and the
merged statistics agree to f32 reduction-order tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deplex_tpu import Config
from deplex_tpu.ops.cellstats import compute_cell_stats
from deplex_tpu.ops.growing import grow_planes
from deplex_tpu.ops.merge import merge_planes, merge_planes_device
from deplex_tpu.ops.merge_triton import merge_planes_triton
from deplex_tpu.pipeline import backproject_device


def _grown(pts_batch, h, w, cfg):
    stats = jax.vmap(lambda p: compute_cell_stats(p, h, w, cfg))(pts_batch)
    return jax.vmap(lambda s: grow_planes(s, cfg))(stats)


def _per_slot_close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if ref.shape[-2:] == (3, 3):
        scale = np.abs(np.trace(ref, axis1=-2, axis2=-1))[..., None, None]
    elif ref.shape[-1] == 3:
        scale = np.linalg.norm(ref, axis=-1, keepdims=True)
    else:
        scale = np.abs(ref)
    assert (np.abs(got - ref) <= rtol * scale + 1e-6).all()


def _assert_matches_xla(lm, seg, cfg):
    ml_ref, m_ref = jax.vmap(lambda l, s: merge_planes(l, s, cfg))(lm, seg)
    ml_got, m_got = jax.vmap(
        lambda l, s: merge_planes_triton(l, s, cfg, interpret=True))(lm, seg)
    np.testing.assert_array_equal(np.asarray(ml_got), np.asarray(ml_ref))
    np.testing.assert_array_equal(np.asarray(m_got.n), np.asarray(m_ref.n))
    for f in ("coord_sum", "scatter", "mean", "d"):
        _per_slot_close(getattr(m_got, f), getattr(m_ref, f), 1e-5)
    np.testing.assert_allclose(np.asarray(m_got.normal), np.asarray(m_ref.normal),
                               atol=1e-5)
    return np.asarray(ml_got)


def test_tum_golden_batch(tum_cloud):
    """Shifted copies of the TUM frame; B=3 becomes the kernel's grid."""
    pts, h, w = tum_cloud
    cfg = Config()
    depth = np.asarray(pts, np.float32).reshape(h, w, 3)[..., 2]
    rng = np.random.default_rng(0)
    rolls = [np.roll(depth, (int(rng.integers(0, 8)), int(rng.integers(0, 8))),
                     (0, 1)) for _ in range(3)]
    K = jnp.asarray([[520.9, 0, 325.1], [0, 521.0, 249.7], [0, 0, 1]],
                    jnp.float32)
    pts_b = jax.vmap(lambda d: backproject_device(jnp.asarray(d), K))(
        jnp.asarray(np.stack(rolls)))
    lm, seg = _grown(pts_b, h, w, cfg)
    ml = _assert_matches_xla(lm, seg, cfg)
    assert (ml != np.arange(cfg.max_planes)).any(), "no merge happened"


def _staircase(n_frames, seed=7, h=120, w=160):
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n_frames):
        z = np.full((h, w), 4000.0, np.float32)
        for _ in range(6):
            r0, c0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
            z[r0:r0 + 40, c0:c0 + 40] = rng.uniform(2000, 6000)
        frames.append(z)
    K = jnp.asarray([[200.0, 0, w / 2], [0, 200.0, h / 2], [0, 0, 1]],
                    jnp.float32)
    return jax.vmap(lambda d: backproject_device(jnp.asarray(d), K))(
        jnp.asarray(np.stack(frames))), h, w


def test_synthetic_multi_plane_batch():
    """Random staircase scenes: many touching coplanar segments to merge."""
    pts_b, h, w = _staircase(4)
    cfg = Config(patch_size=10)
    lm, seg = _grown(pts_b, h, w, cfg)
    _assert_matches_xla(lm, seg, cfg)


@pytest.mark.parametrize("max_planes", [8, 20, 64, 100])
def test_slot_padding(max_planes, tum_cloud):
    """MAXP is padded to a power-of-two block of slots (16 at least); the
    padding slots never merge and are cropped."""
    pts, h, w = tum_cloud
    cfg = Config(max_planes=max_planes)
    lm, seg = _grown(jnp.asarray(pts)[None], h, w, cfg)
    ml = _assert_matches_xla(lm, seg, cfg)
    assert ml.shape == (1, max_planes)


def test_empty_frame_identity():
    cfg = Config()
    pts = jnp.zeros((1, 480 * 640, 3), jnp.float32)
    lm, seg = _grown(pts, 480, 640, cfg)
    ml, merged = jax.vmap(
        lambda l, s: merge_planes_triton(l, s, cfg, interpret=True))(lm, seg)
    np.testing.assert_array_equal(
        np.asarray(ml), np.arange(cfg.max_planes, dtype=np.int32)[None])
    assert int(merged.nr_planes[0]) == 0


def test_platform_dispatch(tum_cloud):
    """The CUDA lowering of merge_planes_device is the Triton kernel; on the
    CPU it is the XLA loop, with merge_planes' labels."""
    pts, h, w = tum_cloud
    cfg = Config()
    lm, seg = _grown(jnp.asarray(pts)[None], h, w, cfg)
    lm, seg = lm[0], jax.tree.map(lambda a: a[0], seg)
    fn = jax.jit(lambda l, s: merge_planes_device(l, s, cfg)[0])
    cuda_text = fn.trace(lm, seg).lower(lowering_platforms=("cuda",)).as_text()
    cpu_text = fn.trace(lm, seg).lower(lowering_platforms=("cpu",)).as_text()
    assert "__gpu$xla.gpu.triton" in cuda_text and "deplex_merge_planes" in cuda_text
    assert "triton" not in cpu_text
    np.testing.assert_array_equal(np.asarray(fn(lm, seg)),
                                  np.asarray(merge_planes(lm, seg, cfg)[0]))
