"""Batched + sharded extraction tests on the simulated 8-device CPU mesh.

The reference has no batch/multi-device story at all (SURVEY.md §2.4); these
validate the new scale-out path: vmap batching must be label-exact
vs single-frame, and mesh sharding must be label-exact vs vmap.
"""

import jax
import numpy as np
from jax.sharding import Mesh

from deplex_tpu import Config, PlaneExtractor
from deplex_tpu.parallel.batch import BatchPlaneExtractor, ShardedPlaneExtractor


def _small_frames(tum_cloud, n):
    """Stack n crops of the TUM frame as a small batch (fast on CPU)."""
    pts, h, w = tum_cloud
    img = pts.reshape(h, w, 3)
    crop = img[:120, :160].reshape(-1, 3)
    batch = np.stack([np.roll(crop, i, axis=0) * (1.0 + 0.01 * i) for i in range(n)])
    return batch.astype(np.float32), 120, 160


def test_batch_matches_single(tum_cloud):
    batch, h, w = _small_frames(tum_cloud, 4)
    single = PlaneExtractor(h, w, Config())
    batched = BatchPlaneExtractor(h, w, Config())
    out = batched.process(batch)
    assert out.shape == (4, h * w)
    for i in range(4):
        np.testing.assert_array_equal(out[i], single.process(batch[i]))


def test_sharded_matches_batch(tum_cloud):
    batch, h, w = _small_frames(tum_cloud, 8)
    devices = np.array(jax.devices()[:8])
    mesh = Mesh(devices, axis_names=("data",))
    sharded = ShardedPlaneExtractor(h, w, Config(), mesh=mesh)
    plain = BatchPlaneExtractor(h, w, Config())
    np.testing.assert_array_equal(sharded.process(batch), plain.process(batch))


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8, "conftest must fake 8 CPU devices"
