"""The CUDA growing kernel and the Triton merge kernel compiled for the card,
against the XLA references. Card-only: these skip without a GPU; chip_smoke.py
runs the same comparisons at every shape it covers."""

import jax
import numpy as np
import pytest

from deplex_tpu import Config

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        pytest.skip("no GPU: the CUDA and Triton kernels run only on the card")
    return devices[0]


@pytest.fixture(scope="module")
def tum_stats_gpu(gpu, tum_cloud):
    from deplex_tpu.ops.cellstats import compute_cell_stats

    pts, h, w = tum_cloud
    cfg = Config()
    return jax.jit(lambda p: compute_cell_stats(p, h, w, cfg))(
        jax.device_put(pts, gpu)), cfg


def test_growing_kernel_bit_equal(tum_stats_gpu):
    from deplex_tpu.ops.growing import grow_rounds, grow_rounds_cuda

    stats, cfg = tum_stats_gpu
    ref = jax.jit(lambda s: grow_rounds(s, cfg))(stats)
    got = jax.jit(lambda s: grow_rounds_cuda(s, cfg))(stats)
    for f in ("round_map", "seeds", "nr_rounds"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_merge_kernel_labels_equal(tum_stats_gpu):
    from deplex_tpu.ops.growing import grow_planes
    from deplex_tpu.ops.merge import merge_planes
    from deplex_tpu.ops.merge_triton import merge_planes_triton

    stats, cfg = tum_stats_gpu
    lm, seg = jax.jit(lambda s: grow_planes(s, cfg))(stats)
    ref, _ = jax.jit(lambda l, s: merge_planes(l, s, cfg))(lm, seg)
    got, _ = jax.jit(lambda l, s: merge_planes_triton(l, s, cfg))(lm, seg)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
