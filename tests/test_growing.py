"""Region growing: the XLA loop against the serial oracle, and the CUDA
kernel's wrapper (packing, unpacking, batching, platform dispatch).

The kernel itself runs only on a GPU (test_gpu_kernels.py and chip_smoke.py);
here its FFI call is replaced by the XLA decisions on the packed inputs, so
everything around the call is exercised on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deplex_tpu import Config
from deplex_tpu.ops import growing
from deplex_tpu.ops.cellstats import compute_cell_stats
from deplex_tpu.ops.growing import (admissibility_edges, finalize_rounds,
                                    grow_decisions, grow_rounds,
                                    grow_rounds_cuda, grow_rounds_device,
                                    pack_flags)
from deplex_tpu.ops.histogram import normal_bins
from deplex_tpu.oracle.reference_impl import grow_rounds_oracle

_DIRS = ("from_up", "from_down", "from_left", "from_right")


def _unpack(flags):
    edges = {name: (flags >> bit) & 1 > 0 for bit, name in enumerate(_DIRS)}
    return edges, (flags >> 4) & 1 > 0


def _stub_call(calls):
    """Stand-in for the FFI call: the XLA decisions on the packed inputs."""
    def call(bins, mse, flags, config):
        calls.append(bins.shape)
        edges, planar = _unpack(flags)
        return grow_decisions(bins, mse, edges, planar, config)
    return call


def _stats(cloud, cfg, crop=None):
    pts, h, w = cloud
    if crop is not None:
        h, w = crop
        pts = pts.reshape(cloud[1], cloud[2], 3)[:h, :w].reshape(-1, 3)
    return compute_cell_stats(pts, h, w, cfg)


@pytest.fixture(scope="module")
def icl_config():
    import pathlib

    ini = pathlib.Path(__file__).resolve().parent.parent / "data" / "configs"
    return Config.from_ini(str(ini / "ICL_living_room.ini"))


@pytest.mark.parametrize("case", ["tum", "icl", "empty", "odd"])
def test_grow_rounds_matches_serial_oracle(case, tum_cloud, icl_cloud, icl_config):
    """The XLA loop's integer decisions equal the serial BFS oracle's."""
    if case == "tum":
        cfg, stats = Config(), _stats(tum_cloud, Config())
    elif case == "icl":
        cfg, stats = icl_config, _stats(icl_cloud, icl_config)
    elif case == "empty":
        cfg = Config()
        stats = compute_cell_stats(np.zeros((480 * 640, 3), np.float32), 480, 640, cfg)
    else:   # 33x45 cells at P=7: nothing is a multiple of anything
        cfg = Config(patch_size=7, max_region_growing_rounds=128)
        stats = _stats(tum_cloud, cfg, crop=(231, 315))
    got = grow_rounds(stats, cfg)
    bins = normal_bins(stats.normal, stats.planar, cfg.histogram_bins_per_coord)
    edges = {k: np.asarray(v) for k, v in admissibility_edges(stats, cfg).items()}
    rm, seeds, nr = grow_rounds_oracle(np.asarray(bins), np.asarray(stats.mse), edges,
                                       np.asarray(stats.planar), cfg)
    assert int(got.nr_rounds) == nr
    np.testing.assert_array_equal(np.asarray(got.round_map), rm)
    np.testing.assert_array_equal(np.asarray(got.seeds), seeds)
    if case == "empty":
        assert nr == 0 and (rm == -1).all()


def test_pack_flags_roundtrip(tum_cloud):
    cfg = Config()
    stats = _stats(tum_cloud, cfg)
    edges = admissibility_edges(stats, cfg)
    flags = pack_flags(edges, stats.planar)
    assert flags.dtype == jnp.uint8 and flags.shape == stats.planar.shape
    got_edges, got_planar = _unpack(flags)
    np.testing.assert_array_equal(got_planar, stats.planar)
    for name in _DIRS:
        np.testing.assert_array_equal(got_edges[name], edges[name])
    assert int(jnp.max(flags)) < 32


@pytest.mark.parametrize("case", ["tum", "icl"])
def test_cuda_wrapper_matches_grow_rounds(case, tum_cloud, icl_cloud, icl_config,
                                          monkeypatch):
    """grow_rounds_cuda around a stubbed call gives grow_rounds' RoundData:
    the inputs are packed and the outputs unpacked correctly."""
    calls = []
    monkeypatch.setattr(growing, "_grow_rounds_call", _stub_call(calls))
    cfg = Config() if case == "tum" else icl_config
    stats = _stats(tum_cloud if case == "tum" else icl_cloud, cfg)
    ref = grow_rounds(stats, cfg)
    got = grow_rounds_cuda(stats, cfg)
    assert calls == [stats.planar.shape]
    for f in ("round_map", "seeds", "nr_rounds"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(np.asarray(got.sums), np.asarray(ref.sums),
                               rtol=1e-6, atol=1e-3)


def test_cuda_wrapper_batches_under_vmap(tum_cloud):
    """Under vmap the FFI call is made once with the frames as its leading
    axis (vmap_method="broadcast_all"): the kernel's own batch axis."""
    import re

    cfg = Config(max_region_growing_rounds=128)
    stats = _stats(tum_cloud, cfg, crop=(240, 320))
    batch = jax.tree.map(lambda a: jnp.stack([a, a, a]), stats)
    fn = jax.jit(jax.vmap(lambda s: grow_rounds_cuda(s, cfg)))
    text = fn.trace(batch).lower(lowering_platforms=("cuda",)).as_text()
    calls = re.findall(r"custom_call @deplex_grow_rounds\(.*", text)
    assert len(calls) == 1
    sig = calls[0]
    assert "tensor<3x24x32xi32>" in sig and "tensor<3x24x32xui8>" in sig
    assert "tensor<3x128xi32>" in sig and "tensor<3xi32>" in sig
    for attr in ("r_max = 128", "nbins2 = 400", "min_candidates = 5"):
        assert attr in sig, attr
    out = jax.eval_shape(fn, batch)
    assert out.round_map.shape == (3, 24, 32) and out.sums.shape == (3, 128, 16)


def test_platform_dispatch(tum_cloud):
    """The CUDA lowering holds the kernel's custom call; the CPU lowering
    does not, and runs the XLA loop with grow_rounds' result."""
    cfg = Config()
    stats = _stats(tum_cloud, cfg, crop=(120, 160))
    fn = jax.jit(lambda s: grow_rounds_device(s, cfg).round_map)
    cuda_text = fn.trace(stats).lower(lowering_platforms=("cuda",)).as_text()
    cpu_text = fn.trace(stats).lower(lowering_platforms=("cpu",)).as_text()
    assert "deplex_grow_rounds" in cuda_text
    assert "deplex_grow_rounds" not in cpu_text
    np.testing.assert_array_equal(np.asarray(fn(stats)),
                                  np.asarray(grow_rounds(stats, cfg).round_map))


def test_finalize_of_wrapper_labels(tum_cloud, monkeypatch):
    """End of stage 3 through the wrapper: the TUM frame's 34 segments."""
    monkeypatch.setattr(growing, "_grow_rounds_call", _stub_call([]))
    cfg = Config()
    stats = _stats(tum_cloud, cfg)
    lm, seg = finalize_rounds(grow_rounds_cuda(stats, cfg), cfg)
    lm_ref, seg_ref = finalize_rounds(grow_rounds(stats, cfg), cfg)
    np.testing.assert_array_equal(np.asarray(lm), np.asarray(lm_ref))
    assert int(seg.nr_planes) == int(seg_ref.nr_planes) == 34
