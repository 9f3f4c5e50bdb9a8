"""Frame-batched and device-sharded plane extraction.

The reference has no batch dimension at all (one serial process() per frame,
examples/process_sequence.cpp:31-43). Frames are independent, so throughput
comes from:

  * vmap over a frame batch within one device: the growing and merge kernels
    take the batch as their own grid (one thread block or program per
    frame), so frames retire independently, and
  * sharding the batch axis over a 1-D "data" mesh with shard_map — no
    collectives are needed on the extraction path, and each device runs the
    single-device program on its shard (XLA cannot partition a custom call,
    so the kernels must see local shards).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deplex_tpu.config import Config


def _labels_from_stats_batch(stats, H: int, W: int, config: Config):
    """Batched stages 3-5: CellStats with leading B axis -> (B, H*W) labels,
    plus the merged cell labels when RANSAC refinement follows."""
    from deplex_tpu.ops.growing import grow_planes
    from deplex_tpu.ops.merge import (apply_label_lut, merge_planes_device,
                                      rasterize_labels)

    P = min(config.patch_size, min(H, W))
    labels_map, segments = jax.vmap(lambda s: grow_planes(s, config))(stats)
    merge_labels, _ = jax.vmap(
        lambda lm, sg: merge_planes_device(lm, sg, config))(labels_map, segments)
    labels = jax.vmap(
        lambda lm, ml: rasterize_labels(lm, ml, H, W, P))(labels_map, merge_labels)
    if not config.ransac_refinement:
        return labels, None
    return labels, jax.vmap(apply_label_lut)(labels_map, merge_labels)


def _refine_batch(points, labels, cell_lab, H: int, W: int, config: Config):
    """Batched stage 6: cell-grid RANSAC sampling (ops/ransac.py)."""
    from deplex_tpu.ops.ransac import refine_labels

    P = min(config.patch_size, min(H, W))
    return jax.vmap(lambda p, l, cl: refine_labels(
        p, l, config, cell_labels=cl, image_width=W, patch_size=P))(
            points, labels, cell_lab)


@functools.partial(jax.jit, static_argnames=("image_height", "image_width", "config"))
def extract_planes_batch_jit(points, *, image_height: int, image_width: int, config: Config):
    """points: (B, H*W, 3) -> (B, H*W) int32 labels."""
    return extract_planes_batch(points, image_height=image_height,
                                image_width=image_width, config=config)


def extract_planes_batch(points, *, image_height: int, image_width: int,
                         config: Config):
    """Unjitted body of extract_planes_batch_jit."""
    from deplex_tpu.ops.cellstats import compute_cell_stats

    H, W = image_height, image_width
    stats = jax.vmap(lambda p: compute_cell_stats(p, H, W, config))(points)
    labels, cell_lab = _labels_from_stats_batch(stats, H, W, config)
    if config.ransac_refinement:
        labels = _refine_batch(points, labels, cell_lab, H, W, config)
    return labels


def extract_depth_batch(depth_batch, intrinsics, config: Config):
    """(B, H, W) uint16 depth + (3,3) K -> (B, H*W) int32 labels.

    The serving path: the 6x smaller depth maps are uploaded and
    back-projected on the device (pipeline.backproject_device), where XLA
    fuses the expansion into the stage-1 block reductions.
    """
    from deplex_tpu.pipeline import backproject_device

    B, H, W = depth_batch.shape
    pts = jax.vmap(lambda d: backproject_device(d, intrinsics))(depth_batch)
    return extract_planes_batch(pts, image_height=H, image_width=W,
                                config=config)


@functools.partial(jax.jit, static_argnames=("config",))
def extract_depth_batch_jit(depth_batch, intrinsics, *, config: Config):
    """Jitted extract_depth_batch with uint8 labels (4x smaller readback;
    valid while max_planes <= 255)."""
    return extract_depth_batch(depth_batch, intrinsics, config).astype(jnp.uint8)


class BatchDepthExtractor:
    """Batched depth-map extractor with asynchronous pipelining.

    process_stream() keeps several batches in flight (jax async dispatch
    overlaps host->device copy, compute, and device->host readback), which
    hides transfer latency — the sustained-throughput serving mode.
    """

    def __init__(self, image_height: int, image_width: int,
                 config: Config | None = None, batch: int = 8):
        self._height = int(image_height)
        self._width = int(image_width)
        self._config = config if config is not None else Config()
        self._batch = int(batch)

    @property
    def batch(self) -> int:
        return self._batch

    def process(self, depth_batch, intrinsics) -> np.ndarray:
        d = jnp.asarray(depth_batch)
        K = jnp.asarray(intrinsics, jnp.float32)
        return np.asarray(extract_depth_batch_jit(d, K, config=self._config))

    def process_stream(self, depth_batches, intrinsics, max_in_flight: int = 4):
        """Yield label arrays for an iterable of (B, H, W) depth batches."""
        K = jnp.asarray(intrinsics, jnp.float32)
        in_flight = []
        for d in depth_batches:
            out = extract_depth_batch_jit(jnp.asarray(d), K, config=self._config)
            in_flight.append(out)
            if len(in_flight) >= max_in_flight:
                yield np.asarray(in_flight.pop(0))
        while in_flight:
            yield np.asarray(in_flight.pop(0))


class BatchPlaneExtractor:
    """Single-chip batched extractor: process B frames per dispatch."""

    def __init__(self, image_height: int, image_width: int,
                 config: Config | None = None):
        self._height = int(image_height)
        self._width = int(image_width)
        self._config = config if config is not None else Config()

    def process(self, pcd_batch) -> np.ndarray:
        pts = jnp.asarray(pcd_batch, dtype=jnp.float32)
        if pts.ndim != 3 or pts.shape[2] != 3 or pts.shape[1] != self._height * self._width:
            raise ValueError(
                f"Expected (B, {self._height * self._width}, 3) batch, got {pts.shape}")
        labels = extract_planes_batch_jit(pts, image_height=self._height,
                                          image_width=self._width, config=self._config)
        return np.asarray(labels)


class ShardedPlaneExtractor:
    """Multi-device extractor: batch axis sharded over a 1-D device mesh.

    mesh: a jax.sharding.Mesh with a 'data' axis (defaults to all local
    devices). The batch size must be divisible by the mesh size. The batched
    program runs under shard_map, once per device on its own frames.
    """

    def __init__(self, image_height: int, image_width: int,
                 config: Config | None = None, mesh: Mesh | None = None):
        self._height = int(image_height)
        self._width = int(image_width)
        self._config = config if config is not None else Config()
        if mesh is None:
            devices = np.array(jax.devices())
            mesh = Mesh(devices, axis_names=("data",))
        self._mesh = mesh
        self._sharding = NamedSharding(mesh, P("data", None, None))
        self._run = jax.jit(jax.shard_map(
            functools.partial(extract_planes_batch, image_height=self._height,
                              image_width=self._width, config=self._config),
            mesh=mesh, in_specs=P("data", None, None), out_specs=P("data", None),
            check_vma=False))

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    def process(self, pcd_batch) -> np.ndarray:
        pts = jnp.asarray(pcd_batch, dtype=jnp.float32)
        ndev = self._mesh.size
        if pts.shape[0] % ndev != 0:
            raise ValueError(f"Batch {pts.shape[0]} not divisible by mesh size {ndev}")
        pts = jax.device_put(pts, self._sharding)
        return np.asarray(self._run(pts))
