"""The jit-compiled plane-extraction pipeline.

Composes the five (plus optional RANSAC) stages into one XLA program per
(image_height, image_width, config) signature — the whole frame is processed
on-device with a single dispatch, vs. the reference's six sequential C++
stages (plane_extractor.cpp:187-283).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from deplex_tpu.config import Config
from deplex_tpu.ops.cellstats import compute_cell_stats
from deplex_tpu.ops.growing import finalize_rounds, grow_planes, grow_rounds_device
from deplex_tpu.ops.merge import merge_planes_device, rasterize_labels


def extract_planes(points: jax.Array, *, image_height: int, image_width: int,
                   config: Config) -> jax.Array:
    """points: (H*W, 3) organized cloud -> (H*W,) int32 labels (0 = none).

    Pure function of its inputs; jit/vmap/shard_map-compatible. Static args:
    image shape + config.
    """
    P = min(config.patch_size, min(image_height, image_width))
    if P == 0:
        raise ValueError(
            f"Error! Invalid config parameter: patchSize({config.patch_size})."
            " patchSize has to be positive.")

    stats = compute_cell_stats(points, image_height, image_width, config)
    labels_map, segments = grow_planes(stats, config)
    merge_labels, _ = merge_planes_device(labels_map, segments, config)
    labels = rasterize_labels(labels_map, merge_labels, image_height, image_width, P)

    if config.ransac_refinement:
        from deplex_tpu.ops.merge import apply_label_lut
        from deplex_tpu.ops.ransac import refine_labels
        labels = refine_labels(
            points, labels, config,
            cell_labels=apply_label_lut(labels_map, merge_labels),
            image_width=image_width, patch_size=P)
    return labels


@functools.partial(jax.jit, static_argnames=("image_height", "image_width", "config"))
def extract_planes_jit(points, *, image_height: int, image_width: int, config: Config):
    return extract_planes(points, image_height=image_height,
                          image_width=image_width, config=config)


def backproject_device(depth: jax.Array, intrinsics: jax.Array) -> jax.Array:
    """On-device pinhole back-projection: (H, W) uint16/float depth ->
    (H*W, 3) float32 organized cloud.

    On-device form of the reference's host-side DepthImage::toPointCloud
    (depth_image.cpp:55-78): the depth map is 6x smaller than the cloud, so
    shipping raw uint16 to the device and expanding there cuts host->device
    traffic by 6x and lets XLA fuse the expansion into stage 1's block
    reductions.
    """
    H, W = depth.shape
    K = intrinsics.astype(jnp.float32)
    fx, cx = K[0, 0], K[0, 2]
    fy, cy = K[1, 1], K[1, 2]
    z = depth.astype(jnp.float32)
    u = (jnp.arange(W, dtype=jnp.float32)[None, :] - cx) / fx
    v = (jnp.arange(H, dtype=jnp.float32)[:, None] - cy) / fy
    pts = jnp.stack([u * z, v * z, z], axis=-1)
    return pts.reshape(H * W, 3)


def extract_planes_from_depth(depth: jax.Array, intrinsics: jax.Array, *,
                              config: Config) -> jax.Array:
    """uint16 depth (H, W) + 3x3 intrinsics -> (H*W,) int32 labels.

    Single jitted program: back-projection + all pipeline stages.
    """
    H, W = depth.shape
    points = backproject_device(depth, intrinsics)
    return extract_planes(points, image_height=H, image_width=W, config=config)


@functools.partial(jax.jit, static_argnames=("config",))
def extract_planes_from_depth_jit(depth, intrinsics, *, config: Config):
    return extract_planes_from_depth(depth, intrinsics, config=config)


def extract_planes_debug(points, *, image_height: int, image_width: int, config: Config):
    """Un-jitted variant returning intermediates for tests/debugging."""
    stats = compute_cell_stats(points, image_height, image_width, config)
    labels_map, segments = grow_planes(stats, config)
    merge_labels, merged = merge_planes_device(labels_map, segments, config)
    P = min(config.patch_size, min(image_height, image_width))
    labels = rasterize_labels(labels_map, merge_labels, image_height, image_width, P)
    return {"stats": stats, "labels_map": labels_map, "segments": segments,
            "merge_labels": merge_labels, "merged": merged, "labels": labels}


def extract_primitives(points: jax.Array, *, image_height: int,
                       image_width: int, config: Config):
    """Planes AND cylinders (CAPE's full primitive set; the reference does
    planes only). Returns a dict:
      plane_labels    (H*W,) int32  — as extract_planes
      cylinder_labels (H*W,) int32  — cylinder ids over pixels, 0 = none
      cylinders       CylinderSegments
    Cylinder candidates are growing rounds that failed the plane planarity
    gate (ops/cylinder.py), so the expensive stages run once for both.
    """
    from deplex_tpu.ops.cylinder import extract_cylinders

    H, W = image_height, image_width
    P = min(config.patch_size, min(H, W))
    stats = compute_cell_stats(points, H, W, config)
    rounds = grow_rounds_device(stats, config)
    labels_map, segments = finalize_rounds(rounds, config)
    merge_labels, _ = merge_planes_device(labels_map, segments, config)
    plane_labels = rasterize_labels(labels_map, merge_labels, H, W, P)

    cyl_map, cylinders = extract_cylinders(stats, rounds, config)
    ident = jnp.arange(config.max_cylinders, dtype=jnp.int32)
    cyl_labels = rasterize_labels(cyl_map, ident, H, W, P)
    # A region explained by a cylinder is not a plane (CAPE assigns the
    # lower-residual primitive); plane labels yield where cylinders won.
    plane_labels = jnp.where(cyl_labels > 0, 0, plane_labels)
    return {"plane_labels": plane_labels, "cylinder_labels": cyl_labels,
            "cylinders": cylinders}


@functools.partial(jax.jit, static_argnames=("image_height", "image_width", "config"))
def extract_primitives_jit(points, *, image_height: int, image_width: int,
                           config: Config):
    return extract_primitives(points, image_height=image_height,
                              image_width=image_width, config=config)
