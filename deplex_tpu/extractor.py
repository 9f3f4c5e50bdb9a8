"""User-facing PlaneExtractor — API parity with the reference binding.

Matches deplex.PlaneExtractor (cpp/pybind/plane_extraction/plane_extraction.cpp:28-37,
README.md:12-19): construct with (image_height, image_width, config=Config()),
call .process(points[N, 3]) -> labels[N] with 0 = non-planar.

Unlike the reference (stateless per-call C++), construction compiles nothing;
the first .process() triggers XLA compilation for the (H, W, config)
signature and subsequent calls reuse the executable.
"""

from __future__ import annotations

import numpy as np

from deplex_tpu.config import Config
from deplex_tpu.pipeline import extract_planes_jit


class PlaneExtractor:
    def __init__(self, image_height: int, image_width: int, config: Config | None = None):
        config = config if config is not None else Config()
        patch = min(config.patch_size, min(image_height, image_width))
        if patch == 0:
            raise ValueError(
                f"Error! Invalid config parameter: patchSize({config.patch_size})."
                " patchSize has to be positive.")
        if config.patch_size < 0:
            raise ValueError("patchSize has to be positive.")
        self._height = int(image_height)
        self._width = int(image_width)
        self._config = config

    @property
    def config(self) -> Config:
        return self._config

    @property
    def image_height(self) -> int:
        return self._height

    @property
    def image_width(self) -> int:
        return self._width

    def process(self, pcd_array) -> np.ndarray:
        """Extract planes from an organized point cloud.

        pcd_array: (H*W, 3) array (numpy or jax). Returns (H*W,) int32 labels;
        label 0 marks non-planar points (plane_extractor.h:43-48).
        """
        pts = np.asarray(pcd_array, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != 3 or pts.shape[0] != self._height * self._width:
            rows = 0 if pts.ndim < 2 else pts.shape[0]
            raise ValueError(
                f"Error! Number of points doesn't match image shape: {rows}"
                f" != {self._height} x {self._width}")
        labels = extract_planes_jit(pts, image_height=self._height,
                                    image_width=self._width, config=self._config)
        return np.asarray(labels)

    def process_primitives(self, pcd_array) -> dict:
        """Planes AND cylinders (CAPE's full primitive set; beyond the
        reference's planes-only API). Returns numpy copies of
        pipeline.extract_primitives' output dict."""
        from deplex_tpu.pipeline import extract_primitives_jit

        pts = np.asarray(pcd_array, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != 3 or pts.shape[0] != self._height * self._width:
            rows = 0 if pts.ndim < 2 else pts.shape[0]
            raise ValueError(
                f"Error! Number of points doesn't match image shape: {rows}"
                f" != {self._height} x {self._width}")
        cfg = self._config if self._config.cylinder_extraction else \
            self._config.replace(cylinder_extraction=True)
        out = extract_primitives_jit(pts, image_height=self._height,
                                     image_width=self._width, config=cfg)
        return {
            "plane_labels": np.asarray(out["plane_labels"]),
            "cylinder_labels": np.asarray(out["cylinder_labels"]),
            "cylinders": out["cylinders"],
        }

    def process_depth(self, depth, intrinsics) -> np.ndarray:
        """Extract planes straight from a (H, W) uint16 depth map.

        Device fast path (no reference analog): ships the 6x-smaller raw
        depth to the device and back-projects there (pipeline.backproject_device).
        """
        from deplex_tpu.pipeline import extract_planes_from_depth_jit

        d = np.asarray(depth)
        if d.shape != (self._height, self._width):
            raise ValueError(
                f"Error! Depth shape {d.shape} != ({self._height}, {self._width})")
        labels = extract_planes_from_depth_jit(
            d, np.asarray(intrinsics, np.float32), config=self._config)
        return np.asarray(labels)
