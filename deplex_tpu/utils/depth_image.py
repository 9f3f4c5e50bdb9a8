"""Depth-image ingestion and back-projection.

API parity with deplex.utils.DepthImage (cpp/pybind/utils/utils.cpp:29-36,
cpp/deplex/src/deplex/utils/depth_image.cpp:30-78): loads a 16-bit grayscale
PNG and back-projects to an organized (H*W, 3) cloud with the pinhole model
    x = (u - cx) * z / fx,  y = (v - cy) * z / fy,  z = raw depth units.

Decoding prefers the native C++ loader (deplex_tpu.native, the equivalent of
the reference's vendored stb_image) and falls back to the numpy + zlib decoder
of utils/png.py where the native library cannot be built. Back-projection is
vectorized (the reference uses OpenMP sections, depth_image.cpp:66-74).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _native():
    """The native library's module, or None where it cannot be built."""
    import subprocess

    try:
        from deplex_tpu import native

        native._load()
        return native
    except (OSError, subprocess.CalledProcessError):
        return None


def _load_png16(path: str) -> np.ndarray:
    """Load a 16-bit grayscale PNG -> (H, W) uint16. Raises on failure."""
    try:
        data = open(path, "rb").read()
    except OSError as e:
        raise RuntimeError(f"Error: Couldn't read image {path}") from e
    native = _native()
    if native is not None:
        img = native.decode_png16(path)
        if img is not None:
            return img
    from deplex_tpu.utils.png import decode_png

    try:
        return decode_png(data)
    except RuntimeError as e:
        raise RuntimeError(f"Error: Couldn't read image {path}: {e}") from e


class DepthImage:
    def __init__(self, image_path: str | None = None):
        self._image: np.ndarray | None = None
        self._width = 0
        self._height = 0
        if image_path is not None:
            self.reset(image_path)

    def reset(self, image_path: str) -> None:
        img = _load_png16(str(image_path))
        self._image = img
        self._height, self._width = img.shape

    @property
    def width(self) -> int:
        return self._width

    @property
    def height(self) -> int:
        return self._height

    def get_width(self) -> int:
        return self._width

    def get_height(self) -> int:
        return self._height

    @property
    def data(self) -> np.ndarray:
        """Raw depth array (H, W) uint16."""
        if self._image is None:
            raise RuntimeError("DepthImage is empty")
        return self._image

    def transform_to_pcd(self, intrinsics) -> np.ndarray:
        """Back-project to an organized (H*W, 3) float32 cloud."""
        if self._image is None:
            raise RuntimeError("DepthImage is empty")
        K = np.asarray(intrinsics, dtype=np.float32)
        fx, cx = K[0, 0], K[0, 2]
        fy, cy = K[1, 1], K[1, 2]
        native = _native()
        if native is not None:
            return native.backproject(self._image, fx, fy, cx, cy)
        H, W = self._image.shape
        z = self._image.astype(np.float32).reshape(-1)
        cols = np.tile(np.arange(W, dtype=np.float32), H)
        rows = np.repeat(np.arange(H, dtype=np.float32), W)
        return np.stack([(cols - cx) * z / fx, (rows - cy) * z / fy, z], axis=1)

    # Reference-compatible alias (C++ name, depth_image.h:44).
    to_point_cloud = transform_to_pcd
