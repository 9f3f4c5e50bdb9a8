"""Test configuration: run the suite on a simulated 8-device CPU mesh.

JAX's standard fake-device flag (`xla_force_host_platform_device_count`)
stands in for several devices, so sharding and collective code paths run
without hardware (SURVEY.md §4). Tests that need a GPU carry the `gpu`
marker and skip on the CPU; on a card run them with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`. Env vars are set
BEFORE jax initializes a backend.
"""

import os
import pathlib as _pathlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# Persistent compile cache: the suite is compile-bound (dozens of unique
# (shape, config) signatures), so re-runs skip straight to execution.
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(
    _pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

import pathlib

import numpy as np
import pytest

from deplex_tpu.utils.metrics import label_f1  # noqa: F401  (tests import it from here)

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


@pytest.fixture(scope="session")
def tum_cloud():
    from deplex_tpu.utils import DepthImage, read_intrinsics

    img = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K = read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K"))
    return img.transform_to_pcd(K), img.height, img.width


@pytest.fixture(scope="session")
def tum_image():
    """Raw uint16 depth + intrinsics (for the fused depth-path kernels)."""
    from deplex_tpu.utils import DepthImage, read_intrinsics

    img = DepthImage(str(DATA / "tum" / "1341848230.910894.png"))
    K = read_intrinsics(str(DATA / "configs" / "TUM_fr3_long_val.K"))
    return img.data, K


@pytest.fixture(scope="session")
def icl_cloud():
    from deplex_tpu.utils import DepthImage, read_intrinsics

    img = DepthImage(str(DATA / "icl_nuim" / "0.png"))
    K = read_intrinsics(str(DATA / "configs" / "ICL_living_room.K"))
    return img.transform_to_pcd(K), img.height, img.width


def load_golden(name: str) -> np.ndarray:
    return np.load(DATA / "golden" / f"{name}.npz")["labels"]
