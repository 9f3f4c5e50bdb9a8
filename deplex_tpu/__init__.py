"""deplex-tpu: a plane-extraction framework in JAX.

A from-scratch JAX implementation of organized-point-cloud plane
segmentation (the Proenca-Gao CAPE pipeline) with the same capabilities and
Python API surface as the reference deplex library
(/root/reference/README.md:12-19), redesigned for accelerators:

  * all per-cell work (validity gates, PCA plane fits, 3x3 eigensolves)
    runs batched over the whole cell grid,
  * region growing and merging run as one GPU kernel per frame each
    (deplex_tpu/cuda, ops/merge_triton.py), with plain XLA loops as the
    reference and the CPU path,
  * frames batch via vmap on one device and shard across device meshes
    with jax.sharding.

Public API:
    >>> from deplex_tpu import PlaneExtractor, Config
    >>> from deplex_tpu.utils import DepthImage
    >>> image = DepthImage("depth.png")
    >>> extractor = PlaneExtractor(image.height, image.width, config=Config())
    >>> labels = extractor.process(image.transform_to_pcd(K))
"""

import os as _os
import pathlib as _pathlib

# Persistent XLA compilation cache: pipeline signatures compile once per
# checkout, not once per process. JAX_COMPILATION_CACHE_DIR, when set,
# wins (JAX reads it itself; "" opts out); otherwise the cache is
# .jax_cache at the root of the checkout, unless that cannot be created.
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    _cache = _pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"
    try:
        _cache.mkdir(exist_ok=True)
    except OSError:          # read-only install: run without the cache
        _cache = None
    if _cache is not None:
        import jax as _jax

        _jax.config.update("jax_compilation_cache_dir", str(_cache))
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from deplex_tpu.config import Config
from deplex_tpu.extractor import PlaneExtractor

__version__ = "0.1.0"

__all__ = ["Config", "PlaneExtractor", "__version__"]


def __getattr__(name):
    # Lazy heavyweight entry points (avoid importing jax-compiled modules
    # until used): deplex_tpu.PlaneSlam, deplex_tpu.extract_primitives.
    if name == "PlaneSlam":
        from deplex_tpu.slam import PlaneSlam

        return PlaneSlam
    if name == "extract_primitives":
        from deplex_tpu.pipeline import extract_primitives

        return extract_primitives
    raise AttributeError(f"module 'deplex_tpu' has no attribute {name!r}")
