"""Stage-level tracing / profiling.

Equivalent of the reference's BENCHMARK_LOGGING build flavor
(plane_extractor.cpp:36-43,196-257: chrono stamps around each pipeline stage
logged in microseconds) and DEBUG_BENCHMARK gprof mode: here the same stage
taxonomy (cell-grid / histogram+growing / merge / labels / refinement) is
exposed as jax.profiler named scopes — visible in TensorBoard/XProf traces —
plus a host-side stage timer that runs the stages as separate dispatches and
reports per-stage wall time.

Usage:
    with deplex_tpu.profiling.trace("/tmp/jax-trace"):
        extractor.process(points)            # then inspect with xprof

    times = stage_timings(points, 480, 640, Config())   # {stage: seconds}
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax

from deplex_tpu.config import Config

STAGES = ("cell_grid", "region_growing", "merge", "labels", "refinement")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace for everything inside the context."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope matching the reference's stage log labels."""
    return jax.named_scope(name)


def stage_timings(points, image_height: int, image_width: int,
                  config: Config | None = None, repeats: int = 10) -> Dict[str, float]:
    """Per-stage wall-clock seconds (jitted per stage, post-warmup mean).

    Mirrors the BENCHMARK_LOGGING report (µs per stage to std::clog); here
    returned as a dict so callers/log sinks decide the format.
    """
    import functools

    import jax.numpy as jnp

    from deplex_tpu.ops.cellstats import compute_cell_stats
    from deplex_tpu.ops.growing import grow_planes
    from deplex_tpu.ops.merge import merge_planes_device, rasterize_labels

    cfg = config or Config()
    H, W = image_height, image_width
    P = min(cfg.patch_size, min(H, W))

    s1 = jax.jit(functools.partial(compute_cell_stats, image_height=H,
                                   image_width=W, config=cfg))
    s2 = jax.jit(functools.partial(grow_planes, config=cfg))
    s3 = jax.jit(functools.partial(merge_planes_device, config=cfg))
    s4 = jax.jit(functools.partial(rasterize_labels, image_height=H,
                                   image_width=W, patch_size=P))

    pts = jnp.asarray(points, jnp.float32)
    stats = s1(pts)
    lm, seg = s2(stats)
    ml, merged = s3(lm, seg)
    labels = s4(lm, ml)
    jax.block_until_ready((stats, lm, seg, ml, labels))

    out: Dict[str, float] = {}

    def timeit(name, fn, *args):
        t0 = time.perf_counter()
        for _ in range(repeats):
            jax.block_until_ready(fn(*args))
        out[name] = (time.perf_counter() - t0) / repeats

    timeit("cell_grid", s1, pts)
    timeit("region_growing", s2, stats)
    timeit("merge", s3, lm, seg)
    timeit("labels", s4, lm, ml)
    if cfg.ransac_refinement:
        from deplex_tpu.ops.merge import apply_label_lut
        from deplex_tpu.ops.ransac import refine_labels

        s5 = jax.jit(lambda p, l, cl: refine_labels(
            p, l, cfg, cell_labels=cl, image_width=W, patch_size=P))
        cell_lab = apply_label_lut(lm, ml)
        jax.block_until_ready(s5(pts, labels, cell_lab))
        timeit("refinement", s5, pts, labels, cell_lab)
    return out
