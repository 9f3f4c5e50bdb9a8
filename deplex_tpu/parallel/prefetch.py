"""Host-side input pipeline: decode/back-project ahead of device compute.

The reference loads and back-projects each PNG synchronously before every
process() call (examples/process_sequence.cpp:31-43). Here a small thread
pool decodes frames ahead (native C++ PNG path) and uploads them while the
device is busy with earlier frames — the pipeline-parallel overlap listed in
SURVEY.md §2.4 as this build's PP analog.
"""

from __future__ import annotations

import concurrent.futures as _fut
from typing import Iterable, Iterator, Sequence

import numpy as np


def iter_depth_frames(paths: Sequence[str], *, workers: int = 2,
                      prefetch: int = 4) -> Iterator[np.ndarray]:
    """Yield (H, W) uint16 depth maps with background decoding."""
    from deplex_tpu.utils.depth_image import _load_png16

    with _fut.ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        it = iter(paths)
        for _ in range(prefetch):
            p = next(it, None)
            if p is None:
                break
            pending.append(pool.submit(_load_png16, str(p)))
        while pending:
            fut = pending.pop(0)
            p = next(it, None)
            if p is not None:
                pending.append(pool.submit(_load_png16, str(p)))
            yield fut.result()


def iter_depth_batches(paths: Sequence[str], batch: int, *, workers: int = 2,
                       prefetch: int = 8) -> Iterator[np.ndarray]:
    """Yield (B, H, W) uint16 batches (last batch padded by repetition)."""
    buf = []
    for frame in iter_depth_frames(paths, workers=workers, prefetch=prefetch):
        buf.append(frame)
        if len(buf) == batch:
            yield np.stack(buf)
            buf = []
    if buf:
        while len(buf) < batch:
            buf.append(buf[-1])
        yield np.stack(buf)
