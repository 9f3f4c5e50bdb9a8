"""Build the CUDA kernel library: ``python -m deplex_tpu.cuda``."""

import time

from deplex_tpu.cuda import build

t0 = time.perf_counter()
path = build()
print(f"built {path} in {time.perf_counter() - t0:.1f} s")
