"""Benchmark-harness protocol guards.

The timing harnesses are measurement code, not product code, but they
feed every committed perf claim — a silent breakage (schema drift, a
validation assert that can no longer pass, an accidentally-hoistable
loop) would poison the artifacts. These tests run the harness entry
points end-to-end on CPU with tiny iteration counts and check the
contract, not the numbers.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.heavy
@pytest.mark.slow
@pytest.mark.gpu
def test_bench_from_csv_contract(tmp_path):
    """bench.py --from-csv (the reference benchmark_extractor.cpp protocol)
    emits one JSON line with the expected schema and the golden plane
    count, on the card."""
    import jax

    try:
        jax.devices("gpu")
    except RuntimeError:
        pytest.skip("bench.py measures only on a GPU")
    env = dict(os.environ, BENCH_CSV_ITERS="2")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench.py"), "--from-csv",
         str(tmp_path / "pts.csv")],
        env=env, capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")][-1]
    d = json.loads(line)
    assert d["metric"] == "tum_fr3_csv_benchmark_seconds_per_iteration"
    assert d["planes"] == 34
    assert d["value"] > 0 and d["vs_baseline"] > 0
    assert d["device"]["platform"] == "gpu"
    # The CSV really was regenerated from the shipped PNG.
    assert (tmp_path / "pts.csv").exists()


def test_stage_bench_differential_helper_monotone():
    """diff_time must return the marginal per-iteration cost: for a
    runner whose total time is fixed + n*per_iter, the fixed part (the
    dispatch and fetch cost) cancels."""
    import time

    sys.path.insert(0, str(ROOT / "scripts"))
    from stage_bench import diff_time

    PER_ITER, FIXED = 0.004, 0.05

    class FakeResult:
        def __init__(self, n):
            self.n = n

    def run_n(n):
        time.sleep(FIXED + n * PER_ITER)
        import numpy as np

        return np.float32(n)

    us = diff_time(run_n, repeats=4, batch=1)
    # Marginal cost per (iteration*batch), in µs; fixed 50 ms cancels.
    assert 0.5 * PER_ITER * 1e6 < us < 2.0 * PER_ITER * 1e6, us
