"""chip_smoke.py and bench.py refuse to run without a GPU: they exit
non-zero and never print a result."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_fails_without_gpu(script):
    out = _run(ROOT / script, ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr + out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
