"""The CUDA library's build: one nvcc command for sm_90a over committed
sources, with its output under build/ (run it with python -m deplex_tpu.cuda)."""

import pathlib
import subprocess

import pytest

from deplex_tpu import cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_build_command_targets_hopper():
    out = cuda.BUILD_DIR / "lib.so"
    cmd = cuda.build_command(out)
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)


def test_sources_are_committed_and_output_is_ignored():
    """Every source is in the package beside the build module, tracked by
    git when the checkout has git; the library lands in build/, which
    .gitignore lists."""
    for s in cuda.SOURCES:
        path = cuda.SRC_DIR / s
        assert path.is_file() and path.suffix == ".cu"
        if (ROOT / ".git").exists():
            tracked = subprocess.run(
                ["git", "ls-files", "--error-unmatch", str(path)], cwd=ROOT,
                capture_output=True)
            assert tracked.returncode == 0, f"{s} is not committed"
    assert cuda.BUILD_DIR == ROOT / "build"
    assert "build/" in (ROOT / ".gitignore").read_text().splitlines()
    lib = cuda.library_path()
    assert lib.parent == cuda.BUILD_DIR and lib.suffix == ".so"


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    """An edited source gets a new library name, so a stale build is never
    loaded."""
    src = tmp_path / "growing.cu"
    src.write_text((cuda.SRC_DIR / "growing.cu").read_text())
    monkeypatch.setattr(cuda, "SRC_DIR", tmp_path)
    before = cuda.library_path()
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda.library_path() != before


def test_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a compiler error surfaces as an exception."""
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="CUDA build failed"):
        cuda.build()
    assert not list(tmp_path.glob("*.so"))
