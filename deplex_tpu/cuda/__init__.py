"""CUDA kernels of the extraction pipeline, called through ``jax.ffi``.

The sources sit beside this file. They are compiled with ``nvcc`` for
``sm_90a`` (Hopper) into ``build/`` at the root of the checkout, either by

    python -m deplex_tpu.cuda

or at the first call on a GPU. The library's file name carries a hash of the
sources and the command, so an edited source is rebuilt and a stale library
is never loaded. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import jax

SRC_DIR = pathlib.Path(__file__).resolve().parent
SOURCES = ("growing.cu",)
ARCH = "sm_90a"
BUILD_DIR = SRC_DIR.parent.parent / "build"

# FFI target name -> handler symbol exported by the library.
TARGETS = {"deplex_grow_rounds": "DeplexGrowRounds"}

_lock = threading.Lock()
_registered = False


def nvcc_path() -> str:
    """The nvcc to build with: on PATH, else the CUDA toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the GPU kernels")


def build_command(output: pathlib.Path, nvcc: str = "nvcc") -> list[str]:
    """The nvcc command line that compiles every source into `output`."""
    return [nvcc, "-gencode", f"arch=compute_90a,code={ARCH}", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-o", str(output),
            *(str(SRC_DIR / s) for s in SOURCES)]


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((SRC_DIR / s).read_bytes())
    h.update(" ".join(build_command(pathlib.Path("x"))).encode())
    return BUILD_DIR / f"libdeplex_cuda-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library if it is not built yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = build_command(pathlib.Path(tmp), nvcc_path())
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"CUDA build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)     # atomic: a concurrent builder sees all or none
    return out


def register() -> None:
    """Build (if needed), load and register every FFI target for CUDA."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(str(build()))
        for name, symbol in TARGETS.items():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA")
        _registered = True


def has_gpu() -> bool:
    """True when JAX has a GPU backend in this process."""
    try:
        return bool(jax.devices("gpu"))
    except RuntimeError:     # no GPU backend: the CUDA branches never lower
        return False
