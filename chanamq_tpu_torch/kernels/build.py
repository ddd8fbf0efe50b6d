"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
on first use into ``chanamq_tpu_torch/_build/lib<name>-<hash>.so``, where
the hash covers the source and the flags, so an edited source rebuilds and
an unchanged one loads the library already there. The library is loaded
with ``ctypes``; nothing here includes PyTorch's headers, so a build takes
seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    path: str       # the shared library
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str        # nvcc's output, ptxas registers/smem/spills included


_LOADED: dict[str, tuple[ctypes.CDLL, Built]] = {}


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags is already in the build directory. Raises on a failed build."""
    src = os.path.join(SRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = f"lib{name}-{digest.hexdigest()[:16]}"
    lib_path = os.path.join(BUILD_DIR, stem + ".so")
    log_path = os.path.join(BUILD_DIR, stem + ".log")
    if os.path.exists(lib_path):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return Built(lib_path, 0.0, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or none
    return Built(lib_path, seconds, log)


def load(name: str) -> tuple[ctypes.CDLL, Built]:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    got = _LOADED.get(name)
    if got is None:
        built = build(name)
        got = _LOADED[name] = (ctypes.CDLL(built.path), built)
    return got
