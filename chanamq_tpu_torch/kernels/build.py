"""Build the port's CUDA sources into shared libraries, load them, and
bind checked launches of their C functions.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
on first use into ``chanamq_tpu_torch/_build/lib<name>-<hash>.so``, where
the hash covers the source, the headers beside it (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one loads
the library already there. The library is loaded
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

import torch

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
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(SRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
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


def check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
          device: torch.device) -> None:
    """Raise unless ``t`` has this dtype, rank and device and is
    contiguous: what a kernel's C launcher takes."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check_shape(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def cuda_device(name: str, t: torch.Tensor) -> torch.device:
    """``t``'s device, which must be a card: a kernel runs nowhere else."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device


def aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor starts on 16 bytes."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not 16-byte aligned (the "
                             "kernel reads 16 bytes at a time)")


# the current stream's handle as an int, without making a Stream object
# (what torch's own generated launchers call); the public API where a
# build lacks it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launcher(lib: ctypes.CDLL, fn, name: str, device: torch.device, *args):
    """A zero-argument launch of ``fn(*args)`` on ``device``'s current
    stream that raises if the launch fails (``fn`` returns
    ``cudaGetLastError()``; ``lib.chana_cuda_error_string`` names it). The
    arguments are bound once, converted to ``fn``'s declared C types
    (``argtypes``, the stream last), so a launch converts nothing and a
    caller can time repeated launches without the wrapper's checks."""
    stream = _raw_stream(device.index) if _raw_stream is not None \
        else torch.cuda.current_stream(device).cuda_stream
    args = (*args, stream)
    if len(fn.argtypes) != len(args):
        raise TypeError(f"{name}: {len(args)} arguments for a C function "
                        f"of {len(fn.argtypes)}")
    # Python numbers and None become C values now; ctypes objects (the
    # update's pointer tables) pass as they are
    bound = tuple(t(a) if a is None or isinstance(a, (int, float)) else a
                  for t, a in zip(fn.argtypes, args))

    def launch() -> None:
        code = fn(*bound)
        if code != 0:
            msg = lib.chana_cuda_error_string(code).decode()
            raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")

    return launch
