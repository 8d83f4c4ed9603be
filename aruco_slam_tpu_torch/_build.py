"""Build the CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface (no PyTorch headers,
so nvcc takes seconds, not minutes). They compile together into one
shared library under ``build/`` at the repository root, named by a hash
of the sources and flags: an edited source builds a new library, an
unchanged one is loaded as it is. The build happens at the first kernel
call, never at import (the CPU-only test host has no nvcc).

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; `call` raises on anything but 0, so a launch
the CUDA runtime refused (too many threads, too much shared memory) is an
error at its call site instead of a silent no-op.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# seconds the last nvcc build took in this process (0.0 = the library
# was already built and only loaded)
last_build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libaruco_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet.
    Processes building at once each write a private temp file and
    rename it into place, so none loads a half-written library."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    handle = ctypes.CDLL(str(build()))
    handle.aruco_error_string.argtypes = [ctypes.c_int]
    handle.aruco_error_string.restype = ctypes.c_char_p
    return handle


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point with its argument types declared (pointers and
    the stream as c_void_p — an undeclared int argument would be cut
    to 32 bits)."""
    fn = getattr(lib(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def call(fn, *args) -> None:
    """Run a C entry point and raise on a nonzero CUDA error code."""
    err = fn(*args)
    if err != 0:
        msg = lib().aruco_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} ({msg})")


def stream() -> ctypes.c_void_p:
    """PyTorch's current stream on the current device."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               ndim: int) -> None:
    """A kernel argument must be a contiguous CUDA tensor of the
    kernel's dtype and rank."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
