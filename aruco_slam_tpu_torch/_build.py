"""Build the CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` file has a plain C interface (no PyTorch headers,
so nvcc takes seconds, not minutes). Each compiles to an object file in
its own nvcc process, all started together, and the objects link into
one shared library under ``build/`` at the repository root, named by a
hash of the sources and flags: an edited source builds a new library,
an unchanged one is loaded as it is. The build happens at the first
kernel call, never at import (the CPU-only test host has no nvcc).

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; `call` raises on anything but 0, so a launch
the CUDA runtime refused (too many threads, too much shared memory) is an
error at its call site instead of a silent no-op. The C side launches on
the runtime's current device (and sets its kernels' attributes there),
so every wrapper makes its call inside `on_device`, which makes its
tensors' card current and hands over that card's stream: with streams on
several cards in one process, a launch never runs on another card than
the pointers it is given.
"""

from __future__ import annotations

import contextlib
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# a source's own flags, after NVCC_FLAGS: the PnP kernel rounds every
# product and sum on its own, as the eager chain it must equal bit for
# bit does (csrc/pnp_square.cu)
SOURCE_FLAGS = {"pnp_square.cu": ["-fmad=false"]}

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
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libaruco_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of each that
    failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the kernels if this source hash has no library yet.
    Processes building at once each work in a private temp directory
    and rename the library into place, so none loads a half-written
    one."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD))
    try:
        nvcc = _nvcc()
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [tmp / f"{src.stem}.o" for src in srcs]
        t0 = time.perf_counter()
        _run([[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, []), "-c",
               "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)])
        _run([[nvcc, *ARCH, "-shared", "-o", str(tmp / out.name),
               *map(str, objs)]])
        os.replace(tmp / out.name, out)
        last_build_seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    handle = ctypes.CDLL(str(build()))
    handle.aruco_error_string.argtypes = [ctypes.c_int]
    handle.aruco_error_string.restype = ctypes.c_char_p
    return handle


def function(name: str, argtypes: list,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """A C entry point with its argument types declared (pointers and
    the stream as c_void_p — an undeclared int argument would be cut
    to 32 bits), once for each loaded library: a new `lib` (after
    ``lib.cache_clear()``) declares its functions anew."""
    return _declared(lib(), name, tuple(argtypes), restype)


@functools.cache
def _declared(handle: ctypes.CDLL, name: str, argtypes: tuple,
              restype) -> ctypes._CFuncPtr:
    fn = getattr(handle, name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def call(fn, *args) -> None:
    """Run a C entry point and raise on a nonzero CUDA error code."""
    err = fn(*args)
    if err != 0:
        msg = lib().aruco_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} ({msg})")


@contextlib.contextmanager
def on_device(*tensors: torch.Tensor):
    """Make the card of a launch's tensor arguments the current device
    for the block and yield that card's current stream (the argument the
    C entry point launches on). Arguments on more than one device raise
    ValueError before anything launches."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("kernel arguments on more than one device: "
                         f"{sorted(map(str, devices))}")
    device, = devices
    with torch.cuda.device(device):
        yield ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def split_ms(run, labels: list[str]) -> dict[str, float]:
    """CUDA-event milliseconds of each launch group of one entry-point
    call, summed by label. ``run(marks, n_marks)`` makes the call with a
    C array of ``len(labels)`` events, which the entry point records
    after its k-th launch group (`aruco_mark`)."""
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(labels) + 1)]
    for e in events:
        e.record()  # creates the event handles
    marks = (ctypes.c_void_p * len(labels))(
        *[e.cuda_event for e in events[1:]])
    events[0].record()
    run(ctypes.cast(marks, ctypes.c_void_p), len(labels))
    events[-1].synchronize()
    out: dict[str, float] = {}
    for label, a, b in zip(labels, events, events[1:]):
        out[label] = out.get(label, 0.0) + a.elapsed_time(b)
    return out


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
