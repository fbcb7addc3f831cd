"""Build and bind the package's hand-written CUDA kernel.

``tony_tpu_torch/csrc/flash_fwd.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with :mod:`ctypes` — no PyTorch headers, so a build takes seconds. The
library is built at first use into ``build/`` at the repository root,
named by a hash of its source and flags, so an edited kernel rebuilds
and an unchanged one is reused. A failed build raises; nothing here
falls back to another implementation.

Importing this module needs neither ``nvcc`` nor a card: both are
touched only when the kernel is first built or launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "flash_fwd.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: the nvcc output of the last build in this process (``-Xptxas=-v``:
#: registers, shared memory and spills per kernel instantiation)
BUILD_LOG = ""

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signature of ``tony_flash_fwd``
_ARGTYPES = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _F, _I,
             _I, _VP]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> str:
    """Path of the built library (may not exist yet)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"flash_fwd-{digest.hexdigest()[:16]}.so")


def build() -> float:
    """Compile the kernel unless it is built already. Returns the wall
    seconds spent; raises ``RuntimeError`` with the compiler's output if
    the build fails."""
    global BUILD_LOG
    out = library_path()
    if os.path.exists(out):
        return 0.0
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernel is built from "
                           "source at first use")
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    BUILD_LOG = proc.stdout
    if proc.returncode:
        raise RuntimeError(f"kernel build failed (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)             # atomic: a reader never sees half a file
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The bound kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(library_path())
            lib.tony_flash_fwd.argtypes = _ARGTYPES
            lib.tony_flash_fwd.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
