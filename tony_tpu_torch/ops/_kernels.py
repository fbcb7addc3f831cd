"""Build and bind the package's hand-written CUDA kernels.

Each source under ``tony_tpu_torch/csrc/`` (``flash_fwd.cu``,
``flash_bwd.cu``, ``adamw.cu``) is compiled by its own ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
:mod:`ctypes` — no PyTorch headers, so a build takes seconds. The
compilers run side by side. Libraries are built at first use into
``build/`` at the repository root, each named by a hash of its source and
the flags, so an edited kernel rebuilds and an unchanged one is reused. A
failed build raises; nothing here falls back to another implementation.

Importing this module needs neither ``nvcc`` nor a card: both are
touched only when a kernel is first built or launched.
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
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_VP, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
_ATTN_TAIL = [_I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _VP]  # dtype..stream

#: source file -> {C entry point: argtypes}
ENTRY_POINTS = {
    "flash_fwd.cu": {
        # q, k, v, o, lse
        "tony_flash_fwd": [_VP] * 5 + _ATTN_TAIL,
    },
    "flash_bwd.cu": {
        # q, k, v, do, lse, delta, dq_acc (f32), dk, dv
        "tony_flash_bwd_fused": [_VP] * 9 + _ATTN_TAIL,
        # q, k, v, do, lse, delta, dq
        "tony_flash_bwd_dq": [_VP] * 7 + _ATTN_TAIL,
        # q, k, v, do, lse, delta, dk, dv
        "tony_flash_bwd_dkv": [_VP] * 8 + _ATTN_TAIL,
    },
    "adamw.cu": {
        # p, g, m, v, scalars, dtype, n, stream
        "tony_adamw": [_VP] * 5 + [_I, _L, _VP],
    },
}
SOURCES = tuple(os.path.join(CSRC, name) for name in ENTRY_POINTS)

#: the nvcc output of the builds made in this process, source by source
#: (``-Xptxas=-v``: registers, shared memory and spills per kernel)
BUILD_LOG: dict[str, str] = {}

_lock = threading.Lock()
_lib = None


def library_path(source: str) -> str:
    """Path of ``source``'s built library (may not exist yet)."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build() -> float:
    """Compile every source whose library is not built yet, one ``nvcc``
    each, all started together. Returns the wall seconds spent; raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    todo = [s for s in SOURCES if not os.path.exists(library_path(s))]
    if not todo:
        return 0.0
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use")
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for src in todo:
        out = library_path(src)
        tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
        procs.append((src, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[os.path.basename(src)] = log
        if proc.returncode:
            failed.append(f"{os.path.basename(src)} (nvcc exit "
                          f"{proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)     # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


class _Library:
    """Every entry point of every built source, as attributes."""

    def __init__(self) -> None:
        for name, fns in ENTRY_POINTS.items():
            lib = ctypes.CDLL(library_path(os.path.join(CSRC, name)))
            for fn, argtypes in fns.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                setattr(self, fn, f)


def load() -> _Library:
    """The bound kernel libraries, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = _Library()
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
