"""Build and load the native data-feed engine (``datafeed.cc``).

The C++ prefetch and shuffle engine behind the reader's native path is
compiled at first use with ``g++ -O2 -std=c++17 -shared -fPIC -pthread``
into ``build/`` at the repository root, named by a hash of the source and
the flags (as the CUDA kernels are, ``ops/_kernels.py``), so an edited
engine rebuilds and an unchanged one is reused. Loading is best-effort: a
host with no compiler gets ``None`` and the reader takes its Python path,
as the reader's ``use_native=None`` asks.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "datafeed.cc")
#: the repository's ``build/``, where ``ops/_kernels.py`` puts the CUDA
#: libraries too (not imported from there: that package loads torch)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(_HERE))), "build")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def library_path() -> str:
    """Where the engine's library is (or will be) built: ``build/`` at
    the repository root, named by a hash of the source and the flags."""
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"_tony_datafeed-{digest.hexdigest()[:16]}.so")


def _compile(lib_path: str) -> bool:
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    # build into a temporary name, then rename: processes racing to build
    # the same library each commit a whole one
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib_path))
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        log.info("native data-feed build unavailable (%s); using the "
                 "python path", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tdf_open.restype = ctypes.c_void_p
    lib.tdf_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64]
    lib.tdf_next_batch.restype = ctypes.c_int64
    lib.tdf_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.tdf_error.restype = ctypes.c_char_p
    lib.tdf_error.argtypes = [ctypes.c_void_p]
    lib.tdf_close.restype = None
    lib.tdf_close.argtypes = [ctypes.c_void_p]
    return lib


def load_native() -> ctypes.CDLL | None:
    """The memoized engine library, or None when it cannot be built or
    loaded on this host."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        lib_path = library_path()
        try:
            if not os.path.exists(lib_path) and not _compile(lib_path):
                _load_failed = True
                return None
            _lib = _bind(ctypes.CDLL(lib_path))
        except OSError as e:
            log.info("native data-feed load failed (%s); using the python "
                     "path", e)
            _load_failed = True
            return None
        return _lib
