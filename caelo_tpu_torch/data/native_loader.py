"""ctypes bindings for the native C++ scan loader and prefetcher (the port's
copy of ``caelo_tpu/data/native_loader.py``).

``data/native/loader.cpp`` (a copy of the JAX package's source) is built
with g++ on first use into ``caelo_tpu_torch/_build/loader-<hash>/`` (listed
in ``.gitignore``), keyed by a hash of the source, never next to the
source.  Without a compiler the loaders fall back to numpy: scan loading is
host file I/O, not a device path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "native", "loader.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
_lock = threading.Lock()
_lib = None
_tried = False


def _library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, f"loader-{h.hexdigest()[:16]}",
                        "libcaeloloader.so")


def _build(path: str) -> bool:
    """Compile the loader into ``path``; False when g++ fails or is absent."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, path)    # atomic: a concurrent loader never sees a
    return True              # half-written library


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.caelo_load_scan.restype = ctypes.c_int
        lib.caelo_load_scan.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.caelo_prefetch_create.restype = ctypes.c_void_p
        lib.caelo_prefetch_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.caelo_prefetch_next.restype = ctypes.c_int
        lib.caelo_prefetch_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
        ]
        lib.caelo_prefetch_destroy.restype = None
        lib.caelo_prefetch_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def load_scan(path: str, max_points: int, n_cols: int = 4):
    """Load + zero-pad one scan.  Returns (array (max_points, n_cols), mask)."""
    lib = get_lib()
    out = np.zeros((max_points, n_cols), np.float32)
    if lib is not None:
        n = lib.caelo_load_scan(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_points, n_cols,
        )
        if n < 0:
            raise FileNotFoundError(path)
    else:  # numpy fallback
        raw = np.fromfile(path, dtype=np.float32).reshape(-1, n_cols)
        n = min(raw.shape[0], max_points)
        out[:n] = raw[:n]
    mask = np.zeros((max_points,), bool)
    mask[:n] = True
    return out, mask


class ScanPrefetcher:
    """Ordered background prefetch over a list of scan files.

    The in-process analog of the reference's 4 loader subprocesses
    (``PoseEstimation.py:91-119``): I/O overlaps with device compute, frames
    are delivered strictly in order.
    """

    def __init__(self, paths, max_points: int, n_cols: int = 4,
                 depth: int = 8, n_threads: int = 2):
        self._h = None
        self.paths = list(paths)
        self.max_points = max_points
        self.n_cols = n_cols
        self._lib = get_lib()
        self._i = 0
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._keepalive = arr
            self._h = self._lib.caelo_prefetch_create(
                arr, len(self.paths), max_points, n_cols, depth, n_threads
            )

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= len(self.paths):
            raise StopIteration
        if self._h is None:
            out, mask = load_scan(self.paths[self._i], self.max_points,
                                  self.n_cols)
            self._i += 1
            return out, mask
        out = np.zeros((self.max_points, self.n_cols), np.float32)
        n = self._lib.caelo_prefetch_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
        if n < 0:
            raise StopIteration
        self._i += 1
        mask = np.zeros((self.max_points,), bool)
        mask[:n] = True
        return out, mask

    def close(self):
        if self._h is not None:
            self._lib.caelo_prefetch_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
