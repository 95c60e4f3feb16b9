"""Build the CUDA kernels of ``csrc/`` into one shared library on first use.

nvcc compiles every ``csrc/*.cu`` for ``sm_90a`` into a library with a plain
C interface, loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds.  The library lands in ``_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the sources and flags; a later process
with the same sources loads it without building.

Every C entry point takes its pointers and its stream as ``void*`` and
returns ``cudaGetLastError()`` after the launch; :func:`check` turns a
nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import NamedTuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(_HERE, "_build")
LIB_NAME = "libcaelo_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (see the csrc/*.cu headers)
_SIGNATURES = {
    "caelo_keypoint_score": [_P, _P, _I, _L, _I, _P, _P, _L, _I, _I,
                             _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _F, _F, _I, _F, _F, _P],
    "caelo_patches_from_planes": [_P, _P, _P, _P, _I, _I, _P],
    "caelo_max_eigvec_sym4x4": [_P, _P, _L, _L, _L, _L, _I, _P],
}


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: str
    build_s: float     # seconds spent in nvcc (0.0 when loaded from cache)
    log: str           # nvcc's output, including -Xptxas -v


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source with the CUDA toolkit's nvcc")
    return path


def _build() -> KernelLibrary:
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    path = os.path.join(out_dir, LIB_NAME)
    log, build_s = "", 0.0
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[s for s in srcs if s.endswith(".cu")]]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_s = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)        # atomic: a concurrent loader never
                                     # sees a half-written library
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.caelo_error_string.argtypes = [ctypes.c_int]
    lib.caelo_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, path, build_s, log)


def load_library() -> KernelLibrary:
    """The kernel library of this process, built on the first call."""
    global _loaded
    with _lock:
        if _loaded is None:
            _loaded = _build()
        return _loaded


_functions: dict = {}


def kernel(name: str):
    """The C entry point ``name`` of the kernel library, looked up once per
    process: a wrapper's launch costs one ctypes call and no lock."""
    fn = _functions.get(name)
    if fn is None:
        fn = _functions[name] = getattr(load_library().lib, name)
    return fn


def stream(device: torch.device) -> int:
    """The raw handle of the current CUDA stream on ``device``: PyTorch's
    own C accessor where the build has it (no Python stream object per
    launch), else the public ``current_stream``."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def check(code: int, what: str) -> None:
    if code != 0:
        msg = load_library().lib.caelo_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
