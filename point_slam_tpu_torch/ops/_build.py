"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source in ``csrc/`` for ``sm_90a``
into one shared library with a plain C interface, under ``ops/build/``
(git-ignored); the file name carries a hash of the sources, so an edited
source builds anew. The library is loaded with ``ctypes``: each pointer and
the stream pass as ``c_void_p``, each launcher returns ``cudaGetLastError()``.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib = None
build_seconds = None   # wall time of the nvcc run, when this process built


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path() -> str:
    h = hashlib.sha256()
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpoint_slam_kernels_{h.hexdigest()[:12]}.so")


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu unless the library for these sources exists."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if verbose or res.returncode:
        print(res.stdout + res.stderr, flush=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}")
    os.replace(tmp, out)                 # atomic: concurrent builds are safe
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ray_topk_packed.argtypes = [vp] * 6 + [i] * 6 + [vp]
        lib.ray_topk_packed.restype = i
        lib.ray_topk_planes.argtypes = [vp] * 8 + [i] * 6 + [vp]
        lib.ray_topk_planes.restype = i
        lib.ray_topk_error_string.argtypes = [i]
        lib.ray_topk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(err: int) -> str:
    return load_library().ray_topk_error_string(err).decode()
