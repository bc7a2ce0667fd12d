"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles each source in ``csrc/`` for ``sm_90a``
into an object, all of them at once in parallel, and links them into one
shared library with a plain C interface, under ``ops/build/``
(git-ignored); the file name carries a hash of the sources, so an edited
source builds anew. The library is loaded with ``ctypes``: each pointer and
the stream pass as ``c_void_p``, each launcher returns
``cudaGetLastError()``. Nothing here runs at import time.
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
              "-Xcompiler", "-fPIC"]

_lib = None
build_seconds = None   # wall time of the nvcc runs, when this process built


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
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per source, all started together, then one link."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, _, proc in jobs:
        log = proc.communicate()[0]
        if verbose or proc.returncode:
            print(log, flush=True)
        if proc.returncode:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("; ".join(failed))
        tmp = f"{out}.{tag}"
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode:
            print(res.stdout + res.stderr, flush=True)
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(link)}")
        os.replace(tmp, out)             # atomic: concurrent builds are safe
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        build_seconds = time.perf_counter() - t0
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ray_topk.argtypes = [i] + [vp] * 7 + [i] * 7 + [vp]
        lib.ray_topk_occupancy.argtypes = [i] * 4 + [
            ctypes.POINTER(ctypes.c_long)]
        lib.row_adam.argtypes = ([vp] * 5 + [vp, f, vp, f, ctypes.c_long, i]
                                 + [f] * 5 + [vp])
        lib.block_topk.argtypes = ([vp] * 4 + [i] * 8 + [vp] * 3 + [i] * 2
                                   + [vp] * 2 + [i] * 6 + [vp])
        ip = ctypes.POINTER(i)
        lib.multi_adam.argtypes = ([i, ctypes.POINTER(ctypes.c_ulonglong),
                                    ctypes.POINTER(f), ip, ip]
                                   + [f] * 5 + [vp])
        lib.multi_adam_limits.argtypes = [ip, ip]
        lib.multi_adam_limits.restype = None
        for fn in (lib.ray_topk, lib.ray_topk_occupancy, lib.row_adam,
                   lib.block_topk, lib.multi_adam):
            fn.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_kernels = {}
_sm_counts = {}


def kernel(name: str):
    """The launcher ``name`` of the kernels' library (looked up once)."""
    fn = _kernels.get(name)
    if fn is None:
        fn = _kernels[name] = getattr(load_library(), name)
    return fn


def stream(device) -> int:
    """The raw handle of the current CUDA stream on ``device`` (one C call,
    no Stream object)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


def sm_count(device) -> int:
    """The SM count of ``device`` (asked once)."""
    n = _sm_counts.get(device.index)
    if n is None:
        import torch
        n = _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def check(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = load_library().cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
