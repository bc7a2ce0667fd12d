"""Build and load the port's host C++ libraries (``native/*.cpp``).

``load(name)`` compiles ``native/<name>.cpp`` with ``g++ -O3`` into a shared
library under the git-ignored ``ops/build/`` at first use (the file name
carries a hash of the source, so an edited source builds anew) and loads it
with ``ctypes``. A failed build raises: there is no silent fall-back to the
numpy versions, which run only when a caller asks for ``backend="numpy"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "ops", "build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_libs = {}


def library_path(name: str) -> str:
    with open(os.path.join(_SRC_DIR, f"{name}.cpp"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def load(name: str) -> ctypes.CDLL:
    """The library of ``native/<name>.cpp``, built on first call."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", *GXX_FLAGS, os.path.join(_SRC_DIR, f"{name}.cpp"),
               "-o", tmp]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"g++ failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stderr[-2000:]}")
        os.replace(tmp, out)             # atomic: concurrent builds are safe
    lib = _libs[name] = ctypes.CDLL(out)
    return lib
