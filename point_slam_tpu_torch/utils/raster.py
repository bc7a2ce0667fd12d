"""Mesh depth rasterization and frustum tests for the reconstruction
eval.

The port of ``point_slam_tpu.utils.raster``: a z-buffer rasterizer and a
points-in-any-frustum test, each with two implementations of identical
semantics chosen by ``backend``: ``"native"`` (the default;
``native/raster.cpp`` built with g++ on first use, bound with ctypes; a
failed build raises) and ``"numpy"`` (the vectorised plain version, the
tests' oracle). Both share the framework camera convention and
perspective-correct depth interpolation.
"""

from __future__ import annotations

import ctypes

import numpy as np

from point_slam_tpu_torch.utils import native

BACKENDS = ("native", "numpy")


def _load_native():
    lib = native.load("raster")
    lib.rasterize_depth.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float)]
    lib.rasterize_depth.restype = None
    lib.points_in_any_frustum.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.points_in_any_frustum.restype = None
    return lib


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def rasterize_depth(verts: np.ndarray, faces: np.ndarray, w2c: np.ndarray,
                    fx, fy, cx, cy, h: int, w: int,
                    z_far: float = 20.0, backend: str = "native"
                    ) -> np.ndarray:
    """Render the z-depth map of a triangle mesh. 0 where empty."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    w2c = np.ascontiguousarray(w2c, np.float32)
    _check_backend(backend)
    if backend == "native":
        lib = _load_native()
        out = np.zeros(h * w, np.float32)
        lib.rasterize_depth(
            _fptr(verts), len(verts),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
            _fptr(w2c), fx, fy, cx, cy, h, w, z_far, _fptr(out))
        return out.reshape(h, w)
    return _rasterize_numpy(verts, faces, w2c, fx, fy, cx, cy, h, w, z_far)


def _rasterize_numpy(verts, faces, w2c, fx, fy, cx, cy, h, w, z_far):
    cam = verts @ w2c[:3, :3].T + w2c[:3, 3]
    z = -cam[:, 2]
    px = fx * cam[:, 0] / np.maximum(z, 1e-9) + cx
    py = -fy * cam[:, 1] / np.maximum(z, 1e-9) + cy
    depth = np.zeros((h, w), np.float32)
    tz = z[faces]
    ok = (tz > 1e-6).all(1) & (tz <= z_far).all(1)
    for f in faces[ok]:
        xs, ys, zs = px[f], py[f], z[f]
        x0 = max(0, int(np.floor(xs.min())))
        x1 = min(w - 1, int(np.ceil(xs.max())))
        y0 = max(0, int(np.floor(ys.min())))
        y1 = min(h - 1, int(np.ceil(ys.max())))
        if x0 > x1 or y0 > y1:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        d01 = (xs[1] - xs[0], ys[1] - ys[0])
        d02 = (xs[2] - xs[0], ys[2] - ys[0])
        det = d01[0] * d02[1] - d01[1] * d02[0]
        if abs(det) < 1e-12:
            continue
        ex = gx - xs[0]
        ey = gy - ys[0]
        b1 = (ex * d02[1] - ey * d02[0]) / det
        b2 = (d01[0] * ey - d01[1] * ex) / det
        b0 = 1.0 - b1 - b2
        inside = (b0 >= -1e-6) & (b1 >= -1e-6) & (b2 >= -1e-6)
        iz = b0 / zs[0] + b1 / zs[1] + b2 / zs[2]
        zval = np.where(inside, 1.0 / np.maximum(iz, 1e-12), np.inf)
        tile = depth[y0:y1 + 1, x0:x1 + 1]
        cur = np.where(tile == 0, np.inf, tile)
        depth[y0:y1 + 1, x0:x1 + 1] = np.where(zval < cur, zval, tile)
    return depth


def points_in_any_frustum(pts: np.ndarray, w2c_list: np.ndarray,
                          fx, fy, cx, cy, h: int, w: int,
                          backend: str = "native") -> np.ndarray:
    """Bool mask: point visible in at least one camera frustum."""
    pts = np.ascontiguousarray(pts, np.float32)
    w2c_list = np.ascontiguousarray(w2c_list, np.float32)
    _check_backend(backend)
    if backend == "native":
        lib = _load_native()
        out = np.zeros(len(pts), np.uint8)
        lib.points_in_any_frustum(
            _fptr(pts), len(pts), _fptr(w2c_list), len(w2c_list),
            fx, fy, cx, cy, h, w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.astype(bool)
    mask = np.zeros(len(pts), bool)
    for w2c in w2c_list:
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = -cam[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = fx * cam[:, 0] / z + cx
            v = -fy * cam[:, 1] / z + cy
        mask |= (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return mask
