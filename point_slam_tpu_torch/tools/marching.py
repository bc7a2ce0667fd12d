"""Isosurface extraction via marching tetrahedra.

The port of ``point_slam_tpu.tools.marching``. Each active grid cell is
split into six tetrahedra sharing the main diagonal; the per-tet case
tables (triangle / quad crossings) are derived programmatically at import,
and triangle winding is fixed numerically so normals point toward
increasing SDF (outward for a truncated signed distance with positive =
free space).

Two implementations with identical semantics, chosen by ``backend``:
* ``"native"`` (the default): ``native/marching.cpp``, built with g++ on
  first use and bound with ctypes; a failed build raises;
* ``"numpy"``: the vectorised plain version, the tests' oracle.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from point_slam_tpu_torch.utils import native

BACKENDS = ("native", "numpy")


def _load_native():
    lib = native.load("marching")
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.ps_marching_tetra.argtypes = [
        f32p, f32p, f32p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float,
        ctypes.POINTER(f32p), ctypes.POINTER(i32p), ctypes.POINTER(f32p),
        ctypes.POINTER(ctypes.c_long)]
    lib.ps_marching_tetra.restype = ctypes.c_long
    lib.ps_free.argtypes = [ctypes.c_void_p]
    lib.ps_free.restype = None
    return lib


def _marching_native(lib, sdf, iso, origin, voxel, weight, color):
    f32p = ctypes.POINTER(ctypes.c_float)

    def fptr(a):
        return (a.ctypes.data_as(f32p) if a is not None
                else ctypes.cast(None, f32p))

    sdf = np.ascontiguousarray(sdf, np.float32)
    weight = (np.ascontiguousarray(weight, np.float32)
              if weight is not None else None)
    color = (np.ascontiguousarray(color, np.float32)
             if color is not None else None)
    out_v, out_f, out_c = f32p(), ctypes.POINTER(ctypes.c_int)(), f32p()
    n_verts = ctypes.c_long(0)
    n_faces = lib.ps_marching_tetra(
        fptr(sdf), fptr(weight), fptr(color),
        sdf.shape[0], sdf.shape[1], sdf.shape[2],
        ctypes.c_float(iso),
        ctypes.c_float(origin[0]), ctypes.c_float(origin[1]),
        ctypes.c_float(origin[2]), ctypes.c_float(voxel),
        ctypes.byref(out_v), ctypes.byref(out_f), ctypes.byref(out_c),
        ctypes.byref(n_verts))
    nv = n_verts.value
    verts = np.ctypeslib.as_array(out_v, (nv, 3)).copy() if nv else \
        np.zeros((0, 3), np.float32)
    faces = np.ctypeslib.as_array(out_f, (n_faces, 3)).copy() if n_faces \
        else np.zeros((0, 3), np.int32)
    vcols = None
    if color is not None and nv:
        vcols = np.ctypeslib.as_array(out_c, (nv, 3)).copy()
    for p in (out_v, out_f, out_c):
        if p:
            lib.ps_free(ctypes.cast(p, ctypes.c_void_p))
    return verts, faces, vcols


# Corner offsets of a cell, index 0..7 -> (dx, dy, dz)
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64)

# Six tetrahedra sharing the 0-6 diagonal
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int64)


def _build_case_tables():
    """For each of 16 inside-masks over tet verts: list of triangles, each a
    triple of crossing edges (pairs of tet-local vertex ids)."""
    tables = []
    for case in range(16):
        inside = [bool(case >> i & 1) for i in range(4)]
        ins = [i for i in range(4) if inside[i]]
        outs = [i for i in range(4) if not inside[i]]
        tris = []
        if len(ins) == 1:
            a = ins[0]
            e = [(a, o) for o in outs]
            tris = [(e[0], e[1], e[2])]
        elif len(ins) == 3:
            a = outs[0]
            e = [(i, a) for i in ins]
            tris = [(e[0], e[1], e[2])]
        elif len(ins) == 2:
            i1, i2 = ins
            o1, o2 = outs
            quad = [(i1, o1), (i1, o2), (i2, o2), (i2, o1)]
            tris = [(quad[0], quad[1], quad[2]), (quad[0], quad[2], quad[3])]
        tables.append(tris)
    return tables


_CASES = _build_case_tables()


def marching_tetrahedra(sdf: np.ndarray, iso: float = 0.0,
                        origin=(0.0, 0.0, 0.0), voxel: float = 1.0,
                        weight: Optional[np.ndarray] = None,
                        color: Optional[np.ndarray] = None,
                        backend: str = "native",
                        ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Extract the iso-surface of a (X,Y,Z) scalar grid.

    weight: optional per-voxel validity (cells touching weight==0 corners are
    skipped — the TSDF 'unobserved' convention). color: optional (X,Y,Z,3)
    field interpolated to vertices. backend: "native" (the C++ library) or
    "numpy" (the plain version the C++ one is tested against).

    Returns (vertices (N,3), faces (M,3), vertex_colors (N,3) or None).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "native":
        return _marching_native(_load_native(), sdf, iso, origin, voxel,
                                weight, color)
    sdf = np.asarray(sdf, np.float32)
    nx, ny, nz = sdf.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), None

    corner_vals = np.empty((nx - 1, ny - 1, nz - 1, 8), np.float32)
    corner_ok = np.ones((nx - 1, ny - 1, nz - 1), bool)
    for ci, (dx, dy, dz) in enumerate(_CORNERS):
        v = sdf[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
        corner_vals[..., ci] = v
        if weight is not None:
            corner_ok &= weight[dx:nx - 1 + dx, dy:ny - 1 + dy,
                                dz:nz - 1 + dz] > 0
    active = (corner_vals.min(-1) < iso) & (corner_vals.max(-1) >= iso) \
        & corner_ok
    idx = np.argwhere(active)                       # (A, 3)
    if len(idx) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32), None
    vals = corner_vals[active]                      # (A, 8)
    base = idx.astype(np.float32)                   # cell origin in voxels

    verts_out = []
    cols_out = []

    def corner_pos(ci):
        return base + _CORNERS[ci].astype(np.float32)

    def corner_col(ci, sel):
        dx, dy, dz = _CORNERS[ci]
        return color[idx[sel, 0] + dx, idx[sel, 1] + dy, idx[sel, 2] + dz]

    for tet in _TETS:
        tvals = vals[:, tet]                        # (A, 4)
        case = ((tvals < iso) << np.arange(4)).sum(-1)  # (A,)
        for c in range(1, 15):
            tris = _CASES[c]
            if not tris:
                continue
            sel = np.nonzero(case == c)[0]
            if len(sel) == 0:
                continue
            for tri in tris:
                pts = []
                cls = []
                for (a, b) in tri:
                    va = tvals[sel, a]
                    vb = tvals[sel, b]
                    t = np.clip((iso - va) / np.where(
                        np.abs(vb - va) < 1e-12, 1e-12, vb - va), 0.0, 1.0)
                    pa = corner_pos(tet[a])[sel]
                    pb = corner_pos(tet[b])[sel]
                    pts.append(pa + t[:, None] * (pb - pa))
                    if color is not None:
                        ca = corner_col(tet[a], sel).astype(np.float32)
                        cb = corner_col(tet[b], sel).astype(np.float32)
                        cls.append(ca + t[:, None] * (cb - ca))
                p0, p1, p2 = pts
                # orient: normal toward increasing sdf (outside)
                ins_mask = (tvals[sel] < iso)
                n_in = np.maximum(ins_mask.sum(-1, keepdims=True), 1)
                pos4 = np.stack([corner_pos(tet[k])[sel] for k in range(4)], 1)
                mean_in = (pos4 * ins_mask[..., None]).sum(1) / n_in
                n_out = np.maximum((~ins_mask).sum(-1, keepdims=True), 1)
                mean_out = (pos4 * (~ins_mask)[..., None]).sum(1) / n_out
                outward = mean_out - mean_in
                nrm = np.cross(p1 - p0, p2 - p0)
                flip = (nrm * outward).sum(-1) < 0
                p1f = np.where(flip[:, None], p2, p1)
                p2f = np.where(flip[:, None], p1, p2)
                verts_out.append(np.stack([p0, p1f, p2f], 1))
                if color is not None:
                    c0, c1, c2 = cls
                    c1f = np.where(flip[:, None], c2, c1)
                    c2f = np.where(flip[:, None], c1, c2)
                    cols_out.append(np.stack([c0, c1f, c2f], 1))

    tri_pts = np.concatenate(verts_out, 0)          # (M, 3, 3) in voxel units
    tri_cols = np.concatenate(cols_out, 0) if color is not None else None

    # weld duplicate vertices (quantized to 1e-5 voxel)
    flat = tri_pts.reshape(-1, 3)
    keys = np.round(flat * 1e5).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    first = np.full(len(uniq), len(flat), np.int64)
    np.minimum.at(first, inv, np.arange(len(flat)))
    vertices = flat[first]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    faces = faces[good]
    vcols = None
    if tri_cols is not None:
        vcols = tri_cols.reshape(-1, 3)[first]
    vertices = vertices * voxel + np.asarray(origin, np.float32)
    return vertices.astype(np.float32), faces, vcols


def connected_components_filter(vertices: np.ndarray, faces: np.ndarray,
                                min_verts: int = 100):
    """Drop small connected components (the reference keeps components with
    >= 100 vertices). The components come from scipy's connected_components
    over the faces' edges instead of the JAX package's Python union-find
    loop: the same partition, so the same vertices and faces are kept, in
    the same order. Returns (vertices, faces, keep mask over vertices)."""
    n = len(vertices)
    faces = np.asarray(faces)
    if len(faces):
        rows = np.concatenate([faces[:, 0], faces[:, 0]])
        cols = np.concatenate([faces[:, 1], faces[:, 2]])
    else:
        rows = cols = np.zeros(0, np.int64)
    graph = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                       shape=(n, n))
    _, labels = connected_components(graph, directed=False)
    counts = np.bincount(labels, minlength=n)
    keep_v = counts[labels] >= min_verts
    keep_f = keep_v[faces].all(1) if len(faces) else np.zeros(0, bool)
    new_index = np.cumsum(keep_v) - 1
    return (vertices[keep_v], new_index[faces[keep_f]].astype(np.int32),
            keep_v)
