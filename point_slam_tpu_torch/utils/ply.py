"""Minimal binary PLY mesh/point-cloud I/O.

A copy of ``point_slam_tpu.utils.ply`` (pure numpy).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def write_ply(path: str, vertices: np.ndarray,
              faces: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None) -> None:
    """vertices (N,3) f32; faces (M,3) int; colors (N,3) float [0,1] or uint8."""
    vertices = np.asarray(vertices, np.float32)
    n = len(vertices)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = vertices
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(vertices.astype("<f4").tobytes())
        if faces is not None:
            faces = np.asarray(faces, np.int32)
            rec = np.zeros(len(faces), dtype=[("n", np.uint8),
                                              ("idx", np.int32, 3)])
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray],
                                 Optional[np.ndarray]]:
    """Returns (vertices (N,3) f32, faces (M,3) int32 or None,
    colors (N,3) uint8 or None). Supports the subset written above plus
    ascii/binary_little_endian with float/double xyz and uchar rgb."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end + len(b"end_header") + 1:]

    fmt = "binary_little_endian"
    elements = []  # (name, count, [(prop_dtype, prop_name) or ('list',...)])
    cur = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = {"name": parts[1], "count": int(parts[2]), "props": []}
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur["props"].append(("list", parts[2], parts[3], parts[4]))
            else:
                cur["props"].append((parts[1], parts[2]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
                "uint": "<u4", "short": "<i2", "ushort": "<u2"}

    verts = faces = colors = None
    if fmt == "ascii":
        tokens = body.decode().split()
        pos = 0
        for el in elements:
            if el["name"] == "vertex":
                names = [p[1] for p in el["props"]]
                ncols = len(names)
                arr = np.array(tokens[pos:pos + el["count"] * ncols],
                               dtype=np.float64).reshape(el["count"], ncols)
                pos += el["count"] * ncols
                verts = arr[:, [names.index("x"), names.index("y"),
                                names.index("z")]].astype(np.float32)
                if "red" in names:
                    colors = arr[:, [names.index("red"), names.index("green"),
                                     names.index("blue")]].astype(np.uint8)
            elif el["name"] == "face":
                fl = []
                for _ in range(el["count"]):
                    k = int(tokens[pos]); pos += 1
                    fl.append([int(t) for t in tokens[pos:pos + k]])
                    pos += k
                faces = np.asarray(fl, np.int32)
        return verts, faces, colors

    off = 0
    for el in elements:
        if el["name"] == "vertex":
            dt = np.dtype([(p[1], type_map[p[0]]) for p in el["props"]])
            arr = np.frombuffer(body, dtype=dt, count=el["count"], offset=off)
            off += dt.itemsize * el["count"]
            verts = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
            names = dt.names
            if "red" in names:
                colors = np.stack([arr["red"], arr["green"], arr["blue"]],
                                  -1).astype(np.uint8)
        elif el["name"] == "face":
            p = el["props"][0]
            cnt_t = np.dtype(type_map[p[1]])
            idx_t = np.dtype(type_map[p[2]])
            rec = np.dtype([("n", cnt_t), ("idx", idx_t, 3)])
            arr = np.frombuffer(body, dtype=rec, count=el["count"], offset=off)
            off += rec.itemsize * el["count"]
            faces = arr["idx"].astype(np.int32)
    return verts, faces, colors
