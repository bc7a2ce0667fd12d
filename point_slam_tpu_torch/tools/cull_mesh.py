"""Cull mesh faces never observed by any trajectory camera.

A copy of ``point_slam_tpu.tools.cull_mesh`` (numpy; the frustum test is
``utils.raster.points_in_any_frustum``'s native backend). It removes faces whose vertices all fall
outside every camera frustum of a trajectory (hardcoded Replica intrinsics
in the reference; configurable here with the same defaults).
"""

from __future__ import annotations

import argparse

import numpy as np

from point_slam_tpu_torch.utils.ply import read_ply, write_ply
from point_slam_tpu_torch.utils.raster import points_in_any_frustum

REPLICA_INTRINSICS = dict(H=680, W=1200, fx=600.0, fy=600.0,
                          cx=599.5, cy=339.5)


def cull_mesh(verts: np.ndarray, faces: np.ndarray, c2w_list: np.ndarray,
              H=680, W=1200, fx=600.0, fy=600.0, cx=599.5, cy=339.5):
    w2c = np.linalg.inv(np.asarray(c2w_list, np.float64)).astype(np.float32)
    seen = points_in_any_frustum(verts, w2c, fx, fy, cx, cy, H, W)
    keep_f = seen[faces].any(1)
    used = np.zeros(len(verts), bool)
    used[faces[keep_f].ravel()] = True
    remap = np.cumsum(used) - 1
    return verts[used], remap[faces[keep_f]].astype(np.int32), used


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_mesh", required=True)
    parser.add_argument("--traj", required=True,
                        help="npz/npy with (N,4,4) c2w poses or a ckpt npz")
    parser.add_argument("--output_mesh", required=True)
    args = parser.parse_args()

    verts, faces, colors = read_ply(args.input_mesh)
    data = np.load(args.traj)
    if hasattr(data, "files"):
        poses = data["estimate_c2w_list" if "estimate_c2w_list" in data.files
                     else data.files[0]]
    else:
        poses = data
    v, f, used = cull_mesh(verts, faces, poses, **REPLICA_INTRINSICS)
    write_ply(args.output_mesh, v, f,
              colors[used] if colors is not None else None)
    print(f"culled mesh: {len(v)} verts, {len(f)} faces")


if __name__ == "__main__":
    main()
