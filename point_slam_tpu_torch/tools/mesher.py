"""Mesh extraction: saved renders -> TSDF fusion -> surface mesh.

The port of ``point_slam_tpu.tools.mesher``: integrates the re-rendered
RGB-D frames (rendered depth zeroed wherever the sensor saw no depth) at
voxel 5/512 m / trunc 0.04 m along the estimated trajectory into a
TSDFVolume on the device, extracts the surface on the host and, for
non-Replica data or on request, drops small connected components. Also the
mesh-from-checkpoint CLI:

    python -m point_slam_tpu_torch.tools.mesher <config.yaml> --output DIR
        [--device cuda|cpu] [--voxel V] [--no_render] [--no_eval]

which restores the newest ``DIR/ckpts/*.npz``, re-renders every mapped
frame, fuses and meshes into ``DIR/mesh/<scene>_pred_mesh.ply`` and, where
there is a ground-truth surface, scores it. It runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from point_slam_tpu_torch.tools.tsdf import TSDFVolume
from point_slam_tpu_torch.utils.ply import write_ply


def _render_index(path: str) -> int:
    return int(os.path.basename(path)[6:-4])       # depth_<idx>.npy


def fuse_renders(render_dir: str, dataset, estimate_c2w_list, every: int,
                 intrinsics, voxel=5.0 / 512.0, sdf_trunc=0.04,
                 bounds_margin=0.2, verbose=True,
                 normal_weighting=False, mesh_freq: int = -1,
                 mid_mesh_dir: Optional[str] = None,
                 clean: bool = False, device="cuda") -> TSDFVolume:
    """Integrate saved renders into a TSDF volume on ``device``.

    With ``mesh_freq`` > 0, writes an intermediate mesh every mesh_freq
    integrated frames to ``mid_mesh_dir`` (``frame_<i>_mesh.ply``)."""
    fx, fy, cx, cy = intrinsics
    depth_files = sorted(glob.glob(os.path.join(render_dir, "depth_*.npy")))
    if not depth_files:
        raise FileNotFoundError(f"no renders found in {render_dir}")

    # scene bounds: backproject a sparse subset of rendered depths
    pts_lo = np.full(3, np.inf)
    pts_hi = np.full(3, -np.inf)
    for p in depth_files[:: max(len(depth_files) // 8, 1)]:
        depth = np.load(p)
        c2w = np.asarray(estimate_c2w_list[_render_index(p)], np.float64)
        h, w = depth.shape
        jj, ii = np.meshgrid(np.arange(0, h, 4), np.arange(0, w, 4),
                             indexing="ij")
        d = depth[::4, ::4]
        dirs = np.stack([(ii - cx) / fx, -(jj - cy) / fy,
                         -np.ones_like(ii, np.float64)], -1)
        pts = (c2w[:3, 3] + (dirs @ c2w[:3, :3].T) * d[..., None])[d > 0]
        if len(pts):
            pts_lo = np.minimum(pts_lo, pts.min(0))
            pts_hi = np.maximum(pts_hi, pts.max(0))

    vol = TSDFVolume.from_bounds(pts_lo, pts_hi, voxel, sdf_trunc,
                                 margin=bounds_margin,
                                 normal_weighting=normal_weighting,
                                 device=device)
    if verbose:
        print(f"TSDF grid {vol.dims} voxels @ {voxel:.4f} m on {vol.device}")

    for i, p in enumerate(depth_files):
        idx = _render_index(p)
        depth = np.load(p)
        color = np.load(os.path.join(render_dir, f"color_{idx:05d}.npy"))
        # gate the rendered depth by the sensor's
        _, _, gt_depth, _ = dataset[idx]
        depth[gt_depth == 0] = 0
        vol.integrate(depth, np.clip(color, 0.0, 1.0),
                      estimate_c2w_list[idx], fx, fy, cx, cy)
        if verbose and i % 20 == 0:
            print(f"  integrated frame {idx}")
        if (mesh_freq > 0 and mid_mesh_dir is not None and i > 0
                and i % mesh_freq == 0):
            os.makedirs(mid_mesh_dir, exist_ok=True)
            verts, faces, colors = vol.extract_mesh(
                min_component_verts=100 if clean else None)
            write_ply(os.path.join(mid_mesh_dir,
                                   f"frame_{every * i}_mesh.ply"),
                      verts, faces, colors)
            if verbose:
                print(f"  saved intermediate mesh until frame {every * i}")
    return vol


def mesh_from_renders(slam, out_dir: str, mesh_path: str,
                      clean: Optional[bool] = None,
                      voxel: float = 5.0 / 512.0,
                      sdf_trunc: Optional[float] = None) -> Dict[str, Any]:
    """Fuse the renders under ``out_dir/rendered_every_frame`` (made first
    if there are none) on the SLAM's device and write the mesh to
    ``mesh_path`` (and its vertices to ``vertices_pos.npy`` beside it).
    Returns {"mesh", "tsdf_dims", "n_verts", "n_faces", "time_fuse",
    "time_extract"} (seconds)."""
    cfg = slam.cfg
    cam = cfg["cam"]
    every = cfg["mapping"]["every_frame"]
    render_dir = os.path.join(out_dir, "rendered_every_frame")
    if not glob.glob(os.path.join(render_dir, "depth_*.npy")):
        from point_slam_tpu_torch.tools.evaluate import rerender_frames
        rerender_frames(slam, out_dir, save_renders=True, eval_img=False)

    if sdf_trunc is None:
        # the reference's 0.04 m at voxel 5/512 (~4 voxels); the band stays
        # >= 4 voxels on a coarser grid
        sdf_trunc = max(0.04, 4.0 * voxel)
    if clean is None:
        clean = cfg["dataset"] != "replica"
    meshing = cfg.get("meshing", {})
    t0 = time.perf_counter()
    vol = fuse_renders(render_dir, slam.dataset, slam.estimate_c2w_list,
                       every, (cam["fx"], cam["fy"], cam["cx"], cam["cy"]),
                       voxel=voxel, sdf_trunc=sdf_trunc,
                       verbose=cfg.get("verbose", True),
                       normal_weighting=meshing.get("normal_weighting",
                                                    False),
                       mesh_freq=meshing.get("mesh_freq", -1),
                       mid_mesh_dir=os.path.join(
                           os.path.dirname(mesh_path), "mid_mesh"),
                       clean=clean, device=slam.device)
    if vol.device.type == "cuda":
        import torch
        torch.cuda.synchronize(vol.device)
    t1 = time.perf_counter()
    verts, faces, colors = vol.extract_mesh(
        min_component_verts=100 if clean else None)
    t2 = time.perf_counter()
    os.makedirs(os.path.dirname(mesh_path), exist_ok=True)
    np.save(os.path.join(os.path.dirname(mesh_path), "vertices_pos.npy"),
            verts)
    write_ply(mesh_path, verts, faces, colors)
    print(f"mesh written to {mesh_path} ({len(verts)} verts, {len(faces)} "
          f"faces; fused in {t1 - t0:.2f} s, extracted in {t2 - t1:.2f} s)")
    return {"mesh": mesh_path, "tsdf_dims": list(vol.dims),
            "n_verts": len(verts), "n_faces": len(faces),
            "time_fuse": t1 - t0, "time_extract": t2 - t1}


def main(argv=None):
    """Mesh from the newest checkpoint of a run: restore the SLAM state,
    re-render every mapped frame, fuse and mesh."""
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--output", required=True)
    parser.add_argument("--name", default=None)
    parser.add_argument("--no_render", action="store_true",
                        help="reuse renders already in the output dir")
    parser.add_argument("--clean", action="store_true")
    parser.add_argument("--voxel", type=float, default=5.0 / 512.0)
    parser.add_argument("--no_eval", action="store_true",
                        help="skip the reconstruction eval after meshing")
    parser.add_argument("-s", "--silent", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda; fails without "
                        "CUDA unless --device cpu is given)")
    args = parser.parse_args(argv)

    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.slam import PointSLAM
    from point_slam_tpu_torch.tools.evaluate import (eval_reconstruction,
                                                     rerender_frames)
    from point_slam_tpu_torch.utils.logger import (
        load_checkpoint, restore_cloud_and_params,
        restore_color_decoder_snapshots)

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = load_config(args.config, os.path.join(here, "configs",
                                                "point_slam.yaml"))
    if args.silent:
        cfg["verbose"] = False
    slam = PointSLAM(cfg, output=args.output, device=args.device)
    ckpts = sorted(glob.glob(os.path.join(args.output, "ckpts", "*.npz")))
    if not ckpts:
        raise SystemExit(f"no checkpoint found under {args.output}/ckpts")
    ckpt = load_checkpoint(ckpts[-1])
    restore_cloud_and_params(ckpt, slam.mapper)
    restore_color_decoder_snapshots(ckpt, slam.mapper)
    if ckpt["exposure_feat_all"].size:
        slam.mapper.exposure_feat_all = list(
            ckpt["exposure_feat_all"].astype(np.float32))
    n = min(len(ckpt["estimate_c2w_list"]), slam.n_img)
    slam.estimate_c2w_list[:n] = ckpt["estimate_c2w_list"][:n]
    slam.gt_c2w_list[:n] = ckpt["gt_c2w_list"][:n]
    slam.n_done = min(int(ckpt["idx"]) + 1, slam.n_img)

    name = args.name or f"{cfg.get('scene', 'scene')}_pred_mesh.ply"
    mesh_path = os.path.join(args.output, "mesh", name)
    if not args.no_render:
        rerender_frames(slam, args.output, save_renders=True, eval_img=False)
    mesh_from_renders(slam, args.output, mesh_path,
                      clean=args.clean or None, voxel=args.voxel)

    # the reconstruction eval needs a ground-truth surface: meshing.gt_mesh
    # or the dataset's analytic one
    if not args.no_eval:
        if cfg.get("meshing", {}).get("gt_mesh") or \
                hasattr(slam.dataset, "gt_mesh"):
            res = {k: float(v) for k, v in eval_reconstruction(
                slam, cfg, mesh_path, args.output).items()}
            print(json.dumps(res, indent=1))
            with open(os.path.join(args.output, "mesh", "recon_eval.json"),
                      "w") as f:
                json.dump(res, f, indent=1)
        elif not args.silent:
            print("no GT mesh configured (meshing.gt_mesh) -> skipping "
                  "the reconstruction eval")
    return mesh_path


if __name__ == "__main__":
    main()
