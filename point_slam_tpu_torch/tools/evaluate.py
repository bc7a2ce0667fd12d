"""End-of-run evaluation: trajectory, re-rendered images, mesh and
reconstruction.

The port of ``point_slam_tpu.tools.evaluate``: the ATE (aligned and not),
a full-resolution re-render of every mapped frame from the final map with
PSNR / MS-SSIM / LPIPS (when its weights exist) and rendered-depth L1, the
renders fused into a TSDF mesh, and the mesh scored against a ground-truth
surface. Everything is a function call returning dicts; the renders and
image metrics run on the SLAM's device.

A step that fails is reported, not hidden: its traceback is printed, its
keys are missing from the result and its name is listed under ``failed``,
and the checkpoints are kept.
"""

from __future__ import annotations

import copy
import os
import shutil
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch

from point_slam_tpu_torch import renderer as R
from point_slam_tpu_torch.tools.eval_ate import evaluate_ate, plot_traj
from point_slam_tpu_torch.utils import metrics


def eval_reconstruction(slam, cfg, mesh_path: str, out_dir: str
                        ) -> Dict[str, float]:
    """3D reconstruction eval against a ground-truth mesh.

    GT mesh sources, in order: ``meshing.gt_mesh`` (a ply path), else the
    dataset's analytic ``gt_mesh()`` (Synthetic), culled to the estimated
    trajectory's frusta (written to ``mesh/gt_culled.ply``). With
    ``meshing.eval_2d`` also the virtual-view depth-L1. Raises when there
    is no GT surface (a disk dataset without ``meshing.gt_mesh``), so the
    step is listed as failed instead of skipped."""
    from point_slam_tpu_torch.tools.cull_mesh import cull_mesh
    from point_slam_tpu_torch.tools.eval_recon import (calc_2d_metric,
                                                       calc_3d_metric)
    from point_slam_tpu_torch.utils.ply import write_ply

    gt_path = cfg.get("meshing", {}).get("gt_mesh") or None
    if gt_path is None and hasattr(slam.dataset, "gt_mesh"):
        v, f = slam.dataset.gt_mesh()
        cam = cfg["cam"]
        cv, cf, _ = cull_mesh(v, f, slam.estimate_c2w_list[:slam.n_done],
                              H=cam["H"], W=cam["W"], fx=cam["fx"],
                              fy=cam["fy"], cx=cam["cx"], cy=cam["cy"])
        gt_path = os.path.join(out_dir, "mesh", "gt_culled.ply")
        write_ply(gt_path, cv, faces=cf)
    if gt_path is None:
        raise RuntimeError(f"no ground-truth mesh for the {cfg['dataset']} "
                           "scene: set meshing.gt_mesh to its ply")
    if not os.path.exists(gt_path):
        raise FileNotFoundError(f"meshing.gt_mesh {gt_path} does not exist")
    res = calc_3d_metric(mesh_path, gt_path, threshold=0.01)
    out = {f"recon_{k.replace(' ', '_').replace('-', '_')}": v
           for k, v in res.items()}
    if cfg.get("meshing", {}).get("eval_2d", False):
        res2d = calc_2d_metric(
            mesh_path, gt_path,
            n_imgs=int(cfg["meshing"].get("eval_2d_n_imgs", 1000)))
        out["recon_depth_l1_2d"] = res2d["depth l1"]
    return out


def rerender_frames(slam, out_dir: str, save_renders: bool = True,
                    eval_img: Optional[bool] = None,
                    stride: int = 1) -> Dict[str, Any]:
    """Re-render every mapped frame of the run (every ``every_frame``-th;
    every ``stride``-th of those) from the final map at full resolution,
    with the per-frame colour-decoder snapshot and exposure latent where
    the run kept them. Returns the averaged metrics; saves depth/color npy
    pairs under ``rendered_every_frame/`` for the TSDF fusion."""
    cfg = slam.cfg
    mapper = slam.mapper
    dev = mapper.device
    every = cfg["mapping"]["every_frame"]
    step = every * max(int(stride), 1)
    if eval_img is None:
        eval_img = cfg["rendering"]["eval_img"]
    rend_dir = os.path.join(out_dir, "rendered_every_frame")
    os.makedirs(rend_dir, exist_ok=True)

    cam = cfg["cam"]
    intr = (cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    hw = (cam["H"], cam["W"])
    snaps = mapper.color_decoder_snapshots
    snap_dec = copy.deepcopy(mapper.decoders) if snaps else None
    lpips_params = metrics.load_lpips_params(dev) if eval_img else None
    generator = torch.Generator(device=dev).manual_seed(0)

    psnr_sum = ssim_sum = lpips_sum = depth_l1 = 0.0
    lpips_n = frame_cnt = 0
    for idx in range(0, slam.n_done, step):
        _, gt_color, gt_depth, _ = slam.dataset[idx]
        color_d = torch.as_tensor(gt_color, device=dev)
        depth_d = torch.as_tensor(gt_depth, device=dev)
        r_query = mapper.radius_maps(color_d)[1]
        dec = mapper.decoders
        if snaps and idx // every < len(snaps):
            # the colour decoder this frame's exposure latent was trained
            # against
            snap_dec.col.load_state_dict(snaps[idx // every])
            dec = snap_dec
        expo = (torch.as_tensor(mapper.exposure_feat_all[idx // every],
                                device=dev)
                if mapper.exposure_feat_all else None)
        dep, _, col = R.render_img(
            dec, mapper.cloud, mapper.index,
            torch.as_tensor(slam.estimate_c2w_list[idx], device=dev), intr,
            hw, mapper.rc, depth_d, r_query, generator=generator,
            exposure_feat=expo)
        if save_renders:
            np.save(os.path.join(rend_dir, f"depth_{idx:05d}"),
                    dep.cpu().numpy())
            np.save(os.path.join(rend_dir, f"color_{idx:05d}"),
                    col.cpu().numpy())
        mask = depth_d > 0
        if bool(mask.any()):
            depth_l1 += float((depth_d[mask] - dep[mask]).abs().mean())
        if eval_img:
            psnr_sum += metrics.psnr(col, color_d, mask)
            ssim_sum += metrics.ms_ssim(col, color_d)
            if lpips_params is not None:
                lpips_sum += metrics.lpips(col, color_d, lpips_params)
                lpips_n += 1
        frame_cnt += 1
        if cfg.get("verbose") and frame_cnt % 25 == 0:
            print(f"  [rerender] {frame_cnt} frames (idx {idx})", flush=True)

    out: Dict[str, Any] = {"frame_cnt": frame_cnt,
                           "depth_l1_render": depth_l1 / max(frame_cnt, 1)}
    if eval_img:
        out["avg_psnr"] = psnr_sum / max(frame_cnt, 1)
        out["avg_ms_ssim"] = ssim_sum / max(frame_cnt, 1)
        out["avg_lpips"] = ((lpips_sum / lpips_n) if lpips_n
                            else metrics.LPIPS_UNAVAILABLE)
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_end_of_run_eval(slam, out_dir: str) -> Dict[str, Any]:
    """The ATE; with ``cfg["dataset"]`` in ``render_datasets`` the
    re-render and its image metrics; in ``reconstruction_datasets`` the
    mesh and, with ``meshing.eval_rec``, its reconstruction metrics. Then
    the re-render scratch directory goes, and the checkpoints too when
    ``mapping.save_ckpts`` is false and the trajectory eval succeeded.
    Each step's seconds go under ``time_<step>``; a failed step's name
    under ``failed``."""
    cfg = slam.cfg
    results: Dict[str, Any] = {}
    failed = []

    def step(name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 - reported, checkpoints kept
            traceback.print_exc()
            print(f"{name} failed: {e}")
            failed.append(name)
            return None
        _sync(slam.device)
        results[f"time_{name}"] = time.perf_counter() - t0
        return out

    def ate():
        gt = slam.gt_c2w_list[:slam.n_done]
        est = slam.estimate_c2w_list[:slam.n_done]
        a = evaluate_ate(gt, est, align=True)
        a_no = evaluate_ate(gt, est, align=False)
        results["ate_rmse"] = a["absolute_translational_error.rmse"]
        results["ate_rmse_no_align"] = a_no[
            "absolute_translational_error.rmse"]
        print("ate_rmse:", a)
        print("ate_rmse_wo_align:", a_no)
        return True

    ate_ok = bool(step("ate", ate))
    # the plot is an artefact of its own: it fails alone
    step("plot", lambda: plot_traj(slam.gt_c2w_list[:slam.n_done],
                                   slam.estimate_c2w_list[:slam.n_done],
                                   os.path.join(out_dir, "trajectory.png")))

    if cfg["dataset"] in cfg.get("render_datasets", []):
        rr = step("rerender", lambda: rerender_frames(slam, out_dir))
        if rr is not None:
            results.update(rr)
            print(rr)

    if cfg["dataset"] in cfg.get("reconstruction_datasets", []):
        from point_slam_tpu_torch.tools.mesher import mesh_from_renders
        mesh_path = os.path.join(out_dir, "mesh", "final_mesh.ply")
        mesh = step("mesh", lambda: mesh_from_renders(
            slam, out_dir, mesh_path,
            voxel=cfg["meshing"].get("voxel", 5.0 / 512.0)))
        if mesh is not None:
            results["mesh"] = mesh["mesh"]
            results.update({f"mesh_{k}": v for k, v in mesh.items()
                            if k != "mesh"})
            if cfg["meshing"]["eval_rec"]:
                rec = step("recon", lambda: eval_reconstruction(
                    slam, cfg, mesh_path, out_dir))
                if rec is not None:
                    results.update(rec)
                    print({k: round(v, 3) for k, v in rec.items()})

    rend = os.path.join(out_dir, "rendered_every_frame")
    if os.path.exists(rend):
        shutil.rmtree(rend)
    if not cfg["mapping"].get("save_ckpts", True) and ate_ok:
        ck = os.path.join(out_dir, "ckpts")
        if os.path.exists(ck):
            shutil.rmtree(ck)
    if failed:
        results["failed"] = failed
    return results
