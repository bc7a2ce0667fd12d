"""The end-of-run evaluation of a soak run, from its newest checkpoint.

    python -m point_slam_tpu_torch.profiling.soak_eval <run_dir>
        [render_stride] [config] [--device cuda|cpu]

Restores the run's cloud, decoders, colour-decoder snapshots, exposure
latents and poses from ``<run_dir>/ckpts``' newest checkpoint
(``utils/logger.py``; a checkpoint of either package), then runs the
evaluation a soak's config leaves off: every ``render_stride``-th mapped
frame re-rendered at full resolution with its colour-decoder snapshot and
exposure latent (PSNR, MS-SSIM, LPIPS when its weights exist, rendered
depth L1), those renders fused into a TSDF mesh, the mesh scored against
the analytic ground truth, and the device memory at scale. Writes
``render_metrics.json``, ``mesh/recon_eval.json`` and
``eval_memory.json`` into the run directory (the inputs of
``soak_summary``). ``config`` defaults to
``configs/Synthetic/room_scannet_scale.yaml``. A stride above 1 fuses the
mesh from those frames only, and both files record it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from point_slam_tpu_torch.profiling import workload as W

HERE = W.HERE
DEFAULT_CONFIG = os.path.join(HERE, "configs", "Synthetic",
                              "room_scannet_scale.yaml")


def restore(cfg, run: str, dev):
    """A PointSLAM on ``run`` holding its newest checkpoint's state."""
    from point_slam_tpu_torch.slam import PointSLAM
    from point_slam_tpu_torch.utils.logger import (
        load_checkpoint, restore_cloud_and_params,
        restore_color_decoder_snapshots)
    slam = PointSLAM(cfg, output=run, device=dev)
    ckpts = sorted(glob.glob(os.path.join(run, "ckpts", "*.npz")))
    if not ckpts:
        raise SystemExit(f"no checkpoints under {run}")
    print("loading", ckpts[-1], flush=True)
    ckpt = load_checkpoint(ckpts[-1])
    restore_cloud_and_params(ckpt, slam.mapper)
    restore_color_decoder_snapshots(ckpt, slam.mapper)
    if ckpt.get("exposure_feat_all") is not None and \
            ckpt["exposure_feat_all"].size:
        slam.mapper.exposure_feat_all = list(
            ckpt["exposure_feat_all"].astype(np.float32))
    n = min(len(ckpt["estimate_c2w_list"]), slam.n_img)
    slam.estimate_c2w_list[:n] = ckpt["estimate_c2w_list"][:n]
    slam.gt_c2w_list[:n] = ckpt["gt_c2w_list"][:n]
    slam.n_done = min(int(ckpt["idx"]) + 1, slam.n_img)
    print(f"restored: {slam.mapper.n_points_host} points, "
          f"{len(slam.mapper.color_decoder_snapshots)} color snapshots, "
          f"{len(slam.mapper.exposure_feat_all)} exposure feats, "
          f"{slam.n_done} frames", flush=True)
    return slam


def evaluate(run: str, stride: int = 1, cfg_path: str = DEFAULT_CONFIG,
             device: str = "cuda"):
    """Re-render, mesh, score and record memory; returns (render metrics,
    recon eval, memory) as written."""
    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.tools.evaluate import (eval_reconstruction,
                                                     rerender_frames)
    from point_slam_tpu_torch.tools.mesher import mesh_from_renders
    from point_slam_tpu_torch.utils.memory import memory_report

    dev = W.device(device, "soak_eval")
    run = run.rstrip("/")
    cfg = load_config(cfg_path, os.path.join(HERE, "configs",
                                             "point_slam.yaml"))
    cfg["verbose"] = True
    slam = restore(cfg, run, dev)

    rr = rerender_frames(slam, run, save_renders=True, eval_img=True,
                         stride=stride)
    rr = {k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
          for k, v in rr.items()}
    rr["render_stride"] = stride
    with open(os.path.join(run, "render_metrics.json"), "w") as f:
        json.dump(rr, f, indent=1)
    print("render_metrics:", rr, flush=True)

    # the memory right after the re-render: the cloud, the keyframe state
    # and the render scratch, the working set at scale
    mem = dict(memory_report(dev))

    mesh_path = os.path.join(run, "mesh", "final_mesh.ply")
    mesh_from_renders(slam, run, mesh_path,
                      voxel=cfg["meshing"].get("voxel", 5.0 / 512.0))
    cfg["meshing"]["eval_rec"] = True
    rec = {k: float(v) for k, v in eval_reconstruction(
        slam, cfg, mesh_path, run).items()}
    # the mesh is fused from every stride-th mapped frame's renders only:
    # recorded beside the F-score so that a strided run is never compared
    # with a full fusion unawares
    rec["render_stride"] = stride
    rec["n_fused_frames"] = int(rr.get("frame_cnt", 0))
    with open(os.path.join(run, "mesh", "recon_eval.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print("recon_eval:", rec, flush=True)

    mem.update({f"post_mesh_{k}": v
                for k, v in memory_report(dev).items()})
    with open(os.path.join(run, "eval_memory.json"), "w") as f:
        json.dump(mem, f, indent=1)
    print("eval_memory:", {k: mem[k] for k in sorted(mem)[:8]}, flush=True)
    return rr, rec, mem


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir")
    ap.add_argument("render_stride", nargs="?", type=int, default=1)
    ap.add_argument("config", nargs="?", default=DEFAULT_CONFIG)
    W.add_device_arg(ap)
    args = ap.parse_args(argv)
    return evaluate(args.run_dir, args.render_stride, args.config,
                    args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
