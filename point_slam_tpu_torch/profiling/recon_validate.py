"""Reconstruction validation on a synthetic scene: a run's TSDF mesh
scored against the scene's ANALYTIC ground-truth mesh.

    python -m point_slam_tpu_torch.profiling.recon_validate <run_cfg.yaml>
        [<output_dir>] [--device cuda|cpu] [--voxel 0.009765625]

The synthetic scenes have exact analytic surfaces (``Synthetic.gt_mesh``:
the room's walls and its furniture), so this closes the loop over the
reconstruction stack (render, TSDF fusion, marching, ``eval_recon``) with
no uncertainty in the ground truth. ``output_dir`` defaults to the newest
run under the config's ``data.output``. When the run has no mesh, the
port's mesh-from-checkpoint CLI (``tools/mesher.py``) builds it from the
newest checkpoint on ``--device``. Prints precision, recall, F-score and
the distances at tau = 1 cm against the full GT mesh and against the GT
culled to the frusta of the checkpoint's estimated poses (the trajectory
sees only part of the room), and writes both to
``<output_dir>/mesh/recon_validate.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

from point_slam_tpu_torch.profiling import workload as W

HERE = W.HERE


def newest_run(cfg) -> str:
    runs = sorted(glob.glob(os.path.join(cfg["data"]["output"], "*")))
    if not runs:
        raise SystemExit(f"no runs under {cfg['data']['output']}")
    return runs[-1]


def run_meshes(out: str):
    """The run's reconstructed meshes (not the GT ones this tool or the
    evaluation write there, nor vertex dumps)."""
    return [p for p in sorted(glob.glob(os.path.join(out, "mesh", "*.ply")))
            if "vertices" not in p
            and not os.path.basename(p).startswith("gt_")]


def validate(cfg_path: str, out: str, device: str = "cuda",
             voxel: float = 5.0 / 512.0):
    """Score the run's newest mesh (built first when missing); returns
    {"full": ..., "culled": ...} of calc_3d_metric's results."""
    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.datasets import get_dataset
    from point_slam_tpu_torch.tools.cull_mesh import cull_mesh
    from point_slam_tpu_torch.tools.eval_recon import calc_3d_metric
    from point_slam_tpu_torch.utils.logger import load_checkpoint
    from point_slam_tpu_torch.utils.ply import write_ply

    cfg = load_config(cfg_path, os.path.join(HERE, "configs",
                                             "point_slam.yaml"))
    ds = get_dataset(cfg)
    v, f = ds.gt_mesh()
    os.makedirs(os.path.join(out, "mesh"), exist_ok=True)
    gt_path = os.path.join(out, "mesh", "gt_scene.ply")
    write_ply(gt_path, v, faces=f)
    print(f"GT analytic mesh: {len(v)} verts {len(f)} faces", flush=True)

    rec = run_meshes(out)
    if not rec:
        print("building the mesh from the checkpoint with the mesher CLI...",
              flush=True)
        r = subprocess.run(
            [sys.executable, "-m", "point_slam_tpu_torch.tools.mesher",
             cfg_path, "--output", out, "--device", device, "--voxel",
             str(voxel), "--no_eval", "--silent"],
            cwd=HERE, capture_output=True, text=True)
        print(r.stdout[-500:], r.stderr[-500:], flush=True)
        if r.returncode != 0:
            raise RuntimeError(f"the mesher failed with code {r.returncode}")
        rec = run_meshes(out)
    print("rec mesh:", rec[-1], flush=True)
    full = calc_3d_metric(rec[-1], gt_path, threshold=0.01)
    print("3D recon metrics vs FULL GT (tau=1cm):", full, flush=True)

    # cull the GT to the frusta the run's poses saw (the evaluation's step)
    ckpts = sorted(glob.glob(os.path.join(out, "ckpts", "*.npz")))
    if not ckpts:
        raise SystemExit(f"no checkpoint under {out}/ckpts")
    ck = load_checkpoint(ckpts[-1])
    poses = ck["estimate_c2w_list"][:int(ck["idx"]) + 1]
    cam = cfg["cam"]
    cv, cf, _ = cull_mesh(v, f, poses, H=cam["H"], W=cam["W"], fx=cam["fx"],
                          fy=cam["fy"], cx=cam["cx"], cy=cam["cy"])
    culled_path = os.path.join(out, "mesh", "gt_scene_culled.ply")
    write_ply(culled_path, cv, faces=cf)
    print(f"culled GT: {len(cv)} verts {len(cf)} faces", flush=True)
    culled = calc_3d_metric(rec[-1], culled_path, threshold=0.01)
    print("3D recon metrics vs CULLED GT (tau=1cm):", culled, flush=True)
    res = {"mesh": rec[-1], "full": {k: float(x) for k, x in full.items()},
           "culled": {k: float(x) for k, x in culled.items()}}
    with open(os.path.join(out, "mesh", "recon_validate.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", help="the run's config yaml")
    ap.add_argument("output", nargs="?", default=None,
                    help="the run directory (default: the newest under the "
                         "config's data.output)")
    ap.add_argument("--voxel", type=float, default=5.0 / 512.0,
                    help="the TSDF voxel when the mesh is built here")
    W.add_device_arg(ap)
    args = ap.parse_args(argv)
    W.device(args.device, "recon_validate")
    out = args.output
    if out is None:
        from point_slam_tpu_torch.config import load_config
        out = newest_run(load_config(args.config, os.path.join(
            HERE, "configs", "point_slam.yaml")))
    return validate(args.config, out.rstrip("/"), args.device, args.voxel)


if __name__ == "__main__":
    main(sys.argv[1:])
