"""Tracking drift at the bench's widths: per-frame pose error and losses.

    python -m point_slam_tpu_torch.profiling.track_quality
        [--device cuda|cpu] [--few_frames] [--train_geo] [--no_frustum]
        [--no_grad_add] [--seed=N] [--chunks] [--small]

``configs/Synthetic/room.yaml`` with bench.py's widths (680x1200, 1500
tracking rays x 40 iterations, 5000 mapping rays, window 12) and the TPU
script's own settings (first frame 500 iterations, 200 of them geometry,
CAP 2^19). Frame 0 is mapped from its GT pose; each later frame is tracked
(its translation error printed in cm, with the loss before and after) and
every 5th and the last one mapped. ``--few_frames`` runs frame 0 only;
``--train_geo`` trains the geometry decoder; ``--no_frustum`` turns the
frustum feature selection off; ``--no_grad_add`` the colour-gradient
densification; ``--seed=N`` sets setup_seed; ``--chunks`` prints the
mapper's progress. ``--small``: a 48x64 camera for a run on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from point_slam_tpu_torch.profiling import workload as W


def config(n_frames: int = 8, train_geo: bool = False,
           no_frustum: bool = False, no_grad_add: bool = False,
           seed=None, chunks: bool = False, small: bool = False):
    cfg = W.bench_config(n_frames, iters_first=500, small=small)
    cfg["mapping"]["geo_iter_first"] = 200
    if not small:
        cfg["cuda"]["point_capacity_init"] = 1 << 19
    cfg["verbose"] = chunks
    cfg["data"]["output"] = os.path.join(W.OUTPUT, "torch", "track_quality")
    if train_geo:
        cfg["mapping"]["fix_geo_decoder"] = False
    if no_frustum:
        cfg["mapping"]["frustum_feature_selection"] = False
    if no_grad_add:
        cfg["mapping"]["pixels_based_on_color_grad"] = 0
    if seed is not None:
        cfg["setup_seed"] = int(seed)
    return cfg


def run(cfg, dev) -> List[Dict]:
    """Map frame 0, then track every frame and map every 5th and the last;
    one record a frame (translation error in cm, losses, map stats)."""
    from point_slam_tpu_torch.slam import PointSLAM
    slam = PointSLAM(cfg, device=dev)
    n = slam.n_img
    color, depth, gt = slam._frame(0)
    slam.estimate_c2w_list[0] = gt
    slam.gt_c2w_list[0] = gt
    st = slam.mapper.map_frame(0, color, depth, gt, gt)
    print(f"frame0 mapped: {st['n_points']} pts, geo {st['geo_loss']:.2f} "
          f"col {st['color_loss']:.2f} n_iters {st['n_iters']}", flush=True)
    out = [{"idx": 0, "terr_cm": 0.0, "map": st}]
    for idx in range(1, n):
        color, depth, gt = slam._frame(idx)
        slam.gt_c2w_list[idx] = gt
        cd = torch.as_tensor(color, device=dev)
        dd = torch.as_tensor(depth, device=dev)
        r_query = slam.mapper.radius_maps(cd)[1]
        res = slam.tracker.track_frame(idx, cd, dd, gt,
                                       slam.estimate_c2w_list, slam.mapper,
                                       r_query)
        slam.estimate_c2w_list[idx] = res["c2w"]
        terr = float(np.linalg.norm(res["c2w"][:3, 3] - gt[:3, 3]) * 100)
        rec = {"idx": idx, "terr_cm": terr}
        msg = f"frame {idx}: terr {terr:6.2f} cm"
        if res.get("tracked"):
            rec.update(first_loss=res["first_loss"],
                       best_loss=res["best_loss"])
            msg += f"  loss {res['first_loss']:9.2f} -> {res['best_loss']:9.2f}"
        print(msg, flush=True)
        if idx % 5 == 0 or idx == n - 1:
            st = slam.mapper.map_frame(idx, cd, dd, gt,
                                       slam.estimate_c2w_list[idx])
            rec["map"] = st
            print(f"  [map] geo {st['geo_loss']:.2f} col "
                  f"{st['color_loss']:.2f} iters {st['n_iters']} pts "
                  f"{st['n_points']}", flush=True)
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--few_frames", action="store_true",
                    help="frame 0 only")
    ap.add_argument("--train_geo", action="store_true")
    ap.add_argument("--no_frustum", action="store_true")
    ap.add_argument("--no_grad_add", action="store_true")
    ap.add_argument("--chunks", action="store_true",
                    help="print the mapper's progress")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--small", action="store_true",
                    help="a 48x64 camera and a few hundred rays")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "track_quality")
    cfg = config(1 if args.few_frames else 8, args.train_geo,
                 args.no_frustum, args.no_grad_add, args.seed, args.chunks,
                 args.small)
    out = run(cfg, dev)
    W.save_json(os.path.join("torch", "track_quality.json"),
                [{k: v for k, v in r.items() if k != "map"} for r in out])
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
