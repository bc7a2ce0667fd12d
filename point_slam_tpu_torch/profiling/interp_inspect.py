"""Inside the interpolation: neighbour counts, weights and query radii on
frame 0.

    python -m point_slam_tpu_torch.profiling.interp_inspect
        [--device cuda|cpu] [--knn-layout packed|planes|fused]

``configs/Synthetic/room.yaml`` at 240x320. Frame 0's cloud is densified
once from 4000 candidate rays (``mapper.sample_add_rays`` then
``pointcloud.add_points``, the cell table rebuilt in ``--knn-layout``);
2000 pixels drawn uniformly are back-projected at their sensor depth and
searched with per-sample ``ops/knn.py::grid_knn`` (k=8). Prints the
radius maps' range, the valid slots a query, the neighbours within the
query radius (mean, share with >= 2 and with none), the distances and the
query radius, the interpolation weights (``models/decoders.py``: the
largest a query and the share of all-zero rows), the spread of the
interpolated colour features against the points' own, and the distinct
neighbours of the first 200 queries.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np
import torch

from point_slam_tpu_torch import mapper as M
from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch.common import camera, sampling
from point_slam_tpu_torch.models import decoders as D
from point_slam_tpu_torch.ops import knn
from point_slam_tpu_torch.profiling import iter_breakdown as IB
from point_slam_tpu_torch.profiling import workload as W

H, W_, FX, CX, CY = 240, 320, 200.0, 159.5, 119.5


def config():
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(W.HERE, "configs", "Synthetic",
                                   "room.yaml"),
                      os.path.join(W.HERE, "configs", "point_slam.yaml"))
    cfg["synthetic"].update({"n_frames": 2, "angular_step": 0.01})
    cfg["cam"].update({"H": H, "W": W_, "fx": FX, "fy": FX, "cx": CX,
                       "cy": CY})
    cfg["mapping"].update({"pixels": 2000, "pixels_adding": 4000})
    cfg["rendering"]["sample_near_pcl"] = False
    cfg["verbose"] = False
    return cfg


def inspect(dev, layout: str = "packed", seed: int = 0) -> Dict[str, float]:
    cfg = config()
    cfg["cuda"]["knn_packed_coords"] = IB.LAYOUTS[layout]
    mapper = W.make_mapper(cfg, dev, seed)
    color, depth, c2w = W.frame(cfg, 0)
    cd = torch.as_tensor(color, device=dev)
    dd = torch.as_tensor(depth, device=dev)
    cw = torch.as_tensor(c2w, device=dev)
    r_add, r_query, _, _ = mapper.radius_maps(cd)
    out = {"r_query_min": float(r_query.min()),
           "r_query_max": float(r_query.max()),
           "r_query_mean": float(r_query.mean())}
    print("r_query map stats: min %.4f max %.4f mean %.4f" % (
        out["r_query_min"], out["r_query_max"], out["r_query_mean"]))
    print("cell_size:", mapper.cell_size, " table:", mapper.table_size,
          " C:", mapper.max_per_cell)

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    ms = mapper.ms
    o, d, dep, col, ra, valid = M.sample_add_rays(ms, cw, cd, dd, r_add,
                                                  4000, g)
    mapper.cloud, _ = pc.add_points(
        mapper.cloud, mapper.index, o, d, dep, col, valid, ra,
        ms.near_end_surface_pc, ms.far_end_surface_pc, n_add=ms.n_add,
        generator=g)
    mapper.index = pc.build_index(mapper.cloud, mapper.cell_size,
                                  mapper.table_size, mapper.max_per_cell,
                                  mapper.packed_coords)
    n_pts = int(mapper.cloud.n_points)
    out["points"] = n_pts
    print("pts:", n_pts)

    i, j = sampling.sample_pixels_uniform(0, H, 0, W_, 2000, g, dev)
    gt_d = sampling.gather_pixels(dd, i, j)
    rq = sampling.gather_pixels(r_query, i, j)
    ro, rd = camera.rays_from_uv(i, j, cw, FX, FX, CX, CY)
    p = ro + rd * gt_d[:, None]

    dists, idx, vmask = knn.grid_knn(mapper.index, p, k=8)
    counts = knn.neighbor_count(dists, vmask, rq)
    sq = torch.sqrt(torch.where(vmask, dists, torch.nan))
    out.update({
        "valid_slots": float(vmask.sum(1).float().mean()),
        "in_radius_mean": float(counts.float().mean()),
        "in_radius_ge2": float((counts >= 2).float().mean()),
        "in_radius_zero": float((counts == 0).float().mean()),
        "dist_min": float(torch.sqrt(dists[vmask]).min()),
        "dist_median": float(torch.nanmedian(sq)),
        "dist_max": float(torch.sqrt(torch.where(vmask, dists, 0)).max()),
        "rq_median": float(torch.median(rq))})
    print("valid slots per query: mean %.2f" % out["valid_slots"])
    print("in-radius counts: mean %.2f  frac>=2: %.3f  frac==0: %.3f" % (
        out["in_radius_mean"], out["in_radius_ge2"], out["in_radius_zero"]))
    print("sqrt(d2) stats: min %.4f med %.4f max %.4f" % (
        out["dist_min"], out["dist_median"], out["dist_max"]))
    print("rq (query radius) med %.4f" % out["rq_median"])

    w = D.interpolation_weights(dists, vmask, rq, "distance")
    out["weight_max_mean"] = float(w.max(1).values.mean())
    out["zero_rows"] = float((w.sum(1) == 0).float().mean())
    print("weight max per query: mean %.3f (1.0 => nearest dominates)" %
          out["weight_max_mean"])
    print("weight row sums: frac zero rows %.3f" % out["zero_rows"])

    packed = mapper.cloud.packed
    c_col = torch.sum(w[..., None] * packed[idx][..., pc.COL_SL], dim=1)
    out["c_col_std"] = float(torch.std(c_col, dim=0).mean())
    out["col_feats_std"] = float(torch.std(packed[:n_pts, pc.COL_SL],
                                           dim=0).mean())
    print("c_col std across queries: %.4f (per-dim mean of std)" %
          out["c_col_std"])
    print("col_feats std across points: %.4f" % out["col_feats_std"])
    idx_np = idx.cpu().numpy()
    out["unique_neighbours"] = float(np.mean(
        [len(np.unique(r)) for r in idx_np[:200]]))
    print("unique neighbors per query (first 200): %.2f/8" %
          out["unique_neighbours"], flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--knn-layout", default="packed",
                    choices=sorted(IB.LAYOUTS))
    args = ap.parse_args(argv)
    dev = W.device(args.device, "interp_inspect")
    out = inspect(dev, args.knn_layout)
    W.save_json("interp_inspect_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
