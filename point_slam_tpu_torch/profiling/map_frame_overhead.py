"""A mapped frame's fixed costs outside the optimisation loop.

    python -m point_slam_tpu_torch.profiling.map_frame_overhead
        [--device cuda|cpu] [--cap 524288] [--points 300000]
        [--cloud surface|sheet] [--reps 10] [--small]

A mapped frame is its iterations times the per-iteration cost
(``iter_breakdown.py``) plus what ``Mapper.map_frame`` does around the
loop: the radius maps, densification (candidate rays -> ``add_points``
with its kNN dedup -> ``insert_index``, for uniform and colour-gradient
candidates), the frustum mask, the overlap scores, keyframe selection and
the window gather. On the bench workload's mapper with the cloud inflated
to ``--points`` and 12 keyframes in its store, each is timed alone (CUDA
events over ``--reps`` calls: host and card), with a full cell-table
rebuild for comparison, then ``map_frame`` end to end at 2 iterations.
On the host it runs each once and times nothing.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from point_slam_tpu_torch import mapper as M
from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch.profiling import workload as W


def run(cfg, dev, n_points: int, cloud: str = "surface", reps: int = 10
        ) -> Dict:
    mapper = W.make_mapper(cfg, dev)
    color, depth, c2w = W.frame(cfg, 0)
    W.inflate(mapper, n_points, cloud, (color, depth, c2w), cfg["cam"])
    ms = mapper.ms
    cd = torch.as_tensor(color, device=dev)
    dd = torch.as_tensor(depth, device=dev)
    c2w_d = torch.as_tensor(c2w, device=dev)
    r_add, _, cand_idx, cand_ok = mapper.radius_maps(cd)
    gen = mapper.generator
    for i in range(12):
        mapper.store.append(cd, dd, c2w)
        mapper.keyframe_list.append(5 * i)
    o, d, dep, col, ra, valid = M.sample_add_rays(
        ms, c2w_d, cd, dd, r_add, cfg["mapping"]["pixels_adding"], gen)
    fix = cfg["pointcloud"]["fix_interval_when_add_along_ray"]

    def add_points():
        return pc.add_points(mapper.cloud, mapper.index, o, d, dep, col,
                             valid, ra, ms.near_end_surface_pc,
                             ms.far_end_surface_pc,
                             n_add=ms.n_add, fix_interval=fix, generator=gen)

    def window():
        scores = mapper._overlap_scores(c2w_d, dd).cpu().numpy()
        return mapper.store.gather_window(mapper.select_keyframes(scores),
                                          ms.f_max)

    stages = {
        "radius maps": lambda: mapper.radius_maps(cd),
        f"sample_add_rays ({ms.add_max})": lambda: M.sample_add_rays(
            ms, c2w_d, cd, dd, r_add, cfg["mapping"]["pixels_adding"], gen),
        "add_points (dedup + scatter)": add_points,
        f"insert_index ({ms.add_max * ms.n_add} rows)": lambda:
            pc.insert_index(mapper.cloud, mapper.index,
                            mapper.cloud.n_points - 100,
                            ms.add_max * ms.n_add),
        "build_index (full rebuild)": lambda: pc.build_index(
            mapper.cloud, mapper.cell_size, mapper.table_size,
            mapper.max_per_cell, mapper.packed_coords),
        f"sample_grad_rays ({ms.grad_max})": lambda: M.sample_grad_rays(
            ms, c2w_d, cd, dd, r_add, cand_idx, cand_ok, gen),
        "frustum_mask (CAP points)": lambda: pc.frustum_mask(
            mapper.cloud.pos, mapper.cloud.n_points, torch.linalg.inv(c2w_d),
            dd, ms.fx, ms.fy, ms.cx, ms.cy, ms.frustum_edge),
        "overlap + select + gather (12 kf)": window,
    }
    out = {}
    for name, fn in stages.items():
        out[name] = W.wall_ms(fn, dev, reps)
        print(f"[map_overhead] {name:<36} {W.shown(out[name])}", flush=True)
    # the whole frame with a near-zero budget: what map_frame serialises
    # outside the loop, plus 2 iterations
    cfg["mapping"].update({"iters": 2, "min_iter_ratio": 1.0})
    e2e = lambda: mapper.map_frame(6, cd, dd, c2w, c2w, radius=(
        mapper.radius_maps(cd)))
    out["map_frame e2e (2 iterations)"] = W.wall_ms(e2e, dev, max(reps // 2,
                                                                  1))
    print(f"[map_overhead] {'map_frame e2e (2 iterations)':<36} "
          f"{W.shown(out['map_frame e2e (2 iterations)'])}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    W.add_cloud_args(ap)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "map_frame_overhead")
    cfg = W.bench_config(4, iters_first=60, small=args.small)
    cfg["cuda"]["point_capacity_init"] = args.cap
    out = run(cfg, dev, args.points, args.cloud, args.reps)
    W.save_json("map_frame_overhead_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
