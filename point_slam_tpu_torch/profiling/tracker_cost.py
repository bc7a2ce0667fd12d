"""Per-iteration tracking cost from two ``track_optimize`` budgets.

    python -m point_slam_tpu_torch.profiling.tracker_cost
        [--device cuda|cpu] [--budgets 4,4,44,44,4,44] [--cap 524288]
        [--iters-first 300] [--small]

Maps frame 0 (``--iters-first`` iterations), then runs the tracker's loop
``track_optimize`` on frame 1 (1500 rays, the bench's edge crop) from the
motion model's pose at each budget in turn, printing its host seconds
(ending in the best loss's fetch) and, from the medians of the smallest
and the largest budget, the per-iteration ms. On the host the seconds are
the host's, not the card's.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Sequence

import numpy as np
import torch

from point_slam_tpu_torch.common import camera
from point_slam_tpu_torch.profiling import workload as W
from point_slam_tpu_torch.tracker import Tracker, track_optimize


def run(dev, budgets: Sequence[int] = (4, 4, 44, 44, 4, 44),
        cap: int = 1 << 19, iters_first: int = 300, small: bool = False
        ) -> Dict:
    cfg = W.bench_config(4, iters_first=iters_first, small=small)
    cfg["mapping"]["geo_iter_first"] = iters_first // 2
    cfg["cuda"]["point_capacity_init"] = cap
    mapper = W.make_mapper(cfg, dev)
    tracker = Tracker(cfg, dev)
    color, depth, c2w = W.frame(cfg, 0)
    mapper.map_frame(0, color, depth, c2w, c2w)
    print(f"[tracker_cost] mapped ({mapper.n_points_host} points)",
          flush=True)
    color, depth, c2w = W.frame(cfg, 1)
    cd = torch.as_tensor(color, device=dev)
    dd = torch.as_tensor(depth, device=dev)
    r_query = mapper.radius_maps(cd)[1]
    cam = torch.as_tensor(camera.tensor_from_pose_matrix(c2w), device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    times: Dict[int, list] = {}
    for n in budgets:
        out, t = W.host_s(lambda: float(track_optimize(
            tracker.ts, tracker.rc, mapper.decoders, mapper.cloud.packed,
            mapper.index, cd, dd, r_query, cam, tracker.lr, n,
            generator=gen)[3]), dev)
        times.setdefault(n, []).append(t)
        print(f"[tracker_cost] track_optimize n={n}: {t:.4f} s (best loss "
              f"{out:.2f})", flush=True)
    lo, hi = min(budgets), max(budgets)
    per = (np.median(times[hi]) - np.median(times[lo])) / (hi - lo)
    print(f"[tracker_cost] tracking per-iteration: {per * 1e3:.4f} ms "
          f"({'host' if dev.type == 'cpu' else 'card'} clock)", flush=True)
    return {"seconds": times, "per_iter_ms": float(per) * 1e3,
            "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--budgets", default="4,4,44,44,4,44")
    ap.add_argument("--cap", type=int, default=1 << 19)
    ap.add_argument("--iters-first", type=int, default=300)
    ap.add_argument("--small", action="store_true",
                    help="a 48x64 camera and a few hundred rays")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "tracker_cost")
    out = run(dev, [int(b) for b in args.budgets.split(",")], args.cap,
              args.iters_first, args.small)
    W.save_json("tracker_cost_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
