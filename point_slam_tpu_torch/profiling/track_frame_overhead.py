"""A tracked frame's fixed costs outside the pose loop.

    python -m point_slam_tpu_torch.profiling.track_frame_overhead
        [--device cuda|cpu] [--cap 524288] [--iters-first 150] [--reps 20]
        [--small]

Itemises a tracked frame the way ``map_frame_overhead.py`` itemises a
mapped one, after frame 0 is mapped, on frame 2:

  1 radius_maps         the frame's Sobel and dynamic radius maps
  2 frame upload        the colour frame from host memory to the card
  3 initial_pose        the host's motion model
  5 loop launch+fetch   ``track_optimize`` (40 iterations) and one fetch
  5b loop + epilogue    the same with track_frame's pose and loss fetch
  6 full track_frame    end to end with the frame on the card
  6b track_frame np-in  the same with the frame uploaded inside

Each is called ``--reps`` times after a warm-up, host seconds ending in a
device sync; prints p50, p90 and max. On the host the seconds are the
host's, not the card's.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch

from point_slam_tpu_torch.common import camera
from point_slam_tpu_torch.profiling import workload as W
from point_slam_tpu_torch.tracker import Tracker, track_optimize


def stat(xs: List[float]) -> Dict[str, float]:
    xs = sorted(xs)
    return {"p50_ms": 1e3 * xs[len(xs) // 2],
            "p90_ms": 1e3 * xs[min(len(xs) - 1,
                                   int(round(0.9 * (len(xs) - 1))))],
            "max_ms": 1e3 * xs[-1]}


def run(cfg, dev, reps: int = 20) -> Dict:
    mapper = W.make_mapper(cfg, dev)
    tracker = Tracker(cfg, dev)
    frames = [W.frame(cfg, i) for i in range(3)]
    color0, depth0, c2w0 = frames[0]
    mapper.map_frame(0, color0, depth0, c2w0, c2w0)
    print(f"[track_overhead] mapped ({mapper.n_points_host} points)",
          flush=True)
    color_np, depth_np, c2w2 = frames[2]
    est = np.zeros((100, 4, 4), np.float32)
    est[0], est[1] = c2w0, frames[1][2]
    cd = torch.as_tensor(color_np, device=dev)
    dd = torch.as_tensor(depth_np, device=dev)
    r_query = mapper.radius_maps(cd)[1]
    cam = torch.as_tensor(tracker.initial_pose(2, est, c2w2), device=dev)

    def loop():
        return track_optimize(tracker.ts, tracker.rc, mapper.decoders,
                              mapper.cloud.packed, mapper.index, cd, dd,
                              r_query, cam, tracker.lr, tracker.iters,
                              generator=tracker.generator)

    def epilogue():
        best, _, first, best_loss = loop()
        return torch.cat([camera.pose_matrix_from_tensor(best).reshape(-1),
                          first[None], best_loss[None]]).cpu()

    stages = {
        "1 radius_maps": lambda: mapper.radius_maps(cd),
        "2 frame upload": lambda: torch.as_tensor(color_np, device=dev),
        "3 initial_pose": lambda: tracker.initial_pose(2, est, c2w2),
        "5 loop launch+fetch": lambda: loop()[0].cpu(),
        "5b loop + pose epilogue": epilogue,
        "6 full track_frame": lambda: tracker.track_frame(
            2, cd, dd, c2w2, est, mapper, r_query),
        "6b track_frame np-in": lambda: tracker.track_frame(
            2, torch.as_tensor(color_np, device=dev),
            torch.as_tensor(depth_np, device=dev), c2w2, est, mapper,
            r_query),
    }
    out = {}
    for name, fn in stages.items():
        fn()                                              # warm-up
        s = out[name] = stat([W.host_s(fn, dev)[1] for _ in range(reps)])
        print(f"[track_overhead] {name:<24} p50 {s['p50_ms']:.4f} ms  p90 "
              f"{s['p90_ms']:.4f} ms  max {s['max_ms']:.4f} ms "
              f"({'host' if dev.type == 'cpu' else 'card'} clock)",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--cap", type=int, default=1 << 19)
    ap.add_argument("--iters-first", type=int, default=150)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--small", action="store_true",
                    help="a 48x64 camera and a few hundred rays")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "track_frame_overhead")
    cfg = W.bench_config(6, iters_first=args.iters_first, small=args.small)
    cfg["mapping"]["geo_iter_first"] = args.iters_first // 2
    cfg["cuda"]["point_capacity_init"] = args.cap
    out = run(cfg, dev, args.reps)
    W.save_json("track_frame_overhead_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
