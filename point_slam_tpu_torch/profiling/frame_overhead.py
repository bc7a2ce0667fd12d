"""Per-frame fixed costs: the radius maps and the colour-gradient pool.

    python -m point_slam_tpu_torch.profiling.frame_overhead
        [--device cuda|cpu] [--reps 20] [--small]

On frame 0 of the bench workload (680x1200) it times, with CUDA events
over ``--reps`` calls: ``mapper.prepare_frame`` (the radius maps and the
candidate pool, as every frame computes them), the dynamic radius maps
alone, the colour-gradient magnitude alone, and the gradient with the
top-k of its 816k pixels to the pool's 5000. On the host it runs each once
and times nothing.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from point_slam_tpu_torch import mapper as M
from point_slam_tpu_torch.common import image
from point_slam_tpu_torch.profiling import workload as W


def run(cfg, dev, reps: int = 20) -> Dict:
    mapper = W.make_mapper(cfg, dev)
    cd = torch.as_tensor(W.frame(cfg, 0)[0], device=dev)
    p = cfg["pointcloud"]
    radius = (p["radius_add_max"], p["radius_add_min"],
              p["radius_query_ratio"], p["color_grad_threshold"])
    top = mapper.ms.grad_top
    stages = {
        "prepare_frame (radius + pool)": lambda: M.prepare_frame(cd, *radius,
                                                                 top),
        "radius maps only": lambda: image.dynamic_radius_maps(cd, *radius),
        "gradient magnitude only": lambda: image.color_gradient_magnitude(cd),
        f"gradient + top-{top}": lambda: torch.topk(
            image.color_gradient_magnitude(cd).reshape(-1), top),
    }
    out = {}
    for name, fn in stages.items():
        out[name] = W.wall_ms(fn, dev, reps)
        print(f"[frame_overhead] {name:<30} {W.shown(out[name])}",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--small", action="store_true",
                    help="a 48x64 camera")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "frame_overhead")
    out = run(W.bench_config(2, small=args.small), dev, args.reps)
    W.save_json("frame_overhead_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
