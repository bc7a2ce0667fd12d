"""Packed-lattice against f32-plane cell table, end to end, on the card.

    python -m point_slam_tpu_torch.profiling.knn_packed_ab
        [--device cuda|cpu] [--cap 524288] [--points 300000]
        [--cloud sheet|surface] [--iters 10] [--repeats 3] [--small]

The port of ``profiling/knn_packed_ab.py``: kNN micros can mislead, so
this A/B runs two rungs of the mapping iteration (``iter_breakdown``'s
own, at the bench's widths: 680x1200, 5000 window rays of frame 0's
window, the TPU script's 300k-point sheet at CAP 2^19) under each cell
table: the f32 planes (K2) and the packed lattice (K1). The rungs: 2, the
kNN (sample rays, z-values, ``ray_grid_knn`` and the renderer's fallback
for non-compact rays), and 7, the full colour-stage step (the gradient of
the packed leaf and the colour decoder, the frustum row mask, Adam over
(CAP, 72)). Each prints its wall ms an iteration (CUDA events over
``--iters`` iterations, median and range over ``--repeats``) and its
device-busy ms (the profiler's summed kernel time), then "packed saves"
for both rungs, from the wall medians and from the device times. On the
host each rung runs once and nothing is timed. Writes
output/knn_packed_ab_torch.json.
"""

from __future__ import annotations

import argparse
import sys

import torch

from point_slam_tpu_torch.profiling import iter_breakdown as IB
from point_slam_tpu_torch.profiling import workload as W

RUNGS = (("kNN rung", IB.rung_knn), ("full step", IB.rung_full))
LAYOUTS = ("planes", "packed")


def run(cfg, dev, n_points: int, cloud: str = "sheet", iters: int = 10,
        repeats: int = 3):
    out = {}
    for layout in LAYOUTS:
        b = IB.build(cfg, dev, n_points, layout, cloud)
        for name, fn in RUNGS:
            res = out[f"{name}, {layout}"] = IB.measure(b, fn, iters, repeats)
            print(f"[knn_packed_ab] {name}, {layout:<6} "
                  f"({IB.KERNEL_OF[layout]}): wall "
                  f"{W.spread_str(res['wall'])}/iter, device busy "
                  f"{W.shown(res['busy_ms'])}/iter", flush=True)
        del b
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    saves = {}
    for key, pick in (("wall", lambda r: r["wall"]["median"]),
                      ("device", lambda r: r["busy_ms"])):
        t = {k: pick(r) for k, r in out.items()}
        if None in t.values():
            continue
        saves[key] = {name: t[f"{name}, planes"] - t[f"{name}, packed"]
                      for name, _ in RUNGS}
        print(f"[knn_packed_ab] packed saves ({key}): kNN "
              f"{saves[key]['kNN rung']:+.3f} ms/iter | full step "
              f"{saves[key]['full step']:+.3f} ms/iter", flush=True)
    out["packed_saves"] = saves
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    W.add_cloud_args(ap, cloud="sheet")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "knn_packed_ab")
    cfg = W.bench_config(4, small=args.small)
    cfg["cuda"]["point_capacity_init"] = args.cap
    out = run(cfg, dev, args.points, args.cloud, args.iters, args.repeats)
    W.save_json("knn_packed_ab_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
