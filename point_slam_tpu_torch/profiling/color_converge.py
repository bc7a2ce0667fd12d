"""Frame-0 colour convergence: the mapping losses every chunk of
iterations.

    python -m point_slam_tpu_torch.profiling.color_converge
        [--device cuda|cpu] [--train_geo] [--iters 1000] [--chunk 100]
        [--small]

The port of ``profiling/color_converge.py``. The mapper at the bench's
widths (680x1200, 5000 mapping rays, CAP 2^19) densifies frame 0 of the
synthetic room once from 18,000 rays (3 points a ray;
``workload.densified_frame0``), puts the frame alone in its keyframe
window and runs ``map_optimize`` for ``--iters`` iterations (the first
100 in the geometry stage; the configuration's first-frame learning
rates), printing the last iteration's geometry loss, colour loss and
masked rays at the end of every ``--chunk`` iterations. The geometry
decoder is frozen unless ``--train_geo``. ``--small``: a 48x64 camera,
CAP 2^13 and 400 densification rays.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import torch

from point_slam_tpu_torch import mapper as M
from point_slam_tpu_torch.profiling import workload as W

ITERS = 1000
CHUNK = 100
GEO_BOUND = 100
ADD_RAYS = 18_000
CAP = 1 << 19


def config(train_geo: bool, small: bool = False):
    cfg = W.bench_config(2, iters_first=500, small=small)
    cfg["mapping"]["geo_iter_first"] = GEO_BOUND
    cfg["mapping"]["fix_geo_decoder"] = not train_geo
    if small:
        cfg["mapping"]["pixels_adding"] = 400
    else:
        cfg["cuda"]["point_capacity_init"] = CAP
        cfg["mapping"]["pixels_adding"] = ADD_RAYS // 3
    return cfg


def run(cfg, dev, iters: int = ITERS, chunk: int = CHUNK, seed: int = 0,
        n_rays=None) -> List[dict]:
    """The stats at each chunk's end: {"it", "geo", "col", "n_mask"}."""
    f0 = W.densified_frame0(cfg, dev, n_rays or 3 * cfg["mapping"]
                            ["pixels_adding"], seed=seed)
    m = f0.mapper
    print(f"[color_converge] cloud: {m.n_points_host} pts", flush=True)
    ms = m.ms._replace(fix_geo_decoder=cfg["mapping"]["fix_geo_decoder"])
    f = ms.f_max
    dd = f0.depth
    window = (torch.zeros((f,) + f0.color.shape, device=dev),
              torch.zeros((f,) + dd.shape, device=dev),
              torch.full((f,) + dd.shape, 1e6, device=dev),
              torch.eye(4, device=dev).repeat(f, 1, 1))
    window[0][0], window[1][0], window[2][0], window[3][0] = (
        f0.color, dd, f0.r_query, f0.c2w)
    cap = m.cloud.packed.shape[0]
    frustum = torch.arange(cap, device=dev) < m.n_points_host
    sched = cfg["mapping"]["init"]
    lrs = [[sched[stage][k] for k in ("decoders_lr", "geometry_lr",
                                      "color_lr")]
           for stage in ("geometry", "color")]
    rows = []

    def record(it_now, stats):
        s = stats.detach().cpu().numpy()
        rows.append({"it": it_now, "geo": float(s[0]), "col": float(s[1]),
                     "n_mask": float(s[2])})
        print(f"[color_converge] it {it_now:4d}: geo {s[0]:9.3f} col "
              f"{s[1]:9.3f} n_mask {s[2]:.0f}", flush=True)

    _, stats, _, _ = M.map_optimize(
        ms, m.rc, m.decoders, m.cloud.packed, m.index, window, 1,
        ms.r_max, frustum, lrs[0], lrs[1], 1.0, GEO_BOUND, iters,
        generator=torch.Generator(device=dev).manual_seed(seed + 3),
        n_live=m.n_points_host, chunk=chunk,
        chunk_hook=lambda a, b, packed, st: record(b, st))
    record(iters, stats)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--train_geo", action="store_true",
                    help="train the geometry decoder too")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--small", action="store_true",
                    help="a 48x64 camera, CAP 2^13, 400 densification rays")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "color_converge")
    cfg = config(args.train_geo, args.small)
    rows = run(cfg, dev, args.iters, args.chunk)
    W.save_json("color_converge_torch.json", rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
