"""Frame-0 mapping at Replica scale, stage by stage, cold and then steady.

    python -m point_slam_tpu_torch.profiling.crash_bisect [STAGE] [N]
        [--device cuda|cpu] [--small]

The port of ``profiling/crash_bisect.py``, which bisected a TPU worker
crash in the first mapped frame. On the card it splits that frame's
fixed cost. Configuration: ``configs/Synthetic/room.yaml`` at bench.py's
widths (680x1200, 5000 mapping rays, 6000 + 1000 densification rays,
window 12, ``iters_first`` 1500, ``geo_iter_first`` 400, no near-cloud
sampling) with CAP 2^19. On frame 0 each stage runs once, timed from a
device sync to a device sync, and prints ``OK <stage> (<s>) [v=...]``
with the first value of its output:

* ``Mapper.radius_maps`` (the dynamic radius maps and the colour-gradient
  candidates);
* ``sample_add_rays`` (the 6000 uniform densification rays);
* ``pointcloud.add_points`` (3 points along each accepted ray);
* ``build_index`` (the cell table over the new cloud; its planes' shapes
  are printed, where the JAX script read the gone ``GridIndex.table``,
  and ``v`` is the number of points the table holds);
* with STAGE ``all`` or ``optimize`` (the default ``all``):
  ``map_optimize`` over frame 0's window (``workload.frame0_window``; the
  JAX script's ``mapper.ring.color`` is gone too, the ring being a uint8
  wire array) at ``n_iters`` in {10, N+10} x ``geo_iter_bound`` in
  {0, 10^6} (N default 50), each from the same decoders, once cold and
  once steady; ``v`` is the sum of the returned statistics. An iteration
  ``it`` is a geometry iteration while ``it <= geo_iter_bound``, so bound
  0 runs one geometry iteration and then colour, 10^6 geometry only: each
  line prints its mix.

In eager PyTorch "cold" is the first use: the CUDA kernels' build into
``ops/build/`` (or their load), the cuBLAS handles and the caching
allocator's growth; there is no compilation of the loop. ``--small``: a
48x64 camera, 400 rays, CAP 2^13, for the host. Writes
``output/torch/crash_bisect.json``.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import os
import sys
from typing import Any, Dict, List

import numpy as np
import torch

from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch.profiling import workload as W

N_DEFAULT = 50
COLD_NOTE = ("cold = first use: the CUDA kernels' build or load, the cuBLAS "
             "handles and the allocator's growth (eager: no compilation)")


def overrides(iters_first: int = 1500, small: bool = False
              ) -> Dict[str, Dict[str, Any]]:
    """The JAX scripts' overrides of room.yaml (``crash_bisect.py:19-29``;
    ``crash_bisect2.py`` sets ``iters_first`` and ``geo_iter_first`` =
    min(400, iters_first // 2)), by section; ``cuda`` is the JAX
    package's ``tpu``. ``small``: a 48x64 camera, 400 mapping and 200
    densification rays, CAP 2^13 and a 2^14-bucket table."""
    out = W.bench_widths(small)
    out["synthetic"]["n_frames"] = 4
    out["mapping"].update({"iters": 300, "iters_first": iters_first,
                           "geo_iter_first": min(400, iters_first // 2),
                           "keyframe_every": 5})
    out["cuda"] = ({"point_capacity_init": 1 << 13, "grid_table_size": 1 << 14}
                   if small else {"point_capacity_init": 1 << 19})
    return out


def config(iters_first: int = 1500, small: bool = False):
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(W.HERE, "configs", "Synthetic",
                                   "room.yaml"),
                      os.path.join(W.HERE, "configs", "point_slam.yaml"))
    W.override(cfg, overrides(iters_first, small))
    cfg["verbose"] = False
    cfg["data"]["output"] = os.path.join(W.OUTPUT, "torch", "crash_bisect")
    return cfg


def make_mapper(cfg, dev):
    from point_slam_tpu_torch.mapper import Mapper
    from point_slam_tpu_torch.models import decoders as D
    return Mapper(cfg, D.init_decoders(cfg, 0, dev), 100,
                  np.random.default_rng(0), dev)


def first(x) -> float:
    return float(x.reshape(-1)[0])


def run(cfg, dev, stage: str = "all", n: int = N_DEFAULT) -> Dict[str, Any]:
    """The stages on frame 0; their records (stage, seconds, v) and the
    kernels' launches."""
    from point_slam_tpu_torch import mapper as M
    from point_slam_tpu_torch.ops import knn
    recs: List[Dict[str, Any]] = []
    before = dict(knn.LAUNCHES)

    def done(name, s, v, **extra):
        recs.append({"stage": name, "s": s, "v": v, **extra})
        print(f"OK {name} ({s:.2f}s) [v={v:.6f}]", flush=True)

    mapper = make_mapper(cfg, dev)
    color, depth, c2w = W.frame(cfg, 0)
    cd, dd, cw = (torch.as_tensor(a, device=dev) for a in (color, depth, c2w))
    g = torch.Generator(device=dev).manual_seed(1)
    maps, s = W.host_s(lambda: mapper.radius_maps(cd), dev)
    done("radius_maps", s, first(maps[0]))
    r_add = maps[0]
    rays, s = W.host_s(lambda: M.sample_add_rays(
        mapper.ms, cw, cd, dd, r_add, cfg["mapping"]["pixels_adding"], g),
        dev)
    done("sample_add_rays", s, first(rays[0]))
    (cloud, n_acc), s = W.host_s(lambda: pc.add_points(
        mapper.cloud, mapper.index, *rays[:4], rays[5], rays[4], 0.98, 1.02,
        n_add=3, fix_interval=False, generator=g), dev)
    n_points = int(cloud.n_points)
    done(f"add_points (n={int(n_acc)} rays, {n_points} points)", s,
         first(cloud.pos), n_points=n_points)
    index, s = W.host_s(lambda: pc.build_index(
        cloud, mapper.cell_size, mapper.table_size, mapper.max_per_cell,
        mapper.packed_coords), dev)
    planes = [tuple(t.shape) for t in index[:-2]]
    done(f"build_index ({type(index).__name__}, planes {planes})", s,
         float(index.counts.sum()))
    out = {"stages": recs, "n_points": n_points, "planes": planes,
           "cap": cloud.packed.shape[0], "device": str(dev)}
    if stage in ("all", "optimize"):
        optimize(mapper, (color, depth, c2w), cloud, index, n_points, n,
                 dev, done)
    out["launches"] = {k: v - before[k] for k, v in knn.LAUNCHES.items()}
    return out


def optimize(mapper, frame, cloud, index, n_points: int, n: int, dev,
             done) -> None:
    """map_optimize over the window of ``frame`` (color, depth, c2w) at 10
    and n+10 iterations in both stages, each from the same decoders, cold
    and then steady; each record goes to ``done``."""
    from point_slam_tpu_torch import mapper as M
    window, w_c2w = W.frame0_window(mapper, *frame)
    frustum = torch.arange(cloud.packed.shape[0], device=dev) < n_points
    lr = [0.001, 0.03, 0.0]
    lrc = [0.005, 0.005, 0.005]
    print(f"[crash_bisect] {COLD_NOTE}", flush=True)
    for phase in ("cold", "steady"):
        for n2, gb in itertools.product((10, n + 10), (0, 10 ** 6)):
            dec = copy.deepcopy(mapper.decoders)
            res, s = W.host_s(lambda: M.map_optimize(
                mapper.ms, mapper.rc, dec, cloud.packed, index,
                (*window, w_c2w), 1, mapper.ms.r_max, frustum, lr, lrc, 1.0,
                gb, n2, generator=torch.Generator(device=dev).manual_seed(n2),
                n_live=n_points), dev)
            n_geo = min(gb + 1, n2)
            done(f"optimize {phase} n_iters={n2} geo_bound={gb} (geometry "
                 f"{n_geo} + colour {n2 - n_geo})", s, float(res[1].sum()),
                 phase=phase, n_iters=n2, geo_bound=gb, n_geometry=n_geo)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", nargs="?", default="all",
                    help="all or optimize: run map_optimize after the "
                         "densification stages (any other: those only)")
    ap.add_argument("n", nargs="?", type=int, default=N_DEFAULT,
                    help="map_optimize runs at 10 and N+10 iterations")
    W.add_device_arg(ap)
    ap.add_argument("--small", action="store_true",
                    help="a 48x64 camera, 400 rays, CAP 2^13")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "crash_bisect")
    out = run(config(small=args.small), dev, args.stage, args.n)
    out["path"] = W.save_json(os.path.join("torch", "crash_bisect.json"), out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
