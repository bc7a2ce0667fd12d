"""Trace of ~30 steady-state mapping iterations and their top kernels.

    python -m point_slam_tpu_torch.profiling.trace_map_iter
        [--device cuda|cpu] [--cap 524288] [--points 300000]
        [--cloud surface|sheet] [--iters 30] [--top 30] [--small]

Runs ``map_optimize`` on the bench workload's mapper (CAP ``--cap``, the
cloud inflated to ``--points`` with N(0, 0.1) features, frame 0's window):
one warm-up launch, then ``--iters`` iterations under ``torch.profiler``
with the stage mix of ``geo_iter_ratio`` (0.4: the first 40% geometry,
the rest colour), written as ``output/trace_map_iter_torch/trace.json``,
and lists the kernels by self device time (``trace_ops.analyze``). On a
window with no device activity it says so (the profiler on the card
machine sometimes records none) and retries twice.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

from point_slam_tpu_torch import mapper as M
from point_slam_tpu_torch.profiling import trace_ops
from point_slam_tpu_torch.profiling import workload as W

OUTDIR = os.path.join(W.OUTPUT, "trace_map_iter_torch")


def build(cfg, dev, n_points: int, cloud: str = "surface", seed: int = 0):
    """(mapper with the inflated cloud, window, window poses)."""
    mapper = W.make_mapper(cfg, dev, seed)
    color, depth, c2w = W.frame(cfg, 0)
    W.inflate(mapper, n_points, cloud, (color, depth, c2w), cfg["cam"], seed,
              features=True)
    window, w_c2w = W.frame0_window(mapper, color, depth, c2w)
    return mapper, window, w_c2w


def iterate(mapper, window, w_c2w, n_iters: int, geo_ratio: float = 0.4):
    """``n_iters`` iterations of map_optimize over frame 0's window, the
    first ``geo_ratio`` of them in the geometry stage; the mapper's cloud
    and decoders step as in map_frame."""
    import torch
    mp = mapper.cfg["mapping"]
    sched = mp["stage"]
    lrs = [[sched[s][k] for k in ("decoders_lr", "geometry_lr", "color_lr")]
           for s in ("geometry", "color")]
    n = mapper.n_points_host
    frustum = torch.arange(mapper.cloud.packed.shape[0],
                           device=mapper.device) < n
    packed, _, _, _ = M.map_optimize(
        mapper.ms, mapper.rc, mapper.decoders, mapper.cloud.packed,
        mapper.index, (*window, w_c2w), 1, mapper.ms.r_max, frustum, lrs[0],
        lrs[1], 1.0, int(round(n_iters * geo_ratio)) - 1, n_iters,
        generator=mapper.generator, n_live=n)
    mapper.cloud = mapper.cloud._replace(packed=packed)


def trace(mapper, window, w_c2w, dev, n_iters: int = 30,
          outdir: str = OUTDIR) -> str:
    """One warm-up launch, then ``n_iters`` iterations under the profiler;
    the Chrome trace's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    iterate(mapper, window, w_c2w, 5)
    W.sync(dev)
    acts = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        iterate(mapper, window, w_c2w, n_iters)
        W.sync(dev)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def run(cfg, dev, n_points: int, cloud: str = "surface", n_iters: int = 30,
        top: int = 30) -> Dict:
    """Trace and analyze; on the card up to three windows until one holds
    device activity."""
    mapper, window, w_c2w = build(cfg, dev, n_points, cloud)
    for attempt in range(3 if dev.type == "cuda" else 1):
        path = trace(mapper, window, w_c2w, dev, n_iters)
        res = trace_ops.analyze(path, top)
        if res["device"] or dev.type != "cuda":
            break
        print(f"[trace_map_iter] window {attempt + 1}: no device activity "
              "recorded", flush=True)
    res["path"] = path
    res["iters"] = n_iters
    busy = sum(s["busy_ms"] for s in res["streams"].values())
    print(f"[trace_map_iter] {n_iters} iterations: window "
          f"{res['window_ms']:.4f} ms wall, device busy "
          f"{W.shown(busy if res['device'] else None)}", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    W.add_cloud_args(ap)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "trace_map_iter")
    cfg = W.bench_config(4, small=args.small)
    cfg["cuda"]["point_capacity_init"] = args.cap
    return run(cfg, dev, args.points, args.cloud, args.iters, args.top)


if __name__ == "__main__":
    main(sys.argv[1:])
