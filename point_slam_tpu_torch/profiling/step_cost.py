"""Steady-state cost of a mapping and a tracking iteration, through the
loops' own entry points.

    python -m point_slam_tpu_torch.profiling.step_cost
        [--device cuda|cpu] [--cap 524288] [--points 300000]
        [--cloud surface|sheet] [--budgets 4,54] [--repeats 3]
        [--iters-first 150] [--small]

Maps frame 0 (``--iters-first`` iterations), inflates the cloud to
``--points`` with N(0, 0.1) features, then times ``Mapper.map_frame`` on
frame 1's data at two iteration budgets (``mapping.iters``; the frame's
own rule sets the iterations run, which are read back), best of
``--repeats`` after a warm-up each: the per-iteration cost is the
difference over the iterations' difference, the rest the frame's fixed
cost. Then ``Tracker.track_frame`` (40 iterations x 1500 rays), best of
``--repeats``. Host seconds ending in a device sync. On the host it runs
each once at ``--small`` sizes and reports the host's seconds, not the
card's.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Sequence

import numpy as np
import torch

from point_slam_tpu_torch.profiling import workload as W


def setup(cfg, dev, n_points: int, cloud: str):
    """(mapper mapped at frame 0 and inflated, color, depth, c2w on the
    device)."""
    mapper = W.make_mapper(cfg, dev)
    color, depth, c2w = W.frame(cfg, 0)
    st, t = W.host_s(lambda: mapper.map_frame(0, color, depth, c2w, c2w),
                     dev)
    print(f"[step_cost] frame 0 map_frame ({st['n_iters']} iterations, "
          f"first call): {t:.2f} s, {st['n_points']} points", flush=True)
    W.inflate(mapper, n_points, cloud, (color, depth, c2w), cfg["cam"],
              features=True)
    return (mapper, torch.as_tensor(color, device=dev),
            torch.as_tensor(depth, device=dev), c2w)


def map_costs(cfg, mapper, color, depth, c2w, dev,
              budgets: Sequence[int] = (4, 54), repeats: int = 3) -> Dict:
    """Best-of-``repeats`` map_frame seconds at each budget; the
    per-iteration ms and the fixed seconds from the two."""
    best = {}
    for n in budgets:
        cfg["mapping"]["iters"] = n
        mapper.map_frame(1, color, depth, c2w, c2w)          # warm-up
        runs = [W.host_s(lambda: mapper.map_frame(1, color, depth, c2w,
                                                  c2w), dev)
                for _ in range(repeats)]
        st, t = min(runs, key=lambda r: r[1])
        best[n] = (t, st["n_iters"])
        print(f"[step_cost] map_frame budget {n}: {st['n_iters']} "
              f"iterations in {t:.4f} s (best of {repeats})", flush=True)
    (ta, na), (tb, nb) = (best[n] for n in budgets)
    per_iter = (tb - ta) / max(nb - na, 1)
    fixed = ta - na * per_iter
    print(f"[step_cost] mapping per-iteration {per_iter * 1e3:.4f} ms, "
          f"fixed {fixed:.4f} s a mapped frame; projected at 300 "
          f"iterations {fixed + 300 * per_iter:.4f} s", flush=True)
    return {"budgets": {n: list(v) for n, v in best.items()},
            "per_iter_ms": per_iter * 1e3, "fixed_s": fixed}


def track_cost(cfg, mapper, color, depth, c2w, dev, repeats: int = 3
               ) -> Dict:
    from point_slam_tpu_torch.tracker import Tracker
    tracker = Tracker(cfg, dev)
    r_query = mapper.radius_maps(color)[1]
    est = np.tile(np.eye(4, dtype=np.float32), (100, 1, 1))
    est[0] = est[1] = c2w
    run = lambda: tracker.track_frame(2, color, depth, c2w, est, mapper,
                                      r_query)
    _, first = W.host_s(run, dev)
    best = min(W.host_s(run, dev)[1] for _ in range(repeats))
    it = tracker.iters
    print(f"[step_cost] track_frame first call {first:.4f} s; steady "
          f"({it} iterations x {tracker.ts.pixels} rays) {best:.4f} s, "
          f"{best / it * 1e3:.4f} ms an iteration", flush=True)
    return {"first_s": first, "steady_s": best,
            "per_iter_ms": best / it * 1e3}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    W.add_cloud_args(ap)
    ap.add_argument("--budgets", default="4,54")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--iters-first", type=int, default=150)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "step_cost")
    cfg = W.bench_config(4, iters_first=args.iters_first, small=args.small)
    cfg["mapping"]["geo_iter_first"] = args.iters_first // 3
    cfg["cuda"]["point_capacity_init"] = args.cap
    mapper, color, depth, c2w = setup(cfg, dev, args.points, args.cloud)
    budgets = [int(b) for b in args.budgets.split(",")]
    out = {"map": map_costs(cfg, mapper, color, depth, c2w, dev, budgets,
                            args.repeats),
           "track": track_cost(cfg, mapper, color, depth, c2w, dev,
                               args.repeats),
           "device": str(dev)}
    W.save_json("step_cost_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
