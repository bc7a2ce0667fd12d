"""Per-iteration mapping cost through ``Mapper.map_frame`` on frame 0, from
two first-frame budgets.

    python -m point_slam_tpu_torch.profiling.iter_cost [--device cuda|cpu]
        [--budgets 60,60,360] [--cap 524288] [--small]

For each budget a fresh mapper maps frame 0 with ``mapping.iters_first``
set to it (``geo_iter_first`` half of it); the first budget twice, so its
second run is warm. The per-iteration ms is the difference of the last
runs of the smallest and the largest budget over their iterations'
difference. Host seconds ending in a device sync; on the host they are
the host's, not the card's.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Sequence

from point_slam_tpu_torch.profiling import workload as W


def run(dev, budgets: Sequence[int] = (60, 60, 360), cap: int = 1 << 19,
        small: bool = False) -> Dict:
    cfg = W.bench_config(4, small=small)
    color, depth, c2w = W.frame(cfg, 0)
    times = {}
    for it in budgets:
        cfg["mapping"].update({"iters_first": it,
                               "geo_iter_first": it // 2})
        cfg["cuda"]["point_capacity_init"] = cap
        mapper = W.make_mapper(cfg, dev)
        st, t = W.host_s(lambda: mapper.map_frame(0, color, depth, c2w, c2w),
                         dev)
        times[it] = t
        print(f"[iter_cost] map_frame iters_first={it}: {t:.4f} s "
              f"({st['n_points']} points)", flush=True)
    lo, hi = min(budgets), max(budgets)
    per = (times[hi] - times[lo]) / (hi - lo)
    print(f"[iter_cost] mapping per-iteration: {per * 1e3:.4f} ms "
          f"({'host' if dev.type == 'cpu' else 'card'} clock)", flush=True)
    return {"seconds": times, "per_iter_ms": per * 1e3, "device": str(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--budgets", default="60,60,360")
    ap.add_argument("--cap", type=int, default=1 << 19)
    ap.add_argument("--small", action="store_true",
                    help="a 48x64 camera and a few hundred rays")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "iter_cost")
    out = run(dev, [int(b) for b in args.budgets.split(",")], args.cap,
              args.small)
    W.save_json("iter_cost_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
