"""Frame-0 mapping at Replica scale through the whole ``Mapper.map_frame``.

    python -m point_slam_tpu_torch.profiling.crash_bisect2 [ITERS_FIRST]
        [--device cuda|cpu] [--small]

The port of ``profiling/crash_bisect2.py``: ``crash_bisect``'s
configuration (bench.py's widths, window 12, CAP 2^19, no near-cloud
sampling) with ``iters_first`` = ITERS_FIRST (default 300) and
``geo_iter_first`` = min(400, ITERS_FIRST // 2); maps frame 0 once and
prints the wall from a device sync to a device sync, the cloud's points,
the geometry loss and the first geometry feature. ``--small``: a 48x64
camera, 400 rays, CAP 2^13, for the host. Writes
``output/torch/crash_bisect2.json``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict

from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch.profiling import crash_bisect as CB
from point_slam_tpu_torch.profiling import workload as W


def run(cfg, dev) -> Dict[str, Any]:
    mapper = CB.make_mapper(cfg, dev)
    color, depth, c2w = W.frame(cfg, 0)
    st, s = W.host_s(lambda: mapper.map_frame(0, color, depth, c2w, c2w),
                     dev)
    v = float(mapper.cloud.packed[0, pc.GEO_SL][0])
    iters_first = cfg["mapping"]["iters_first"]
    print(f"map_frame(0) iters_first={iters_first}: {s:.1f}s "
          f"n_points={st['n_points']} geo_loss={st['geo_loss']:.3f} "
          f"v={v:.5f}", flush=True)
    return {"iters_first": iters_first, "s": s, "n_points": st["n_points"],
            "geo_loss": st["geo_loss"], "color_loss": st["color_loss"],
            "v": v, "device": str(dev)}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters_first", nargs="?", type=int, default=300)
    W.add_device_arg(ap)
    ap.add_argument("--small", action="store_true",
                    help="a 48x64 camera, 400 rays, CAP 2^13")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "crash_bisect2")
    out = run(CB.config(args.iters_first, args.small), dev)
    out["path"] = W.save_json(os.path.join("torch", "crash_bisect2.json"),
                              out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
