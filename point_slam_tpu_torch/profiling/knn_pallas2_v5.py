"""The stage split of the kNN study's v5 (P2') beside v4 (P2) on the card.

    python -m point_slam_tpu_torch.profiling.knn_pallas2_v5
        [--device cuda|cpu] [--points 300000] [--rays 5000] [--iters 20]

The port of ``profiling/knn_pallas2_v5.py``. On the sine sheet of
``profiling/knn_pallas2.py`` (CAP 2^19, 300k points, cell 0.16, table
2^16 x 64 with its +inf sentinel row; R = 5000 rays of 5 samples) it
prints four rows: s5 probes (the 4x4x4 box compacted to 40 slots,
``knn_pallas2.s5_probes``), s5 + the (R, 40, C, 4) row gather, v5 full
(+ the transpose and P2' through the CUDA block top-k) and v4 full (the
64-slot box, P2). Every call jitters the queries (q + 0.002 N(0, 1));
each row: the median CUDA-event ms and the device ms a call. On the host
each runs once and nothing is timed. Writes
output/knn_pallas2_v5_torch.json.
"""

from __future__ import annotations

import argparse
import sys

import torch

from point_slam_tpu_torch.profiling import knn_pallas2 as kp2
from point_slam_tpu_torch.profiling import scene as S
from point_slam_tpu_torch.profiling import workload as W

STAGES = (("s5 probes+compact", kp2.s5_probes),
          ("s5 +gather (P2=40)", kp2.s5_gather),
          ("v5 full compacted", kp2.knn_rays_v5),
          ("v4 full", kp2.knn_rays))


def run(dev, points=None, rays=None, iters: int = 20, seed: int = 0):
    """Time STAGES on the sheet; returns {stage: {"ms", "device_ms"}}."""
    sc, _, q, index = S.sheet(dev, points, rays)
    table = S.interleaved_table(index)
    g = torch.Generator(device=dev).manual_seed(seed)
    stages = [(name, lambda f=f: f(table, S.jitter(q, g), sc.cell))
              for name, f in STAGES]
    print(f"[knn_pallas2_v5] sine sheet: {sc.n_points} points, "
          f"R={q.shape[0]}, ns={q.shape[1]}, P={kp2.P} (v4) and "
          f"{kp2.P2} (v5), C={S.C}", flush=True)
    with torch.no_grad():
        return S.run_stages("knn_pallas2_v5", stages, dev, iters)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--points", type=int, default=None,
                    help="points on the sheet (default 300000)")
    ap.add_argument("--rays", type=int, default=None,
                    help="rays (default 5000)")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls a stage, after warm-up")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "knn_pallas2_v5")
    rows = run(dev, args.points, args.rays, args.iters)
    W.save_json("knn_pallas2_v5_torch.json", rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
