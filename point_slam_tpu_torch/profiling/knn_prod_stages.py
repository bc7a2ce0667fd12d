"""The shipped ray kNN split into stages, and the bucket-row gather's
calibration (rows or bytes), on the card.

    python -m point_slam_tpu_torch.profiling.knn_prod_stages
        [--device cuda|cpu] [--points 22500] [--rays 5000] [--iters 20]

The port of ``profiling/knn_prod_stages.py``, at the bench's kNN shapes:
R = 5000 rays of 5 samples on the sine sheet of ``profiling/knn_pallas.py``
with 22,500 points (CAP 2^17, cell 0.16), the packed cell table 2^16 x
64, 27 probes. Stages (each the chain up to it, queries jittered by
0.002 N(0, 1) every call):

  s1  probes: ``ops/knn.py::_box_probes``;
  s2  + the two plane gathers (pxyz and pid rows at probe width) as torch
      index ops. The port's K1 reads its rows itself and never builds
      this block: s2 is the cost the kernel avoids;
  s3  the full ``ray_grid_knn`` (K1, the CUDA ray top-k);
  s3f the same over the fused coords|ids table (K3).

Then the row-rate calibration over the same ~135k probe rows: g64 one
(TABLE+1, 64) i32 plane, g2x64 two of them, g128 one (TABLE+1, 128) i32
plane (the fused rows), each minus s1. If g128 ~ g64 the gather is bound
by the number of rows; if g128 ~ 2 x g64, by the bytes. The verdict is
read from the device times (the card's own work) and printed beside the
CUDA-event times. On the host nothing is timed. Writes
output/knn_prod_stages_torch.json.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.profiling import scene as S
from point_slam_tpu_torch.profiling import workload as W

NPTS = 22_500
CAP = 1 << 17
PROBES = 27


def s_probes(index, q):
    return tk._box_probes(q, index.cell_size, index.table_size, PROBES)


def s_gathers(index, q):
    rows, compact = s_probes(index, q)
    r = rows.long()
    return index.pxyz[r], index.pid[r], compact


def s_full(index, q):
    return tk.ray_grid_knn(index, q, k=S.K, probes=PROBES)


def g_one_plane(index, q):
    return index.pxyz[s_probes(index, q)[0].long()]


def g_two_planes(index, q):
    r = s_probes(index, q)[0].long()
    return index.pxyz[r], index.pid[r]


def g_fused_wide(fused, q):
    return fused.plane[s_probes(fused, q)[0].long()]


def verdict(g64: Optional[float], g128: Optional[float]) -> str:
    """Rows or bytes, from the two gathers' costs over the probes."""
    if g64 is None or g128 is None:
        return "not measured"
    if g64 <= 0:
        return (f"undetermined: g64 = {g64:.4f} ms <= 0 (the timing's noise "
                "exceeds the gather)")
    ratio = g128 / g64
    kind = "rows" if ratio < 1.5 else "bytes"
    return (f"g128/g64 = {ratio:.3f}: bound by {kind} (rows if g128 ~ g64, "
            "bytes if g128 ~ 2 x g64)")


def run(dev, points: int = NPTS, rays=None, iters: int = 20, seed: int = 0):
    sc, pts, q, packed = S.sheet(dev, points, rays, cap=CAP,
                                 build=tk.build_packed_grid_index)
    fused = tk.build_fused_grid_index(pts, sc.n_points, sc.cell, S.TABLE,
                                      S.C)
    g = torch.Generator(device=dev).manual_seed(seed)
    jq = lambda: S.jitter(q, g)
    stages = [("s1 probes", lambda: s_probes(packed, jq())),
              ("s2 +plane gathers", lambda: s_gathers(packed, jq())),
              ("s3 full ray_grid_knn", lambda: s_full(packed, jq())),
              ("s3f full fused plane", lambda: s_full(fused, jq())),
              ("g one 64-wide plane", lambda: g_one_plane(packed, jq())),
              ("g two 64-wide planes", lambda: g_two_planes(packed, jq())),
              ("g one 128-wide fused", lambda: g_fused_wide(fused, jq()))]
    print(f"[knn_prod_stages] sine sheet: {sc.n_points} points, CAP {CAP}, "
          f"R={q.shape[0]}, ns={q.shape[1]}, P={PROBES}, C={S.C}: "
          f"{q.shape[0] * PROBES} probe rows a call; s2's gathered block "
          "is what K1 never builds (it reads its rows in the kernel)",
          flush=True)
    with torch.no_grad():
        rows = S.run_stages("knn_prod_stages", stages, dev, iters)
    out = {"stages": rows}
    for key in ("ms", "device_ms"):
        t = {name: r[key] for name, r in rows.items()}
        if None in t.values():
            continue
        base = t["s1 probes"]
        cost = {"g64": t["g one 64-wide plane"] - base,
                "g2x64": t["g two 64-wide planes"] - base,
                "g128": t["g one 128-wide fused"] - base}
        out[key] = {"probes": base,
                    "gathers": t["s2 +plane gathers"] - base,
                    "kernel": t["s3 full ray_grid_knn"] - base, **cost}
        print(f"[knn_prod_stages] {key}: probes {base:.4f} | the gathers K1 "
              f"avoids {out[key]['gathers']:.4f} | K1 and its epilogue "
              f"(s3 - s1) {out[key]['kernel']:.4f} | fused full "
              f"{t['s3f full fused plane']:.4f} (vs "
              f"{t['s3 full ray_grid_knn']:.4f}) | g64 {cost['g64']:.4f} | "
              f"g2x64 {cost['g2x64']:.4f} | g128 {cost['g128']:.4f}",
              flush=True)
    if "device_ms" in out:
        out["verdict"] = verdict(out["device_ms"]["g64"],
                                 out["device_ms"]["g128"])
        print(f"[knn_prod_stages] verdict (device times): {out['verdict']}",
              flush=True)
    if "ms" in out:
        print(f"[knn_prod_stages] by CUDA-event times: "
              f"{verdict(out['ms']['g64'], out['ms']['g128'])}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--points", type=int, default=NPTS,
                    help="points on the sheet")
    ap.add_argument("--rays", type=int, default=None,
                    help="rays (default 5000)")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls a stage, after warm-up")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "knn_prod_stages")
    out = run(dev, args.points, args.rays, args.iters)
    W.save_json("knn_prod_stages_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
