"""The cell-width sweep of the ray kNN on the card: C = 64, 48, 32.

    python -m point_slam_tpu_torch.profiling.knn_pallas5
        [--device cuda|cpu] [--points 300000] [--rays 5000] [--iters 20]

The port of ``profiling/knn_pallas5.py``. A smaller C cuts the candidate
lanes (P*C) and the rows' bytes linearly; recall falls where occupied
cells overflow. On the sine sheet (CAP 2^19, 300k points, cell 0.16,
table 2^16; R = 5000 rays of 5 samples) each width builds the f32-plane
cell table (``build_grid_index``) and runs ``ray_grid_knn`` at the
default 36 probes: K2, the CUDA ray top-k, whose generic instantiation
takes 48 (32 and 64 are built as constants). Parity is the script's: the
share of sorted exact d^2 slots (from the winners' ids) within rtol 1e-5,
atol 1e-10 of per-sample ``grid_knn`` over a C = 96 table, a non-finite
reference slot counting as equal. Time: the median CUDA-event ms and the
device ms of one ``ray_grid_knn`` call on jittered queries (q + 0.002
N(0, 1)). The TPU script's ``blk`` axis (``_RAY_BLK`` 32/64) was the
Pallas grid's ray block; the persistent kernel has none (its blocks walk
rays r += gridDim.x), so those rows are not run. On the host nothing is
timed. Writes output/knn_pallas5_torch.json.
"""

from __future__ import annotations

import argparse
import sys

import torch

from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.profiling import scene as S
from point_slam_tpu_torch.profiling import workload as W

WIDTHS = (64, 48, 32)
REF_C = 96


def parity(ref_d2: torch.Tensor, got_d2: torch.Tensor) -> float:
    """The script's parity in %: sorted d^2 slots (f32) within rtol 1e-5,
    atol 1e-10 of the reference's, or where the reference is not
    finite."""
    a = torch.sort(ref_d2, dim=1).values
    b = torch.sort(got_d2, dim=1).values
    ok = torch.isclose(a, b, rtol=1e-5, atol=1e-10) | ~torch.isfinite(a)
    return float(ok.double().mean()) * 100.0


def reference(points, n_points, q, cell, table=S.TABLE, c=REF_C):
    """Per-sample grid_knn's d^2 over a C = ``c`` table, (R*ns, k)."""
    index = tk.build_grid_index(points, n_points, cell, table, c)
    return tk.grid_knn(index, q.reshape(-1, 3), k=S.K)[0]


def width_parity(points, n_points, q, cell, c, ref_d2, table=S.TABLE):
    """(index, parity %) of ray_grid_knn over a C = ``c`` f32 table."""
    index = tk.build_grid_index(points, n_points, cell, table, c)
    _, idx, valid, _ = tk.ray_grid_knn(index, q, k=S.K)
    got = S.exact_d2(points, q, idx, valid)
    return index, parity(ref_d2, got)


def run(dev, points=None, rays=None, iters: int = 20, seed: int = 0):
    sc, pts, q, _ = S.sheet(dev, points, rays)
    g = torch.Generator(device=dev).manual_seed(seed)
    print(f"[knn_pallas5] sine sheet: {sc.n_points} points, R={q.shape[0]}"
          f", ns={q.shape[1]}, {tk._P_RAY_DEFAULT} probes; the Pallas "
          "grid's ray block (blk 32/64) has no counterpart in the "
          "persistent kernel: the blk=64 rows are not run", flush=True)
    rows = {}
    with torch.no_grad():
        ref = reference(pts, sc.n_points, q, sc.cell)
        for c in WIDTHS:
            index, par = width_parity(pts, sc.n_points, q, sc.cell, c, ref)
            ms, dev_ms = S.stage_times(
                lambda: tk.ray_grid_knn(index, S.jitter(q, g), k=S.K),
                dev, iters)
            rows[c] = {"parity_pct": par, "ms": ms, "device_ms": dev_ms}
            print(f"[knn_pallas5] C={c}: {S.shown_ms(ms, dev_ms)} a call, "
                  f"parity {par:.4f}% vs grid_knn at C={REF_C}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--points", type=int, default=None,
                    help="points on the sheet (default 300000)")
    ap.add_argument("--rays", type=int, default=None,
                    help="rays (default 5000)")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls a width, after warm-up")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "knn_pallas5")
    rows = run(dev, args.points, args.rays, iters=args.iters)
    W.save_json("knn_pallas5_torch.json", rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
