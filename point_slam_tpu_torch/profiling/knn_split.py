"""The stages of per-sample grid_knn on the card.

    python -m point_slam_tpu_torch.profiling.knn_split
        [--device cuda|cpu] [--points 300000] [--queries 25000]
        [--iters 20]

The port of ``profiling/knn_split.py``: on the sine sheet of
``profiling/knn_pallas.py`` (CAP 2^19, 300k points, cell 0.16, table
2^16 x 64) with Q = 25,000 queries (the first Q points, each call jittered
by 0.02 N(0, 1)), it times per-sample ``grid_knn`` split into its
stages: the probes only (the 27 neighbour cells hashed); + the
(Q, 27, C, 4) row gather, d^2 (repeated buckets at +inf) and its min;
the same with ``torch.topk`` of the 8 smallest in place of the min; and
the full ``grid_knn``. The script's fifth row, ``jax.lax.approx_max_k``
(the TPU's approximate top-k), has no PyTorch counterpart and is printed
as absent. Each row: the median CUDA-event ms and the device ms a call;
on the host nothing is timed. Writes output/knn_split_torch.json.
"""

from __future__ import annotations

import argparse
import sys

import torch

from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.profiling import scene as S
from point_slam_tpu_torch.profiling import workload as W

Q = 25_000


def probe_rows(q: torch.Tensor, index) -> torch.Tensor:
    """(Q, 27) int32 buckets of each query's 27 neighbour cells."""
    off = torch.as_tensor(tk._offsets27(), device=q.device)
    cells = tk._cells(q, index.cell_size)[:, None, :] + off[None]
    return tk._hash_cells(cells, index.table_size).to(torch.int32)


def common(q: torch.Tensor, index, table: torch.Tensor):
    """(d^2 (Q, 27*C) with repeated buckets at +inf, the buckets)."""
    hs = probe_rows(q, index)
    ok = tk._dedup_probes(hs)
    blk = table[hs.long()]                                  # (Q,27,C,4)
    d2 = torch.sum((blk[..., :3] - q[:, None, None, :]) ** 2, -1)
    return torch.where(ok[:, :, None], d2, torch.inf).reshape(
        q.shape[0], -1), hs


def s_probe(q, index, table):
    return probe_rows(q, index)


def s_dist(q, index, table):
    return torch.amin(common(q, index, table)[0], dim=1)


def s_topk(q, index, table):
    return torch.topk(common(q, index, table)[0], S.K, largest=False).values


def s_full(q, index, table):
    return tk.grid_knn(index, q, k=S.K)


STAGES = (("probes only", s_probe), ("gather+d2+min", s_dist),
          ("gather+d2+top_k", s_topk), ("full grid_knn", s_full))


def run(dev, points=None, queries: int = Q, iters: int = 20, seed: int = 0):
    sc, pts, _, index = S.sheet(dev, points, rays=1)
    table = S.interleaved_table(index)
    base = pts[:queries]
    g = torch.Generator(device=dev).manual_seed(seed)
    print(f"[knn_split] sine sheet: {sc.n_points} points, Q={queries}, "
          f"C={S.C}", flush=True)
    stages = [(name, lambda f=f: f(S.jitter(base, g, 0.02), index, table))
              for name, f in STAGES]
    with torch.no_grad():
        rows = S.run_stages("knn_split", stages, dev, iters)
    print("[knn_split] gather+d2+approx_topk    absent: jax.lax.approx_max_k "
          "(the TPU's approximate top-k) has no PyTorch counterpart",
          flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--points", type=int, default=None,
                    help="points on the sheet (default 300000)")
    ap.add_argument("--queries", type=int, default=Q)
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls a stage, after warm-up")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "knn_split")
    rows = run(dev, args.points, args.queries, args.iters)
    W.save_json("knn_split_torch.json", rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
