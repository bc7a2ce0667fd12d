"""Per-sample kNN over two table layouts, beside two controls, on the card.

    python -m point_slam_tpu_torch.profiling.knn_chain
        [--device cuda|cpu] [--small] [--iters 10]

The port of ``profiling/knn_chain.py``. Two random tables of TABLE = 2^16
rows of C = 96 candidates, lane-major (TABLE, 4, C) and row-major
(TABLE, C, 4) f32 (100.7 MB each); Q = 25,000 queries; each query's 27
neighbour cells (cell 0.13) hashed to rows, gathered ((Q, 27, 4, C) or
(Q, 27, C, 4): 1.04 GB of f32), d^2 to the query, and ``torch.topk`` of
the 8 smallest over (Q, 27*C). These are plain torch ops: no Pallas
kernel is behind them, and the point is the layouts' gather. Controls:
a 4096^3 f32 matmul (137 GFLOP) and an elementwise op on (Q, 3). The TPU
script chained 30 steps in a fori_loop, each feeding its result back into
the queries to serialise them; here each step (the same feedback: q +
1e-9 * the first three distances) is timed alone: the median CUDA-event
ms and the device ms a step. ``--small``: TABLE 2^10, C 8, Q 500, a 256^3
matmul. On the host nothing is timed. Writes output/knn_chain_torch.json.
"""

from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import numpy as np
import torch

from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.profiling import scene as S
from point_slam_tpu_torch.profiling import workload as W

CELL = 0.13
K = 8


class Sizes(NamedTuple):
    table: int
    c: int
    q: int
    matmul: int


FULL = Sizes(1 << 16, 96, 25_000, 4096)
SMALL = Sizes(1 << 10, 8, 500, 256)


def make(sizes: Sizes, dev, seed: int = 0):
    """The script's draws, in its order: (tableT, tableR, q0, A)."""
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((sizes.table, 4, sizes.c)),
              rng.standard_normal((sizes.table, sizes.c, 4)),
              rng.standard_normal((sizes.q, 3)),
              rng.standard_normal((sizes.matmul, sizes.matmul)) * 1e-3)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in arrays)


def probes(q: torch.Tensor, table_size: int) -> torch.Tensor:
    """(Q, 27) rows of the query's 27 neighbour cells."""
    off = torch.as_tensor(tk._offsets27(), device=q.device)
    cells = tk._cells(q, tk._as_cell_size(CELL, q.device))[:, None, :]
    return tk._hash_cells(cells + off[None], table_size).long()


def knn_lane_major(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """8 smallest d^2 over the (Q, 27, 4, C) block, ascending."""
    blk = table[probes(q, table.shape[0])]
    d2 = ((blk[:, :, 0] - q[:, None, 0, None]) ** 2
          + (blk[:, :, 1] - q[:, None, 1, None]) ** 2
          + (blk[:, :, 2] - q[:, None, 2, None]) ** 2)
    return torch.topk(d2.reshape(q.shape[0], -1), K, largest=False).values


def knn_row_major(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """8 smallest d^2 over the (Q, 27, C, 4) block, ascending."""
    blk = table[probes(q, table.shape[0])]
    diff = blk[..., :3] - q[:, None, None, :]
    d2 = torch.sum(diff * diff, -1)
    return torch.topk(d2.reshape(q.shape[0], -1), K, largest=False).values


def run(dev, sizes: Sizes = FULL, iters: int = 10):
    t_lane, t_row, q0, a = make(sizes, dev)
    steps = [
        (f"matmul {sizes.matmul}^3", lambda: (a @ a) * 1e-3 + 1e-3),
        ("elementwise (Q,3)", lambda: q0 * 0.9999 + 1e-5),
        ("knn lane-major", lambda: q0 + 1e-9 * knn_lane_major(t_lane, q0)
         [:, :3]),
        ("knn row-major", lambda: q0 + 1e-9 * knn_row_major(t_row, q0)
         [:, :3]),
    ]
    block_gb = sizes.q * 27 * 4 * sizes.c * 4 / 1e9
    print(f"[knn_chain] TABLE {sizes.table}, C {sizes.c}, Q {sizes.q}: "
          f"each table {t_lane.numel() * 4 / 1e6:.1f} MB, each gathered "
          f"block {block_gb:.3f} GB of f32", flush=True)
    with torch.no_grad():
        rows = S.run_stages("knn_chain", steps, dev, iters)
    gf = 2 * sizes.matmul ** 3 / 1e9
    mm = rows[steps[0][0]]
    if mm["ms"] is not None:
        print(f"[knn_chain] matmul {gf:.1f} GFLOP at "
              f"{gf / mm['ms']:.1f} TFLOP/s (CUDA events)", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--small", action="store_true",
                    help="TABLE 2^10, C 8, Q 500, a 256^3 matmul")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed calls a step, after warm-up")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "knn_chain")
    rows = run(dev, SMALL if args.small else FULL, args.iters)
    W.save_json("knn_chain_torch.json", rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
