"""Single-call latency and known-cost control ops.

    python -m point_slam_tpu_torch.profiling.latency_floor
        [--device cuda|cpu] [--queries 25000] [--table 65536] [--c 96]
        [--calls 8]

Times single calls, each between its own CUDA events with the card idle
before it (median and min of ``--calls``): a 4096^3 f32 matmul (137
GFLOP, the control), a tiny add (the floor), and a 27-probe brute top-8
over a cell table in the lane-major (TABLE, 4, C) and the row-major
(TABLE, C, 4) layouts. On the host it runs each once and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from point_slam_tpu_torch.profiling import workload as W

K = 8
PROBES = 27


def knn_lane_major(t, ids, q):
    """Top-8 over the probed (C,) lanes of a (TABLE, 4, C) table."""
    blk = t[ids]                                     # (Q, 27, 4, C)
    d2 = ((blk[:, :, 0] - q[:, None, 0, None]) ** 2
          + (blk[:, :, 1] - q[:, None, 1, None]) ** 2
          + (blk[:, :, 2] - q[:, None, 2, None]) ** 2)
    cid = blk[:, :, 3].contiguous().view(torch.int32)
    d, p = torch.topk(d2.reshape(q.shape[0], -1), K, largest=False)
    return d, torch.gather(cid.reshape(q.shape[0], -1), 1, p)


def knn_row_major(t, ids, q):
    """The same over a (TABLE, C, 4) table."""
    blk = t[ids]                                     # (Q, 27, C, 4)
    d2 = torch.sum((blk[..., :3] - q[:, None, None, :]) ** 2, -1)
    cid = blk[..., 3].contiguous().view(torch.int32)
    d, p = torch.topk(d2.reshape(q.shape[0], -1), K, largest=False)
    return d, torch.gather(cid.reshape(q.shape[0], -1), 1, p)


def run(dev, q: int = 25_000, table: int = 1 << 16, c: int = 96,
        calls: int = 8, n: int = 4096):
    g = torch.Generator(device=dev).manual_seed(0)
    t_lane = torch.randn((table, 4, c), generator=g, device=dev)
    t_row = torch.randn((table, c, 4), generator=g, device=dev)
    ids = torch.randint(0, table, (q, PROBES), generator=g, device=dev)
    qpos = torch.randn((q, 3), generator=g, device=dev)
    a = torch.randn((n, n), generator=g, device=dev)
    tiny = torch.ones((8, 128), device=dev)
    lines = {
        f"control matmul {n}^3 f32": lambda: a @ a,
        "noop tiny add": lambda: tiny + 1.0,
        f"knn lane-major (TABLE,4,{c})": lambda: knn_lane_major(t_lane, ids,
                                                                qpos),
        f"knn row-major (TABLE,{c},4)": lambda: knn_row_major(t_row, ids,
                                                              qpos),
    }
    out = {}
    for name, fn in lines.items():
        ts = W.call_ms(fn, dev, calls)
        out[name] = None if ts is None else {"median_ms": ts[len(ts) // 2],
                                             "min_ms": ts[0]}
        shown = ("not measured (cpu)" if ts is None else
                 f"median single call {ts[len(ts) // 2]:.4f} ms, min "
                 f"{ts[0]:.4f} ms")
        print(f"[latency] {name:<28} {shown}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--queries", type=int, default=25_000)
    ap.add_argument("--table", type=int, default=1 << 16)
    ap.add_argument("--c", type=int, default=96)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--n", type=int, default=4096,
                    help="the control matmul's size")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "latency_floor")
    out = run(dev, args.queries, args.table, args.c, args.calls, args.n)
    W.save_json("latency_floor_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
