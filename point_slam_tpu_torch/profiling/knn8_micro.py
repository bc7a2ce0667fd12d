"""27 probes of cell r_max (C=96) against 8 probes of cell 2 r_max (C=384).

    python -m point_slam_tpu_torch.profiling.knn8_micro [--device cuda|cpu]
        [--queries 25000] [--iters 20]

The 8-probe variant takes, per axis, the two cells the query ball touches
(floor((q - r) / s), floor((q + r) / s)); with s >= 2 r_max that covers
the ball exactly: fewer but wider candidate rows, a win where the gather
is bound by its row count. Both gather from random (TABLE, C, 4) tables,
drop repeated buckets and take the top-8 by ``torch.topk``; each iteration
jitters the queries from a generator. Prints each time (CUDA events over
``--iters`` calls, and the profiler's device time). On the host it runs
each once and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from point_slam_tpu_torch.ops import knn
from point_slam_tpu_torch.profiling import workload as W

K = 8
T27, C27, CELL27 = 1 << 16, 96, 0.16
T8, C8, CELL8 = 1 << 14, 384, 0.32


def _top8(blk, q, hs):
    ok = knn._dedup_probes(hs)
    d2 = torch.sum((blk[..., :3] - q[:, None, None, :]) ** 2, -1)
    d2 = torch.where(ok[:, :, None], d2, torch.inf).reshape(q.shape[0], -1)
    return torch.topk(d2, K, largest=False).values


def knn27(t27, q):
    off = torch.as_tensor(knn._offsets27(), device=q.device)
    qc = torch.floor(q / CELL27).to(torch.int32)
    hs = knn._hash_cells(qc[:, None, :] + off[None], T27)
    return _top8(t27[hs], q, hs)


def knn8(t8, q, r):
    lo = torch.floor((q - r[:, None]) / CELL8).to(torch.int32)
    hi = torch.floor((q + r[:, None]) / CELL8).to(torch.int32)
    bits = ((torch.arange(8, device=q.device)[:, None]
             >> torch.arange(3, device=q.device)[None, :]) & 1) == 1
    cells = torch.where(bits[None], hi[:, None, :], lo[:, None, :])
    hs = knn._hash_cells(cells, T8)
    return _top8(t8[hs], q, hs)


def run(dev, q: int = 25_000, iters: int = 20):
    g = torch.Generator(device=dev).manual_seed(0)
    t27 = torch.randn((T27, C27, 4), generator=g, device=dev)
    t8 = torch.randn((T8, C8, 4), generator=g, device=dev)
    qpos = 6.0 * torch.rand((q, 3), generator=g, device=dev)
    r = 0.04 + 0.12 * torch.rand(q, generator=g, device=dev)

    def jitter():
        return qpos + 1e-4 * torch.randn((q, 3), generator=g, device=dev)

    lines = {"27-probe C=96": lambda: knn27(t27, jitter()),
             "8-probe C=384": lambda: knn8(t8, jitter(), r)}
    out = {}
    for name, fn in lines.items():
        out[name] = {"ms": W.wall_ms(fn, dev, iters),
                     "device_ms": W.busy_ms(fn, dev, iters)}
        print(f"[knn8] {name:<14} {W.shown(out[name]['ms'])} (device "
              f"{W.shown(out[name]['device_ms'])})", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--queries", type=int, default=25_000)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "knn8_micro")
    out = run(dev, args.queries, args.iters)
    W.save_json("knn8_micro_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
