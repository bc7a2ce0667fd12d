"""Gather, scatter, search, top-k and sort rates on the card.

    python -m point_slam_tpu_torch.profiling.profile_gather
        [--device cuda|cpu] [--scale 1] [--iters 10]

The port of the root ``profile_gather.py`` (rows A-H at its sizes; a
``--scale`` s divides every count by s, for the host). Each row reduces
its result to one sum, as the script does, so the timed call ends in one
value:

  A   (2^19, 3) f32 rows x 64.8M indices (25,000 x 27 x 96): the
      gathered block is 778 MB;
  B   (2^19, 32) rows x 200k indices (25,000 x 8 neighbours);
  C   (2^16, 384) rows x 675k indices (25,000 x 27 cells of C = 96);
  C2  (2^16, 128) rows x 675k indices (C = 32);
  D   a scatter-add of 200k x 32 into (2^19, 32) zeros (``index_add_``);
  E   ``torch.searchsorted`` of 675k int32 keys into 512k sorted ones;
  F   ``torch.topk`` k = 8 over (25k, 2592);
  G   ``torch.topk`` k = 8 over (25k, 104);
  H   ``torch.argsort`` of 675k int32.

Each row: the median CUDA-event ms and the device ms a call, and for A-D
the gathered (scattered) bytes over each, in GB/s, where the script
prints a rate. On the host nothing is timed. Writes
output/profile_gather_torch.json.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from point_slam_tpu_torch.profiling import scene as S
from point_slam_tpu_torch.profiling import workload as W

CAP = 1 << 19
TABLE = 1 << 16


def inputs(dev, scale: int = 1, seed: int = 0):
    """The script's arrays, drawn in its order from numpy's generator."""
    rng = np.random.default_rng(seed)
    cap = CAP // scale
    table = TABLE // scale
    q, k27 = 25_000 // scale, 27
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    x = {"src3": f32(rng.standard_normal((cap, 3)))}
    x["idxA"] = i32(rng.integers(0, cap, q * k27 * 96))
    x["src32"] = f32(rng.standard_normal((cap, 32)))
    x["idxB"] = i32(rng.integers(0, cap, q * 8))
    x["srcC"] = f32(rng.standard_normal((table, 96 * 4)))
    x["idxC"] = i32(rng.integers(0, table, q * k27))
    x["srcC2"] = f32(rng.standard_normal((table, 32 * 4)))
    x["updB"] = f32(rng.standard_normal((q * 8, 32)))
    x["keys"] = torch.sort(i32(rng.integers(0, 1 << 20, cap))).values
    x["q"] = i32(rng.integers(0, 1 << 20, q * k27))
    x["d2"] = f32(rng.standard_normal((q, 2592)))
    x["d3"] = f32(rng.standard_normal((q, 104)))
    return x


def gather_sum(src, idx):
    return src[idx.long()].sum()


def scatter_sum(idx, upd, cap: int):
    return torch.zeros((cap, upd.shape[1]), device=upd.device).index_add_(
        0, idx.long(), upd).sum()


def search_sum(keys, q):
    return torch.searchsorted(keys, q).sum()


def topk_sum(d, k: int = 8):
    return torch.topk(d, k).values.sum()


def argsort_sum(x):
    return torch.argsort(x).sum()


def rows(x):
    """(tag, label, call, bytes its rate counts or None) for A-H."""
    cap = x["src3"].shape[0]
    na, nb, nc = x["idxA"].numel(), x["idxB"].numel(), x["idxC"].numel()
    c96, c32 = x["srcC"].shape[1] // 4, x["srcC2"].shape[1] // 4
    return [
        ("A", f"({cap},3) rows x {na} idx",
         lambda: gather_sum(x["src3"], x["idxA"]), na * 12),
        ("B", f"({cap},32) rows x {nb} idx",
         lambda: gather_sum(x["src32"], x["idxB"]), nb * 128),
        ("C", f"({x['srcC'].shape[0]},{4 * c96}) rows x {nc} idx",
         lambda: gather_sum(x["srcC"], x["idxC"]), nc * c96 * 16),
        ("C2", f"({x['srcC2'].shape[0]},{4 * c32}) rows x {nc} idx",
         lambda: gather_sum(x["srcC2"], x["idxC"]), nc * c32 * 16),
        ("D", f"scatter-add {nb} x 32",
         lambda: scatter_sum(x["idxB"], x["updB"], cap), nb * 128),
        ("E", f"searchsorted {x['keys'].numel()} x {x['q'].numel()}",
         lambda: search_sum(x["keys"], x["q"]), None),
        ("F", f"top_k {tuple(x['d2'].shape)} k=8",
         lambda: topk_sum(x["d2"]), None),
        ("G", f"top_k {tuple(x['d3'].shape)} k=8",
         lambda: topk_sum(x["d3"]), None),
        ("H", f"argsort {x['q'].numel()} int32",
         lambda: argsort_sum(x["q"]), None),
    ]


def run(dev, scale: int = 1, iters: int = 10):
    x = inputs(dev, scale)
    out = {}
    with torch.no_grad():
        for tag, label, call, n_bytes in rows(x):
            ms, dev_ms = S.stage_times(call, dev, iters)
            rate = ""
            if ms is not None and n_bytes is not None:
                rate = f"; {n_bytes / ms / 1e6:.1f} GB/s"
                if dev_ms:
                    rate += f" ({n_bytes / dev_ms / 1e6:.1f} GB/s on the " \
                            "device time)"
            out[tag] = {"label": label, "ms": ms, "device_ms": dev_ms,
                        "bytes": n_bytes}
            print(f"[profile_gather] {tag:<2} {label:<34} "
                  f"{S.shown_ms(ms, dev_ms)}{rate}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every count by this (1: the script's)")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed calls a row, after warm-up")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "profile_gather")
    out = run(dev, args.scale, args.iters)
    W.save_json("profile_gather_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
