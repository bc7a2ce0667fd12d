"""The feature gather's row width and Adam's layout.

    python -m point_slam_tpu_torch.profiling.feat_adam_micro
        [--device cuda|cpu] [--cap 524288] [--queries 125000] [--iters 30]

Each iteration draws (Q, 8) random row ids from a generator. Times (CUDA
events over ``--iters`` iterations, and the profiler's device time): the
ids alone; the gather and weighted sum of 32-, 64-, 72- and 128-wide rows
of a CAP table; the scatter-add (``index_add_``) of 32-wide rows; one Adam
step of a (CAP, 32) leaf as 2-D and flattened. On the host it runs each
once and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from point_slam_tpu_torch.profiling import workload as W

K = 8
WIDTHS = (32, 64, 72, 128)


def adam_step(p, g, m, v):
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    return p - 0.01 * (m / 0.5) / (torch.sqrt(v / 0.5) + 1e-8), m, v


def run(dev, cap: int = 1 << 19, q: int = 125_000, iters: int = 30):
    g = torch.Generator(device=dev).manual_seed(0)
    tables = {w: torch.randn((cap, w), generator=g, device=dev)
              for w in WIDTHS}
    wgt = torch.randn((q, K), generator=g, device=dev)
    g32, m32 = (torch.randn((cap, 32), generator=g, device=dev)
                for _ in range(2))
    v32 = torch.randn((cap, 32), generator=g, device=dev).abs()

    def idxs():
        return torch.randint(0, cap, (q, K), generator=g, device=dev)

    def gather(w):
        return lambda: torch.sum(wgt[..., None] * tables[w][idxs()], dim=1)

    def scatter():
        i = idxs()
        upd = wgt[..., None].expand(q, K, 32).reshape(-1, 32)
        return torch.zeros((cap, 32), device=dev).index_add_(
            0, i.reshape(-1), upd)

    lines = {"idx only": idxs,
             **{f"gather {w}-wide + wsum": gather(w) for w in WIDTHS},
             "scatter-add 32-wide": scatter,
             "adam one leaf (CAP,32)": lambda: adam_step(tables[32], g32,
                                                         m32, v32),
             "adam one leaf flat": lambda: adam_step(
                 tables[32].reshape(-1), g32.reshape(-1), m32.reshape(-1),
                 v32.reshape(-1))}
    out = {}
    for name, fn in lines.items():
        out[name] = {"ms": W.wall_ms(fn, dev, iters),
                     "device_ms": W.busy_ms(fn, dev, iters)}
        print(f"[feat_adam] {name:<24} {W.shown(out[name]['ms'])} (device "
              f"{W.shown(out[name]['device_ms'])})", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--cap", type=int, default=1 << 19)
    ap.add_argument("--queries", type=int, default=125_000)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "feat_adam_micro")
    out = run(dev, args.cap, args.queries, args.iters)
    W.save_json("feat_adam_micro_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
