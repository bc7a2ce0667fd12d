"""The gather's backward (scatter-add): one packed 72-wide table against
two 32-wide ones.

    python -m point_slam_tpu_torch.profiling.scatter_micro
        [--device cuda|cpu] [--cap 524288] [--queries 125000] [--iters 20]

Each iteration draws (Q, 8) random row ids from a generator and forms the
weighted sum of the neighbours' first 64 columns, either from the packed
(CAP, 72) table or from two (CAP, 32) tables; forward alone and forward +
backward (autograd: index_put_ with accumulation). Prints each time (CUDA
events over ``--iters`` iterations; the profiler's device time) and the
backward's cost in both layouts, with rows/s. On the host it runs each
once and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from point_slam_tpu_torch.profiling import workload as W

K = 8


def fwd72(src, i, w):
    out = torch.sum(w[..., None] * src[i][..., :64], dim=1)
    return torch.sum(out * out)


def fwd2x32(a, b, i, w):
    oa = torch.sum(w[..., None] * a[i], dim=1)
    ob = torch.sum(w[..., None] * b[i], dim=1)
    return torch.sum(oa * oa) + torch.sum(ob * ob)


def grad72(src, i, w):
    s = src.detach().requires_grad_(True)
    return torch.autograd.grad(fwd72(s, i, w), s)[0]


def grad2x32(a, b, i, w):
    a, b = (x.detach().requires_grad_(True) for x in (a, b))
    return torch.autograd.grad(fwd2x32(a, b, i, w), [a, b])


def run(dev, cap: int = 1 << 19, q: int = 125_000, iters: int = 20):
    g = torch.Generator(device=dev).manual_seed(0)
    f72 = torch.randn((cap, 72), generator=g, device=dev)
    a32 = torch.randn((cap, 32), generator=g, device=dev)
    b32 = torch.randn((cap, 32), generator=g, device=dev)
    w = torch.randn((q, K), generator=g, device=dev)

    def idxs():
        return torch.randint(0, cap, (q, K), generator=g, device=dev)

    lines = {
        "fwd packed 72": lambda: fwd72(f72, idxs(), w),
        "fwd+bwd packed 72": lambda: grad72(f72, idxs(), w),
        "fwd 2x 32": lambda: fwd2x32(a32, b32, idxs(), w),
        "fwd+bwd 2x 32": lambda: grad2x32(a32, b32, idxs(), w),
    }
    out = {}
    for name, fn in lines.items():
        ms = W.wall_ms(fn, dev, iters)
        out[name] = {"ms": ms, "device_ms": W.busy_ms(fn, dev, iters)}
        print(f"[scatter] {name:<18} {W.shown(ms)} (device "
              f"{W.shown(out[name]['device_ms'])})", flush=True)
    rows = q * K
    for layout in ("packed 72", "2x 32"):
        t = [out[f"{p} {layout}"]["device_ms"] for p in ("fwd+bwd", "fwd")]
        cost = None if None in t else t[0] - t[1]
        out[f"bwd cost {layout}"] = cost
        rate = ("not measured (cpu)" if cost is None or cost <= 0
                else f"{rows / (cost * 1e-3) / 1e6:.1f}M rows/s")
        print(f"[scatter] bwd cost {layout}: {W.shown(cost)} on the device "
              f"({rows} rows: {rate})", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--cap", type=int, default=1 << 19)
    ap.add_argument("--queries", type=int, default=125_000)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "scatter_micro")
    out = run(dev, args.cap, args.queries, args.iters)
    W.save_json("scatter_micro_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
