"""The renderer's neighbour-row gather and its backward scatter-add.

    python -m point_slam_tpu_torch.profiling.gather_scatter_micro
        [--device cuda|cpu] [--cap 524288] [--samples 25000] [--iters 30]

At mapping scale (25k samples x 8 neighbours x 72 columns of a CAP 2^19
packed buffer) it times, with CUDA events over ``--iters`` calls and with
the profiler's device time: the gather ``packed[idx]`` in f32 and bf16;
its backward as the renderer runs it (autograd of the gather: index_put_
with accumulation) with f32 and with bf16 updates; the same sum through
``index_add_``; and gather + elementwise forward and backward. Each row
prints rows/s (samples x neighbours over the time): the device figure of
the f32 gather and of the backward are the card's row rates (roofline.py).
On the host it runs each once and times nothing.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from point_slam_tpu_torch.profiling import workload as W

K = 8
WIDTH = 72


def make_inputs(cap: int, n: int, dev, seed: int = 0, k: int = K,
                w: int = WIDTH):
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randn((cap, w), generator=g, device=dev)
    idx = torch.randint(0, cap, (n, k), generator=g, device=dev)
    upd = torch.randn((n, k, w), generator=g, device=dev)
    return packed, idx, upd


def gather(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, K, W) rows: the renderer's ``packed[idx]``."""
    return packed[idx]


def gather_backward(packed: torch.Tensor, idx: torch.Tensor,
                    upd: torch.Tensor) -> torch.Tensor:
    """d/d packed of sum(packed[idx] * upd): the renderer's backward
    scatter-add (index_put_ with accumulation), as autograd runs it."""
    p = packed.detach().requires_grad_(True)
    (g,) = torch.autograd.grad((p[idx] * upd.float()).sum(), p)
    return g


def index_add(cap: int, idx: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """The same sum through ``index_add_``."""
    w = upd.shape[-1]
    out = torch.zeros((cap, w), device=upd.device)
    return out.index_add_(0, idx.reshape(-1), upd.reshape(-1, w).float())


def gather_ew_grad(packed, idx, upd) -> torch.Tensor:
    """Gather + the renderer-like elementwise chain (softmax weights over
    the neighbours' squared coordinates), forward and backward."""
    p = packed.detach().requires_grad_(True)
    nb = p[idx]
    wgt = torch.softmax(torch.sum(nb[..., :3] ** 2, -1), dim=-1)
    (g,) = torch.autograd.grad(torch.sum(wgt[..., None] * nb * upd), p)
    return g


def run(dev, cap: int = 1 << 19, n: int = 25_000, iters: int = 30
        ) -> Dict[str, Dict]:
    packed, idx, upd = make_inputs(cap, n, dev)
    packed_bf, upd_bf = packed.to(torch.bfloat16), upd.to(torch.bfloat16)
    rows = n * K
    lines = {
        "gather f32 (N,K,72)": lambda: gather(packed, idx),
        "gather bf16 (N,K,72)": lambda: gather(packed_bf, idx),
        "backward f32 (autograd)": lambda: gather_backward(packed, idx, upd),
        "backward f32<-bf16 upd": lambda: gather_backward(packed, idx,
                                                          upd_bf),
        "index_add_ f32": lambda: index_add(cap, idx, upd),
        "gather+ew fwd+bwd f32": lambda: gather_ew_grad(packed, idx, upd),
    }
    out = {}
    for name, fn in lines.items():
        ms = W.wall_ms(fn, dev, iters)
        dev_ms = W.busy_ms(fn, dev, iters)
        rate = None if dev_ms is None else rows / (dev_ms * 1e-3)
        out[name] = {"ms": ms, "device_ms": dev_ms, "rows": rows,
                     "rows_per_s_device": rate,
                     "rows_per_s": None if ms is None
                     else rows / (ms * 1e-3)}
        rate_s = ("not measured (cpu)" if rate is None
                  else f"{rate / 1e6:.1f}M rows/s on the device")
        print(f"[gather] {name:<24} {W.shown(ms)} (device "
              f"{W.shown(dev_ms)}); {rows} rows: {rate_s}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--cap", type=int, default=1 << 19)
    ap.add_argument("--samples", type=int, default=25_000)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "gather_scatter_micro")
    out = run(dev, args.cap, args.samples, args.iters)
    W.save_json("gather_scatter_micro_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
