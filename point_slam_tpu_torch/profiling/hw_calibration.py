"""Calibrate the card: matmul rates, HBM copy bandwidth, launch overhead.

    python -m point_slam_tpu_torch.profiling.hw_calibration
        [--device cuda|cpu] [--n 4096] [--copy-mb 256] [--iters 20]

Times, with CUDA events over ``--iters`` calls after warm-up: an n^3
matmul in f32 with TF32 off (IEEE f32 on the CUDA cores), in TF32 and in
bf16 (tensor cores), each with its precision set explicitly and the
previous setting restored; a copy of ``--copy-mb`` MB (read + write); and
the overhead of one eager op (a tiny add, back to back, per launch). Each
rate is printed beside the card's published peak (roofline.py). On the
host it runs each once at the given sizes and times nothing.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from point_slam_tpu_torch.profiling import roofline as RL
from point_slam_tpu_torch.profiling import workload as W


def _matmul(a: torch.Tensor, tf32: bool):
    """a @ a with TF32 matmuls on or off (f32 inputs; bf16 ones run on the
    bf16 tensor cores either way), the setting restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return a @ a
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def calibrate(dev, n: int = 4096, copy_mb: int = 256, iters: int = 20
              ) -> Dict[str, Dict]:
    """{line: {ms, rate, unit, peak}}; ms and rate None on the host."""
    g = torch.Generator(device=dev).manual_seed(0)
    a32 = 1e-2 * torch.randn((n, n), generator=g, device=dev)
    a16 = a32.to(torch.bfloat16)
    big = torch.randn(copy_mb * (1 << 20) // 4, generator=g, device=dev)
    dst = torch.empty_like(big)
    tiny = torch.ones((8, 128), device=dev)
    flops = 2.0 * n ** 3
    lines = {
        "matmul f32 (TF32 off)": (lambda: _matmul(a32, False), flops,
                                  "TFLOP/s", RL.F32_FLOP_PER_S),
        "matmul tf32": (lambda: _matmul(a32, True), flops, "TFLOP/s",
                        RL.TF32_FLOP_PER_S),
        "matmul bf16": (lambda: _matmul(a16, False), flops, "TFLOP/s",
                        RL.BF16_FLOP_PER_S),
        "copy (read + write)": (lambda: dst.copy_(big),
                                2.0 * big.numel() * 4, "TB/s",
                                RL.HBM_BYTES_PER_S),
        "eager op (tiny add)": (lambda: tiny.add(1.0), None, "us a launch",
                                None),
    }
    out = {}
    for name, (fn, work, unit, peak) in lines.items():
        ms = W.wall_ms(fn, dev, iters=iters if work else 10 * iters,
                       warmup=3)
        if ms is None:
            rate = None
        elif work is None:
            rate = ms * 1e3                 # us a launch
        else:
            rate = work / (ms * 1e-3) / 1e12
        out[name] = {"ms": ms, "rate": rate, "unit": unit,
                     "peak": None if peak is None else peak / 1e12}
        peak_s = "" if peak is None else f" (peak {peak / 1e12:.2f})"
        rate_s = "not measured (cpu)" if rate is None else f"{rate:.3f}"
        print(f"[hw] {name:<22} {W.shown(ms)}  -> {rate_s} {unit}{peak_s}",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--copy-mb", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "hw_calibration")
    out = calibrate(dev, args.n, args.copy_mb, args.iters)
    W.save_json("hw_calibration_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
