"""Host-to-device copies: pageable against pinned memory over PCIe.

    python -m point_slam_tpu_torch.profiling.upload_micro
        [--device cuda|cpu] [--reps 6] [--max-mb 13]

Whether a frame's upload cost is bandwidth (fewer bytes win) or a fixed
cost a copy (they win nothing): the median host seconds (ending in a
device sync) of one copy of 1 KB to ``--max-mb`` MB from pageable and from
pinned host memory, with MB/s; a 680x1200 frame as f32 colour + depth
against the u8 + u16 wire format; and whether two copies from two threads
overlap. On the host (``--device cpu``) there is no copy over PCIe: it
runs each once and reports nothing as the card's.
"""

from __future__ import annotations

import argparse
import sys
import threading
from typing import Dict, Optional

import numpy as np
import torch

from point_slam_tpu_torch.profiling import workload as W

SIZES = ((1 << 10, "1 KB"), (1 << 17, "128 KB"), (1 << 20, "1 MB"),
         ((1 << 21) + (1 << 19), "2.5 MB"), (1 << 22, "4 MB"),
         (10 << 20, "10 MB"), (13 << 20, "13 MB"))


def put_s(host: torch.Tensor, dev, reps: int) -> Optional[float]:
    """Median host seconds of one host->device copy, ending in a sync;
    None without a card (the copy is once, and no copy)."""
    host.to(dev)
    if dev.type != "cuda":
        return None
    ts = sorted(W.host_s(lambda: host.to(dev), dev)[1] for _ in range(reps))
    return ts[len(ts) // 2]


def shown(t: Optional[float], nbytes: Optional[int] = None) -> str:
    if t is None:
        return "not measured (cpu)"
    rate = "" if nbytes is None else f" ({nbytes / t / 1e6:.1f} MB/s)"
    return f"{t * 1e3:.4f} ms{rate}"


def run(dev, reps: int = 6, max_mb: float = 13.0) -> Dict:
    pin = dev.type == "cuda"
    out = {"sizes": {}}
    for nbytes, label in SIZES:
        if nbytes > max_mb * (1 << 20):
            continue
        row = out["sizes"][label] = {}
        for kind in ("pageable", "pinned"):
            host = torch.zeros(nbytes, dtype=torch.uint8,
                               pin_memory=pin and kind == "pinned")
            row[kind] = put_s(host, dev, reps)
        print(f"[upload] {label:<7} pageable "
              f"{shown(row['pageable'], nbytes)}, pinned "
              f"{shown(row['pinned'], nbytes)}", flush=True)
    rng = np.random.default_rng(0)
    h, w = 680, 1200
    c32 = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32))
    d32 = torch.from_numpy(rng.random((h, w), dtype=np.float32))
    c8 = (c32 * 255).to(torch.uint8)
    d16 = (d32 * 5000).to(torch.int16)
    for name, (a, b) in (("frame_f32_s", (c32, d32)),
                         ("frame_wire_s", (c8, d16))):
        ta, tb = put_s(a, dev, reps), put_s(b, dev, reps)
        out[name] = None if ta is None else ta + tb
    print(f"[upload] frame f32 (13.1 MB) {shown(out['frame_f32_s'])} | wire "
          f"u8 + u16 (4.1 MB) {shown(out['frame_wire_s'])}", flush=True)
    big = torch.zeros(10 << 20, dtype=torch.uint8, pin_memory=pin)
    out["single_s"] = put_s(big, dev, reps)

    def both():
        th = threading.Thread(target=lambda: big.to(dev))
        th.start()
        big.to(dev)
        th.join(timeout=60)
        if th.is_alive():
            raise RuntimeError("upload_micro: a copy thread did not finish")

    t = W.host_s(both, dev)[1]
    out["two_threads_s"] = t if pin else None
    print(f"[upload] two 10 MB copies from two threads "
          f"{shown(out['two_threads_s'])} (one alone "
          f"{shown(out['single_s'])}; serial would be ~2x)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--max-mb", type=float, default=13.0)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "upload_micro")
    out = run(dev, args.reps, args.max_mb)
    W.save_json("upload_micro_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
