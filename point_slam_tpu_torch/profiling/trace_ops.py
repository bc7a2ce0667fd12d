"""Op-level trace of the port's SLAM loop.

    python -m point_slam_tpu_torch.profiling.trace_ops capture [OUTDIR]
        [--device cuda|cpu] [--small] [--cuda-overrides JSON]
        [--warm 10] [--traced 5] [--iters-first 300] [--iters 300]
    python -m point_slam_tpu_torch.profiling.trace_ops analyze TRACE
        [--top 30]

``capture`` runs bench.py's shapes through ``PointSLAM`` (``--small``: a
48x64 camera and a few hundred rays, for the host): frame 0 mapped, frames
1..``--warm`` tracked and every 5th mapped as the loop does, then frames
``--warm``+1..``--warm``+``--traced`` under ``torch.profiler`` (CPU and
CUDA activity), written as a Chrome trace ``OUTDIR/trace.json`` (default
``output/trace_ops_torch``). ``--cuda-overrides`` updates the config's
``cuda:`` section (a JSON object).

``analyze`` reads such a trace (a file, or the newest ``*.json`` in a
directory) and prints, for each CUDA stream, the busy ms (the summed
kernel, copy and set durations), the traced window's wall ms and the top
kernels by total duration, one row each in the format
``roofline.parse_trace`` reads (names with their spaces removed). A trace
with no device activity says so and reports no busy time; a host run's
trace is then listed by its host threads' operators instead.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
from collections import defaultdict
from typing import Dict, List, Optional

from point_slam_tpu_torch.profiling import workload as W

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
DEFAULT_OUT = os.path.join(W.OUTPUT, "trace_ops_torch")


def capture(outdir: str, dev, small: bool = False,
            overrides: Optional[Dict] = None, warm: int = 10,
            traced: int = 5, iters_first: int = 300, iters: int = 300
            ) -> str:
    """Warm the loop, trace ``traced`` frames; returns the trace's path."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from point_slam_tpu_torch.slam import PointSLAM

    cfg = W.bench_config(warm + traced + 1, iters_first=iters_first,
                         small=small)
    cfg["mapping"].update({"iters": iters,
                           "geo_iter_first": max(iters_first // 3, 1)})
    cfg["cuda"].update(overrides or {})
    cfg["data"]["output"] = os.path.join(DEFAULT_OUT, "run")
    slam = PointSLAM(cfg, device=dev)
    every = cfg["mapping"]["every_frame"]
    color, depth, gt = slam._frame(0)
    slam.estimate_c2w_list[0] = gt
    slam.gt_c2w_list[0] = gt
    _, t = W.host_s(lambda: slam.mapper.map_frame(0, color, depth, gt, gt),
                    dev)
    print(f"[trace_ops] frame 0 mapped in {t:.2f} s "
          f"({slam.mapper.n_points_host} points)", flush=True)

    def run_frame(idx):
        color, depth, gt = slam._frame(idx)
        color = torch.as_tensor(color, device=dev)
        depth = torch.as_tensor(depth, device=dev)
        slam.gt_c2w_list[idx] = gt
        radius = slam.mapper.radius_maps(color)
        res = slam.tracker.track_frame(idx, color, depth, gt,
                                       slam.estimate_c2w_list, slam.mapper,
                                       radius[1])
        slam.estimate_c2w_list[idx] = res["c2w"]
        if idx % every == 0:
            st = slam.mapper.map_frame(idx, color, depth, gt,
                                       slam.estimate_c2w_list[idx],
                                       radius=radius)
            slam.estimate_c2w_list[idx] = st["cur_c2w"]
            return True
        return False

    for idx in range(1, warm + 1):
        mapped, t = W.host_s(lambda: run_frame(idx), dev)
        print(f"[trace_ops] warm frame {idx} mapped={mapped} {t:.2f} s",
              flush=True)
    frames = list(range(warm + 1, warm + traced + 1))
    print(f"[trace_ops] tracing frames {frames[0]}..{frames[-1]} "
          f"({sum(i % every == 0 for i in frames)} mapped)", flush=True)
    acts = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for idx in frames:
            run_frame(idx)
        W.sync(dev)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[trace_ops] trace written to {path}", flush=True)
    if not np.isfinite(slam.estimate_c2w_list[frames[-1]]).all():
        raise RuntimeError("trace_ops: a traced frame's pose is not finite")
    return path


def _load(path: str) -> List[Dict]:
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "**", "*.json*"),
                                 recursive=True), key=os.path.getmtime)
        if not found:
            raise FileNotFoundError(f"no *.json trace under {path}")
        path = found[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _name(ev) -> str:
    return re.sub(r"\s+", "", ev.get("name", "?")) or "?"


def _rows(events, total_us: float) -> List[str]:
    """One row a name, by total duration: ms, share, count, name."""
    agg = defaultdict(lambda: [0.0, 0])          # name -> [us, count]
    for ev in events:
        a = agg[_name(ev)]
        a[0] += float(ev.get("dur", 0.0))
        a[1] += 1
    return [f"  {us / 1e3:9.4f} ms {100.0 * us / max(total_us, 1e-9):5.1f}%  "
            f"x{cnt:<6} {name}"
            for name, (us, cnt) in sorted(agg.items(),
                                          key=lambda kv: -kv[1][0])]


def analyze(path: str, top: int = 30, quiet: bool = False) -> Dict:
    """Per-stream busy ms, the window's wall ms and the kernels of a Chrome
    trace, by total duration; prints the ``top`` of each stream unless
    ``quiet``. Returns {"device": bool, "window_ms", "streams": {stream:
    {"busy_ms", "events"}}, "listing": every row, for
    roofline.parse_trace}; streams is empty and device False when the trace
    holds no device activity (a host run's operators are listed then)."""
    events = [e for e in _load(path) if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no complete events in the trace")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    window_ms = (t1 - t0) / 1e3
    dev_events = [e for e in events if e.get("cat") in DEVICE_CATS]
    shown = [f"=== trace {path}: window {window_ms:.4f} ms wall"]
    listing = []
    out = {"device": bool(dev_events), "window_ms": window_ms,
           "streams": {}, "listing": listing}
    if dev_events:
        groups = defaultdict(list)
        for e in dev_events:
            groups[e.get("args", {}).get("stream", e.get("tid"))].append(e)
        what = "stream"
    else:
        shown.append("no device activity recorded in this trace: device "
                     "busy not measured")
        groups = defaultdict(list)
        for e in events:
            if e.get("cat") == "cpu_op":
                groups[e.get("tid")].append(e)
        what = "host thread"
    for key, evs in sorted(groups.items(), key=lambda kv: str(kv[0])):
        us = sum(float(e["dur"]) for e in evs)
        if dev_events:
            out["streams"][key] = {"busy_ms": us / 1e3, "events": len(evs)}
            head = (f"busy={us / 1e3:.4f} ms of {window_ms:.4f} ms wall "
                    f"({100 * us / 1e3 / window_ms:.1f}%)")
        else:
            head = "host time, nested operators counted in each"
        rows = _rows(evs, us)
        listing += rows
        shown += [f"\n-- {what} {key}: events={len(evs)}  {head}"]
        shown += rows[:top]
    if not quiet:
        print("\n".join(shown), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("capture", "analyze"))
    ap.add_argument("path", nargs="?", default=None,
                    help="capture: the output directory; analyze: a trace "
                         "file or directory")
    W.add_device_arg(ap)
    ap.add_argument("--small", action="store_true",
                    help="a 48x64 camera and a few hundred rays")
    ap.add_argument("--cuda-overrides", default=None,
                    help="a JSON object merged into the cuda: section")
    ap.add_argument("--warm", type=int, default=10)
    ap.add_argument("--traced", type=int, default=5)
    ap.add_argument("--iters-first", type=int, default=300)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    if args.mode == "analyze":
        if args.path is None:
            ap.error("analyze needs a trace file or directory")
        return analyze(args.path, args.top)
    dev = W.device(args.device, "trace_ops")
    path = capture(args.path or DEFAULT_OUT, dev, args.small,
                   json.loads(args.cuda_overrides)
                   if args.cuda_overrides else None,
                   args.warm, args.traced, args.iters_first, args.iters)
    return analyze(path, args.top)


if __name__ == "__main__":
    main(sys.argv[1:])
