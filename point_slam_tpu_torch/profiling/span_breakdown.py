"""Where a run's time goes, by the program's own spans.

    python -m point_slam_tpu_torch.profiling.span_breakdown
        [--frames 11] [--window-from 6] [--device cuda|cpu] [--small]

Runs ``PointSLAM`` on the bench workload (``workload.bench_config``: the
synthetic room at 680x1200 with Replica's schedule; ``--small`` for a run
on the host) with its spans recording (``utils/spans.py``) and, on the
card, ``torch.profiler`` over CUDA activity from frame ``--window-from``
on. Each device operation is credited to the innermost span open on the
launching thread when its runtime call started (the spans are on the
profiler's clock), and each idle gap to the innermost span that launched
the work ending it (``map.backward:cudaLaunchKernel``). Prints, for each
span name, host ms a window frame, device ms launched, operations
launched and count, then the longest gaps and the stage figures
(``stage_figures``): iteration walls, operations an iteration, the host's
syncs, densification, the keyframe window, the kNN's fallback share.

``breakdown`` and ``stage_figures`` take a stopped profiler and the
records of any run, for callers that drive ``PointSLAM`` themselves. On
the host no operation is timed: the stage figures from spans only.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from point_slam_tpu_torch.profiling import workload as W
from point_slam_tpu_torch.utils.spans import Record


def innermost(records: Sequence[Record], times_ns: np.ndarray,
              threads: Optional[np.ndarray] = None) -> np.ndarray:
    """For each time (on each thread, or on any where ``threads`` is
    None), the index of the innermost record whose bounds hold it; -1
    where none does. Spans on one thread nest, so each thread's timeline
    is cut into segments that each belong to one innermost span."""
    out = np.full(len(times_ns), -1, np.int64)
    by_thread: Dict[int, List[Record]] = defaultdict(list)
    for r in records:
        by_thread[r.thread if threads is not None else 0].append(r)
    for th, recs in by_thread.items():
        edges: List[Tuple[int, int, int]] = []      # time, order, record
        for r in recs:
            edges.append((r.t0, 1, r.index))
            edges.append((r.t1, 0, r.index))
        edges.sort()
        starts, owner, stack = [], [], []
        for t, opening, idx in edges:
            if opening:
                stack.append(idx)
            elif stack and stack[-1] == idx:
                stack.pop()
            elif idx in stack:                 # closed at its parent's end
                stack.remove(idx)
            starts.append(t)
            owner.append(stack[-1] if stack else -1)
        if not starts:
            continue
        sel = (np.ones(len(times_ns), bool) if threads is None
               else threads == th)
        pos = np.searchsorted(np.asarray(starts, np.int64),
                              times_ns[sel], side="right") - 1
        own = np.asarray(owner, np.int64)
        out[sel] = np.where(pos >= 0, own[np.maximum(pos, 0)], -1)
    return out


def read_trace(prof) -> Tuple[list, Dict[int, Tuple[int, int, str]]]:
    """A stopped profiler's device operations (start, end, correlation
    id, name) and runtime calls by correlation id (start, thread, name)."""
    from torch.autograd import DeviceType
    device, launches = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            s = ev.start_ns()
            device.append((s, s + ev.duration_ns(), ev.correlation_id(),
                           ev.name()))
        else:
            tid = getattr(ev, "start_thread_id", lambda: 0)()
            launches[ev.correlation_id()] = (ev.start_ns(), tid, ev.name())
    return device, launches


def breakdown(records: Sequence[Record], device: list,
              launches: Dict[int, Tuple[int, int, str]], t0_ns: int,
              t1_ns: int) -> Dict[str, Any]:
    """Device seconds and operations by innermost span name over the
    window [t0_ns, t1_ns], the busy and idle time, and the idle gaps by
    the span and runtime call that launched the work ending each. The
    launching thread picks the span where the profiler's thread ids are
    the spans'; otherwise (as with PyTorch 2.11's CUDA traces) any
    thread's span holding the launch time does, so the reader thread's few
    launches go to the main thread's span (``by_thread`` says which)."""
    ops = sorted(d for d in device if d[1] > t0_ns and d[0] < t1_ns)
    launch = np.array([launches.get(c, (-1, 0, ""))[0]
                       for _, _, c, _ in ops], np.int64)
    lthread = np.array([launches.get(c, (-1, 0, ""))[1]
                        for _, _, c, _ in ops], np.int64)
    rec_threads = {r.thread for r in records}
    by_thread = bool(len(ops)) and bool(set(lthread.tolist())
                                        & rec_threads)
    owner = innermost(records, launch, lthread if by_thread else None)
    owner[launch < 0] = -1
    dev_s: Dict[str, float] = defaultdict(float)
    n_ops: Dict[str, int] = defaultdict(int)
    for (s, e, _, _), o in zip(ops, owner):
        name = records[o].name if o >= 0 else "-"
        dev_s[name] += (min(e, t1_ns) - max(s, t0_ns)) * 1e-9
        n_ops[name] += 1
    merged: List[List[int]] = []
    for s, e, _, _ in ops:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps: Dict[str, float] = defaultdict(float)
    nxt = 0
    for (_, e_prev), (s_next, _) in zip(merged, merged[1:]):
        while nxt < len(ops) and ops[nxt][0] < s_next:
            nxt += 1
        if nxt >= len(ops):
            break
        o = owner[nxt]
        call = launches.get(ops[nxt][2], (0, 0, "unattributed"))[2]
        gaps[f"{records[o].name if o >= 0 else '-'}:{call}"] += \
            (s_next - e_prev) * 1e-9
    return {"busy_s": busy * 1e-9, "window_s": (t1_ns - t0_ns) * 1e-9,
            "device_s": dict(dev_s), "ops": dict(n_ops),
            "owner": owner, "n_ops": len(ops), "by_thread": by_thread,
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])}


def _under(records: Sequence[Record], names: Sequence[str]) -> np.ndarray:
    """For each record, the index of its nearest ancestor-or-self named
    one of ``names``; -1 where none is."""
    out = np.full(len(records), -1, np.int64)
    for r in records:
        if r.name in names:
            out[r.index] = r.index
        elif r.parent >= 0:
            out[r.index] = out[r.parent]       # parents come first
    return out


def stage_figures(records: Sequence[Record], frames: Sequence[int],
                  bd: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Optional[float]]:
    """The stage figures over the records of ``frames``: walls in ms,
    ``*.ops_per_iter`` from the breakdown ``bd`` (None without one)."""
    fs = set(frames)
    win = [r for r in records if r.frame in fs]

    def walls(name):
        return [(r.t1 - r.t0) * 1e-6 for r in win if r.name == name]

    def mean(v):
        return float(np.mean(v)) if v else None

    n_mapped = len(walls("map_frame"))
    t_it, m_it = walls("track.iter"), walls("map.iter")
    # the schedule's thread: the reader's syncs block only the reader
    main = {r.thread for r in win if r.name == "frame"}
    syncs = [r for r in win
             if r.name.startswith("sync.") and r.thread in main]
    rays = sum((r.counts or {}).get("rays", 0) for r in win)
    fallback = sum((r.counts or {}).get("rays_fallback", 0) for r in win)
    out = {
        "tracker.iter_host_ms": mean(t_it),
        "mapper.iter_host_ms": mean(m_it),
        "mapper.densify_ms": (sum(walls("map.densify")) / n_mapped
                              if n_mapped else None),
        "keyframes.window_ms": (sum(walls("map.window")) / n_mapped
                                if n_mapped else None),
        "host.sync_ms": (sum((r.t1 - r.t0) * 1e-6 for r in syncs)
                         / len(fs) if fs else None),
        "host.syncs_per_iter": (len(syncs) / (len(t_it) + len(m_it))
                                if t_it or m_it else None),
        "knn.fallback_pct": 100.0 * fallback / rays if rays else None,
        "tracker.ops_per_iter": None, "mapper.ops_per_iter": None,
    }
    if bd is not None and bd["n_ops"]:
        it_of = _under(records, ("track.iter", "map.iter"))
        owner = bd["owner"]
        hit = owner >= 0
        it_idx = np.where(hit, it_of[np.maximum(owner, 0)], -1)
        for name, key in (("track.iter", "tracker.ops_per_iter"),
                          ("map.iter", "mapper.ops_per_iter")):
            ids = {r.index for r in win if r.name == name}
            if ids:
                n = int(np.isin(it_idx, list(ids)).sum())
                out[key] = n / len(ids)
    return out


def table(records: Sequence[Record], frames: Sequence[int],
          bd: Optional[Dict[str, Any]] = None) -> str:
    """Per span name: host ms a frame (the spans' own wall, children
    included), device ms and operations launched while it was innermost,
    and count, over ``frames``."""
    fs = set(frames)
    host: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for r in records:
        if r.frame in fs:
            host[r.name] += (r.t1 - r.t0) * 1e-6
            count[r.name] += 1
    dev = bd["device_s"] if bd else {}
    ops = bd["ops"] if bd else {}
    lines = [f"{'span':24s} {'host ms/frame':>14s} {'device ms':>11s} "
             f"{'ops':>9s} {'count':>7s}"]
    for name in sorted(set(host) | set(dev), key=lambda k: -host.get(k, 0)):
        lines.append(f"{name:24s} {host.get(name, 0.0) / len(fs):14.3f} "
                     f"{1e3 * dev.get(name, 0.0):11.3f} "
                     f"{ops.get(name, 0):9d} {count.get(name, 0):7d}")
    return "\n".join(lines)


def run(cfg, dev, frames: int, window_from: int,
        input_folder: Optional[str] = None) -> Dict[str, Any]:
    """Track and map frames 0..frames-1, recording spans; on the card
    the profiler traces the frames from ``window_from`` on (it starts as
    frame ``window_from - 1``, a mapped one, returns). Returns the
    records, the window's frames, its breakdown (None on the host) and
    its figures."""
    from point_slam_tpu_torch.slam import PointSLAM
    slam = PointSLAM(cfg, input_folder=input_folder, device=str(dev))
    slam.spans.enable()
    state: Dict[str, Any] = {"prof": None, "t0": None}
    mapper = slam.mapper
    orig = mapper.map_frame

    def map_frame(idx, *a, **kw):
        out = orig(idx, *a, **kw)
        if idx == window_from - 1 and dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            state["prof"] = profile(activities=[ProfilerActivity.CUDA])
            state["prof"].start()
            torch.cuda.synchronize()
            state["t0"] = time.time_ns()
        return out

    mapper.map_frame = map_frame
    try:
        slam.run(stop=frames - 1)
    finally:
        del mapper.map_frame
    window = list(range(window_from, frames))
    bd = None
    if state["prof"] is not None:
        torch.cuda.synchronize()
        t1 = time.time_ns()
        state["prof"].stop()
        device, launches = read_trace(state["prof"])
        bd = breakdown(slam.spans.records(), device, launches,
                       state["t0"], t1)
    recs = slam.spans.records()
    return {"records": recs, "frames": window, "breakdown": bd,
            "figures": stage_figures(recs, window, bd),
            "iters": {i: s["n_iters"] for i, s in
                      sorted(slam.mapper.frame_stats.items())}}


def report(out: Dict[str, Any]) -> str:
    bd = out["breakdown"]
    lines = [table(out["records"], out["frames"], bd)]
    if bd is not None:
        lines.append(f"busy {bd['busy_s']:.4f} s of {bd['window_s']:.4f} "
                     f"({100 * (1 - bd['busy_s'] / bd['window_s']):.2f}% "
                     f"idle), {bd['n_ops']} operations, spans matched by "
                     f"{'thread' if bd['by_thread'] else 'time alone'}")
        lines += [f"gap {k:48s} {v:9.4f} s" for k, v in bd["idle_gaps"][:15]]
    lines += [f"{k:24s} {v!r}" for k, v in out["figures"].items()]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=11)
    ap.add_argument("--window-from", type=int, default=6)
    ap.add_argument("--small", action="store_true")
    W.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "span_breakdown")
    cfg = W.bench_config(args.frames, small=args.small)
    cfg["verbose"] = False
    out = run(cfg, dev, args.frames, args.window_from)
    print(f"iterations {out['iters']}")
    print(report(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
