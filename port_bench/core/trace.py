"""The device trace of the window: ``torch.profiler`` over CUDA activity
(kernels, copies, memsets and the runtime calls that launch them; no host
operators, whose recording would double the host's time in this
launch-bound loop), reduced to the device's busy time, the device time
launched inside each of the benchmark's spans, the kernels that took most
time, and the longest idle gaps by what the host was doing.

A kernel belongs to a span when the runtime call that launched it (the
host event with the kernel's correlation id) started inside the span,
whose bounds the driver took on the profiler's clock (nanoseconds since
the epoch). Idle time is the window's time with no kernel, copy or memset
on the device; a gap is named after the span and the runtime call that
launched the work that ends it (``map_frame:cudaLaunchKernel``).

Given the program's own span records (``--trace 1``), each operation is
also credited to the innermost program span open at its launch
(``core/stages.py``): device seconds and operations by stage, each
operation's owner, and gaps named after both spans
(``map_frame/map.backward:cudaLaunchKernel``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def start(device: str = "cuda"):
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA if device == "cuda"
            else ProfilerActivity.CPU]
    prof = profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)
    prof.start()
    if device == "cuda":
        torch.cuda.synchronize()
    return prof


def reduce(prof, t0_ns: int, t1_ns: int,
           spans: Dict[str, List[Tuple[int, int]]],
           records: Optional[Sequence[Any]] = None
           ) -> Dict[str, Any]:
    """The window [t0_ns, t1_ns] of a stopped profiler: busy seconds,
    device seconds launched inside each span name, the device operations
    by time and the idle gaps by span and runtime call (ten each).

    Device events are those on a CUDA device; the host events of a trace
    of CUDA activity are the runtime calls, each sharing its correlation
    id with the device work it launched.

    With the program's span ``records`` also ``by_stage`` (device seconds
    and operations by the innermost program span that launched them),
    ``stage_owner`` (each operation's record index, -1 for none, in the
    order of the window's operations by start), ``stage_by_thread``
    (whether the launching thread matched), and gaps named
    ``<span>/<program span>:<runtime call>``."""
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    launches: Dict[int, Tuple[int, Any]] = {}        # corr: t, event
    device: List[Tuple[int, int, int, str]] = []     # start, end, corr, name
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            s = ev.start_ns()
            if s < t1_ns:
                device.append((s, s + ev.duration_ns(), ev.correlation_id(),
                               ev.name()))
        else:
            launches[ev.correlation_id()] = (ev.start_ns(), ev)
    device = [d for d in device if d[1] > t0_ns and d[0] < t1_ns]
    device.sort()
    # busy: the union of device intervals, clipped to the window
    merged: List[List[int]] = []
    for s, e, _, _ in device:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, _, name in device:
        by_name[name] += (e - s) * 1e-9
    # device time by the span its launch fell in
    dur = np.array([e - s for s, e, _, _ in device], np.int64)
    launch = np.array([launches.get(c, (-1,))[0] for _, _, c, _ in device],
                      np.int64)
    in_span: Dict[str, float] = {}
    where = np.full(len(device), "", dtype=object)
    for name, ranges in spans.items():
        ranges = sorted(ranges)
        rs = np.array([r[0] for r in ranges], np.int64)
        re_ = np.array([r[1] for r in ranges], np.int64)
        i = np.searchsorted(rs, launch, side="right") - 1
        inside = (i >= 0) & (launch >= 0) & (launch <= re_[np.maximum(i, 0)])
        in_span[name] = float(dur[inside].sum()) * 1e-9
        if name != "ray_grid_knn":
            where[inside] = name
    owner = None
    if records:
        # imported here: this module also loads on its own, by path, where
        # the harness's ``core`` package is not importable
        from core import stages
        lthread = np.array([launches[c][1].start_thread_id()
                            if c in launches else -1
                            for _, _, c, _ in device], np.int64)
        owner, by_thread = stages.credit(records, launch, lthread)
    # idle gaps by the span and runtime call that launched what ends them
    gaps: Dict[str, float] = defaultdict(float)
    nxt = 0
    for (_, e_prev), (s_next, _) in zip(merged, merged[1:]):
        while nxt < len(device) and device[nxt][0] < s_next:
            nxt += 1
        if nxt >= len(device):
            break
        ln = launches.get(device[nxt][2])
        call = ln[1].name() if ln else "unattributed"
        span = where[nxt] or "loop"
        if owner is not None:
            o = owner[nxt]
            span += "/" + (records[o].name if o >= 0 else "-")
        gaps[f"{span}:{call}"] += (s_next - e_prev) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    out = {"busy_s": busy * 1e-9, "window_s": (t1_ns - t0_ns) * 1e-9,
           "device_s_in_span": in_span, "n_device_ops": len(device),
           "device_ops": [[n, v] for n, v in top],
           "idle_gaps": [[n, v] for n, v in top_gaps]}
    if owner is not None:
        out["by_stage"] = stages.by_stage(records, owner, device, t0_ns,
                                          t1_ns)
        out["stage_owner"] = owner
        out["stage_by_thread"] = by_thread
    return out
