"""The program's own spans (``PointSLAM.spans``, recorded in ``--trace
1`` runs) against the device trace: which stage launched each device
operation, and the stage figures of the window.

The rule is copied from the program's ``profiling/span_breakdown.py``
(``innermost``, ``breakdown``, ``stage_figures``) so that a change to the
program cannot move it. An operation belongs to the innermost span open
when the runtime call that launched it started: on the launching thread
where the profiler's thread ids are the records'; otherwise on the
schedule's thread (the thread of the ``frame`` spans), so that the reader
thread's spans take no launch of the main thread, and the reader's own
few launches go to the main thread's span open at that time. (PyTorch
2.11's CUDA traces give every runtime call the thread id 1, so on the
card the time decides.)
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

ITERS = (("track.iter", "tracker.ops_per_iter"),
         ("map.iter", "mapper.ops_per_iter"))


# A record is one of the program's spans as ``PointSLAM.spans.records()``
# hands it out (``utils/spans.Record``): ``index`` its place in the list,
# ``name``, ``parent`` (the index of the span around it, -1 for none),
# ``frame``, ``thread``, ``t0``/``t1`` (ns since the epoch), ``counts``
# (the counters added while it was innermost, or None).
Record = Any


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


def credit(records: Sequence[Record], launch_ns: np.ndarray,
           launch_thread: np.ndarray) -> Tuple[np.ndarray, bool]:
    """Each operation's owner (the index of the innermost record open at
    its launch, -1 for none or for an operation whose launch the trace
    lacks, ``launch_ns`` < 0), and whether the launching thread picked
    it (True) or the time on the schedule's thread did (False)."""
    rec_threads = {r.thread for r in records}
    by_thread = bool(len(launch_ns)) and bool(
        set(launch_thread.tolist()) & rec_threads)
    if by_thread:
        owner = innermost(records, launch_ns, launch_thread)
    else:
        main = {r.thread for r in records if r.name == "frame"}
        # records of other threads hold no launch; the indices stay
        owner = innermost([r for r in records
                           if not main or r.thread in main], launch_ns)
    owner[launch_ns < 0] = -1
    return owner, by_thread


def by_stage(records: Sequence[Record], owner: np.ndarray,
             ops: Sequence[Tuple[int, int, int, str]], t0_ns: int,
             t1_ns: int) -> Dict[str, Dict[str, float]]:
    """Device seconds (clipped to the window) and operations by the name
    of the innermost span that launched them ("-" for none)."""
    n = len(ops)
    start = np.fromiter((o[0] for o in ops), np.int64, n)
    end = np.fromiter((o[1] for o in ops), np.int64, n)
    dur = np.minimum(end, t1_ns) - np.maximum(start, t0_ns)
    names = list(dict.fromkeys([r.name for r in records] + ["-"]))
    code = {name: i for i, name in enumerate(names)}
    of_rec = np.array([code[r.name] for r in records] + [code["-"]],
                      np.int64)
    which = of_rec[np.where(owner >= 0, owner, len(records))]
    count = np.bincount(which, minlength=len(names))
    secs = np.bincount(which, weights=dur, minlength=len(names))
    return {name: {"device_s": float(secs[i]) * 1e-9, "ops": int(count[i])}
            for i, name in enumerate(names) if count[i]}


def under(records: Sequence[Record], names: Sequence[str]) -> np.ndarray:
    """For each record, the index of its nearest ancestor-or-self named
    one of ``names``; -1 where none is."""
    out = np.full(len(records), -1, np.int64)
    for r in records:
        if r.name in names:
            out[r.index] = r.index
        elif r.parent >= 0:
            out[r.index] = out[r.parent]       # parents come first
    return out


def figures(records: Sequence[Record], frames: Sequence[int],
            owner: Optional[np.ndarray] = None
            ) -> Dict[str, Optional[float]]:
    """The stage figures over the records of ``frames``: walls in ms a
    span, a mapped frame or a frame; ``*.ops_per_iter`` from the
    operations' owners (None without a trace or with no operation)."""
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
    if owner is not None and len(owner):
        it_of = under(records, [n for n, _ in ITERS])
        hit = owner >= 0
        it_idx = np.where(hit, it_of[np.maximum(owner, 0)], -1)
        for name, key in ITERS:
            ids = {r.index for r in win if r.name == name}
            if ids:
                n = int(np.isin(it_idx, list(ids)).sum())
                out[key] = n / len(ids)
    return out


def of(run) -> Dict[str, Optional[float]]:
    """The stage figures of a run's window (frames ``every+1`` to
    ``every+frames``), worked out once a run; all None where the run
    recorded no spans (``--trace 0``)."""
    got = getattr(run, "_stage_figures", None)
    if got is None:
        recs = getattr(run, "records", None) or []
        frames = (range(run.every + 1, run.every + run.frames + 1)
                  if recs else ())
        got = run._stage_figures = figures(
            recs, frames, (run.trace or {}).get("stage_owner"))
    return got
