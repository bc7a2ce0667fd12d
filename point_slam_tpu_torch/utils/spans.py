"""Spans and counters of the program's own stages, on the profiler's clock.

``PointSLAM`` owns one recorder, ``slam.spans``; the schedule opens the
outer spans on it (``frame``, ``track_frame``, ``map_frame``, ...) and the
reader thread its own (``reader.fetch``, ``reader.stage``). Code below the
schedule (the tracker's and mapper's loops, the renderer, the kNN, the
keyframe store) opens its spans with the module-level ``span`` and adds to
counters with ``count``: both act on the innermost span open on the
calling thread, and do nothing where none is. A span records its name,
its parent, its frame (the parent's unless given; the frame index is the
id a frame's spans share), its iteration, its thread and its bounds; a
counter adds to the innermost open span, so ratios are taken where the
work happens. Records stay in memory and are handed out after the run by
``Spans.records()``; nothing is written per span.

Clock: ``time.perf_counter_ns`` moved to nanoseconds since the epoch by an
offset taken once when recording starts, the clock ``torch.profiler``
stamps its events with, so each device operation can be put inside the
innermost span whose bounds hold its launch.

Recording is off by default: a span then costs one attribute check and a
shared no-op context, with no clock read. ``Spans.timed`` is the one
exception, for the schedule's spans that feed ``PointSLAM.timing`` and the
reader's totals: it always reads the clock and gives its wall in ``.s``,
and records only when recording is on. ``enable()`` turns recording on
(``PointSLAM.run`` does with ``cuda.profile_dir``); with ``ranges`` each
span also opens a ``torch.profiler.record_function`` range of its name, so
a Chrome trace of the run shows the stages.

A span never touches the device: it adds no read, copy, sync or kernel. A
``sync.*`` span wraps a host read of the device that the program makes
anyway, and every such read on the main path sits in exactly one.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

# .stack: this thread's open spans, innermost last. Per thread, so that
# code below the schedule (the renderer, the kNN, Adam) finds the run's
# recorder without a parameter through every signature.
_tls = threading.local()


class Record:
    """One span: ``index`` is its place in its recorder's records,
    ``parent`` the index of the enclosing span there (-1 for none),
    ``thread`` its thread's ``threading.get_ident()``; ``t0``/``t1``
    nanoseconds since the epoch; ``counts`` the counters added while it
    was innermost."""

    __slots__ = ("index", "name", "parent", "frame", "it", "thread", "t0",
                 "t1", "counts")

    def __init__(self, index, name, parent, frame, it, thread, t0):
        self.index, self.name, self.parent = index, name, parent
        self.frame, self.it, self.thread = frame, it, thread
        self.t0, self.t1 = t0, 0
        self.counts: Optional[Dict[str, int]] = None

    def __repr__(self):
        return (f"Record({self.name!r}, parent={self.parent}, "
                f"frame={self.frame}, it={self.it}, "
                f"ms={(self.t1 - self.t0) * 1e-6:.3f}, counts={self.counts})")


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, name: str, n: int) -> None:
        pass


NULL = _Null()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
        _tls.tid = threading.get_ident()
    return st


class _Open:
    """An open span of ``owner``. ``ns`` (and ``s``) is its wall after it
    closes; ``rec`` its record, None when the owner is not recording."""

    __slots__ = ("owner", "name", "frame", "it", "rec", "fn", "t0", "ns")

    def __init__(self, owner, name, frame, it):
        self.owner, self.name, self.frame, self.it = owner, name, frame, it
        self.rec = self.fn = None
        self.ns = 0

    def __enter__(self):
        o = self.owner
        if o.on:
            st = _stack()
            parent = -1
            frame = self.frame
            if st and st[-1].owner is o:
                top = st[-1].rec
                parent = top.index
                if frame is None:
                    frame = top.frame
            self.t0 = time.perf_counter_ns()
            rec = Record(len(o._records), self.name, parent, frame, self.it,
                         _tls.tid, self.t0 + o.offset_ns)
            o._records.append(rec)
            self.rec = rec
            st.append(self)
            if o.ranges:
                self.fn = torch.profiler.record_function(self.name)
                self.fn.__enter__()
        else:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.ns = t1 - self.t0
        rec = self.rec
        if rec is not None:
            if self.fn is not None:
                self.fn.__exit__(*exc)
            rec.t1 = t1 + self.owner.offset_ns
            _tls.stack.pop()
        return False

    @property
    def s(self) -> float:
        return self.ns * 1e-9

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to counter ``name`` of this span, open or closed (a
        count the host learns only after the span, at a later read)."""
        if self.rec is not None:
            _add(self.rec, name, n)

    def set_frame(self, frame: int) -> None:
        """Name the frame once it is known (the schedule learns it from
        the reader, inside the span)."""
        self.frame = frame
        if self.rec is not None:
            self.rec.frame = frame


class Spans:
    """The recorder: off until ``enable``."""

    def __init__(self):
        self.on = False
        self.ranges = False
        self.offset_ns = 0
        self._records: List[Record] = []

    def enable(self, ranges: bool = False) -> "Spans":
        """Record from now on; ``ranges``: also open a profiler range per
        span."""
        if not self.on:
            self.offset_ns = time.time_ns() - time.perf_counter_ns()
            self.on = True
        self.ranges = self.ranges or ranges
        return self

    def span(self, name: str, frame: Optional[int] = None,
             it: Optional[int] = None):
        """A span on this recorder, recorded when recording is on."""
        if not self.on:
            return NULL
        return _Open(self, name, frame, it)

    def timed(self, name: str, frame: Optional[int] = None) -> _Open:
        """A span whose wall (``.s``) is read whether or not recording is
        on: the schedule's buckets and the reader's totals."""
        return _Open(self, name, frame, None)

    def records(self) -> List[Record]:
        """Every span recorded, in the order they opened; ``index`` is a
        record's place in this list."""
        return list(self._records)


def span(name: str, it: Optional[int] = None):
    """A span under the innermost span open on this thread, on its
    recorder and frame; a no-op where none is open."""
    st = getattr(_tls, "stack", None)
    if not st:
        return NULL
    return _Open(st[-1].owner, name, None, it)


def count(name: str, n: int) -> None:
    """Add ``n`` (a host number) to counter ``name`` of the innermost span
    open on this thread; nothing where none is."""
    st = getattr(_tls, "stack", None)
    if st:
        _add(st[-1].rec, name, n)


def _add(rec: Record, name: str, n: int) -> None:
    if rec.counts is None:
        rec.counts = {name: n}
    else:
        rec.counts[name] = rec.counts.get(name, 0) + n


def upload(x, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype, device)``. A copy from the host (a
    number, a list, a numpy array, a tensor on another device) sits in a
    ``sync.upload`` span: from pageable memory it blocks the host until
    the device's queue has drained."""
    device = torch.device(device)
    if isinstance(x, torch.Tensor) and x.device.type == device.type:
        return torch.as_tensor(x, dtype=dtype, device=device)
    with span("sync.upload"):
        return torch.as_tensor(x, dtype=dtype, device=device)


def innermost() -> Optional[Record]:
    """The record of the innermost span open on this thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1].rec if st else None
