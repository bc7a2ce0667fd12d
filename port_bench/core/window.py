"""The measured window: whole mapping periods from a fixed frame.

Point-SLAM's schedule tracks every frame and maps every ``every_frame``-th
one; a *period* is ``every_frame`` frames, all tracked, the last one
mapped. Warm-up is counted in frames: frame 0 (mapped with
``iters_first``) and then one whole period, so every run's window starts
at frame ``every_frame + 1``. The window is a whole number of periods: it
opens when the warm-up period's mapped frame returns and each period ends
when its mapped frame returns. Before a period's first frame is tracked
the driver asks whether the running mean of the window's periods (the
warm-up period's length before the first) would take it past the run's
seconds; if so the window closes there, by raising ``WindowClosed`` out of
the program's loop. A period always ends in a device sync, since the
mapped frame's results are read back to the host.

``Driver`` wraps the calls ``PointSLAM.run`` makes into
``Tracker.track_frame``, ``Mapper.map_frame`` and ``ops.knn.ray_grid_knn``
and records a span for each (name, frame, start, end) on the host's
clock and on the profiler's (nanoseconds since the epoch); the kNN's
spans only inside the window.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional


class WindowClosed(Exception):
    """Raised from the tracker's wrapper to end the program's loop."""


class Span(NamedTuple):
    name: str
    frame: int
    t0: float
    t1: float
    t0_ns: int = 0       # the same bounds on the profiler's clock
    t1_ns: int = 0


class Mark(NamedTuple):
    """A period boundary: the mapped frame, its end on the profiler's
    clock (ns since the epoch), and the program's wait bucket
    (``PointSLAM.timing["wait"]``) there."""
    frame: int
    t_ns: int
    wait_s: float


def first_window_frame(every: int) -> int:
    """Frame 0 and one whole period warm up; the window starts after."""
    return every + 1


def whole_periods(spans: List[Span], every: int):
    """(frames, seconds) of the window's whole periods: from the end of
    the warm-up period's mapped frame to the end of the last mapped frame
    that closes a period. Frames tracked after it (a period the window
    did not finish) count for nothing."""
    ends = {s.frame: s.t1 for s in spans if s.name == "map_frame"}
    start = ends.get(every)
    if start is None:
        return 0, 0.0
    last = None
    k = 2
    while k * every in ends:
        last = k * every
        k += 1
    if last is None:
        return 0, 0.0
    return last - every, ends[last] - start


def fps(spans: List[Span], every: int) -> Optional[float]:
    frames, secs = whole_periods(spans, every)
    return frames / secs if frames and secs > 0 else None


class Driver:
    """Wraps a PointSLAM's tracker and mapper calls and the kNN entry for
    one run; decides where the window opens and closes."""

    def __init__(self, slam, seconds: float, every: int,
                 on_open: Callable[[], None], on_close: Callable[[], None],
                 knn_module, on_knn=None,
                 on_frame: Optional[Callable[[str, int, bool], None]] = None,
                 on_last_warm: Optional[Callable[[], None]] = None):
        self.slam = slam
        self.seconds = float(seconds)
        self.every = int(every)
        self.first = first_window_frame(every)
        self.on_open, self.on_close = on_open, on_close
        self.on_knn = on_knn                # (q_rays, index, probes, k)
        self.on_frame = on_frame            # (name, idx, in_window)
        self.on_last_warm = on_last_warm    # before the warm-up's mapping
        self.spans: List[Span] = []
        self.marks: List[Mark] = []
        self.t_open: Optional[float] = None
        self.warm_period_s: Optional[float] = None
        self.closed_by = None
        self._t_warm0: Optional[float] = None
        self._knn_module = knn_module
        self._orig_knn = knn_module.ray_grid_knn
        self._in_window = False
        tracker, mapper = slam.tracker, slam.mapper
        self._orig_track = tracker.track_frame
        self._orig_map = mapper.map_frame
        tracker.track_frame = self._track
        mapper.map_frame = self._map
        knn_module.ray_grid_knn = self._knn

    def restore(self) -> None:
        self._knn_module.ray_grid_knn = self._orig_knn
        del self.slam.tracker.track_frame
        del self.slam.mapper.map_frame

    def _period_mean(self) -> float:
        frames, secs = whole_periods(self.spans, self.every)
        n = frames // self.every
        return secs / n if n else self.warm_period_s

    def _track(self, idx, *args, **kwargs):
        if self._in_window and (idx - 1) % self.every == 0:
            elapsed = time.perf_counter() - self.t_open
            if (idx > self.first
                    and elapsed + self._period_mean() > self.seconds):
                self._close("seconds")
                raise WindowClosed(idx)
        if idx == 1:
            self._t_warm0 = time.perf_counter()
        if self.on_frame:
            self.on_frame("track_frame", idx, self._in_window)
        n0, t0 = time.time_ns(), time.perf_counter()
        out = self._orig_track(idx, *args, **kwargs)
        t1, n1 = time.perf_counter(), time.time_ns()
        self.spans.append(Span("track_frame", idx, t0, t1, n0, n1))
        return out

    def _map(self, idx, *args, **kwargs):
        if idx == self.every and not self._in_window and self.on_last_warm:
            self.on_last_warm()
        if self.on_frame:
            self.on_frame("map_frame", idx, self._in_window)
        n0, t0 = time.time_ns(), time.perf_counter()
        out = self._orig_map(idx, *args, **kwargs)
        t1, n1 = time.perf_counter(), time.time_ns()
        self.spans.append(Span("map_frame", idx, t0, t1, n0, n1))
        if idx % self.every == 0 and (self._in_window or idx == self.every):
            self.marks.append(Mark(idx, n1,
                                   float(self.slam.timing["wait"])))
        if idx == self.every and not self._in_window:
            self.warm_period_s = t1 - (self._t_warm0 or t0)
            self._in_window = True
            self.t_open = t1
            self.on_open()
        return out

    def _knn(self, index, q_rays, k=8, probes=0):
        if not self._in_window:
            return self._orig_knn(index, q_rays, k=k, probes=probes)
        if self.on_knn:
            self.on_knn(q_rays, index, probes, k)
        n0, t0 = time.time_ns(), time.perf_counter()
        out = self._orig_knn(index, q_rays, k=k, probes=probes)
        t1, n1 = time.perf_counter(), time.time_ns()
        self.spans.append(Span("ray_grid_knn", -1, t0, t1, n0, n1))
        return out

    def _close(self, why: str) -> None:
        if self._in_window:
            self._in_window = False
            self.closed_by = why
            self.on_close()

    def finish(self, why: str = "sequence") -> None:
        """The program's loop ended by itself (the sequence ran out)."""
        self._close(why)
