"""The window's period arithmetic and the frame-counted warm-up."""

import pytest

from core import window as W


def _periods(every, n_periods, track_s, map_s, t0=0.0, extra_tracked=0):
    """Spans of frame 0, the warm-up period and ``n_periods`` more, each
    frame tracked for ``track_s`` and every ``every``-th mapped for
    ``map_s``; ``extra_tracked`` frames of an unfinished period after."""
    spans, t = [], t0
    spans.append(W.Span("map_frame", 0, t, t + map_s))
    t += map_s
    last = every * (n_periods + 1) + extra_tracked
    for i in range(1, last + 1):
        spans.append(W.Span("track_frame", i, t, t + track_s))
        t += track_s
        if i % every == 0:
            spans.append(W.Span("map_frame", i, t, t + map_s))
            t += map_s
    return spans


def fixed_time_count(spans, t_start, seconds):
    """Frames whose work ended inside [t_start, t_start + seconds]: the
    count a fixed-time window takes."""
    ends = {}
    for s in spans:
        ends[s.frame] = max(ends.get(s.frame, 0.0), s.t1)
    return sum(1 for t in ends.values() if t_start < t <= t_start + seconds)


def test_whole_periods_ignore_a_period_cut_short():
    every = 2
    whole = _periods(every, 4, 3.1, 3.857)
    cut = _periods(every, 4, 3.1, 3.857, extra_tracked=1)
    period = 2 * 3.1 + 3.857
    assert W.whole_periods(whole, every) == pytest.approx((8, 4 * period))
    assert W.fps(cut, every) == W.fps(whole, every)
    assert W.fps(whole, every) == pytest.approx(2 / period)


def test_fixed_time_window_moves_by_a_frame():
    """TUM's periods (two frames tracked at 3.1 s, one mapped at 3.857 s)
    in a 37-s fixed-time window: where the window starts decides how many
    frames end inside it (one frame of ~7.4 is a 13% swing in a frame
    rate), while the rate over whole periods does not move."""
    every = 2
    spans = _periods(every, 8, 3.1, 3.857)
    t_open = [s.t1 for s in spans if s.name == "map_frame"
              and s.frame == every][0]
    counts = {fixed_time_count(spans, t_open + 0.25 * k, 37.0)
              for k in range(41)}
    assert 7 in counts and len(counts) > 1
    assert max(counts) - min(counts) >= 1
    assert 1 / 7 > 0.12
    rates = {round(W.fps(_periods(every, n, 3.1, 3.857), every), 12)
             for n in (3, 4, 5)}
    assert len(rates) == 1


class _Clock:
    t = 0.0


class _Tracker:
    def __init__(self, clock, dt):
        self.clock, self.dt = clock, dt

    def track_frame(self, idx, *a, **k):
        self.clock.t += self.dt
        return {"idx": idx}


class _Mapper:
    def __init__(self, clock, dt):
        self.clock, self.dt = clock, dt

    def map_frame(self, idx, *a, **k):
        self.clock.t += self.dt
        return {"idx": idx}


class _Slam:
    def __init__(self, clock):
        self.tracker = _Tracker(clock, 1.0)
        self.mapper = _Mapper(clock, 3.0)
        self.timing = {"wait": 0.0}


class _Knn:
    @staticmethod
    def ray_grid_knn(index, q, k=8, probes=0):
        return None


def _drive(monkeypatch, every, seconds, n_frames):
    clock = _Clock()
    monkeypatch.setattr(W.time, "perf_counter", lambda: clock.t)
    slam = _Slam(clock)
    events = []
    drv = W.Driver(slam, seconds, every, lambda: events.append("open"),
                   lambda: events.append("close"), _Knn)
    try:
        slam.mapper.map_frame(0)
        for i in range(1, n_frames):
            slam.tracker.track_frame(i)
            if i % every == 0:
                slam.mapper.map_frame(i)
        drv.finish()
    except W.WindowClosed as e:
        events.append(("closed at", e.args[0]))
    return drv, events


def test_warm_up_is_frame_zero_and_one_period(monkeypatch):
    every = 5
    drv, events = _drive(monkeypatch, every, seconds=1e9, n_frames=31)
    assert events[0] == "open"
    assert W.first_window_frame(every) == every + 1
    # frame 0 (3 s) and one period (5 tracked, 1 mapped: 8 s) warm up
    assert drv.t_open == pytest.approx(3.0 + 8.0)
    assert drv.warm_period_s == pytest.approx(8.0)
    frames, secs = W.whole_periods(drv.spans, every)
    assert frames == 25 and secs == pytest.approx(25 * 1.0 + 5 * 3.0)


def test_window_closes_at_a_period_boundary(monkeypatch):
    every = 5
    drv, events = _drive(monkeypatch, every, seconds=30.0, n_frames=200)
    # periods of 8 s: three fit in 30 s, a fourth would end at 32
    assert ("closed at", 4 * every + 1) in events
    frames, secs = W.whole_periods(drv.spans, every)
    assert frames == 3 * every and secs == pytest.approx(24.0)
    assert drv.closed_by == "seconds"
