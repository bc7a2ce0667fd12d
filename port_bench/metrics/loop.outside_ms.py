"""loop.outside_ms: the window's wall outside the track_frame and
map_frame spans, per frame (the schedule's own host work: the reader's
wait, logging, bookkeeping)."""


def read(run):
    if not run.frames:
        return None
    inside = sum(s.t1 - s.t0 for s in run.window_spans
                 if s.name in ("track_frame", "map_frame"))
    return 1e3 * (run.window_s - inside) / run.frames
