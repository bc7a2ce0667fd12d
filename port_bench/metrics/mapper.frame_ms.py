"""mapper.frame_ms: wall of the window's map_frame spans, per mapped
frame (each ends in the host read of the frame's results)."""


def read(run):
    spans = [s for s in run.window_spans if s.name == "map_frame"]
    if not spans:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(spans)
