"""tracker.frame_ms: the summed wall of the window's track_frame spans
over the frames tracked (each span ends in the host read of the pose)."""


def read(run):
    spans = [s for s in run.window_spans if s.name == "track_frame"]
    if not spans:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(spans)
