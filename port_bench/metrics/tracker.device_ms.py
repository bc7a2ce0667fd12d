"""tracker.device_ms: device time of the kernels launched inside the
window's track_frame spans, per tracked frame (device trace)."""


def read(run):
    t = run.trace
    n = sum(1 for s in run.window_spans if s.name == "track_frame")
    dev = 0.0 if t is None else t["device_s_in_span"].get("track_frame", 0.0)
    if not n or dev <= 0:
        return None
    return 1e3 * dev / n
