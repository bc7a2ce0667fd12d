"""reader.wait_ms: growth of PointSLAM.timing["wait"] (the main thread
blocked on the prefetch thread) across the window's whole periods, per
frame."""


def read(run):
    if not run.frames or not run.marks:
        return None
    last = run.every + run.frames
    at = {m.frame: m.wait_s for m in run.marks}
    if run.every not in at or last not in at:
        return None
    return 1e3 * (at[last] - at[run.every]) / run.frames
