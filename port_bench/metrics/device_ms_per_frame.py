"""device_ms_per_frame: the device's busy time over the window's whole
mapping periods (the union of its kernels, copies and memsets, from the
trace) per frame: the card's time that a frame of the sequence costs."""


def read(run):
    t = run.trace
    if t is None or not run.frames or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / run.frames
