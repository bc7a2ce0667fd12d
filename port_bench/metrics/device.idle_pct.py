"""device.idle_pct: share of the window with no kernel, copy or memset
on the device (device trace)."""


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
