"""loop.fps: frames of the window's whole mapping periods over their wall
on the host's clock (each period ends in the host read of its mapped
frame's results)."""


def read(run):
    if not run.frames or run.window_s <= 0:
        return None
    return run.frames / run.window_s
