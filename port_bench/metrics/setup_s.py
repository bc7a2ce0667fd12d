"""setup_s: process start to the window's start (the kernels' build or
load, the sequence written, PointSLAM built, frame 0 and the warm-up
period)."""


def read(run):
    return run.setup_s
