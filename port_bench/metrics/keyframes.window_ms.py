"""keyframes.window_ms: wall of the program's map.window spans (the
keyframes' overlap scores, the selection, the window's gather and cameras)
per mapped frame of the window."""

from core import stages


def read(run):
    return stages.of(run)["keyframes.window_ms"]
