"""mapper.densify_ms: wall of the program's map.densify spans (new
points picked, added to the cloud and inserted into the grid index) per
mapped frame of the window."""

from core import stages


def read(run):
    return stages.of(run)["mapper.densify_ms"]
