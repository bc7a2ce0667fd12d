"""tracker.iter_host_ms: mean wall of the program's track.iter spans in
the window's frames (one tracking iteration on the host: sampling, the
render's launches, the backward, the step; spans of --trace 1 runs)."""

from core import stages


def read(run):
    return stages.of(run)["tracker.iter_host_ms"]
