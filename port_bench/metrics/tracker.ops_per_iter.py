"""tracker.ops_per_iter: device operations launched under the window's
track.iter spans (each credited to the innermost program span open at its
launch, core/stages.py) per tracking iteration."""

from core import stages


def read(run):
    return stages.of(run)["tracker.ops_per_iter"]
