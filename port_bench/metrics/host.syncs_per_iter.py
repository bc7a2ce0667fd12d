"""host.syncs_per_iter: the program's sync.* spans on the schedule's
thread in the window's frames over its tracking and mapping iterations."""

from core import stages


def read(run):
    return stages.of(run)["host.syncs_per_iter"]
