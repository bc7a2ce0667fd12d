"""host.sync_ms: wall of the program's sync.* spans on the schedule's
thread (each a host read of the device, or a copy from pageable memory,
that waits for the device's queue) per window frame."""

from core import stages


def read(run):
    return stages.of(run)["host.sync_ms"]
