"""mapper.iter_host_ms: mean wall of the program's map.iter spans in the
window's frames (one mapping iteration on the host; spans of --trace 1
runs)."""

from core import stages


def read(run):
    return stages.of(run)["mapper.iter_host_ms"]
