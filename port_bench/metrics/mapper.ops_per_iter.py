"""mapper.ops_per_iter: device operations launched under the window's
map.iter spans (each credited to the innermost program span open at its
launch, core/stages.py) per mapping iteration."""

from core import stages


def read(run):
    return stages.of(run)["mapper.ops_per_iter"]
