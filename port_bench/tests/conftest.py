"""The benchmark's own tests: ``python -m pytest port_bench/tests`` from
the repository's root. Tests marked ``cuda`` need the card and skip
without one."""

import importlib.util
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


def load_harness():
    """``port_bench/run.py`` as a module (the repository's root has a
    ``run.py`` of its own)."""
    spec = importlib.util.spec_from_file_location(
        "port_bench_run", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def harness():
    return load_harness()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this host")
    return "cuda"


# a cell cut to a CPU test's size: the same paths (ray-shared search over
# the lattice-packed table, which the card takes by default), tiny shapes
SMALL = {
    "cam": {"H": 60, "W": 80, "fx": 40.0, "fy": 40.0, "cx": 39.5,
            "cy": 29.5},
    "tracking": {"pixels": 200, "iters": 6, "ignore_edge_W": 5,
                 "ignore_edge_H": 5},
    "mapping": {"pixels": 400, "pixels_adding": 300,
                "pixels_based_on_color_grad": 50, "iters": 8,
                "iters_first": 20, "geo_iter_first": 8},
    "cuda": {"point_capacity_init": 8192, "grid_table_size": 4096,
             "ray_knn": True, "knn_packed_coords": True},
}
