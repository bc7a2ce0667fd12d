"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` joins ``port_bench/configs/<config>.json``
(the configuration as it is run, its source and what was cut),
``port_bench/traffic/<traffic>.json`` (the sequence's parameters) and, for
each metric the cell reports, ``port_bench/metrics/<metric>.py`` (a
reader with ``read(run) -> float | None``). A new configuration, traffic
mix or metric is a new file and a new entry; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_benchmark(root: str) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bm: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bm["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bm: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in bm["configs"]:
        if c["name"] == name:
            with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict[str, Any]:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def metrics_for(bm: Dict[str, Any], cell: str, trace: bool
                ) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics (trace off) or per-layer ones (trace
    on): those that list the cell, or list no cells."""
    out = []
    for m in bm["per_layer" if trace else "end_to_end"]:
        if "workloads" not in m or cell in m["workloads"]:
            out.append(m)
    return out


def reader(name: str):
    """The module ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
