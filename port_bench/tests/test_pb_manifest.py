"""BENCHMARK.json's names and units, and discovery of configurations,
traffic mixes and metrics added as files."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT
from core import manifest


# the naming rules of BENCHMARK.json
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def problems(bm):
    """What in the manifest breaks the naming rules or misses a file."""
    bad = []
    names = [c["name"] for c in bm["configs"]] + \
        [w["name"] for w in bm["workloads"]] + \
        [m["name"] for m in bm["end_to_end"] + bm["per_layer"]]
    for n in names:
        if not NAME_RE.match(n):
            bad.append(f"name {n!r}")
    for c in bm["configs"]:
        for k in c["reduced"]:
            if not NAME_RE.match(k):
                bad.append(f"reduced key {k!r}")
        if not os.path.exists(os.path.join(ROOT, c["file"])):
            bad.append(f"missing {c['file']}")
    for w in bm["workloads"]:
        for key in ("config", "traffic"):
            if not NAME_RE.match(w[key]):
                bad.append(f"{key} {w[key]!r}")
        if not os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json")):
            bad.append(f"missing traffic {w['traffic']}")
    for m in bm["end_to_end"] + bm["per_layer"]:
        if not UNIT_RE.match(m["unit"]):
            bad.append(f"unit {m['unit']!r}")
        if m["source"] not in SOURCES:
            bad.append(f"source {m['source']!r}")
        if m["better"] not in ("lower", "higher"):
            bad.append(f"better {m['better']!r}")
        if not os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py")):
            bad.append(f"missing reader {m['name']}")
    if len(set(names)) != len(names):
        bad.append("duplicate names")
    return bad


@pytest.fixture
def bm():
    return manifest.load_benchmark(ROOT)


def test_manifest_keeps_the_rules(bm):
    assert problems(bm) == []
    assert set(bm) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    names = {m["name"] for m in bm["end_to_end"]}
    assert "setup_s" in names
    e2e = {m["name"] for m in bm["end_to_end"]}
    for m in bm["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in bm["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert len(json.dumps(bm)) < 64 * 1024


@pytest.mark.parametrize("name,ok", [
    ("loop.fps", True), ("loop.outside_ms", True), ("tum_fr1.orbit_holes", True),
    ("_x-1", True), ("a b", False), ("a,b", False), ("a/b", False),
    ("-x", False), ("µs", False), ("x" * 65, False)])
def test_names(name, ok):
    assert bool(NAME_RE.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("frames/s", True), ("%", True), ("ms", True), ("tokens per s", False),
    ("µs", False), ("x" * 17, False)])
def test_units(unit, ok):
    assert bool(UNIT_RE.match(unit)) is ok


def test_problems_name_what_is_wrong(bm):
    bad = json.loads(json.dumps(bm))
    bad["per_layer"][0]["unit"] = "milli seconds"
    bad["workloads"][0]["traffic"] = "no_such_mix"
    found = problems(bad)
    assert any("unit" in p for p in found)
    assert any("no_such_mix" in p for p in found)


def test_new_files_are_found_by_name(tmp_path, monkeypatch, bm):
    """A configuration, a traffic mix and a metric added as new files and
    entries are found by the harness without an edit to any file."""
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), tmp_path / d)
    monkeypatch.setattr(manifest, "HERE", str(tmp_path))
    cfg = json.load(open(tmp_path / "configs" / "replica.json"))
    cfg["name"] = "replica_wide"
    json.dump(cfg, open(tmp_path / "configs" / "replica_wide.json", "w"))
    mix = json.load(open(tmp_path / "traffic" / "orbit.json"))
    mix["angular_step"] = 0.02
    json.dump(mix, open(tmp_path / "traffic" / "orbit_fast.json", "w"))
    (tmp_path / "metrics" / "frames.count.py").write_text(
        "def read(run):\n    return run.frames or None\n")
    bm = json.loads(json.dumps(bm))
    bm["configs"].append(dict(bm["configs"][0], name="replica_wide",
                              file="port_bench/configs/replica_wide.json"))
    bm["workloads"].append({"name": "replica_wide.orbit_fast",
                            "config": "replica_wide",
                            "traffic": "orbit_fast", "chips": 1,
                            "why": "a test cell"})
    bm["per_layer"].append({"name": "frames.count", "unit": "frames",
                            "better": "higher", "source": "host_clock",
                            "layer": "schedule",
                            "moves": "device_ms_per_frame",
                            "workloads": ["replica_wide.orbit_fast"]})
    w = manifest.workload(bm, "replica_wide.orbit_fast")
    assert manifest.config(bm, w["config"])["name"] == "replica_wide"
    assert manifest.traffic(w["traffic"])["angular_step"] == 0.02
    per = [m["name"] for m in manifest.metrics_for(bm, w["name"], True)]
    assert "frames.count" in per and "device.idle_pct" in per
    assert "frames.count" not in [
        m["name"] for m in manifest.metrics_for(bm, "replica.orbit", True)]

    class R:
        frames = 25
    assert manifest.reader("frames.count").read(R) == 25


@pytest.mark.parametrize("trace,frames,want", [
    ({"busy_s": 1.5}, 5, 300.0), (None, 5, None), ({"busy_s": 1.5}, 0, None),
    ({"busy_s": 0.0}, 5, None)])
def test_device_time_per_frame(trace, frames, want):
    """The card's busy time over the window's frames; nothing where the
    run has no device trace or no whole period."""
    class R:
        pass
    R.trace, R.frames = trace, frames
    assert manifest.reader("device_ms_per_frame").read(R) == want


@pytest.mark.parametrize("name,source", [
    ("tracker.iter_host_ms", "program_span"),
    ("tracker.ops_per_iter", "device_trace"),
    ("mapper.iter_host_ms", "program_span"),
    ("mapper.ops_per_iter", "device_trace"),
    ("mapper.densify_ms", "program_span"),
    ("keyframes.window_ms", "program_span"),
    ("host.sync_ms", "program_span"),
    ("host.syncs_per_iter", "program_span"),
    ("knn.fallback_pct", "program_counter")])
def test_a_stage_metric_is_listed_with_its_reader(bm, name, source):
    """The stage figures read from the program's spans: each listed once,
    for every cell (no ``workloads``), moving ``device_ms_per_frame``, in
    a layer whose other metrics give it letter for letter, with its
    reader beside it."""
    entries = [m for m in bm["per_layer"] if m["name"] == name]
    assert len(entries) == 1
    m = entries[0]
    assert m["source"] == source and "workloads" not in m
    assert m["moves"] == "device_ms_per_frame"
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves"}
    prefix = m["layer"].split(":")[0]
    assert {x["layer"] for x in bm["per_layer"]
            if x["layer"].split(":")[0] == prefix} == {m["layer"]}
    assert callable(manifest.reader(name).read)
