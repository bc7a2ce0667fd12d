"""The program's spans and counters (point_slam_tpu_torch/utils/spans.py).

On the CPU, over the tiny synthetic configuration of
tests/test_torch_slam_e2e.py (built here with the port's own loader):

* with recording off a run records nothing, and ``timing`` and
  ``frame_times`` keep their keys, their buckets summing to the active
  wall;
* with recording on, the poses and ``frame_stats`` are bit-equal to a run
  with it off;
* each tracked frame has ``tracking.iters`` ``track.iter`` spans under its
  ``track_frame``; each mapped frame ``n_iters`` ``map.iter`` spans under
  its ``map.optimize``; every child lies inside its parent's bounds with
  the parent's frame;
* a span's bounds are on ``torch.profiler``'s clock: an ``aten::`` op
  launched inside a span starts inside it in the profiler's trace;
* ``rays_fallback`` equals a recount of the non-compact rays of the same
  ``ray_grid_knn`` output.

On the card (marked ``cuda``; run with ``python -m pytest --noconftest
tests/test_torch_spans.py -m cuda``): one tracking and one mapping
iteration under ``torch.cuda.set_sync_debug_mode("warn")`` flag as many
syncs with recording on as off, and each flagged sync falls inside a
``sync.*`` span, but for the one inside each backward (autograd's
``cumprod`` backward reads whether its input holds a zero), which no span
of the program's code can wrap apart from the backward's.

This file imports no JAX: its card test runs where JAX is not installed.
"""

import collections
import copy
import importlib.util
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from point_slam_tpu_torch.config import load_config
from point_slam_tpu_torch.ops import knn
from point_slam_tpu_torch.slam import PointSLAM
from point_slam_tpu_torch.utils import spans as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")


def tiny_cfg(n_frames=5, track_iters=3, map_iters=4, iters_first=5):
    """tests/torch_parity.tiny_cfgs's port configuration (48x64), cut to a
    few iterations."""
    cfg = load_config(os.path.join(CONFIGS, "Synthetic", "room.yaml"),
                      os.path.join(CONFIGS, "point_slam.yaml"))
    cfg["synthetic"].update({"n_frames": n_frames, "angular_step": 0.02})
    cfg["cam"].update({"H": 48, "W": 64, "fx": 40.0, "fy": 40.0,
                       "cx": 31.5, "cy": 23.5})
    cfg["tracking"].update({"pixels": 300, "iters": track_iters,
                            "ignore_edge_W": 5, "ignore_edge_H": 5})
    cfg["mapping"].update({
        "pixels": 400, "pixels_adding": 200,
        "pixels_based_on_color_grad": 50, "iters": map_iters,
        "iters_first": iters_first, "geo_iter_first": 2,
        "mapping_window_size": 4, "keyframe_every": 4, "every_frame": 2,
        "lazy_start": False, "color_refine": False})
    cfg["cuda"].update({"point_capacity_init": 1 << 13,
                        "point_capacity_max": 1 << 16,
                        "grid_table_size": 1 << 14,
                        "grid_max_per_cell": 64})
    cfg["verbose"] = False
    return cfg


def _run(tmp, on: bool, cfg=None, device="cpu"):
    cfg = copy.deepcopy(cfg or tiny_cfg())
    cfg["data"]["output"] = str(tmp)
    slam = PointSLAM(cfg, device=device)
    if on:
        slam.spans.enable()
    summary = slam.run()
    return slam, summary


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run with recording off and one with it on, both under
    deterministic algorithms (the CPU's scatter-add otherwise sums in a
    varying order)."""
    torch.set_num_threads(2)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        off = _run(tmp_path_factory.mktemp("off"), False)
        on = _run(tmp_path_factory.mktemp("on"), True)
    finally:
        torch.use_deterministic_algorithms(was)
    return off, on


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.index]


def test_recording_off_records_nothing_and_keeps_the_buckets(runs):
    (slam, summary), _ = runs
    assert slam.spans.records() == []
    tm = summary["timing"]
    assert set(tm) == {"track", "map", "io", "wait", "log", "other",
                       "prefetch_fetch", "prefetch_stage", "wall_active"}
    parts = sum(tm[k] for k in ("track", "map", "io", "wait", "log",
                                "other"))
    assert tm["track"] > 0 and tm["map"] > 0 and tm["prefetch_stage"] > 0
    assert parts <= tm["wall_active"] + 1e-6
    assert parts >= 0.95 * tm["wall_active"]
    ft = summary["frame_times"]
    assert sorted(ft) == list(range(5))
    assert all(set(v) == {"track", "map"} for v in ft.values())
    assert ft[0]["track"] == 0.0 and ft[1]["map"] == 0.0
    assert ft[2]["track"] > 0 and ft[2]["map"] > 0


def test_recording_on_gives_bit_equal_results(runs):
    (s_off, sum_off), (s_on, sum_on) = runs
    assert s_on.spans.records()
    np.testing.assert_array_equal(sum_off["estimate_c2w_list"],
                                  sum_on["estimate_c2w_list"])
    assert sum_off["n_points"] == sum_on["n_points"]
    st_off, st_on = s_off.mapper.frame_stats, s_on.mapper.frame_stats
    assert sorted(st_off) == sorted(st_on) == [0, 2, 4]
    for idx in st_off:
        assert st_off[idx].keys() == st_on[idx].keys()
        for k in st_off[idx]:
            np.testing.assert_array_equal(np.asarray(st_off[idx][k]),
                                          np.asarray(st_on[idx][k]),
                                          err_msg=f"frame {idx} {k}")


def test_buckets_are_the_schedule_spans(runs):
    """With recording on, each bucket is the sum of its spans' walls."""
    _, (slam, summary) = runs
    recs = slam.spans.records()
    tm = summary["timing"]
    wall = collections.defaultdict(float)
    for r in recs:
        wall[r.name] += (r.t1 - r.t0) * 1e-9
    for bucket, name in (("track", "track_frame"), ("map", "map_frame"),
                         ("wait", "reader.wait"), ("io", "reader.io"),
                         ("log", "log"), ("prefetch_fetch", "reader.fetch"),
                         ("prefetch_stage", "reader.stage")):
        assert wall[name] == pytest.approx(tm[bucket], rel=1e-3, abs=1e-5), \
            bucket
    for idx, ft in summary["frame_times"].items():
        tr = [r for r in recs if r.name == "track_frame" and r.frame == idx]
        assert len(tr) == (0 if idx == 0 else 1)
        if tr:
            assert (tr[0].t1 - tr[0].t0) * 1e-9 == pytest.approx(
                ft["track"], rel=1e-3, abs=1e-5)


def test_iteration_spans_per_frame(runs):
    _, (slam, _) = runs
    recs = slam.spans.records()
    iters = slam.cfg["tracking"]["iters"]
    tracked = [r for r in recs if r.name == "track_frame"]
    assert sorted(r.frame for r in tracked) == [1, 2, 3, 4]
    for tf in tracked:
        kids = _children(recs, tf)
        its = [r for r in kids if r.name == "track.iter"]
        if tf.frame == 1:                   # frame 1 takes its GT pose
            assert kids == []
            continue
        assert [r.it for r in its] == list(range(iters))
        assert sum(r.name == "sync.pose_read" for r in kids) == 1
        for it in its:
            assert [r.name for r in _children(recs, it)] == [
                "track.sample", "track.render", "track.backward",
                "track.step"]
    mapped = [r for r in recs if r.name == "map_frame"]
    assert sorted(r.frame for r in mapped) == [0, 2, 4]
    for mf in mapped:
        opt = [r for r in _children(recs, mf) if r.name == "map.optimize"]
        assert len(opt) == 1
        its = [r for r in _children(recs, opt[0]) if r.name == "map.iter"]
        assert [r.it for r in its] == list(
            range(slam.mapper.frame_stats[mf.frame]["n_iters"]))
        for it in its:
            assert [r.name for r in _children(recs, it)] == [
                "map.sample", "map.render", "map.backward", "map.step"]
        names = [r.name for r in _children(recs, mf)]
        for name in ("map.densify", "map.frustum", "map.window",
                     "sync.map_fetch", "sync.map_stats"):
            assert name in names, (mf.frame, name)
        dens = [r for r in _children(recs, mf) if r.name == "map.densify"]
        assert dens[0].counts["points_added"] == \
            slam.mapper.frame_stats[mf.frame]["n_added"]
        assert [r.name for r in _children(recs, dens[0])].count(
            "pc.add_points") == 2


def test_children_lie_inside_their_parents(runs):
    _, (slam, _) = runs
    recs = slam.spans.records()
    main = threading.main_thread().ident
    assert any(r.thread != main for r in recs)        # the reader's spans
    for r in recs:
        assert r.t0 <= r.t1, r
        if r.parent < 0:
            continue
        p = recs[r.parent]
        assert p.index < r.index and p.thread == r.thread
        assert p.t0 <= r.t0 and r.t1 <= p.t1, (p, r)
        assert r.frame == p.frame, (p, r)
    frames = [r for r in recs if r.name == "frame"]
    assert [r.frame for r in frames] == [0, 1, 2, 3, 4, None]
    for f in frames:
        assert all(recs[r.parent].name == "frame" or r.parent < 0
                   for r in _children(recs, f))
    for r in recs:
        if r.name.startswith(("reader.fetch", "reader.stage")):
            assert r.thread != main and r.parent == -1 and r.frame >= 1


def test_recorder_off_is_a_shared_no_op():
    sp = S.Spans()
    assert sp.span("x") is S.NULL
    assert S.span("y") is S.NULL          # nothing open on this thread
    S.count("n", 3)                       # no open span: dropped
    with sp.timed("t", frame=4) as t:
        time.sleep(0.001)
    assert t.s >= 0.001 and sp.records() == []


def test_counters_go_to_the_innermost_span_and_threads_keep_apart():
    sp = S.Spans().enable()
    seen = {}

    def other():
        # a thread of its own: no open span here
        seen["inner"] = S.innermost()
        with sp.span("reader", frame=9):
            S.count("n", 1)

    with sp.span("outer", frame=3) as outer:
        S.count("n", 2)
        with S.span("inner", it=5):
            S.count("n", 1)
            S.count("n", 4)
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
        outer.count("late", 7)
    assert not th.is_alive()
    assert seen["inner"] is None
    by = {r.name: r for r in sp.records()}
    outer_r, inner_r, reader_r = by["outer"], by["inner"], by["reader"]
    assert outer_r.counts == {"n": 2, "late": 7}
    assert inner_r.counts == {"n": 5}
    assert (inner_r.parent, inner_r.frame, inner_r.it) == (
        outer_r.index, 3, 5)
    assert (reader_r.parent, reader_r.frame, reader_r.counts) == (
        -1, 9, {"n": 1})
    assert reader_r.thread != outer_r.thread


def test_upload_spans_only_copies_from_the_host():
    sp = S.Spans().enable()
    dev_tensor = torch.ones(3)
    with sp.span("outer"):
        a = S.upload(dev_tensor, "cpu")
        b = S.upload([1.0, 2.0], "cpu", torch.float64)
        c = S.upload(np.arange(3), "cpu")
    assert a is dev_tensor
    assert b.dtype == torch.float64 and c.tolist() == [0, 1, 2]
    assert [r.name for r in sp.records()] == [
        "outer", "sync.upload", "sync.upload"]


def _load_trace_module():
    spec = importlib.util.spec_from_file_location(
        "port_bench_trace", os.path.join(ROOT, "port_bench", "core",
                                         "trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spans_share_the_profilers_clock():
    trace = _load_trace_module()
    sp = S.Spans().enable()
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    prof = trace.start("cpu")
    try:
        time.sleep(0.002)
        with sp.span("outer"):
            time.sleep(0.002)
            torch.mm(a, b)
            time.sleep(0.002)
        time.sleep(0.002)
    finally:
        prof.stop()
    (rec,) = sp.records()
    mm = [ev for ev in prof.profiler.kineto_results.events()
          if ev.name() == "aten::mm"]
    assert len(mm) == 1
    t = mm[0].start_ns()
    assert rec.t0 <= t <= rec.t1, (rec.t0, t, rec.t1)
    assert rec.t0 + 1_000_000 <= t <= rec.t1 - 1_000_000


def test_rays_fallback_recounts_the_non_compact_rays():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2.0, 2.0, (2048, 3)).astype(np.float32)
    index = knn.build_packed_grid_index(torch.from_numpy(pts), 2048, 0.2,
                                        table_size=1 << 12, max_per_cell=64)
    centers = pts[rng.integers(0, 2048, 60)]
    z = np.linspace(-0.02, 0.02, 5, dtype=np.float32)
    q = (centers[:, None, :] + z[None, :, None]).astype(np.float32)
    q[:7, :, 0] = np.linspace(-1.5, 1.5, 5)            # non-compact rays
    sp = S.Spans().enable()
    with sp.span("render"):
        _, _, _, compact = knn.ray_grid_knn(index, torch.from_numpy(q),
                                            k=8, probes=27)
        knn.grid_knn_subset(index, torch.from_numpy(q), ~compact, k=8)
    by = {r.name: r for r in sp.records()}
    assert by["knn.ray_topk"].counts == {"rays": 60}
    n_fb = int((~compact).sum())
    assert n_fb >= 7
    assert by["knn.fallback"].counts == {"rays_fallback": n_fb}
    assert by["sync.knn_subset"].parent == by["knn.fallback"].index


def test_rays_fallback_over_a_run_with_the_ray_knn(tmp_path, monkeypatch):
    """Over a run with the ray-shared kNN (the plain version on the CPU):
    the counters equal a recount of each call's output."""
    seen = {"rays": 0, "rays_fallback": 0}
    orig = knn.ray_grid_knn

    def counted(index, q_rays, k=8, probes=0):
        out = orig(index, q_rays, k=k, probes=probes)
        seen["rays"] += int(q_rays.shape[0])
        seen["rays_fallback"] += int((~out[3]).sum())
        return out

    monkeypatch.setattr(knn, "ray_grid_knn", counted)
    cfg = tiny_cfg(n_frames=3, track_iters=2, map_iters=2, iters_first=2)
    cfg["cuda"]["ray_knn"] = True
    slam, _ = _run(tmp_path, True, cfg)
    got = collections.Counter()
    for r in slam.spans.records():
        if r.name in ("knn.ray_topk", "knn.fallback"):
            got.update(r.counts)
    assert seen["rays"] > 0
    assert got["rays"] == seen["rays"]
    assert got["rays_fallback"] == seen["rays_fallback"]


@pytest.mark.cuda
def test_spans_add_no_sync_and_wrap_every_sync_on_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = tiny_cfg(n_frames=3, track_iters=1, map_iters=2, iters_first=1)
    flagged = {}
    for on in (False, True):
        c = copy.deepcopy(cfg)
        c["data"]["output"] = str(tmp_path / f"out_{on}")
        slam = PointSLAM(c, device="cuda")
        if on:
            slam.spans.enable()
        hits = []

        def hook(message, category, filename, lineno, file=None,
                 line=None):
            if "synchroniz" in str(message):
                hits.append(_where(slam.spans, S.innermost()))

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = hook
                slam.run()
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        flagged[on] = hits
    assert len(flagged[True]) == len(flagged[False]) > 0
    outside = collections.Counter(
        w for w in flagged[True] if not w.startswith("sync."))
    backward = [r for r in slam.spans.records()
                if r.name in ("track.backward", "map.backward")]
    assert set(outside) <= {"track.backward", "map.backward"}, outside
    assert sum(outside.values()) <= len(backward)


def _where(sp, rec):
    """The innermost ``sync.*`` span holding ``rec`` (itself or an
    ancestor), else ``rec``'s own name; '-' outside every span."""
    if rec is None:
        return "-"
    recs = sp.records()
    r = rec
    while r is not None:
        if r.name.startswith("sync."):
            return r.name
        r = recs[r.parent] if r.parent >= 0 else None
    return rec.name


def _rec(index, name, parent, t0, t1, frame=6, thread=1, counts=None):
    r = S.Record(index, name, parent, frame, None, thread, t0)
    r.t1, r.counts = t1, counts
    return r


def test_breakdown_credits_the_innermost_span_and_names_gaps():
    """Synthetic trace: ops launched in map.iter > map.render > knn and in
    map.iter > map.step are credited to the innermost span; each idle gap
    to the span that launched the op ending it; ops an iteration count the
    iteration's descendants."""
    from point_slam_tpu_torch.profiling import span_breakdown as SB
    recs = [_rec(0, "frame", -1, 0, 1000),
            _rec(1, "map_frame", 0, 10, 900),
            _rec(2, "map.iter", 1, 20, 400),
            _rec(3, "map.render", 2, 30, 200),
            _rec(4, "knn.ray_topk", 3, 40, 100, counts={"rays": 10}),
            _rec(5, "map.step", 2, 250, 390),
            _rec(6, "sync.upload", 5, 300, 320),
            _rec(7, "knn.fallback", 3, 150, 160,
                 counts={"rays_fallback": 1})]
    # runtime calls: correlation id -> (start, thread, name)
    launches = {1: (35, 1, "cudaLaunchKernel"), 2: (50, 1, "cuLaunchKernel"),
                3: (260, 1, "cudaLaunchKernel"),
                4: (310, 1, "cudaMemcpyAsync"), 5: (950, 1, "x")}
    device = [(100, 110, 1, "k1"), (200, 230, 2, "k2"),
              (400, 420, 3, "k3"), (500, 505, 4, "copy"),
              (2000, 2010, 5, "late")]
    bd = SB.breakdown(recs, device, launches, 0, 1000)
    assert bd["n_ops"] == 4 and bd["by_thread"]
    assert bd["ops"] == {"map.render": 1, "knn.ray_topk": 1, "map.step": 1,
                         "sync.upload": 1}
    assert bd["busy_s"] == pytest.approx(65e-9)
    assert bd["device_s"]["map.step"] == pytest.approx(20e-9)
    assert dict(bd["idle_gaps"]) == pytest.approx(
        {"knn.ray_topk:cuLaunchKernel": 90e-9,
         "map.step:cudaLaunchKernel": 170e-9,
         "sync.upload:cudaMemcpyAsync": 80e-9})
    # without the launching thread's id, the time alone picks the span
    other = {c: (t, 99, n) for c, (t, _, n) in launches.items()}
    bd2 = SB.breakdown(recs, device, other, 0, 1000)
    assert not bd2["by_thread"] and bd2["ops"] == bd["ops"]
    fig = SB.stage_figures(recs, [6], bd)
    assert fig["mapper.ops_per_iter"] == 4.0
    assert fig["tracker.ops_per_iter"] is None
    assert fig["host.syncs_per_iter"] == 1.0
    assert fig["knn.fallback_pct"] == pytest.approx(10.0)
    assert fig["mapper.iter_host_ms"] == pytest.approx(380e-6)
    assert "map.render" in SB.table(recs, [6], bd)
