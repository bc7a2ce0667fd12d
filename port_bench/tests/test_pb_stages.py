"""The program's spans against the device trace: the harness's copy of
the crediting rule (``core/stages.py``) beside the program's own
(``profiling/span_breakdown.py``), ``core/trace.reduce`` with and without
span records, and the stage readers."""

import json
import math

import numpy as np
import pytest
from conftest import SMALL
from torch.autograd import DeviceType

from core import manifest, stages, trace
from point_slam_tpu_torch.profiling import span_breakdown as sb
from point_slam_tpu_torch.utils import spans as program_spans
from point_slam_tpu_torch.utils.spans import Record

MAIN, READER = 101, 202
FRAMES = (1, 2, 3)


def _records():
    """Three frames of the schedule's spans on MAIN (frame 2 mapped) and
    the reader's on READER, in the order they open, as the program's
    recorder keeps them; times in ns."""
    recs = []

    def add(name, t0, t1, thread=MAIN, frame=None, parent=-1, counts=None):
        if frame is None:
            frame = recs[parent].frame
        r = Record(len(recs), name, parent, frame, None, thread, t0)
        r.t1, r.counts = t1, counts
        recs.append(r)
        return r.index

    for f in FRAMES:
        b = f * 1_000_000
        fr = add("frame", b, b + 100_000, frame=f)
        add("reader.wait", b + 1_000, b + 5_000, parent=fr)
        tr = add("track_frame", b + 10_000, b + 60_000, parent=fr)
        for k in range(2):
            o = b + 10_000 + 20_000 * k
            it = add("track.iter", o, o + 20_000, parent=tr)
            add("track.render", o + 1_000, o + 10_000, parent=it)
            add("sync.upload", o + 11_000, o + 12_000, parent=it)
            add("track.step", o + 13_000, o + 19_000, parent=it)
        add("reader.fetch", b + 40_000, b + 70_000, thread=READER,
            frame=f + 4)
        if f == 2:
            mf = add("map_frame", b + 62_000, b + 95_000, parent=fr)
            it = add("map.iter", b + 63_000, b + 80_000, parent=mf)
            rd = add("map.render", b + 64_000, b + 70_000, parent=it)
            add("knn.ray_topk", b + 65_000, b + 68_000, parent=rd,
                counts={"rays": 100})
            fb = add("knn.fallback", b + 71_000, b + 75_000, parent=it,
                     counts={"rays_fallback": 5})
            add("sync.knn_subset", b + 72_000, b + 73_000, parent=fb)
            add("map.window", b + 81_000, b + 85_000, parent=mf)
            dn = add("map.densify", b + 86_000, b + 90_000, parent=mf,
                     counts={"points_added": 7})
            add("pc.add_points", b + 87_000, b + 88_000, parent=dn)
        add("reader.stage", b + 96_000, b + 99_000, thread=READER,
            frame=f + 4)
    return recs


def _trace(recs, lthread):
    """A device operation launched at every 500 ns of the main thread's
    spans of frames 1-3 (none at a span's bounds) and two by the reader
    inside its stage span; each runs 300 ns after its launch for 200 ns.
    ``lthread(thread)`` is the id the trace gives a launching thread."""
    times = []
    for f in FRAMES:
        b = f * 1_000_000
        times += [(t, MAIN) for t in range(b + 250, b + 100_000, 500)]
        times += [(b + 96_500, READER), (b + 97_500, READER)]
    device, launches = [], {}
    for corr, (t, th) in enumerate(sorted(times), start=1):
        device.append((t + 300, t + 500, corr, f"k{corr % 3}"))
        launches[corr] = (t, lthread(th), "cudaLaunchKernel")
    return device, launches


T0, T1 = 1_000_000, 4_000_000


@pytest.mark.parametrize("matched", [True, False])
def test_the_copy_credits_as_the_program_does(matched):
    """On one trace and one set of records, the copy gives the program's
    owners, stages and figures: by the launching thread where the
    profiler's thread ids are the records', and by time where they are
    not (the reader's spans then held out of the window, which the copy
    does by reading only the schedule's thread)."""
    recs = _records()
    device, launches = _trace(recs, (lambda th: th) if matched
                              else (lambda th: 7))
    if matched:
        theirs = recs
    else:
        theirs = list(recs)
        for r in recs:
            if r.thread == READER:
                far = Record(r.index, r.name, r.parent, r.frame, None,
                             r.thread, 1)
                far.t1, far.counts = 2, r.counts
                theirs[r.index] = far
    bd = sb.breakdown(theirs, device, launches, T0, T1)
    ops = sorted(d for d in device if d[1] > T0 and d[0] < T1)
    launch = np.array([launches[c][0] for _, _, c, _ in ops], np.int64)
    lthread = np.array([launches[c][1] for _, _, c, _ in ops], np.int64)
    owner, by_thread = stages.credit(recs, launch, lthread)
    assert by_thread is bd["by_thread"] is matched
    assert owner.tolist() == bd["owner"].tolist()
    got = stages.by_stage(recs, owner, ops, T0, T1)
    assert {k: v["ops"] for k, v in got.items()} == bd["ops"]
    assert set(got) == set(bd["device_s"])
    for k, v in got.items():
        assert v["device_s"] == pytest.approx(bd["device_s"][k], rel=1e-12)
    ours = stages.figures(recs, FRAMES, owner)
    want = sb.stage_figures(recs, FRAMES, bd)
    assert set(ours) == set(want)
    for k, v in want.items():
        assert ours[k] == pytest.approx(v, rel=1e-12), k
    # a launch every 500 ns: 40 in a tracking iteration, 34 in a mapping one
    assert (ours["tracker.ops_per_iter"], ours["mapper.ops_per_iter"]) == \
        (40.0, 34.0)


def test_by_time_the_reader_takes_no_launch_of_the_main_thread():
    """Without thread ids, a launch of the main thread that falls in the
    reader's span goes to the main thread's span open then, and the
    reader's own launches to the main thread's span open at theirs."""
    recs = _records()
    t_track = 1_000_000 + 45_250      # frame 1's second track.step, in
    t_stage = 1_000_000 + 96_500      # reader.fetch; in reader.stage
    owner, by_thread = stages.credit(
        recs, np.array([t_track, t_stage], np.int64),
        np.array([7, 7], np.int64))
    assert by_thread is False
    assert [recs[o].name for o in owner] == ["track.step", "frame"]
    assert all(recs[o].thread == MAIN for o in owner)


def test_the_figures_count_what_the_spans_say():
    recs = _records()
    fig = stages.figures(recs, FRAMES)
    assert fig["tracker.iter_host_ms"] == pytest.approx(0.02)
    assert fig["mapper.iter_host_ms"] == pytest.approx(0.017)
    assert fig["mapper.densify_ms"] == pytest.approx(0.004)
    assert fig["keyframes.window_ms"] == pytest.approx(0.004)
    # six uploads and the fallback's sync on the schedule's thread, over
    # seven iterations and three frames
    assert fig["host.syncs_per_iter"] == pytest.approx(7 / 7)
    assert fig["host.sync_ms"] == pytest.approx(7 * 0.001 / 3)
    assert fig["knn.fallback_pct"] == pytest.approx(5.0)
    assert fig["tracker.ops_per_iter"] is None
    assert stages.figures(recs, ())["host.sync_ms"] is None


class _Ev:
    def __init__(self, dev, s, d, corr, name, tid=0):
        self._v = (dev, s, d, corr, name, tid)

    def device_type(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def name(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


class _Prof:
    def __init__(self, events):
        class K:
            pass
        self.profiler = K()
        self.profiler.kineto_results = K()
        self.profiler.kineto_results.events = lambda: list(events)


def _small_trace():
    """Four operations in the window [1000, 2000] ns and two outside it,
    each with the runtime call that launched it (thread 5)."""
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    evs = []
    for corr, (s, e, name, t_launch, call) in enumerate([
            (900, 1100, "k1", 850, "cudaLaunchKernel"),
            (1200, 1300, "k2", 1150, "cudaLaunchKernel"),
            (1250, 1400, "k1", 1160, "cudaLaunchKernel"),
            (1600, 1700, "memcpy", 1590, "cudaMemcpyAsync"),
            (2100, 2200, "k2", 2050, "cudaLaunchKernel"),
            (500, 800, "k2", 450, "cudaLaunchKernel")], start=1):
        evs.append(_Ev(cuda, s, e - s, corr, name))
        evs.append(_Ev(cpu, t_launch, 5, corr, call, 5))
    spans = {"track_frame": [(1100, 1200)], "map_frame": [(1500, 1650)],
             "ray_grid_knn": [(1140, 1155)]}
    return _Prof(evs), spans


def test_reduce_without_records_is_as_it_was():
    prof, spans = _small_trace()
    out = trace.reduce(prof, 1000, 2000, spans)
    assert set(out) == {"busy_s", "window_s", "device_s_in_span",
                        "n_device_ops", "device_ops", "idle_gaps"}
    assert out["busy_s"] == pytest.approx(400e-9, rel=1e-12)
    assert out["window_s"] == pytest.approx(1000e-9, rel=1e-12)
    assert out["n_device_ops"] == 4
    assert out["device_s_in_span"] == pytest.approx(
        {"track_frame": 250e-9, "map_frame": 100e-9,
         "ray_grid_knn": 100e-9}, rel=1e-12)
    assert [n for n, _ in out["device_ops"]] == ["k1", "k2", "memcpy"]
    assert [v for _, v in out["device_ops"]] == pytest.approx(
        [350e-9, 100e-9, 100e-9], rel=1e-12)
    assert [n for n, _ in out["idle_gaps"]] == [
        "map_frame:cudaMemcpyAsync", "track_frame:cudaLaunchKernel"]
    assert [v for _, v in out["idle_gaps"]] == pytest.approx(
        [200e-9, 100e-9], rel=1e-12)


def test_reduce_with_records_adds_the_stages():
    prof, spans = _small_trace()
    plain = trace.reduce(prof, 1000, 2000, spans)
    recs = []
    for name, t0, t1, parent in (("frame", 800, 1900, -1),
                                 ("track_frame", 1100, 1200, 0),
                                 ("track.render", 1140, 1170, 1),
                                 ("map_frame", 1500, 1650, 0),
                                 ("map.backward", 1580, 1600, 3)):
        r = Record(len(recs), name, parent, 1, None, 5, t0)
        r.t1 = t1
        recs.append(r)
    out = trace.reduce(prof, 1000, 2000, spans, recs)
    for k in ("busy_s", "window_s", "device_s_in_span", "n_device_ops",
              "device_ops"):
        assert out[k] == plain[k]
    assert out["stage_by_thread"] is True
    assert [recs[o].name for o in out["stage_owner"]] == [
        "frame", "track.render", "track.render", "map.backward"]
    assert {k: v["ops"] for k, v in out["by_stage"].items()} == {
        "frame": 1, "track.render": 2, "map.backward": 1}
    # device time clipped to the window: k1's first 100 of its 200 ns
    assert out["by_stage"]["frame"]["device_s"] == pytest.approx(100e-9)
    assert [n for n, _ in out["idle_gaps"]] == [
        "map_frame/map.backward:cudaMemcpyAsync",
        "track_frame/track.render:cudaLaunchKernel"]
    assert [v for _, v in out["idle_gaps"]] == [
        v for _, v in plain["idle_gaps"]]


NINE = ("tracker.iter_host_ms", "tracker.ops_per_iter",
        "mapper.iter_host_ms", "mapper.ops_per_iter", "mapper.densify_ms",
        "keyframes.window_ms", "host.sync_ms", "host.syncs_per_iter",
        "knn.fallback_pct")


class _Run:
    every, frames = 0, 3

    def __init__(self, records=None, trace=None):
        self.records, self.trace = records, trace


@pytest.mark.parametrize("name", NINE)
def test_a_stage_reader_reads_nothing_without_spans(name):
    assert manifest.reader(name).read(_Run()) is None
    assert manifest.reader(name).read(_Run(records=[])) is None


@pytest.mark.parametrize("name", NINE)
def test_a_stage_reader_reads_the_window(name):
    """Each reader gives the program's stage figure over the window's
    frames (``every+1`` to ``every+frames``) of the same records and
    trace."""
    recs = _records()
    device, launches = _trace(recs, lambda th: th)
    bd = sb.breakdown(recs, device, launches, T0, T1)
    want = sb.stage_figures(recs, FRAMES, bd)[name]
    run = _Run(recs, {"stage_owner": bd["owner"]})
    got = manifest.reader(name).read(run)
    assert got is not None and math.isfinite(got)
    assert got == pytest.approx(want, rel=1e-12)


def _cell(harness, capsys, monkeypatch, trace_flag, device="cpu"):
    """``replica.orbit`` cut to the CPU tests' size, with every recorder
    the program makes kept for a look after the run."""
    made = []
    init = program_spans.Spans.__init__

    def kept(self):
        init(self)
        made.append(self)
    monkeypatch.setattr(program_spans.Spans, "__init__", kept)
    cut = dict(json.loads(json.dumps(SMALL)), frames=11)
    cut["mapping"]["color_refine"] = False
    rc = harness.main(["--workload", "replica.orbit", "--seed",
                       str(2 ** 31 + 4093), "--seconds", "1000", "--trace",
                       str(trace_flag)], device=device, cut=cut)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return out, made


def test_a_traced_run_reports_the_stage_figures(harness, capsys,
                                                monkeypatch):
    """``--trace 1`` on the CPU: the program's spans record and every
    stage figure read from spans and counters is a finite number; the
    two read from the device trace are left out, as every device-trace
    metric is where there is no card."""
    out, made = _cell(harness, capsys, monkeypatch, 1)
    assert out["correct"] is True, out["checks"]
    assert [s.on for s in made] == [True] and made[0].records()
    bm = manifest.load_benchmark(harness.ROOT)
    src = {m["name"]: m["source"] for m in bm["per_layer"]}
    for name in NINE:
        if src[name] == "device_trace":
            assert name not in out["metrics"]
        else:
            assert math.isfinite(out["metrics"][name]["value"]), name
    assert out["metrics"]["tracker.iter_host_ms"]["value"] > 0
    assert out["metrics"]["host.syncs_per_iter"]["value"] > 0


def test_an_untraced_run_records_no_span(harness, capsys, monkeypatch):
    """``--trace 0``, the runs the end-to-end metrics come from: the
    program's recorder stays off and records nothing."""
    out, made = _cell(harness, capsys, monkeypatch, 0)
    assert out["correct"] is True, out["checks"]
    assert made and all(not s.on and not s.records() for s in made)
    assert not set(NINE) & set(out["metrics"])


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reports_all_nine(harness, capsys,
                                                   monkeypatch, card):
    """``--trace 1`` on the card at the small size: all nine stage
    figures, and idle gaps named by the program's stages."""
    out, _ = _cell(harness, capsys, monkeypatch, 1, device=card)
    assert out["correct"] is True, out["checks"]
    for name in NINE:
        assert math.isfinite(out["metrics"][name]["value"]), name
    assert out["metrics"]["tracker.ops_per_iter"]["value"] > 0
    gaps = out["breakdown"]["idle_gaps"]
    assert gaps and all("/" in n for n, _ in gaps)
