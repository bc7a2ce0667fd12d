"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 port_bench/run.py --workload <config>.<traffic> --seed N
        --seconds S --trace 0|1 [--control tf32]

Set-up makes the traffic's sequence from ``--seed`` on the card and writes
it under ``$TMPDIR`` in the configuration's dataset layout, builds
``point_slam_tpu_torch.slam.PointSLAM`` on the cell's configuration with
the program's own reader over those files, and drives ``PointSLAM.run``
through frame 0 and one whole mapping period. The window is then a whole
number of mapping periods within ``--seconds`` (``core/window.py``). With
``--trace 1`` the cell's per-layer metrics are reported; with ``--trace
0`` its end-to-end ones. The window runs under ``torch.profiler``
(CUDA activity only, started in set-up) whenever a metric reported reads
the device trace, as the end-to-end ``device_ms_per_frame`` does. With
``--trace 1`` the program's own spans and counters record too
(``PointSLAM.spans``, from the moment it is built), and the stage
figures are read from them and from the trace (``core/stages.py``); with
``--trace 0`` they stay off.

After the window: the peak device memory, the check that no JAX module
was loaded, the reader's depth against what was written, and the renders
kept from the window against the plain reference (``core/check.py``).
The last lines on standard error give each compared number beside its
limit; the last line on standard output is the result's JSON.

``--control tf32`` runs the configuration with the decoders' matmuls in
TF32 (``cuda.mlp_precision: default``), the control that the limits are
set against; the driver's runs never pass it.

The seed draws the sequence's sensor noise and holes and the iterations
and frames the check keeps. The program's own random streams take the
traffic's ``program_seed``, so every seed maps each frame for as many
iterations.

Exit codes: 0 a result was printed; 2 bad arguments or an unknown cell;
3 no CUDA device, or fewer than the cell asks for; 4 a JAX module was
loaded; 1 anything else.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
for _k, _d in (("TRITON_CACHE_DIR", "triton"),
               ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
               ("CUDA_CACHE_PATH", "nv")):
    os.environ[_k] = os.path.join(CACHE, _d)
# one process with few threads: the loop is bound by the host's launches,
# and idle pool threads spinning beside it only take cores from it
for _k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_k] = "1"
for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from core import check, guard, manifest, scene, trace  # noqa: E402
from core import window as W, yardstick  # noqa: E402


class Run:
    """What a run measured, for the metric readers: the window's spans
    and period marks, its trace (``--trace 1``), the program's span
    records (``--trace 1``; None otherwise), the counts the wrappers
    kept, and the configuration."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def window_spans(self) -> List[W.Span]:
        lo, hi = self.every + 1, self.every + self.frames
        return [s for s in self.spans if lo <= s.frame <= hi]


def card() -> Dict[str, Any]:
    """The card's name and power limit, as nvidia-smi reads them."""
    out = {"kind": torch.cuda.get_device_name(0), "power_limit_w": None}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=20)
        out["power_limit_w"] = float(r.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return out


def build_config(entry: Dict[str, Any], control: Optional[str],
                 traffic: Dict[str, Any],
                 cut: Optional[Dict[str, Any]] = None):
    """The cell's configuration over the program's defaults, with the
    program's own random streams (its decoders' initial weights, its
    pixel and densification draws) seeded from the traffic's
    ``program_seed``: those draws set how many points a frame adds and so
    how many iterations it maps, which the run's seed may not change.
    ``cut`` (tests only) is laid over it."""
    from point_slam_tpu_torch.config import CUDA_DEFAULTS, update_recursive
    cfg = copy.deepcopy(CUDA_DEFAULTS)
    update_recursive(cfg, copy.deepcopy(entry["config"]))
    update_recursive(cfg, copy.deepcopy(cut or {}))
    cfg["setup_seed"] = int(traffic["program_seed"])
    if control == "tf32":
        cfg["cuda"]["mlp_precision"] = "default"
    return cfg


def draws(seed: int, cfg: Dict[str, Any]):
    """The iteration of each tracked and mapped frame whose render and
    step the check keeps, each followed by another (the state the step
    leaves): any tracking iteration but the last; a mapping iteration
    that every mapped frame runs with one more after it (it runs at least
    ``min_iter_ratio`` x ``iters``) and that lies in the colour stage
    (which starts by ``geo_iter_ratio`` x 2 x ``iters`` at the latest)."""
    rng = np.random.default_rng([seed, 99])
    mp = cfg["mapping"]
    it_t = int(rng.integers(max(cfg["tracking"]["iters"] - 1, 1)))
    hi = max(int(mp["min_iter_ratio"] * mp["iters"]) - 1, 1)
    lo = min(int(mp["geo_iter_ratio"] * 2 * mp["iters"]) + 1, hi - 1)
    it_m = int(rng.integers(lo, hi))
    return it_t, it_m, rng


def run_cell(args, device: str, cut: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    bm = manifest.load_benchmark(ROOT)
    wl = manifest.workload(bm, args.workload)
    entry = manifest.config(bm, wl["config"])
    traffic = manifest.traffic(wl["traffic"])
    cut = dict(cut or {})
    traffic["frames"] = cut.pop("frames", traffic["frames"])
    cfg = build_config(entry, args.control, traffic, cut)
    traced = any(m["source"] == "device_trace" for m in
                 manifest.metrics_for(bm, wl["name"], bool(args.trace)))
    from point_slam_tpu_torch import mapper as mapper_mod
    from point_slam_tpu_torch import renderer
    from point_slam_tpu_torch import tracker as tracker_mod
    from point_slam_tpu_torch.ops import adam as adam_mod
    from point_slam_tpu_torch.ops import knn as knn_mod
    from point_slam_tpu_torch.slam import PointSLAM
    from point_slam_tpu_torch.utils import prefetch

    tmp = tempfile.mkdtemp(prefix="port_bench_")
    try:
        return _run(args, device, entry, traffic, cfg, tmp, renderer,
                    knn_mod, PointSLAM, prefetch,
                    (tracker_mod, mapper_mod, adam_mod), traced)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, device, entry, traffic, cfg, tmp, renderer, knn_mod,
         PointSLAM, prefetch, step_modules, traced_run):
    every = int(cfg["mapping"]["every_frame"])
    n_frames = int(traffic["frames"])
    data = os.path.join(tmp, "data")
    t_start = time.perf_counter()
    seq = scene.write_sequence(data, cfg, traffic, args.seed, n_frames,
                               device)
    t_written = time.perf_counter()
    slam = PointSLAM(copy.deepcopy(cfg), input_folder=data,
                     output=os.path.join(tmp, "out"), device=device)
    if args.trace:
        slam.spans.enable()
    t_built = time.perf_counter()
    it_t, it_m, rng = draws(args.seed, cfg)
    capture = check.Capture(renderer)
    steps = check.Steps(*step_modules, refine_frame=(
        n_frames - 1 if cfg["mapping"]["color_refine"] else -1))
    prefetchers = []
    orig_pf = prefetch.FramePrefetcher

    class Tracked(orig_pf):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            prefetchers.append(self)

    prefetch.FramePrefetcher = Tracked
    state: Dict[str, Any] = {"prof": None, "knn_bound_s": 0.0,
                             "knn_calls": 0, "t_open_ns": None}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def on_last_warm():
        # the profiler's own start-up lands in set-up, not in the window
        if traced_run:
            state["prof"] = trace.start(device)

    def on_open():
        sync()
        state["t_open_ns"] = time.time_ns()
        capture.counting = True

    def on_close():
        capture.counting = False
        capture.arm(None, -1)
        steps.arm(None, -1, -1)
        sync()
        if state["prof"] is not None:
            state["prof"].stop()

    def on_frame(name, idx, in_window):
        if in_window:
            kind = "track" if name == "track_frame" else "map"
            target = it_t if name == "track_frame" else it_m
            capture.arm(kind, target)
            steps.arm(kind, target, idx)
        else:
            capture.arm(None, -1)
            steps.arm(None, -1, idx)

    def on_knn(q, index, probes, k):
        r, ns = int(q.shape[0]), int(q.shape[1])
        p = min(max(int(probes) or 36, 1), 64)
        state["knn_bound_s"] += yardstick.ray_topk_bound_s(
            r, ns, p, int(index.max_per_cell), int(k))
        state["knn_calls"] += 1

    drv = W.Driver(slam, args.seconds, every, on_open, on_close, knn_mod,
                   on_knn=on_knn, on_frame=on_frame,
                   on_last_warm=on_last_warm)
    try:
        try:
            slam.run()
            drv.finish("sequence")
        except W.WindowClosed:
            pass
    finally:
        for pf in prefetchers:
            pf.close()
            pf._thread.join(timeout=60)
        prefetch.FramePrefetcher = orig_pf
        drv.restore()
        capture.restore()
        steps.restore()
    sync()
    if drv.t_open is None:
        raise RuntimeError("the sequence ended before the window opened")
    frames, window_s = W.whole_periods(drv.spans, every)
    walls = [x.t1 - x.t0 for x in drv.spans
             if x.name == "track_frame" and every < x.frame <= every + frames]
    setup_s = drv.t_open - T_PROCESS
    f0 = [x for x in drv.spans if x.frame == 0]
    t_f0 = f0[0].t1 if f0 else t_built
    print(f"setup_s {setup_s:.3f}: start {t_start - T_PROCESS:.3f}, "
          f"sequence ({n_frames} frames, {seq.n_bytes} bytes) "
          f"{t_written - t_start:.3f}, PointSLAM {t_built - t_written:.3f},"
          f" frame 0 {t_f0 - t_built:.3f}, warm-up period "
          f"{drv.t_open - t_f0:.3f}", file=sys.stderr)
    print(f"window: {frames} frames, {frames // every} periods, "
          f"{window_s:.3f} s, closed by {drv.closed_by}; host fps "
          f"{frames / window_s if window_s > 0 else 0.0!r}, track ms "
          f"{1e3 * sum(walls) / max(len(walls), 1)!r}; map_frame ms "
          + " ".join(f"{1e3 * (x.t1 - x.t0):.1f}" for x in drv.spans
                     if x.name == "map_frame" and x.frame > every)
          + "; track_frame ms " + " ".join(
              f"{1e3 * (x.t1 - x.t0):.1f}" for x in drv.spans
              if x.name == "track_frame" and x.frame > every)
          + "; mapping iterations " + " ".join(
              f"{i}:{st['n_iters']}" for i, st in
              sorted(slam.mapper.frame_stats.items())),
          file=sys.stderr)
    mem_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
    bad_modules = guard.loaded()
    if bad_modules:
        return {"forbidden": bad_modules}
    records = slam.spans.records() if slam.spans.on else None
    traced = None
    if state["prof"] is not None:
        marks = [m for m in drv.marks if m.frame == every + frames]
        t1_ns = marks[0].t_ns if marks else time.time_ns()
        t_r = time.perf_counter()
        by_name: Dict[str, list] = {}
        for x in drv.spans:
            by_name.setdefault(x.name, []).append((x.t0_ns, x.t1_ns))
        traced = trace.reduce(state["prof"], state["t_open_ns"], t1_ns,
                              by_name, records)
        state["prof"] = None
        print(f"trace: {traced['n_device_ops']} device operations, "
              f"{state['knn_calls']} kNN calls, busy "
              f"{traced['busy_s']!r} s of {traced['window_s']!r}, reduced in "
              f"{time.perf_counter() - t_r:.1f} s"
              + ("" if not records else
                 f"; {len(records)} span records, stages matched by "
                 f"{'thread' if traced['stage_by_thread'] else 'time'}"),
              file=sys.stderr)
    est = slam.estimate_c2w_list
    lo, hi = every + 1, every + frames
    failed = int(sum(not np.isfinite(est[i]).all() for i in range(lo,
                                                                  hi + 1)))
    gt = scene.gt_trajectory(seq, cfg["dataset"])
    ate = (float(np.sqrt(np.mean(np.sum(
        (est[lo:hi + 1, :3, 3] - gt[lo:hi + 1, :3, 3]) ** 2, -1))))
        if frames else math.nan)
    crop = int(cfg["cam"].get("crop_edge") or 0)
    pick = sorted(set(int(x) for x in rng.integers(lo, hi + 1, size=3))) \
        if frames else []
    nums = {"reader.depth_mismatch": check.reader_mismatch(
        slam.dataset, seq.depth_u16, pick, crop)}
    spans, marks = list(drv.spans), list(drv.marks)
    kept = capture.kept
    kept_steps = steps.kept
    calls = capture.calls
    del slam, drv, capture, steps
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    for kind in ("track", "map"):
        if kind in kept:
            nums.update(check.compare(kept[kind], cfg, kind, device))
        else:
            nums[f"{kind}.depth_gap"] = math.inf
            nums[f"{kind}.color_gap"] = math.inf
        if kind in kept_steps:
            nums.update(check.compare_step(kept_steps[kind], cfg, kind,
                                           device))
        else:
            nums[f"{kind}.step_gap"] = math.inf
    run = Run(every=every, frames=frames, window_s=window_s,
              spans=spans, marks=marks, records=records,
              setup_s=setup_s, trace=traced, cfg=cfg, entry=entry,
              knn_bound_s=state["knn_bound_s"],
              knn_calls=state["knn_calls"], render_calls=calls,
              ate_m=ate, device=device)
    return {"run": run, "nums": nums, "mem_peak": mem_peak,
            "failed": failed}


def main(argv=None, device: Optional[str] = None,
         cut: Optional[Dict[str, Any]] = None) -> int:
    """The command line. The CPU tests pass ``device`` (skipping the look
    for a card) and ``cut`` (configuration keys laid over the cell's, and
    ``frames``, the sequence's length) to run a cell at a small size."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0
    try:
        bm = manifest.load_benchmark(ROOT)
        wl = manifest.workload(bm, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    if device is None:
        chips = int(wl["chips"])
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            print(f"port_bench: {args.workload} needs {chips} CUDA "
                  f"device(s); this host has {n}", file=sys.stderr)
            return 3
        device = "cuda"
    out = run_cell(args, device, cut)
    if "forbidden" in out:
        print("port_bench: the run loaded JAX modules: "
              + ", ".join(out["forbidden"]), file=sys.stderr)
        return 4
    return report(args, bm, wl, out, device)


def report(args, bm, wl, out, device) -> int:
    run, nums = out["run"], out["nums"]
    entry = run.entry
    limits = entry["limits"]
    correct, lines = check.verdict(nums, limits)
    metrics = {}
    for m in manifest.metrics_for(bm, wl["name"], bool(args.trace)):
        v = manifest.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev: Dict[str, Any] = {"platform": "gpu" if device == "cuda" else
                           device, "count": 1,
                           "memory_peak_bytes": int(out["mem_peak"])}
    if device == "cuda":
        c = card()
        dev["kind"] = c["kind"]
        dev["power_limit_w"] = c["power_limit_w"]
    else:
        dev["kind"] = "cpu"
    result: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(run.frames),
        "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if run.trace is not None and args.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    info = {k: v for k, v in nums.items() if k not in limits}
    info["ate_window_m"] = run.ate_m
    result["info"] = {k: _finite(v) for k, v in info.items()}
    result["checks"] = [
        {"name": ln["name"], "value": _finite(ln["value"]),
         "limit": ln["limit"]} for ln in lines]
    for ln in lines:
        print(f"check {ln['name']}: {ln['value']!r} limit {ln['limit']!r}"
              f" {'ok' if ln['ok'] else 'FAIL'}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0


def _finite(v):
    """A number for the JSON line; None where it is not finite."""
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


if __name__ == "__main__":
    sys.exit(main())
