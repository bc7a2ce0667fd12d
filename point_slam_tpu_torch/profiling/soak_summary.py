"""A soak run's summary: one JSON of what the run left behind.

    python -m point_slam_tpu_torch.profiling.soak_summary <run_dir>
        [--wedge-log output/torch/soak/soak.log] [--config CFG]
        [--device cuda|cpu]

From the run's newest checkpoint (either package's) it recomputes the ATE,
aligned and not (``tools/eval_ate.py``, not parsed from logs), and reads
the final point count, keyframes and capacity; from ``metrics.jsonl`` the
active wall time (record gaps under 120 s; longer gaps, such as a stall
and its kill and resume, are summed apart) and the final segment's timing
buckets and memory; the evaluation's files that ``soak_eval`` writes
(``render_metrics.json``, ``mesh/recon_eval.json``, ``eval_memory.json``)
when present; and the kill-and-resume lines of ``soak_runner``'s log.
``keyframe_ring`` is where the run's config keeps keyframe images (the
store's own rule; ``--config`` defaults to room_scannet_scale.yaml, which
forces the host ring). Writes ``soak_summary.json`` beside the run
directory. The summary reads files only; ``--device`` is checked as the
other tools check it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

import numpy as np

from point_slam_tpu_torch.profiling import workload as W

HERE = W.HERE
DEFAULT_LOG = os.path.join(W.OUTPUT, "torch", "soak", "soak.log")
DEFAULT_CONFIG = os.path.join(HERE, "configs", "Synthetic",
                              "room_scannet_scale.yaml")
RESUME_LINES = r"resume='--resume'|no log progress|wedged|injected stall"


def active_wall(metrics_path: str, gap_s: float = 120.0):
    """(the sum of record-to-record deltas below gap_s, the sum of those at
    or above it): the active wall time without stalls and the kill and
    resume windows, and what was left out."""
    ts = []
    with open(metrics_path) as f:
        for line in f:
            try:
                ts.append(json.loads(line)["t"])
            except Exception:  # noqa: BLE001 - a torn or foreign line
                pass
    ts = np.asarray(sorted(ts))
    if len(ts) < 2:
        return 0.0, 0.0
    dt = np.diff(ts)
    return float(dt[dt < gap_s].sum()), float(dt[dt >= gap_s].sum())


def _read(path: str):
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def timing_accounting(final):
    """The main thread's buckets (track/map/io/wait/log/other; the
    prefetch worker's overlapped counters left out) against the final
    segment's active wall. active_wall spans every segment of a killed and
    resumed run; these cover the last segment only."""
    phases = {k: v for k, v in final.items()
              if k.startswith("time_") and not k.startswith("time_prefetch")
              and k != "time_wall_active"}
    seg = final.get("time_wall_active")
    return {
        "phase_sum_s": round(sum(phases.values()), 1),
        # null (not NaN, which strict JSON lacks) without the attribution
        "segment_wall_s": round(seg, 1) if seg is not None else None,
        "unattributed_s": (round(seg - sum(phases.values()), 1)
                           if seg is not None else None),
        "note": ("pre-round-5 segment: only track/map/io were attributed"
                 if "time_wait" not in final else
                 "buckets: track/map/io/wait/log/other"),
    }


def summarize(run: str, wedge_log: str = DEFAULT_LOG,
              config: str = DEFAULT_CONFIG):
    """The summary dict (written to soak_summary.json beside ``run``)."""
    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.mapper import host_ring
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate
    from point_slam_tpu_torch.utils.logger import load_checkpoint

    run = run.rstrip("/")
    ckpts = sorted(glob.glob(os.path.join(run, "ckpts", "*.npz")))
    if not ckpts:
        raise SystemExit(f"no checkpoints under {run}")
    z = load_checkpoint(ckpts[-1])
    est = z["estimate_c2w_list"]
    gt = z["gt_c2w_list"]
    n_img = len(est)
    ate = evaluate_ate(gt, est, align=True)
    ate_na = evaluate_ate(gt, est, align=False)

    metrics_path = os.path.join(run, "metrics.jsonl")
    act, gaps = active_wall(metrics_path)
    final = {}
    with open(metrics_path) as f:
        for line in f:
            d = json.loads(line)
            if "final_n_points" in d:
                final = d

    resumes = []
    if os.path.exists(wedge_log):
        with open(wedge_log) as f:
            resumes = [line.strip() for line in f
                       if re.search(RESUME_LINES, line)]

    cfg = load_config(config, os.path.join(HERE, "configs",
                                           "point_slam.yaml"))
    ring = host_ring(cfg, n_img, cfg["mapping"]["keyframe_every"])
    cap_final = 1 << max(int(z["cloud_pos"].shape[0]) - 1, 1).bit_length()
    out = {
        "run_dir": run,
        "n_frames": int(n_img),
        "n_points": int(z["pts_num"]),
        "n_keyframes": int(len(z["keyframe_list"])),
        "point_capacity_final": cap_final,
        "packed_buffer_mb": round(cap_final * 72 * 4 / 1e6, 1),
        "keyframe_ring": "host" if ring else "device",
        "ate_rmse_cm": round(
            ate["absolute_translational_error.rmse"] * 100, 3),
        "ate_rmse_noalign_cm": round(
            ate_na["absolute_translational_error.rmse"] * 100, 3),
        "ate_max_noalign_cm": round(
            ate_na["absolute_translational_error.max"] * 100, 3),
        "wall_active_s": round(act, 1),
        "wall_excluded_gaps_s": round(gaps, 1),
        "final_segment_timing": {k: round(v, 1) for k, v in final.items()
                                 if k.startswith("time_")},
        "timing_accounting": timing_accounting(final),
        "final_memory": {k: final[k] for k in final if k.startswith("mem_")},
        "render_metrics": _read(os.path.join(run, "render_metrics.json")),
        "recon_eval": _read(os.path.join(run, "mesh", "recon_eval.json")),
        "eval_memory": _read(os.path.join(run, "eval_memory.json")),
        "kill_resume_log": resumes,
        "checkpoints": [os.path.basename(c) for c in ckpts],
    }
    dst = os.path.join(os.path.dirname(run), "soak_summary.json")
    with open(dst, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    print("written:", dst, flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir")
    ap.add_argument("--wedge-log", default=DEFAULT_LOG,
                    help="soak_runner's log (its kill and resume lines)")
    ap.add_argument("--config", default=DEFAULT_CONFIG,
                    help="the run's config (where its keyframes live)")
    W.add_device_arg(ap)
    args = ap.parse_args(argv)
    W.device(args.device, "soak_summary")
    return summarize(args.run_dir, args.wedge_log, args.config)


if __name__ == "__main__":
    main(sys.argv[1:])
