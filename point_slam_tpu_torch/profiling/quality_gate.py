"""The quality gate: one command, one row of quality metrics.

    python -m point_slam_tpu_torch.profiling.quality_gate [n_frames] [tag]
        [--config configs/Synthetic/room_furnished.yaml] [--standing]
        [--device cuda|cpu]
    python -m point_slam_tpu_torch.profiling.quality_gate --check
    QG_CUDA_OVERRIDES='{"mlp_precision": "default"}' \\
        python -m point_slam_tpu_torch.profiling.quality_gate 100 mlp_default

Runs the furnished synthetic scene end to end (SLAM, then the re-render,
the TSDF mesh and the reconstruction eval) and writes one row: ATE aligned
and without alignment, F-score, precision, recall, PSNR, MS-SSIM, LPIPS,
rendered-depth L1, the run's timing buckets and memory, the commit, the
card (``nvidia-smi`` name and power limit, or "cpu") and any ``cuda:``
overrides (``QG_CUDA_OVERRIDES``, a JSON object merged into
``cfg["cuda"]``).

Files: ``output/torch/quality_gate.json`` is the standing gate (an
untagged run); a tagged run is an A/B probe written to
``output/torch/quality_gate_<tag>.json`` and judged against the standing
gate: PASS when its ATE without alignment is at most max(0.25, 1.1 x the
gate's) cm and its F-score at least the gate's - 0.5. With ``--standing``
a tagged run is a second standing gate of its own (e.g. ``sensor`` with
``--config configs/Synthetic/room_sensor.yaml``). The port's files live
apart from the JAX package's ``output/quality_gate*.json`` and never mix
with them.

Staleness: a standing gate certifies the product code (``PRODUCT_PATHS``)
of the commit it ran at. A standing run from a tree whose product code has
uncommitted changes is refused (``QG_ALLOW_DIRTY=1`` overrides); outside a
git checkout the commit is ``unknown``, which ``--check`` never
certifies. ``--check`` audits every ``output/torch/quality_gate*.json``:
a standing file fails with a -dirty or unknown commit, or when product
code changed between its commit and HEAD; probes are listed, not audited.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional, Tuple

from point_slam_tpu_torch.profiling import workload as W

HERE = W.HERE
PRODUCT_PATHS = ["point_slam_tpu_torch", "configs"]
STANDING_FILES = ("quality_gate.json", "quality_gate_sensor.json")
DEFAULT_CONFIG = "configs/Synthetic/room_furnished.yaml"


def gate_dir(root: str = HERE) -> str:
    """The port's gate files: output/torch under ``root``."""
    return os.path.join(root, "output", "torch")


def product_dirty(root: str = HERE) -> bool:
    """True when product code (``PRODUCT_PATHS``) has uncommitted changes.
    Evidence files (output/, documents, tests) never block a standing
    run: the same scope ``check_stale`` audits."""
    r = subprocess.run(["git", "status", "--porcelain", "--",
                        *PRODUCT_PATHS],
                       cwd=root, capture_output=True, text=True)
    return bool(r.stdout.strip())


def check_stale(root: str = HERE) -> int:
    """Audit the port's gate files for staleness against HEAD's product
    code: 2 when a standing file is stale, else 0."""
    fails = []
    for path in sorted(glob.glob(os.path.join(gate_dir(root),
                                              "quality_gate*.json"))):
        with open(path) as f:
            row = json.load(f)
        c = str(row.get("commit", "")).replace("-dirty", "")
        name = os.path.basename(path)
        # probes (a tag without --standing) are evidence, not
        # certifications; a row without the field is standing when it is
        # one of the two standing files
        if not row.get("standing", name in STANDING_FILES):
            print(f"probe (not audited): {name} "
                  f"[{row.get('commit')}, tag={row.get('tag')!r}]")
            continue
        if row.get("commit", "").endswith("-dirty") or c in ("", "unknown"):
            fails.append(f"{name}: dirty/unknown commit tag "
                         f"{row.get('commit')!r}")
            continue
        r = subprocess.run(
            ["git", "diff", "--name-only", f"{c}..HEAD", "--",
             *PRODUCT_PATHS], cwd=root, capture_output=True, text=True)
        if r.returncode != 0:
            fails.append(f"{name}: unknown commit {c}")
            continue
        changed = r.stdout.strip().splitlines()
        if changed:
            fails.append(f"{name}: product code changed since {c}: "
                         f"{changed[:5]}{'...' if len(changed) > 5 else ''}")
    for f in fails:
        print("STALE:", f)
    if not fails:
        print("all committed gate files certify HEAD product code")
    return 2 if fails else 0


def passes(row: Dict[str, Any], gate: Dict[str, Any]) -> bool:
    """The gate rule: ATE without alignment at most max(0.25, 1.1 x the
    gate's) cm and F-score at least the gate's - 0.5."""
    return (row["ate_noalign_cm"] <= max(0.25, 1.1 * gate["ate_noalign_cm"])
            and row["fscore"] >= gate["fscore"] - 0.5)


def commit_of(root: str = HERE) -> Tuple[str, bool]:
    """(short HEAD commit, product code dirty); ("unknown", False) outside
    a git checkout (e.g. a ``git archive`` copy)."""
    try:
        r = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                           cwd=root, capture_output=True, text=True)
    except OSError:
        return "unknown", False
    if r.returncode != 0 or not r.stdout.strip():
        return "unknown", False
    return r.stdout.strip(), product_dirty(root)


def device_name(dev) -> str:
    """The card as nvidia-smi names it (name, power limit), or "cpu"."""
    import torch
    if torch.device(dev).type != "cuda":
        return "cpu"
    from point_slam_tpu_torch.profiling.scene import card_line
    return card_line()


def pipeline_config(config: str, n_frames: int, output: str,
                    overrides: Optional[Dict[str, Any]] = None):
    """``config`` (relative to the repository or absolute) over n_frames
    with the re-render, image metrics, mesh and reconstruction eval on."""
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(HERE, config),
                      os.path.join(HERE, "configs", "point_slam.yaml"))
    cfg["synthetic"]["n_frames"] = n_frames
    if overrides:
        cfg["cuda"].update(overrides)
    cfg["reconstruction_datasets"] = ["synthetic"]
    cfg["render_datasets"] = ["synthetic"]
    cfg["rendering"]["eval_img"] = True
    cfg["meshing"]["eval_rec"] = True
    cfg["verbose"] = False
    cfg["data"]["output"] = output
    return cfg


def run_pipeline(cfg, dev):
    """PointSLAM over the config's frames, then the end-of-run eval:
    (slam, summary, run wall seconds, eval results)."""
    from point_slam_tpu_torch.slam import PointSLAM
    from point_slam_tpu_torch.tools.evaluate import run_end_of_run_eval
    slam = PointSLAM(cfg, device=dev)
    summary, wall = W.host_s(slam.run, dev)
    res = run_end_of_run_eval(slam, slam.output)
    return slam, summary, wall, res


def metric_row(res: Dict[str, Any]) -> Dict[str, Any]:
    """The eval's quality metrics in the gate's units and rounding."""
    nan = float("nan")
    return {
        "ate_cm": round(res.get("ate_rmse", nan) * 100, 3),
        "ate_noalign_cm": round(res.get("ate_rmse_no_align", nan) * 100, 3),
        "fscore": round(res.get("recon_F_score", nan), 2),
        "precision": round(res.get("recon_precision", nan), 2),
        "recall": round(res.get("recon_recall", nan), 2),
        "psnr": round(res.get("avg_psnr", nan), 2),
        "ms_ssim": round(res.get("avg_ms_ssim", nan), 4),
        "lpips": res.get("avg_lpips"),
        "depth_l1_cm": round(res.get("depth_l1_render", nan) * 100, 3),
    }


def run_gate(n_frames: int = 100, tag: str = "",
             config: str = DEFAULT_CONFIG, standing: bool = False,
             device: str = "cuda", root: str = HERE,
             overrides: Optional[Dict[str, Any]] = None, cfg_hook=None):
    """One gate run; returns (row, verdict): verdict is PASS/FAIL (True /
    False) of a probe against the standing gate, None when nothing was
    judged. ``cfg_hook(cfg)`` edits the config before the run (depth cuts
    of a smoke run). Writes under ``gate_dir(root)``."""
    import torch
    from point_slam_tpu_torch.utils.memory import memory_report
    dev = W.device(device, "quality_gate")
    if overrides is None:
        overrides = json.loads(os.environ.get("QG_CUDA_OVERRIDES", "{}"))
    if overrides:
        print(f"cuda overrides: {overrides}", flush=True)
    commit, dirty = commit_of(root)
    if dirty and (not tag or standing) \
            and not os.environ.get("QG_ALLOW_DIRTY"):
        raise SystemExit("refusing to update a STANDING gate from a dirty "
                         "tree (commit first, or set QG_ALLOW_DIRTY=1 / "
                         "pass a tag for an A/B probe)")
    out_dir = gate_dir(root)
    cfg = pipeline_config(config, n_frames, os.path.join(
        out_dir, "quality_gate" + ("_" + tag if tag else "")), overrides)
    if cfg_hook is not None:
        cfg_hook(cfg)
    slam, summary, wall, res = run_pipeline(cfg, dev)
    row = {
        "tag": tag or "gate",
        "standing": bool(standing or not tag),
        "config": config,
        "commit": commit + ("-dirty" if dirty else ""),
        "device": device_name(dev),
        "n_frames": n_frames,
        "cuda_overrides": overrides,
        "wall_s": round(wall, 1),
        "n_points": int(slam.mapper.n_points_host),
        **metric_row(res),
        "timing_s": {k: round(v, 1) for k, v in summary["timing"].items()},
        "memory": memory_report(dev),
    }
    if "failed" in res:
        row["failed"] = res["failed"]
    print(json.dumps(row, indent=1), flush=True)
    del slam
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    os.makedirs(out_dir, exist_ok=True)
    gate_path = os.path.join(out_dir, "quality_gate.json")
    if not tag:
        with open(gate_path, "w") as f:
            json.dump(row, f, indent=1)
        print(f"standing gate updated: {gate_path}", flush=True)
        return row, None
    # an A/B probe (or, with --standing, a standing gate of its own):
    # written beside the main gate, never over it
    probe = os.path.join(out_dir, f"quality_gate_{tag}.json")
    with open(probe, "w") as f:
        json.dump(row, f, indent=1)
    if standing:
        print(f"standing gate updated: {probe}", flush=True)
        return row, None
    if not os.path.exists(gate_path):
        return row, None
    with open(gate_path) as f:
        gate = json.load(f)
    ok = passes(row, gate)
    print(f"vs standing gate ({gate['commit']}): {'PASS' if ok else 'FAIL'} "
          f"(ATE {gate['ate_noalign_cm']} -> {row['ate_noalign_cm']} cm, "
          f"F {gate['fscore']} -> {row['fscore']})", flush=True)
    return row, ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=100)
    ap.add_argument("tag", nargs="?", default="")
    ap.add_argument("--check", action="store_true",
                    help="staleness audit of the gate files, no run")
    ap.add_argument("--config", default=DEFAULT_CONFIG,
                    help="the gate's scene config (e.g. configs/Synthetic/"
                         "room_sensor.yaml for the sensor-shaped gate)")
    ap.add_argument("--standing", action="store_true",
                    help="with a tag: write quality_gate_<tag>.json as a "
                         "standing gate of its own (no A/B verdict)")
    W.add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.check:
        sys.exit(check_stale())
    t0 = time.perf_counter()
    row, verdict = run_gate(args.n_frames, args.tag, args.config,
                            args.standing, args.device)
    print(f"[quality_gate] {time.perf_counter() - t0:.1f} s with the "
          "evaluation", flush=True)
    if verdict is False:
        sys.exit(3)
    return row


if __name__ == "__main__":
    main(sys.argv[1:])
