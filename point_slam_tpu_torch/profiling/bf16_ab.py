"""A/B of the render view: f32 against ``cuda.bf16_features`` over the
furnished pipeline.

    python -m point_slam_tpu_torch.profiling.bf16_ab [n_frames]
        [--variants f32,bf16] [--device cuda|cpu]

The bf16 view halves the bytes of the hot loops' gathers and scatters but
rounds the features in the forward pass (``pointcloud.encode_render``).
Tiny configurations mislead in both directions, so the decision needs the
whole pipeline: ``configs/Synthetic/room_furnished.yaml`` over n_frames
(100 by default) in its shipped regime (the pretrained geometry decoder,
frozen), each variant through SLAM, the re-render, the mesh and the
reconstruction eval. A row per variant: the run's wall seconds, ATE without
alignment, F-score, PSNR, MS-SSIM and rendered-depth L1. Writes
``output/torch/bf16_ab/<variant>/`` (the run, and its row in
``row.json``) and the rows run in ``results.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from point_slam_tpu_torch.profiling import quality_gate as QG
from point_slam_tpu_torch.profiling import workload as W

VARIANTS = {"f32": False, "bf16": True}


def ab_dir(name: str, root: str = QG.HERE) -> str:
    return os.path.join(QG.gate_dir(root), name)


def ab_row(variant: str, wall: float, res, **extra):
    """The A/B's row: the variant, its wall seconds and its quality."""
    m = QG.metric_row(res)
    return {"variant": variant, **extra, "wall_s": round(wall, 1),
            "ate_cm": m["ate_noalign_cm"], "fscore": m["fscore"],
            "psnr": m["psnr"], "ms_ssim": m["ms_ssim"],
            "depth_l1_cm": m["depth_l1_cm"]}


def run_variant(tag: str, n_frames: int, dev, bf16: bool,
                root: str = QG.HERE, cfg_hook=None):
    out = os.path.join(ab_dir("bf16_ab", root), tag)
    cfg = QG.pipeline_config(QG.DEFAULT_CONFIG, n_frames, out)
    cfg["cuda"]["bf16_features"] = bf16
    if cfg_hook is not None:
        cfg_hook(cfg)
    _, _, wall, res = QG.run_pipeline(cfg, dev)
    row = ab_row(tag, wall, res)
    with open(os.path.join(out, "row.json"), "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row), flush=True)
    return row


def print_table(rows) -> None:
    print("\n| variant | wall s | ATE cm | F-score | PSNR | MS-SSIM | "
          "depth L1 cm |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['variant']} | {r['wall_s']} | {r['ate_cm']} | "
              f"{r['fscore']} | {r['psnr']} | {r['ms_ssim']} | "
              f"{r['depth_l1_cm']} |", flush=True)


def run(n_frames: int, dev, variants=None, root: str = QG.HERE,
        cfg_hook=None):
    rows = [run_variant(v, n_frames, dev, VARIANTS[v], root, cfg_hook)
            for v in (variants or list(VARIANTS))]
    print_table(rows)
    with open(os.path.join(ab_dir("bf16_ab", root), "results.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=100)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, of " + ", ".join(VARIANTS))
    W.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "bf16_ab")
    return run(args.n_frames, dev, args.variants.split(","))


if __name__ == "__main__":
    main(sys.argv[1:])
