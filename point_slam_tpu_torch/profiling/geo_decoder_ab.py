"""A/B of the geometry decoder's regime over the furnished pipeline.

    python -m point_slam_tpu_torch.profiling.geo_decoder_ab [n_frames]
        [freeze_after] [--variants train_always,freeze_after,pretrained_frozen]
        [--device cuda|cpu]

Three regimes on ``configs/Synthetic/room_furnished.yaml`` over n_frames
(150 by default), each through SLAM, the re-render, the mesh and the
reconstruction eval:

* ``train_always``: a random geometry decoder, trained throughout;
* ``freeze_after_N``: the same, frozen from mapped frame N on
  (``mapping.fix_geo_decoder_after``, 20 by default);
* ``pretrained_frozen``: the reference's regime, the pretrained decoder
  (``pretrained/middle_fine.npz``, or ``PRETRAIN_NPZ``) loaded and frozen
  for the whole run; it runs when the file exists.

Each variant names its regime explicitly, so the config's default (which
follows whether the npz exists) does not decide it. A row per variant:
wall seconds, ATE without alignment, F-score, PSNR, MS-SSIM and
rendered-depth L1. Writes ``output/torch/geo_ab/<variant>/`` (the run and
its ``row.json``) and the rows run in ``results.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from point_slam_tpu_torch.profiling import bf16_ab as AB
from point_slam_tpu_torch.profiling import quality_gate as QG
from point_slam_tpu_torch.profiling import workload as W

VARIANTS = ("train_always", "freeze_after", "pretrained_frozen")


def pretrained_npz() -> str:
    return os.environ.get("PRETRAIN_NPZ", os.path.join(
        QG.HERE, "pretrained", "middle_fine.npz"))


def run_variant(tag: str, n_frames: int, dev, fix_after: int,
                pretrained: str = "", root: str = QG.HERE, cfg_hook=None):
    out = os.path.join(AB.ab_dir("geo_ab", root), tag)
    cfg = QG.pipeline_config(QG.DEFAULT_CONFIG, n_frames, out)
    cfg["mapping"]["fix_geo_decoder_after"] = fix_after
    # pretrained: load and freeze for the run; "": train (frozen at N)
    cfg["pretrained_decoders"] = {"middle_fine": pretrained}
    cfg["mapping"]["fix_geo_decoder"] = bool(pretrained)
    if cfg_hook is not None:
        cfg_hook(cfg)
    _, _, wall, res = QG.run_pipeline(cfg, dev)
    row = AB.ab_row(tag, wall, res, fix_after=fix_after)
    with open(os.path.join(out, "row.json"), "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row), flush=True)
    return row


def run(n_frames: int, freeze_after: int, dev, variants=None,
        root: str = QG.HERE, cfg_hook=None):
    variants = variants or list(VARIANTS)
    rows = []
    for v in variants:
        if v == "train_always":
            rows.append(run_variant(v, n_frames, dev, 0, root=root,
                                    cfg_hook=cfg_hook))
        elif v == "freeze_after":
            rows.append(run_variant(f"freeze_after_{freeze_after}",
                                    n_frames, dev, freeze_after, root=root,
                                    cfg_hook=cfg_hook))
        elif v == "pretrained_frozen":
            npz = pretrained_npz()
            if os.path.exists(npz):
                rows.append(run_variant(v, n_frames, dev, 0, npz, root,
                                        cfg_hook))
            else:
                print(f"pretrained_frozen: no {npz}; not run", flush=True)
        else:
            raise ValueError(f"geo_decoder_ab: variant {v!r} not in "
                             f"{VARIANTS}")
    print("\n| variant | ATE cm | F-score | PSNR | MS-SSIM | depth L1 cm |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['variant']} | {r['ate_cm']} | {r['fscore']} | "
              f"{r['psnr']} | {r['ms_ssim']} | {r['depth_l1_cm']} |",
              flush=True)
    with open(os.path.join(AB.ab_dir("geo_ab", root), "results.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=150)
    ap.add_argument("freeze_after", nargs="?", type=int, default=20)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, of " + ", ".join(VARIANTS))
    W.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "geo_decoder_ab")
    return run(args.n_frames, args.freeze_after, dev,
               args.variants.split(","))


if __name__ == "__main__":
    main(sys.argv[1:])
