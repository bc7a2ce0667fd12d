"""Isolated colour training through the renderer: does the loss fall
with plain Adam?

    python -m point_slam_tpu_torch.profiling.color_train_iso
        [--device cuda|cpu] [--steps 200] [--small]

The port of ``profiling/color_train_iso.py``. On frame 0 of the synthetic
room at 240x320, densified once (``workload.densified_frame0``), each step
renders 2000 drawn pixels through ``render_rays`` in the colour stage (the
ray kNN on the card) and takes the geometry L1 plus 0.1 x the colour L1
over the rays with depth and enough neighbours; Adam (lr 0.005) steps
the cloud's geometry and colour columns and the colour decoder (the
geometry decoder stays). Prints both losses at step 1 and every 25
steps. ``--small``: 48x64, 400 and 200 rays.
"""

from __future__ import annotations

import argparse
import sys

import torch

from point_slam_tpu_torch import renderer as R
from point_slam_tpu_torch.profiling import color_direct as CD
from point_slam_tpu_torch.profiling import workload as W

STEPS = 200
LR = 0.005
W_COLOR = 0.1


def iso_loss(f0: W.Frame0):
    """loss(packed, draw) -> (geo + 0.1 col, (geo, col))."""
    m = f0.mapper

    def loss(packed, d):
        gt_d, gt_c, rq, ro, rd = W.pixel_batch(f0, d["i"], d["j"])
        ok = gt_d > 0
        depth_r, _, col_r, valid_ray = R.render_rays(
            m.decoders, packed, m.index, ro, rd, gt_d, rq, ok, m.rc,
            stage_color=True, fill=d["fill"])
        mask = ok & valid_ray
        geo_l = torch.sum(torch.where(mask, torch.abs(gt_d - depth_r), 0.0))
        col_l = torch.sum(torch.where(mask[:, None],
                                      torch.abs(gt_c - col_r), 0.0))
        return geo_l + W_COLOR * col_l, (geo_l, col_l)
    return loss


def fit(f0: W.Frame0, steps: int = STEPS, draws=None, n_pixels: int = 2000,
        seed: int = 11, report=None):
    """Each step's (loss, (geo, col))."""
    draws = draws or W.pixel_draws(f0, n_pixels, seed, fill=True)
    return CD.adam_fit(f0.mapper.cloud.packed, f0.mapper.decoders.col,
                       iso_loss(f0), steps,
                       CD.lr_row(f0.depth.device, LR, geo=True), LR, draws,
                       report)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--small", action="store_true",
                    help="48x64, 400 densification and 200 loss rays")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "color_train_iso")
    cfg = W.color_config(args.small)
    f0 = W.densified_frame0(cfg, dev, cfg["mapping"]["pixels_adding"])
    print(f"[color_train_iso] pts: {f0.mapper.n_points_host}", flush=True)

    def report(t, value):
        if t == 1 or t % 25 == 0:
            print(f"[color_train_iso] it {t:3d}: geo {value[1][0]:8.2f} col "
                  f"{value[1][1]:8.1f}", flush=True)
    out = {"losses": fit(f0, args.steps, n_pixels=cfg["mapping"]["pixels"],
                         report=report)}
    W.save_json("color_train_iso_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
