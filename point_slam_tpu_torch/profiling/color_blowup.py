"""Diagnose a seed-dependent colour blow-up: parameter and feature norms,
the colour before its sigmoid, NaN flags.

    python -m point_slam_tpu_torch.profiling.color_blowup
        [--device cuda|cpu] [--seed N] [--iters-first 500] [--small]

The port of ``profiling/color_blowup.py``. The mapper at the bench's
widths (680x1200, 5000 mapping rays, 6000 + 1000 densification rays,
CAP 2^19, ``cuda.max_iters_per_launch`` 25) maps frame 0 of the synthetic
room (``map_frame(0)``: 500 iterations, 200 of them in the geometry
stage) with ``setup_seed`` ``--seed``. Prints the frame's colour loss
and points, each colour-decoder part's squared norm before and after,
the std and largest magnitude of the cloud's colour and geometry
features, the pre-sigmoid colour of a 2000-pixel render and whether any
feature or colour parameter is NaN. ``--small``: a 48x64 camera and CAP
2^13 (``workload.bench_config``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch import renderer as R
from point_slam_tpu_torch.profiling import workload as W

ITERS_FIRST = 500
GEO_ITER_FIRST = 200
CAP = 1 << 19


def config(seed: int, iters_first: int = ITERS_FIRST,
           geo_iter_first: int = GEO_ITER_FIRST, small: bool = False):
    cfg = W.bench_config(2, iters_first=iters_first, small=small)
    cfg["mapping"]["geo_iter_first"] = geo_iter_first
    if not small:
        cfg["cuda"]["point_capacity_init"] = CAP
    cfg["cuda"]["max_iters_per_launch"] = 25
    cfg["setup_seed"] = seed
    return cfg


def norms(col) -> Dict[str, float]:
    """Squared norm of each top-level part of the colour decoder (its
    parameters and its fixed embedding), by name."""
    out: Dict[str, float] = {}
    for name, t in list(col.named_parameters()) + list(col.named_buffers()):
        key = name.split(".")[0]
        out[key] = out.get(key, 0.0) + float(torch.sum(t.detach() ** 2))
    return out


def feature_stats(packed: torch.Tensor, n: int) -> Dict[str, float]:
    live = packed[:n]
    return {f"{k}_{s}": v for k, sl in (("col", pc.COL_SL),
                                        ("geo", pc.GEO_SL))
            for s, v in (("std", float(torch.std(live[:, sl],
                                                  unbiased=False))),
                         ("max", float(torch.abs(live[:, sl]).max())))}


def run(cfg, dev, seed: int = 0, n_pixels: int = 2000,
        mapper=None) -> Dict:
    """Map frame 0 and report (``mapper``: the mapper to use, a fresh one
    on ``cfg`` with decoders from ``seed`` by default)."""
    mapper = mapper or W.make_mapper(cfg, dev, seed)
    before = norms(mapper.decoders.col)
    color, depth, c2w = W.frame(cfg, 0)
    st = mapper.map_frame(0, color, depth, c2w, c2w)
    out = {"color_loss": float(st["color_loss"]),
           "n_points": int(mapper.n_points_host),
           "norms_before": before, "norms_after": norms(mapper.decoders.col),
           "features": feature_stats(mapper.cloud.packed,
                                     mapper.n_points_host)}
    f0 = W.Frame0(mapper, *(torch.as_tensor(a, device=dev)
                            for a in (color, depth, c2w)),
                  mapper.radius_maps(torch.as_tensor(color, device=dev))[1])
    d = W.pixel_draws(f0, n_pixels, 3, fill=True)(1)
    gt_d, _, rq, ro, rd = W.pixel_batch(f0, d["i"], d["j"])
    with torch.no_grad():
        raw = R.render_rays(mapper.decoders, mapper.cloud.packed, mapper.index,
                            ro, rd, gt_d, rq, gt_d > 0, mapper.rc,
                            stage_color=True, apply_sigmoid_color=False,
                            fill=d["fill"])[2]
    out["pre_sigmoid"] = {"min": float(raw.min()), "max": float(raw.max()),
                          "mean": float(raw.mean()),
                          "std": float(torch.std(raw, unbiased=False))}
    live = mapper.cloud.packed[:mapper.n_points_host]
    out["nan_feats"] = bool(torch.isnan(live).any())
    out["nan_col_params"] = any(bool(torch.isnan(p).any())
                                for p in mapper.decoders.col.parameters())
    return out


def report(out: Dict) -> None:
    print(f"[color_blowup] mapped: col {out['color_loss']:.1f} pts "
          f"{out['n_points']}", flush=True)
    for k, v0 in out["norms_before"].items():
        print(f"[color_blowup] col.{k}: |w|^2 {v0:10.2f} -> "
              f"{out['norms_after'][k]:10.2f}", flush=True)
    f = out["features"]
    print(f"[color_blowup] col feats: std {f['col_std']:.3f}  max|.| "
          f"{f['col_max']:.2f}; geo feats: std {f['geo_std']:.3f}  max|.| "
          f"{f['geo_max']:.2f}", flush=True)
    p = out["pre_sigmoid"]
    print(f"[color_blowup] pre-sigmoid: min {p['min']:.2f} max "
          f"{p['max']:.2f} mean {p['mean']:.2f} std {p['std']:.2f}; nan in "
          f"feats: {out['nan_feats']}, nan in col params: "
          f"{out['nan_col_params']}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--seed", type=int, default=0, help="setup_seed")
    ap.add_argument("--iters-first", type=int, default=ITERS_FIRST)
    ap.add_argument("--geo-iter-first", type=int, default=GEO_ITER_FIRST)
    ap.add_argument("--small", action="store_true",
                    help="a 48x64 camera, CAP 2^13")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "color_blowup")
    cfg = config(args.seed, args.iters_first, args.geo_iter_first, args.small)
    out = run(cfg, dev)
    report(out)
    W.save_json("color_blowup_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
