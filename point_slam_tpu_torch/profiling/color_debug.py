"""A numerical probe of the colour path: activations and gradient sums.

    python -m point_slam_tpu_torch.profiling.color_debug
        [--device cuda|cpu] [--small]

The port of ``profiling/color_debug.py``. On frame 0 of the synthetic
room at 240x320, densified once (``workload.densified_frame0``), one batch
of 2000 drawn pixels goes through ``render_rays`` in the colour stage.
Prints the colour L1 loss and the rays it counts, the rendered colour's
min / max / mean / std beside the ground truth's, the summed absolute
gradient of the packed leaf's colour, geometry and position columns and
of four colour-decoder weights (output_linear, pts_linears[0], fc_c[0],
mlp_col_neighbor.l1), and the range of the colour before its sigmoid
(``render_rays(..., apply_sigmoid_color=False)``). ``--small``: 48x64.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch import renderer as R
from point_slam_tpu_torch.profiling import workload as W


def weights(col) -> Dict[str, torch.Tensor]:
    """The four colour-decoder weights the probe reports."""
    return {"output_linear.w": col.output_linear.weight,
            "pts_linears0.w": col.pts_linears[0].weight,
            "fc_c0.w": col.fc_c[0].weight,
            "mlp_col_neighbor.l1.w": col.mlp_col_neighbor["l1"].weight}


def stats(x: torch.Tensor) -> Dict[str, float]:
    return {"min": float(x.min()), "max": float(x.max()),
            "mean": float(x.mean()), "std": float(torch.std(x,
                                                             unbiased=False))}


def probe(f0: W.Frame0, draw) -> Dict:
    """The probe on one draw {"i", "j", "fill"}."""
    m = f0.mapper
    gt_d, gt_c, rq, ro, rd = W.pixel_batch(f0, draw["i"], draw["j"])
    ok = gt_d > 0
    leaf = m.cloud.packed.detach().clone().requires_grad_(True)
    w = weights(m.decoders.col)
    _, _, col_r, valid_ray = R.render_rays(
        m.decoders, leaf, m.index, ro, rd, gt_d, rq, ok, m.rc,
        stage_color=True, fill=draw["fill"])
    mask = ok & valid_ray & (gt_d > 0)
    closs = torch.sum(torch.where(mask[:, None], torch.abs(gt_c - col_r),
                                  0.0))
    g = torch.autograd.grad(closs, [leaf] + list(w.values()))
    out = {"color_loss": float(closs.detach()), "rays": int(mask.sum()),
           "rendered": stats(col_r.detach()),
           "gt": stats(gt_c),
           "grad_packed": {name: float(torch.abs(g[0][:, sl]).sum())
                           for name, sl in (("col", pc.COL_SL),
                                            ("geo", pc.GEO_SL),
                                            ("pos", pc.POS_SL))},
           "grad_col": {name: float(torch.abs(gi).sum())
                        for name, gi in zip(w, g[1:])}}
    with torch.no_grad():
        raw = R.render_rays(m.decoders, m.cloud.packed, m.index, ro, rd, gt_d,
                            rq, ok, m.rc, stage_color=True,
                            apply_sigmoid_color=False, fill=draw["fill"])[2]
    out["pre_sigmoid"] = stats(raw)
    return out


def report(out: Dict) -> None:
    r, gt, gp = out["rendered"], out["gt"], out["grad_packed"]
    lines = [
        f"color loss {out['color_loss']:.2f} over {out['rays']} rays",
        f"rendered color stats: min {r['min']:.3f} max {r['max']:.3f} "
        f"mean {r['mean']:.3f} std {r['std']:.3f}",
        f"gt color mean {gt['mean']:.3f} std {gt['std']:.3f}",
        f"grad packed col cols: {gp['col']:.3e} (geo cols {gp['geo']:.3e}, "
        f"pos cols {gp['pos']:.3e})"]
    lines += [f"grad col.{k}: {v:.3e}" for k, v in out["grad_col"].items()]
    p = out["pre_sigmoid"]
    lines.append(f"pre-sigmoid color: min {p['min']:.2f} max {p['max']:.2f} "
                 f"mean {p['mean']:.2f} std {p['std']:.2f}")
    for ln in lines:
        print(f"[color_debug] {ln}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--small", action="store_true", help="48x64")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "color_debug")
    cfg = W.color_config(args.small)
    f0 = W.densified_frame0(cfg, dev, cfg["mapping"]["pixels_adding"])
    print(f"[color_debug] pts: {f0.mapper.n_points_host}", flush=True)
    out = probe(f0, W.pixel_draws(f0, cfg["mapping"]["pixels"], 5,
                                  fill=True)(1))
    report(out)
    W.save_json("color_debug_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
