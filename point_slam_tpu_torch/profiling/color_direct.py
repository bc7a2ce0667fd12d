"""Fit the colour model directly at surface points, without compositing.

    python -m point_slam_tpu_torch.profiling.color_direct
        [--device cuda|cpu] [--steps 200] [--small]

The port of ``profiling/color_direct.py``: if this fits fast, the colour
model is fine and a plateau comes from compositing; if it also plateaus,
the decoder or the interpolation is the problem. On frame 0 of the
synthetic room at 240x320, densified once (``workload.densified_frame0``,
4000 rays), each step draws 2000 pixels, places a point at each pixel's
depth, interpolates its 8 nearest neighbours' colour features
(per-sample ``grid_knn``, inverse squared distance weights within the
query radius) through the colour decoder's relative-position encoder,
decodes RGB and takes the L1 loss; Adam (lr 0.005) steps the cloud's
colour columns and the colour decoder. Prints the loss at step 1 and
every 25 steps. ``--small``: 48x64, 400 and 200 rays.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List

import torch

from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch.models import decoders as D
from point_slam_tpu_torch.ops import adam, knn
from point_slam_tpu_torch.profiling import workload as W

STEPS = 200
LR = 0.005


def color_at(col, packed, index, p, rq, use_rel: bool = True):
    """RGB (N, 3) at points p from their 8 nearest neighbours' colour
    features; ``use_rel``: through the relative-position encoder."""
    dists, idx, vmask = knn.grid_knn(index, p, k=8)
    w = D.interpolation_weights(dists, vmask, rq, "distance")
    nb = packed[idx]
    nf = nb[..., pc.COL_SL]
    if use_rel:
        nf = col.encode_neighbor_feats(nb[..., pc.POS_SL].detach(), p, nf)
    c = torch.sum(w[..., None] * nf, dim=1)
    return col(p, c)


def direct_loss(f0: W.Frame0, col, use_rel: bool = True):
    """loss(packed, draw): the L1 colour loss at the drawn pixels' surface
    points."""
    def loss(packed, d):
        gt_d, gt_c, rq, ro, rd = W.pixel_batch(f0, d["i"], d["j"])
        pred = color_at(col, packed, f0.mapper.index, ro + rd * gt_d[:, None],
                        rq, use_rel)
        ok = gt_d > 0
        return torch.sum(torch.where(ok[:, None], torch.abs(gt_c - pred),
                                     0.0))
    return loss


def lr_row(device, lr: float, geo: bool = False) -> torch.Tensor:
    """The packed leaf's (72,) learning rates: ``lr`` on the colour
    columns (and the geometry ones with ``geo``), 0 elsewhere."""
    row = torch.zeros(pc.PACK_W, device=device)
    row[pc.COL_SL] = lr
    if geo:
        row[pc.GEO_SL] = lr
    return row


def adam_fit(packed: torch.Tensor, col, loss: Callable, steps: int,
             lr_packed: torch.Tensor, lr: float, draws: Callable,
             report: Callable = None) -> List:
    """``steps`` Adam steps (t = 1, 2, ...) of the packed leaf (per-column
    ``lr_packed``) and the colour decoder ``col`` (``lr``, in place) on
    loss(packed, draws(t)), which returns the loss or (loss, aux). Returns
    each step's loss (or (loss, aux)) as floats; ``report(t, value)``
    after each step."""
    params = list(col.parameters())
    leaf = packed.detach().clone()
    state = adam.init_state([leaf] + params)
    out = []
    for t in range(1, steps + 1):
        x = leaf.requires_grad_(True)
        res = loss(x, draws(t))
        total = res[0] if isinstance(res, tuple) else res
        g = torch.autograd.grad(total, [x] + params, allow_unused=True)
        g = [torch.zeros_like(p) if gi is None else gi
             for p, gi in zip([x] + params, g)]
        new, state = adam.update([leaf.detach()] + [p.detach()
                                                    for p in params],
                                 g, state, float(t),
                                 [lr_packed] + [lr] * len(params))
        leaf = new[0]
        with torch.no_grad():
            for p, q in zip(params, new[1:]):
                p.copy_(q)
        value = (float(total.detach()) if not isinstance(res, tuple) else
                 (float(total.detach()),
                  tuple(float(a.detach()) for a in res[1])))
        out.append(value)
        if report is not None:
            report(t, value)
    return out


def fit(f0: W.Frame0, steps: int = STEPS, lr: float = LR, draws=None,
        col=None, use_rel: bool = True, n_pixels: int = 2000, seed: int = 11,
        report=None) -> List[float]:
    """The direct fit: each step's L1 colour loss. ``col``: the colour
    decoder to train (in place; the frame's own by default); ``draws``:
    draws(t) -> {"i", "j"} (``workload.pixel_draws`` by default)."""
    col = f0.mapper.decoders.col if col is None else col
    draws = draws or W.pixel_draws(f0, n_pixels, seed)
    return adam_fit(f0.mapper.cloud.packed, col, direct_loss(f0, col, use_rel),
                    steps, lr_row(f0.depth.device, lr), lr, draws, report)


def print_every(tag: str, what: str, every: int = 25):
    def report(t, value):
        if t == 1 or t % every == 0:
            print(f"[{tag}] it {t:3d}: {what} {value:8.1f}", flush=True)
    return report


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--small", action="store_true",
                    help="48x64, 400 densification and 200 loss rays")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "color_direct")
    cfg = W.color_config(args.small)
    f0 = W.densified_frame0(cfg, dev, cfg["mapping"]["pixels_adding"])
    print(f"[color_direct] pts: {f0.mapper.n_points_host}", flush=True)
    losses = fit(f0, args.steps, n_pixels=cfg["mapping"]["pixels"],
                 report=print_every("color_direct", "direct col loss"))
    out = {"losses": losses}
    W.save_json("color_direct_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
