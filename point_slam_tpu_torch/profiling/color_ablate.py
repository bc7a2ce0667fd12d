"""Ablate the colour model's parts to find what blocks the fit.

    python -m point_slam_tpu_torch.profiling.color_ablate
        [--device cuda|cpu] [--steps 150] [--small]

The port of ``profiling/color_ablate.py``: ``color_direct``'s fit (colour
at surface points, no compositing) in six variants, each from the same
initial decoders and cloud (``workload.densified_frame0``) and the same
pixel draws, ``--steps`` Adam steps each: the baseline (the colour
decoder's fixed positional embedding at scale 32, the relative-position
encoder, lr 0.005), no positional embedding (its matrix zeroed), no
relative-position encoder (the neighbours' raw colour features), the
embedding at scale 3, scale 3 with no relative encoder, and lr 0.02.
Prints each variant's first and last loss.
"""

from __future__ import annotations

import argparse
import copy
import sys
from typing import Dict, NamedTuple, Optional

import torch

from point_slam_tpu_torch.profiling import color_direct as CD
from point_slam_tpu_torch.profiling import workload as W

STEPS = 150


class Variant(NamedTuple):
    name: str
    emb_scale: Optional[float] = None   # the embedding matrix times this/32
    use_rel: bool = True
    zero_emb: bool = False
    lr: float = CD.LR


VARIANTS = (
    Variant("baseline (scale 32, rel)"),
    Variant("no positional emb", zero_emb=True),
    Variant("no rel-pos encoder", use_rel=False),
    Variant("emb scale 3", emb_scale=3.0),
    Variant("emb scale 3 + no rel", emb_scale=3.0, use_rel=False),
    Variant("lr 0.02", lr=0.02),
)


def variant_decoder(col, v: Variant):
    """A copy of the colour decoder with the variant's embedding."""
    col = copy.deepcopy(col)
    with torch.no_grad():
        if v.emb_scale is not None:
            col.embedder_B.mul_(v.emb_scale / 32.0)
        if v.zero_emb:
            col.embedder_B.zero_()
    return col


def run(f0: W.Frame0, steps: int = STEPS, draws_for=None, n_pixels=2000,
        variants=VARIANTS) -> Dict[str, list]:
    """Each variant's losses. ``draws_for(variant)`` -> its draws (the
    same pixels for every variant by default: one generator each, seeded
    alike)."""
    out = {}
    for v in variants:
        draws = (draws_for(v) if draws_for is not None
                 else W.pixel_draws(f0, n_pixels, 11))
        losses = CD.fit(f0, steps, v.lr, draws,
                        variant_decoder(f0.mapper.decoders.col, v),
                        v.use_rel)
        out[v.name] = losses
        print(f"[color_ablate] {v.name:<26}: {losses[0]:8.1f} -> "
              f"{losses[-1]:8.1f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--small", action="store_true",
                    help="48x64, 400 densification and 200 loss rays")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "color_ablate")
    cfg = W.color_config(args.small)
    f0 = W.densified_frame0(cfg, dev, cfg["mapping"]["pixels_adding"])
    out = run(f0, args.steps, n_pixels=cfg["mapping"]["pixels"])
    W.save_json("color_ablate_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
