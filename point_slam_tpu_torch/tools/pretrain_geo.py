"""Pretrain the geometry decoder on randomised procedural scenes.

The port of ``point_slam_tpu.tools.pretrain_geo``. The reference
initialises its geometry MLP from NICE-SLAM's pretrained middle decoder
and freezes it (src/Point_SLAM.py:143-164; fix_geo_decoder); that .pt
cannot be fetched here, so this tool makes the equivalent artefact: it
runs the port's SLAM mapper over K randomised synthetic scenes in turn,
each run's geometry decoder warm-started from the previous run's (colour
decoder and point features restart per scene), and writes the final
geometry decoder in the npz layout that ``models.decoders.
load_pretrained_geo`` reads (``pts_linears.{i}.{weight,bias}``,
``fc_c.{i}.{weight,bias}``, ``output_linear.{weight,bias}`` as torch
Linear (out, in) matrices, ``embedder._B``): the JAX package's layout, so
either package loads the other's file. Scenes take their GT poses
(tracking.gt_camera): the decoder is what is trained.

    python -m point_slam_tpu_torch.tools.pretrain_geo \\
        [--out pretrained/middle_fine.npz] [--scenes 4] [--frames 40] \\
        [--workdir DIR] [--device cuda|cpu]

Runs on CUDA unless --device cpu is given. The default --out overwrites
the committed pretrained/middle_fine.npz.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def save_geo_npz(geo, path: str) -> int:
    """Write the geometry decoder (``Decoders.geo``) in
    load_pretrained_geo's npz layout; the number of arrays."""
    def arr(t):
        return t.detach().cpu().numpy()

    out = {}
    for name in ("pts_linears", "fc_c"):
        for i, lin in enumerate(getattr(geo, name)):
            out[f"{name}.{i}.weight"] = arr(lin.weight)
            out[f"{name}.{i}.bias"] = arr(lin.bias)
    out["output_linear.weight"] = arr(geo.output_linear.weight)
    out["output_linear.bias"] = arr(geo.output_linear.bias)
    out["embedder._B"] = arr(geo.embedder_B)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **out)
    return len(out)


def scene_cfg(k: int, frames: int, out_dir: str, warm_npz: Optional[str]):
    """Randomised synthetic scene k (the JAX tool's: room size, furniture
    and texture drawn from seed 9000 + 77k)."""
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", "room.yaml"),
                      os.path.join(HERE, "configs", "point_slam.yaml"))
    rng = np.random.default_rng(9000 + 77 * k)
    cfg["synthetic"].update({
        "n_frames": frames,
        "seed": int(rng.integers(1, 1 << 30)),
        "objects": int(rng.integers(4, 10)),
        "texture_freq": float(rng.uniform(1.0, 2.5)),
        "texture_detail": float(rng.uniform(0.1, 0.35)),
        "half_extent": [float(rng.uniform(2.2, 3.6)),
                        float(rng.uniform(1.8, 2.6)),
                        float(rng.uniform(2.0, 3.0))],
    })
    # the decoder's supervision is set by the mapping iterations, not the
    # image size
    cfg["cam"].update({"H": 150, "W": 200, "fx": 125.0, "fy": 125.0,
                       "cx": 99.5, "cy": 74.5})
    cfg["tracking"]["gt_camera"] = True
    cfg["mapping"].update({
        "fix_geo_decoder": False,
        "fix_geo_decoder_after": 0,
        "every_frame": 4,
        "keyframe_every": 8,
        "mapping_window_size": 6,
        "pixels": 2500,
        "pixels_adding": 3000,
        "pixels_based_on_color_grad": 500,
        "iters": 150,
        "iters_first": 500,
        "geo_iter_first": 200,
        "lazy_start": 4,
        "ckpt_freq": 0,
        "color_refine": False,
    })
    cfg["verbose"] = False
    cfg["data"]["output"] = os.path.join(out_dir, f"scene_{k}")
    # the geometry decoder starts from the previous scene's
    cfg["pretrained_decoders"] = {"middle_fine": warm_npz or ""}
    return cfg


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "pretrained",
                                                  "middle_fine.npz"))
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--workdir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the run fails "
                    "without CUDA unless --device cpu is given)")
    args = ap.parse_args(argv)

    from point_slam_tpu_torch.slam import PointSLAM

    workdir = args.workdir or tempfile.mkdtemp(prefix="pretrain_geo_")
    warm = None
    for k in range(args.scenes):
        cfg = scene_cfg(k, args.frames, workdir, warm)
        t0 = time.time()
        slam = PointSLAM(cfg, device=args.device)
        slam.run()
        slam.mlog.close()
        warm = os.path.join(workdir, f"geo_after_scene_{k}.npz")
        n = save_geo_npz(slam.mapper.decoders.geo, warm)
        print(f"[pretrain] scene {k}: {cfg['synthetic']['n_frames']} frames, "
              f"{time.time() - t0:.0f}s, {n} arrays -> {warm}", flush=True)
        del slam
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    shutil.copyfile(warm, args.out)
    print(f"[pretrain] final geometry decoder -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
