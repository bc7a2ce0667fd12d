"""Sub-ladder inside ``render_rays``: where the geometry forward goes.

    python -m point_slam_tpu_torch.profiling.render_breakdown
        [--device cuda|cpu] [--cap 524288] [--points 300000]
        [--queries 25000] [--iters 30]

On the TPU script's scene (the kNN study's sine sheet: ``--points`` on
z = 2 + 0.3 sin(3x), cell 0.16, table 2^16 x 96; random N(0, 0.1)
features), each rung adds one stage for ``--queries`` samples jittered
around cloud points:

 0 the queries
 1 + per-sample ``grid_knn`` (27 cells)
 2 + the geometry features' interpolation (``interpolation_weights``)
 3 + the geometry decoder (``GeoDecoder``)
 4 the colour path: kNN, the neighbours' features and positions, F_theta
   (``encode_neighbor_feats``), the weighted sum, ``ColorDecoder``

Prints each rung's wall ms (CUDA events over ``--iters`` calls) and device
time, and the differences. On the host it runs each once and times
nothing.
"""

from __future__ import annotations

import argparse
import sys

import torch

from point_slam_tpu_torch.models import decoders as D
from point_slam_tpu_torch.ops import knn
from point_slam_tpu_torch.profiling import scene as S
from point_slam_tpu_torch.profiling import workload as W

CELL = 0.16
TABLE = 1 << 16
C = 96
K = 8
RADIUS = 0.16


def make_scene(dev, cap: int, n_points: int, seed: int = 0):
    sc = S.sine_sheet(seed, n_points, rays=1, cap=cap)
    pos = torch.from_numpy(sc.points).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"pos": pos, "n": n_points, "gen": g,
            "geo": 0.1 * torch.randn((pos.shape[0], 32), generator=g,
                                     device=dev),
            "col": 0.1 * torch.randn((pos.shape[0], 32), generator=g,
                                     device=dev),
            "index": knn.build_grid_index(pos, n_points, CELL, TABLE, C),
            "dec": D.init_decoders({"model": {"c_dim": 32}}, seed, dev)}


def queries(b, q: int) -> torch.Tensor:
    dev = b["pos"].device
    i = torch.randint(0, b["n"], (q,), generator=b["gen"], device=dev)
    return b["pos"][i] + 0.02 * torch.randn((q, 3), generator=b["gen"],
                                            device=dev)


def rung_queries(b, q):
    return queries(b, q)


def rung_knn(b, q):
    return knn.grid_knn(b["index"], queries(b, q), k=K)


def _interp(b, q):
    p = queries(b, q)
    d, i, v = knn.grid_knn(b["index"], p, k=K)
    w = D.interpolation_weights(d, v, torch.full((q,), RADIUS,
                                                 device=p.device))
    return p, d, i, w


def rung_interp(b, q):
    _, _, i, w = _interp(b, q)
    return torch.sum(w[..., None] * b["geo"][i], dim=1)


def rung_geo(b, q):
    p, _, i, w = _interp(b, q)
    return b["dec"].geo(p, torch.sum(w[..., None] * b["geo"][i], dim=1))


def rung_col(b, q):
    p, _, i, w = _interp(b, q)
    col = b["dec"].col
    nf = col.encode_neighbor_feats(b["pos"][i], p, b["col"][i])
    return col(p, torch.sum(w[..., None] * nf, dim=1))


RUNGS = [("0 make queries", rung_queries),
         ("1 + grid_knn", rung_knn),
         ("2 + geo interp", rung_interp),
         ("3 + geo MLP", rung_geo),
         ("4 col path (knn + rel)", rung_col)]


def run(dev, cap: int = 1 << 19, n_points: int = 300_000,
        q: int = 25_000, iters: int = 30):
    b = make_scene(dev, cap, n_points)
    out = {}
    with torch.no_grad():
        for name, fn in RUNGS:
            step = lambda: fn(b, q)
            out[name] = {"ms": W.wall_ms(step, dev, iters),
                         "device_ms": W.busy_ms(step, dev, iters)}
            print(f"[render] {name:<24} {W.shown(out[name]['ms'])} (device "
                  f"{W.shown(out[name]['device_ms'])})", flush=True)
    t = [out[n]["device_ms"] for n, _ in RUNGS]
    if None not in t:
        print(f"[render] device differences: knn {t[1] - t[0]:.4f} ms | geo "
              f"feature gather + interp {t[2] - t[1]:.4f} | geo MLP "
              f"{t[3] - t[2]:.4f} | col gathers + MLPs {t[4] - t[1]:.4f}",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--cap", type=int, default=1 << 19)
    ap.add_argument("--points", type=int, default=300_000)
    ap.add_argument("--queries", type=int, default=25_000)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "render_breakdown")
    out = run(dev, args.cap, args.points, args.queries, args.iters)
    W.save_json("render_breakdown_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
