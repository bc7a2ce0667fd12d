"""Fine ablation of the geometry-stage forward between ``iter_breakdown``'s
rung 2 (+ kNN) and rung 3 (+ geo fwd loss).

    python -m point_slam_tpu_torch.profiling.geo_fwd_split
        [--device cuda|cpu] [--cap 524288] [--points 300000]
        [--cloud surface|sheet] [--knn-layout packed|planes|fused]
        [--iters 10] [--repeats 3] [--small]

On frame 0's keyframe window and a steady-state cloud at bench.py's
widths, each stage adds one piece of ``render_rays``' geometry forward:

 A the kNN prefix: rays, z values, samples, ``ray_grid_knn`` (K1 on the
   packed cell table; K2 with ``--knn-layout planes``, K3 with ``fused``)
 B + the non-compact fallback (``renderer.py`` -> ``ops/knn.py::
   grid_knn_subset``), whose ``q_rays[need]`` syncs the host once a render
 C + the neighbours' gather and distances
 D + the interpolation weights and the random fill
 E + the geometry MLP
 F + compositing and the masked depth loss, without the fallback
 G F with the fallback
 H the mapper's own ``_losses`` (geometry stage)

Each stage prints its wall ms an iteration (CUDA events, median and range)
and its device-busy ms (the profiler's summed kernel time), then the
differences. The fallback's cost is a host sync, so it shows in wall time
and hardly in device time. Also prints how many rays of one batch are
non-compact. On the host it runs each stage once and times nothing.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Tuple

import torch

from point_slam_tpu_torch import mapper as M
from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch import renderer as R
from point_slam_tpu_torch.common.compositing import raw2outputs
from point_slam_tpu_torch.models import decoders as D
from point_slam_tpu_torch.ops import knn
from point_slam_tpu_torch.profiling import iter_breakdown as IB
from point_slam_tpu_torch.profiling import workload as W


def stage_pts(b: IB.Ladder, d):
    """The common prefix: rays, samples and the ray-shared kNN."""
    rays = IB._rays(b, d)
    o, dirs = M._rays_world(rays, b.c2w)
    z, _ = R.build_z_vals(b.rc, b.index, o, dirs, rays["gt_depth"],
                          rays["r_query"], rays["ray_ok"])
    pts = o[:, None, :] + dirs[:, None, :] * z[..., None]
    _, idx, valid, compact = knn.ray_grid_knn(b.index, pts, k=b.rc.nn_num,
                                              probes=b.rc.knn_probes)
    return rays, dirs, z, pts, idx, valid, compact


def fallback(b: IB.Ladder, pts, idx, valid, compact):
    """The renderer's per-sample grid_knn for the non-compact rays."""
    k = b.rc.nn_num
    i_f, v_f = knn.grid_knn_subset(b.index, pts, ~compact, k=k)
    rep = compact.repeat_interleave(pts.shape[1])[:, None]
    return (torch.where(rep, idx, i_f.reshape(-1, k)),
            torch.where(rep, valid, v_f.reshape(-1, k)))


def s_knn(b, d):
    return stage_pts(b, d)[4]


def s_fallback(b, d):
    _, _, _, pts, idx, valid, compact = stage_pts(b, d)
    return fallback(b, pts, idx, valid, compact)[0]


def make_fwd(upto: str, with_fallback: bool = False) -> Callable:
    """The forward up to ``upto``: gather | interp | mlp | full."""
    def step(b: IB.Ladder, d):
        rays, dirs, z, pts, idx, valid, compact = stage_pts(b, d)
        rc = b.rc
        ns = rc.n_surface
        if with_fallback:
            idx, valid = fallback(b, pts, idx, valid, compact)
        p = pts.reshape(-1, 3)
        nb = b.packed[idx]
        diff = pc.neighbor_pos(nb) - p[:, None, :]
        dists = torch.sum(diff * diff, dim=-1)
        if upto == "gather":
            return dists, nb
        r_query_pts = rays["r_query"].repeat_interleave(ns)
        counts = knn.neighbor_count(dists, valid, r_query_pts)
        has = counts > rc.min_nn_num - 1
        w = D.interpolation_weights(dists, valid, r_query_pts, rc.weighting)
        c_geo = torch.sum(w[..., None] * pc.neighbor_geo(nb), dim=1)
        c_geo = D.random_fill_features(c_geo, has, d[2][0])
        if upto == "interp":
            return c_geo
        occ = b.dec.geo(p, c_geo, precision=rc.mlp_precision)
        if upto == "mlp":
            return occ
        r = pts.shape[0]
        valid_ray = torch.sum(has.reshape(r, ns), dim=1) >= (ns // 2 + 1)
        occ = torch.where(has, occ, -100.0)
        raw = torch.cat([torch.zeros((p.shape[0], 3), device=p.device),
                         occ[:, None]], dim=-1).reshape(r, ns, 4)
        dep, _, _, _ = raw2outputs(raw, z, dirs, coef=rc.sigmoid_coef)
        gt = rays["gt_depth"]
        dep = torch.where(gt > 0, dep, 0.0)
        mask = (gt > 0) & valid_ray & rays["ray_ok"] & ~torch.isnan(dep)
        return torch.sum(torch.where(mask, torch.abs(gt - dep), 0.0))
    return step


def s_losses(b, d):
    return IB._loss(b, d, b.packed, False)


STAGES: List[Tuple[str, Callable]] = [
    ("A kNN prefix", s_knn),
    ("B + fallback", s_fallback),
    ("C + gather+dists", make_fwd("gather")),
    ("D + interp+fill", make_fwd("interp")),
    ("E + geo MLP", make_fwd("mlp")),
    ("F + composite+loss", make_fwd("full")),
    ("G F with fallback", make_fwd("full", with_fallback=True)),
    ("H mapper _losses", s_losses),
]


def non_compact(b: IB.Ladder) -> Tuple[int, int]:
    """(non-compact rays, rays) of one batch."""
    with torch.no_grad():
        compact = stage_pts(b, IB.draw(b))[6]
    return int((~compact).sum()), int(compact.numel())


def run(b: IB.Ladder, iters: int = 10, repeats: int = 3) -> Dict:
    nc, nr = non_compact(b)
    print(f"non-compact rays in one batch: {nc} / {nr}", flush=True)
    out = {"non_compact": nc, "rays": nr, "stages": {}}
    with torch.no_grad():
        for name, fn in STAGES:
            res = out["stages"][name] = IB.measure(b, fn, iters, repeats)
            print(f"{name:<20}: wall {W.spread_str(res['wall'])}/iter, "
                  f"device busy {W.shown(res['busy_ms'])}/iter", flush=True)
    st = out["stages"]
    names = [n for n, _ in STAGES]
    for key, unit in (("wall", "wall"), ("busy_ms", "device busy")):
        t = [st[n][key]["median"] if key == "wall" else st[n][key]
             for n in names]
        if None in t:
            continue
        diffs = {"fallback": t[1] - t[0], "gather+dists": t[2] - t[1],
                 "interp": t[3] - t[2], "geoMLP": t[4] - t[3],
                 "composite+loss": t[5] - t[4],
                 "fallback-in-full": t[6] - t[5],
                 "_losses-vs-G": t[7] - t[6]}
        out[f"diff_{key}"] = diffs
        print(f"\n{unit} (ms/iter): " + " | ".join(
            f"{k}: {v:.3f}" for k, v in diffs.items()), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    W.add_cloud_args(ap)
    ap.add_argument("--knn-layout", default="packed",
                    choices=sorted(IB.LAYOUTS))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "geo_fwd_split")
    cfg = W.bench_config(4, small=args.small)
    cfg["cuda"]["point_capacity_init"] = args.cap
    b = IB.build(cfg, dev, args.points, args.knn_layout, args.cloud)
    out = run(b, args.iters, args.repeats)
    W.save_json("geo_fwd_split_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
