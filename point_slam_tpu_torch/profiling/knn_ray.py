"""Ray-shared kNN prototypes against per-sample ``grid_knn``.

    python -m point_slam_tpu_torch.profiling.knn_ray [--device cuda|cpu]
        [--points 300000] [--rays 5000] [--iters 30]

The renderer queries kNN at R rays x 5 samples whose samples span only
0.04 x depth, so adjacent samples probe almost the same 27 cells. On the
TPU script's sine-sheet scene (``scene.sine_sheet``: cell 0.16, table
2^16 x 64) it measures:

  v0  ``grid_knn`` on the flattened (R*ns) samples
  v1  the ray's probe buckets deduplicated (budget 48), gathered once a
      ray from the interleaved table, top-8 per sample over the shared
      candidates (exact up to the budget)
  v2  v1 with a per-ray preselection of 64 candidates by their distance
      to the ray's segment, then the top-8 over those (approximate)

It first prints the distribution of distinct probe cells a ray (host) and
v1's and v2's top-8 distance match against v0; then each variant's time
(CUDA events over ``--iters`` calls with jittered samples, and the
profiler's device time). The ray top-k kernels (K1, K2) are not on these
paths: they live in ``ops/knn.py``, which the script imports for
``grid_knn``. On the host it runs each once and times nothing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from point_slam_tpu_torch.ops import knn
from point_slam_tpu_torch.profiling import scene as S
from point_slam_tpu_torch.profiling import workload as W

M_PROBE = 48     # distinct buckets a ray
M_SEL = 64       # v2's candidates a ray
K = 8


def ray_probes(q: torch.Tensor, cell: float, table: int) -> torch.Tensor:
    """(R, M_PROBE) distinct probe buckets of each ray's samples, ``table``
    (the table's +inf sentinel row) past them."""
    r, ns, _ = q.shape
    off = torch.as_tensor(knn._offsets27(), device=q.device)
    qc = torch.floor(q / cell).to(torch.int32)
    hs = knn._hash_cells(qc[:, :, None, :] + off[None, None], table)
    hs = torch.sort(hs.reshape(r, ns * 27), dim=1).values
    first = torch.cat([torch.ones((r, 1), dtype=torch.bool, device=q.device),
                       hs[:, 1:] != hs[:, :-1]], dim=1)
    rank = torch.cumsum(first, dim=1) - 1
    dst = torch.where(first & (rank < M_PROBE), rank, M_PROBE)
    probes = torch.full((r, M_PROBE + 1), table, dtype=torch.long,
                        device=q.device)
    probes.scatter_(1, dst, hs)    # every repeat lands in the dropped column
    return probes[:, :M_PROBE]


def _top8(cand: torch.Tensor, q: torch.Tensor):
    """Per-sample top-8 over a ray's (R, N, 4) candidates [x|y|z|id]."""
    r, ns, _ = q.shape
    d2 = torch.sum((cand[:, None, :, :3] - q[:, :, None, :]) ** 2, -1)
    d, pos = torch.topk(d2.reshape(r * ns, -1), K, largest=False)
    ids = torch.gather(cand[:, None, :, 3].expand(r, ns, -1)
                       .reshape(r * ns, -1), 1, pos)
    return d, ids


def v0(index, q):
    return knn.grid_knn(index, q.reshape(-1, 3), k=K)[:2]


def v1(table, q, cell, size):
    probes = ray_probes(q, cell, size)
    cand = table[probes].reshape(q.shape[0], -1, 4)
    return _top8(cand, q)


def v2(table, q, cell, size):
    probes = ray_probes(q, cell, size)
    cand = table[probes].reshape(q.shape[0], -1, 4)
    a, b = q[:, 0, :], q[:, -1, :]
    ab = b - a
    denom = torch.clamp(torch.sum(ab * ab, -1, keepdim=True), min=1e-12)
    t = torch.clamp(torch.sum((cand[..., :3] - a[:, None, :])
                              * ab[:, None, :], -1) / denom, 0.0, 1.0)
    closest = a[:, None, :] + t[..., None] * ab[:, None, :]
    dseg = torch.sum((cand[..., :3] - closest) ** 2, -1)
    dseg = torch.nan_to_num(dseg, nan=torch.inf)
    sel = torch.topk(dseg, M_SEL, largest=False).indices
    return _top8(torch.gather(cand, 1, sel[..., None].expand(-1, -1, 4)), q)


def match(d_ref, v_ref, d):
    """% of slots whose top-8 distance equals v0's (rtol 1e-5), or where
    v0 has none."""
    ok = torch.isclose(d.double(), d_ref.double(), rtol=1e-5, atol=1e-10)
    return 100.0 * float((ok | ~v_ref).double().mean())


def run(dev, points: int = 300_000, rays: int = 5000, iters: int = 30):
    sc = S.sine_sheet(0, points, rays)
    pts = torch.from_numpy(sc.points).to(dev)
    q_ray = torch.from_numpy(sc.q).to(dev)
    index = knn.build_grid_index(pts, points, sc.cell, S.TABLE, S.C)
    table = S.interleaved_table(index)
    cells = np.floor(sc.q / sc.cell).astype(np.int64)
    probe = cells[:, :, None, :] + knn._offsets27()[None, None]
    keys = (probe[..., 0] * (1 << 42) + probe[..., 1] * (1 << 21)
            + probe[..., 2]).reshape(rays, -1)
    uniq = np.array([len(np.unique(k)) for k in keys])
    print(f"[knn_ray] distinct probe cells a ray: mean {uniq.mean():.1f} "
          f"p50 {np.percentile(uniq, 50):.0f} p95 "
          f"{np.percentile(uniq, 95):.0f} max {uniq.max()}", flush=True)
    args = (table, q_ray, sc.cell, S.TABLE)
    with torch.no_grad():
        d0, _, v_ref = knn.grid_knn(index, q_ray.reshape(-1, 3), k=K)
        out = {"match_v1_pct": match(d0, v_ref, v1(*args)[0]),
               "match_v2_pct": match(d0, v_ref, v2(*args)[0])}
        print(f"[knn_ray] top-{K} distance match vs v0: v1 "
              f"{out['match_v1_pct']:.3f}%, v2 {out['match_v2_pct']:.3f}%",
              flush=True)
        g = torch.Generator(device=dev).manual_seed(0)

        def jitter():
            return q_ray + 0.002 * torch.randn(q_ray.shape, generator=g,
                                               device=dev)

        lines = {"v0 per-sample grid_knn": lambda: v0(index, jitter()),
                 "v1 ray-shared exact": lambda: v1(table, jitter(), sc.cell,
                                                   S.TABLE),
                 "v2 ray-shared + preselect": lambda: v2(
                     table, jitter(), sc.cell, S.TABLE)}
        for name, fn in lines.items():
            out[name] = {"ms": W.wall_ms(fn, dev, iters),
                         "device_ms": W.busy_ms(fn, dev, iters)}
            print(f"[knn_ray] {name:<26} {W.shown(out[name]['ms'])} (device "
                  f"{W.shown(out[name]['device_ms'])})", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    ap.add_argument("--points", type=int, default=300_000)
    ap.add_argument("--rays", type=int, default=5000)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    dev = W.device(args.device, "knn_ray")
    out = run(dev, args.points, args.rays, args.iters)
    W.save_json("knn_ray_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
