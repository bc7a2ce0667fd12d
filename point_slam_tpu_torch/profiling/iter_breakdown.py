"""Ablation ladder of one mapping iteration at the bench's widths.

    python -m point_slam_tpu_torch.profiling.iter_breakdown
        [--device cuda|cpu] [--cap 524288] [--points 300000]
        [--cloud sheet|surface] [--knn-layout packed|planes|fused]
        [--iters 10] [--repeats 3] [--rungs 1,2,...] [--small]

Each rung adds one stage of ``map_optimize``'s iteration, on frame 0's
keyframe window and a steady-state cloud (``workload.inflate``):

 1 sample rays (``_sample_window_rays``: pixel gathers, masked median)
 2 + kNN: ``ray_grid_knn`` (K1 on the packed cell table; K2 with
   ``--knn-layout planes``, K3 with ``fused``) and the renderer's
   per-sample fallback for non-compact rays, whose ``q_rays[need]`` syncs
   the host once a render (``ops/knn.py::grid_knn_subset``)
 3 + the geometry-stage loss forward, 4 + the colour-stage forward
 5 the geometry-stage gradient, 6 the colour-stage gradient (packed leaf
   and colour decoder)
 7 the full-buffer step: 6 + frustum row mask + Adam over (CAP, 72)
 8 the compacted-row step: the leaf is packed[sel] (M, 72), composed into
   the buffer in the forward pass by ``index_copy``; Adam over M rows
 9 the fused row-Adam step: 6 + ``ops/adam.update_rows`` (K4)
10 the bf16 view step: 7 rendered from ``pointcloud.encode_render``

Each rung prints its wall ms an iteration (CUDA events around ``--iters``
iterations, median and range over ``--repeats``) and its device-busy ms an
iteration (the profiler's summed kernel time): the loop is host-bound, so
the two differ and a wall difference alone says little. Adam steps from
zero moments at t = 1 with lr 0.01, as the TPU script does. Rays, pixels
and the random fill come from one generator. On the host it runs each rung
once and times nothing.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from point_slam_tpu_torch import mapper as M
from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch import renderer as R
from point_slam_tpu_torch.ops import adam, knn
from point_slam_tpu_torch.profiling import workload as W

LAYOUTS = {"packed": True, "planes": False, "fused": "fused"}
KERNEL_OF = {"packed": "ray_topk_packed", "planes": "ray_topk_planes",
             "fused": "ray_topk_fused"}
LR = 0.01


class Ladder(NamedTuple):
    """One iteration's inputs."""
    ms: M.MapperStatic
    rc: R.RenderConfig
    dec: object                  # models.decoders.Decoders
    packed: torch.Tensor         # (CAP, 72)
    index: object                # the cell table
    window: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    c2w: torch.Tensor            # (F, 4, 4)
    n_frames: int
    ppi: int                     # rays a window frame
    frustum: torch.Tensor        # (CAP,) bool
    sel: torch.Tensor            # (M,) rows of the compacted leaf
    n_sel: int                   # its valid prefix (the rest is padding)
    scratch: Dict[str, torch.Tensor]   # zero moments, K4's buffers
    gen: torch.Generator


def compacted_rows(frustum: torch.Tensor, m_rows: int):
    """The frustum's rows in ascending order, padded to m_rows with ids past
    the buffer (CAP + k) as the TPU script's bucket is; (sel, n_valid)."""
    cap = frustum.shape[0]
    rows = torch.nonzero(frustum).squeeze(1)[:m_rows]
    n = rows.numel()
    pad = cap + torch.arange(m_rows - n, device=frustum.device)
    return torch.cat([rows, pad]), n


def ladder_from(ms, rc, dec, packed, index, window, c2w, n_points: int,
                n_frames: int = 1, ppi: Optional[int] = None,
                seed: int = 0) -> Ladder:
    """A Ladder over given state: frustum = the cloud's rows, the
    compacted leaf in a power-of-two bucket, zero Adam moments."""
    cap = packed.shape[0]
    dev = packed.device
    frustum = torch.arange(cap, device=dev) < n_points
    m_rows = min(1 << int(math.ceil(math.log2(max(n_points, 1024)))), cap)
    sel, n_sel = compacted_rows(frustum, m_rows)
    rows0 = torch.zeros((m_rows, packed.shape[1]), device=dev)
    rows0[:n_sel] = packed[sel[:n_sel]]
    col = [p.detach() for p in dec.col.parameters()]
    scratch = {
        "zeros": torch.zeros_like(packed), "rows0": rows0,
        "zeros_rows": torch.zeros_like(rows0),
        "zeros_col": [torch.zeros_like(p) for p in col],
        # K4 steps these in place on the card
        "p9": packed.clone(), "m9": torch.zeros_like(packed),
        "v9": torch.zeros_like(packed),
        "mask9": frustum.float(),
        "t_row": torch.ones(packed.shape[1], device=dev),
        "lr_row": torch.full((packed.shape[1],), LR, device=dev)}
    return Ladder(ms, rc, dec, packed, index, window, c2w, n_frames,
                  ppi or ms.r_max, frustum, sel, n_sel, scratch,
                  torch.Generator(device=dev).manual_seed(seed))


def build(cfg, dev, n_points: int, layout: str = "packed",
          cloud: str = "sheet", seed: int = 0) -> Ladder:
    """The bench workload's mapper at ``cfg``'s capacity, its cloud
    inflated to n_points, frame 0's window, cell table in ``layout``."""
    cfg["cuda"]["knn_packed_coords"] = LAYOUTS[layout]
    mapper = W.make_mapper(cfg, dev, seed)
    color, depth, c2w = W.frame(cfg, 0)
    W.inflate(mapper, n_points, cloud, (color, depth, c2w), cfg["cam"], seed)
    window, w_c2w = W.frame0_window(mapper, color, depth, c2w)
    # rungs 2-10 always take the ray top-k (the plain version on the host)
    rc = mapper.rc._replace(ray_knn=True)
    return ladder_from(mapper.ms, rc, mapper.decoders, mapper.cloud.packed,
                       mapper.index, window, w_c2w, n_points, seed=seed)


def draw(b: Ladder):
    """One iteration's pixel columns, rows and random fill."""
    dev = b.packed.device
    i = torch.randint(0, b.ms.w, (b.ms.r_max,), generator=b.gen, device=dev)
    j = torch.randint(0, b.ms.h, (b.ms.r_max,), generator=b.gen, device=dev)
    return i, j, R.draw_fill(b.gen, dev)


def _rays(b: Ladder, d):
    return M._sample_window_rays(b.ms, b.window, b.n_frames, b.ppi, d[0],
                                 d[1])


def sample_points(b: Ladder, d) -> torch.Tensor:
    """The (R, ns, 3) ray samples the renderer searches around."""
    rays = _rays(b, d)
    o, dirs = M._rays_world(rays, b.c2w)
    z, _ = R.build_z_vals(b.rc, b.index, o, dirs, rays["gt_depth"],
                          rays["r_query"], rays["ray_ok"])
    return o[:, None, :] + dirs[:, None, :] * z[..., None]


def rung_sample(b: Ladder, d):
    return _rays(b, d)


def rung_knn(b: Ladder, d):
    """ray_grid_knn's (d2, idx, valid, compact), after the fallback."""
    pts = sample_points(b, d)
    out = knn.ray_grid_knn(b.index, pts, k=b.rc.nn_num,
                           probes=b.rc.knn_probes)
    knn.grid_knn_subset(b.index, pts, ~out[3], k=b.rc.nn_num)
    return out


def _loss(b: Ladder, d, packed, stage_color: bool):
    return M._losses(b.ms, b.rc, b.dec, packed, b.index, _rays(b, d), b.c2w,
                     stage_color, d[2])[0]


def rung_geo_fwd(b: Ladder, d):
    with torch.no_grad():
        return _loss(b, d, b.packed, False)


def rung_col_fwd(b: Ladder, d):
    with torch.no_grad():
        return _loss(b, d, b.packed, True)


def grads(b: Ladder, d, stage_color: bool, view: Callable = None,
          leaf: Optional[torch.Tensor] = None, compose: Callable = None):
    """(d loss / d leaf, d loss / d colour decoder): the leaf is the packed
    buffer (or ``leaf``, put into it by ``compose``), rendered through
    ``view`` (the bf16 encoding) when given."""
    x = (b.packed if leaf is None else leaf).detach().requires_grad_(True)
    packed = x if compose is None else compose(x)
    col = list(b.dec.col.parameters())
    loss = _loss(b, d, packed if view is None else view(packed), stage_color)
    g = torch.autograd.grad(loss, [x] + col, allow_unused=True)
    g = [torch.zeros_like(p) if gi is None else gi
         for p, gi in zip([x] + col, g)]
    return g[0], g[1:]


def rung_geo_grad(b: Ladder, d):
    return grads(b, d, False)[0]


def rung_col_grad(b: Ladder, d):
    return grads(b, d, True)[0]


def _step(b: Ladder, leaf, g_leaf, zeros, g_col):
    """Adam from zero moments at t = 1: the leaf and the colour decoder."""
    col = [p.detach() for p in b.dec.col.parameters()]
    z = [zeros] + b.scratch["zeros_col"]
    new, _ = adam.update([leaf] + col, [g_leaf] + g_col, {"m": z, "v": z},
                         1.0, LR)
    return new[0], new[1:]


def rung_full(b: Ladder, d):
    g, g_col = grads(b, d, True)
    return _step(b, b.packed, g * b.frustum[:, None], b.scratch["zeros"],
                 g_col)


def rung_rows(b: Ladder, d):
    """The compacted leaf (M, 72), composed by index_copy; no frustum mask
    (the rows are the frustum's)."""
    n = b.n_sel
    rows0 = b.scratch["rows0"]
    g, g_col = grads(b, d, True, leaf=rows0, compose=lambda x: b.packed
                     .index_copy(0, b.sel[:n], x[:n]))
    return _step(b, rows0, g, b.scratch["zeros_rows"], g_col)


def rung_fused(b: Ladder, d):
    """The packed leaf through the row-Adam (K4 on the card: it steps the
    scratch buffers in place)."""
    g, g_col = grads(b, d, True)
    s = b.scratch
    col = [p.detach() for p in b.dec.col.parameters()]
    new_col, _ = adam.update(col, g_col, {"m": s["zeros_col"],
                                          "v": s["zeros_col"]}, 1.0, LR)
    p, _ = adam.update_rows(s["p9"], g, {"m": s["m9"], "v": s["v9"]},
                            s["t_row"], s["lr_row"], s["mask9"])
    return p, new_col


def rung_bf16(b: Ladder, d):
    g, g_col = grads(b, d, True, view=pc.encode_render)
    return _step(b, b.packed, g * b.frustum[:, None], b.scratch["zeros"],
                 g_col)


RUNGS: List[Tuple[str, Callable]] = [
    ("1 sample rays", rung_sample),
    ("2 + kNN (with the fallback's host sync)", rung_knn),
    ("3 + geo fwd loss", rung_geo_fwd),
    ("4 + col fwd loss", rung_col_fwd),
    ("5 geo grad", rung_geo_grad),
    ("6 col grad", rung_col_grad),
    ("7 full-buffer step", rung_full),
    ("8 compacted-row step", rung_rows),
    ("9 fused-adam step (K4)", rung_fused),
    ("10 bf16-view step", rung_bf16),
]


def measure(b: Ladder, fn: Callable, iters: int, repeats: int) -> Dict:
    """Wall ms an iteration over ``repeats`` runs of ``iters`` iterations
    and device-busy ms an iteration."""
    dev = b.packed.device
    step = lambda: fn(b, draw(b))
    walls = [W.wall_ms(step, dev, iters) for _ in range(repeats)]
    return {"wall": W.spread(walls), "walls": walls,
            "busy_ms": W.busy_ms(step, dev, iters)}


def run(b: Ladder, rungs: Optional[List[int]] = None, iters: int = 10,
        repeats: int = 3, tag: str = "ladder") -> Dict[str, Dict]:
    out = {}
    for k, (name, fn) in enumerate(RUNGS, 1):
        if rungs and k not in rungs:
            continue
        res = out[name] = measure(b, fn, iters, repeats)
        print(f"[{tag}] {name:<40} wall {W.spread_str(res['wall'])}/iter, "
              f"device busy {W.shown(res['busy_ms'])}/iter", flush=True)
    names = [n for n, _ in RUNGS]
    med = {n: out[n]["wall"]["median"] for n in out}
    if len(out) == len(RUNGS) and None not in med.values():
        t = [med[n] for n in names]
        print(f"[{tag}] wall differences: kNN {t[1] - t[0]:.3f} ms | geo "
              f"fwd {t[2] - t[1]:.3f} | col extras fwd {t[3] - t[2]:.3f} | "
              f"geo bwd {t[4] - t[2]:.3f} | col bwd {t[5] - t[3]:.3f} | "
              f"adam {t[6] - t[5]:.3f} | compaction saves {t[6] - t[7]:.3f} "
              f"| fused adam saves {t[6] - t[8]:.3f} | bf16 view saves "
              f"{t[6] - t[9]:.3f}", flush=True)
    return out


def neighbour_shares(b: Ladder) -> Tuple[float, float, float]:
    """One draw's kNN: the shares of (valid slots, slots within the
    sample's query radius, compact rays). A slot is valid when its probed
    buckets hold any point, hash collisions included; the interpolation
    uses only the points within the radius."""
    with torch.no_grad():
        d = draw(b)
        rays = _rays(b, d)
        d2, _, valid, compact = rung_knn(b, d)
        r = rays["r_query"].repeat_interleave(b.rc.n_surface)[:, None]
        inball = valid & (d2 < r * r)
    return (float(valid.float().mean()), float(inball.float().mean()),
            float(compact.float().mean()))


def hold_ray_topk(b: Ladder, d, layout: str) -> Dict:
    """Rung 2's ray top-k launch against its plain version on the same
    inputs (keys and ids EQUAL, ids as bit patterns)."""
    pts = sample_points(b, d)
    index = b.index
    p_ray = b.rc.knn_probes
    probes, _ = knn._box_probes(pts, index.cell_size, index.table_size,
                                p_ray)
    qk = (pts if layout == "planes"
          else knn._query_lattice(pts, index.cell_size)).contiguous()
    lanes = 2 if layout == "fused" else 1
    lane_mask = knn._lane_mask(p_ray * index.max_per_cell * lanes)
    planes = knn.index_planes(index)
    keys, ids = knn.ray_topk(probes, planes, qk, b.rc.nn_num, lane_mask)
    rk, rids = knn.ray_topk_reference(probes, planes, qk, b.rc.nn_num,
                                      lane_mask)
    ib, rib = ids.view(torch.int32), rids.view(torch.int32)
    err = max(int((keys.long() - rk.long()).abs().max()),
              int((ib.long() - rib.long()).abs().max()))
    return {"name": KERNEL_OF[layout],
            "equal": torch.equal(keys, rk) and torch.equal(ib, rib),
            "max_abs_err": float(err), "rays": int(probes.shape[0])}


def hold_row_adam(b: Ladder, d) -> Dict:
    """Rung 9's row-Adam launch against its plain version (p, m, v EQUAL)."""
    g, _ = grads(b, d, True)
    s = b.scratch
    p0, m0 = b.packed.clone(), torch.zeros_like(b.packed)
    pk, sk = adam.update_rows(p0.clone(), g, {"m": m0.clone(),
                                              "v": m0.clone()},
                              s["t_row"], s["lr_row"], s["mask9"])
    pr, sr = adam.update_rows_reference(p0, g, {"m": m0, "v": m0.clone()},
                                        s["t_row"], s["lr_row"], s["mask9"])
    pairs = [(pk, pr), (sk["m"], sr["m"]), (sk["v"], sr["v"])]
    return {"name": "row_adam",
            "equal": all(torch.equal(x, y) for x, y in pairs),
            "max_abs_err": max(float((x - y).abs().max()) for x, y in pairs),
            "rows": int(p0.shape[0])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    W.add_device_arg(ap)
    W.add_cloud_args(ap)
    ap.add_argument("--knn-layout", default="packed", choices=sorted(LAYOUTS))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--rungs", default="",
                    help="comma-separated rung numbers (default: all)")
    args = ap.parse_args(argv)
    dev = W.device(args.device, "iter_breakdown")
    cfg = W.bench_config(4, small=args.small)
    cfg["cuda"]["point_capacity_init"] = args.cap
    b = build(cfg, dev, args.points, args.knn_layout, args.cloud)
    vs, ins, cs = neighbour_shares(b)
    print(f"[ladder] CAP {args.cap}, {args.points} points ({args.cloud}), "
          f"{args.knn_layout} cell table ({KERNEL_OF[args.knn_layout]}), "
          f"{b.ms.r_max} rays: valid neighbour slots {vs:.4f}, within the "
          f"query radius {ins:.4f}, compact rays {cs:.4f}", flush=True)
    rungs = [int(r) for r in args.rungs.split(",") if r]
    out = run(b, rungs, args.iters, args.repeats)
    W.save_json("iter_breakdown_torch.json", out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
