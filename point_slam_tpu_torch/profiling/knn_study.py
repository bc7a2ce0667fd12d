"""The kNN selection study on the card.

    python -m point_slam_tpu_torch.profiling.knn_study [--device cuda|cpu]
        [--points N] [--rays R] [--iters N]

The TPU study (``profiling/knn_pallas*.py``, ``knn_layout_micro.py``,
``knn_quad_micro.py``) asked how to feed the ray-shared top-8 selection:
which probe set, which candidate layout, ids taken in the kernel or by an
epilogue. Here every variant runs its pipeline (probes -> gather ->
layout -> block top-k -> epilogue) with its Pallas body as the CUDA block
top-k (``ops/block_topk.py``), on the script's own scene:

    sine sheet     v0 (per-sample grid_knn), v3 (P1), v4 (P2), v5 (P2'),
                   v6, v7 (P3), v8, v8b (P4); and the production
                   ray_grid_knn, which reads the cell table in its kernel,
                   over the f32 planes (K2) and the packed table (K1) at
                   48 and 27 probes
    gaussian slab  v0, A (K2's body on the row layout), B (P5b), C (P5c)
    random rays    v0, planes (P6p), quad (P6q)

Each prints one line: the pipeline's median ms and the kernel's own median
ms (CUDA events, ``--iters`` timed calls after warm-up), each with its
device time (the kernels' and copies' summed durations from
torch.profiler, without the card's waits for the host), the top-k
distance-set match against the scene's v0 (sorted exact d^2 within rtol
1e-5) and the block top-k launches of the row. ``--device`` defaults to
cuda and the study raises without it; ``--device cpu`` runs the plain
versions and times nothing. Sizes default to the scripts' (300k points; 5000, 5024,
5008 rays).
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, NamedTuple, Optional

import torch

from point_slam_tpu_torch.ops import block_topk as bt
from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.profiling import knn_layout_micro as klm
from point_slam_tpu_torch.profiling import knn_pallas as kp1
from point_slam_tpu_torch.profiling import knn_pallas2 as kp2
from point_slam_tpu_torch.profiling import knn_pallas3 as kp3
from point_slam_tpu_torch.profiling import knn_pallas4 as kp4
from point_slam_tpu_torch.profiling import knn_quad_micro as kqm
from point_slam_tpu_torch.profiling import scene as S


class Variant(NamedTuple):
    name: str
    body: str                 # the Pallas body its kernel replaces
    scene: str
    p: int                    # probe slots a ray
    run: Callable             # () -> (d2, idx, valid), (R*ns, k)
    kernel: Optional[Callable]  # () -> the kernel call alone (inputs ready)
    block: Optional[Callable] = None   # () -> its block top-k's inputs


class Data(NamedTuple):
    scene: S.Scene
    points: torch.Tensor
    q: torch.Tensor
    index: tk.GridIndex
    extra: dict


def prepare(device, points: Optional[int] = None, rays: Optional[int] = None
            ) -> List[Data]:
    """The three scenes (seed 0) on ``device`` with their tables."""
    size = {} if points is None else {"n_points": points}
    if rays is not None:
        size["rays"] = rays
    out = []
    for make in (S.sine_sheet, S.gaussian_slab, S.random_rays):
        sc = make(**size)
        pts = torch.from_numpy(sc.points).to(device)
        q = torch.from_numpy(sc.q).to(device)
        index = tk.build_grid_index(pts, sc.n_points, sc.cell, S.TABLE, S.C)
        table = S.interleaved_table(index)
        extra = {"table": table}
        if make is S.sine_sheet:
            extra["pos_tab"] = kp4.make_pos_table(table)
            extra["packed"] = tk.build_packed_grid_index(
                pts, sc.n_points, sc.cell, S.TABLE, S.C)
        elif make is S.gaussian_slab:
            extra["table_cm"] = klm.component_major(table)
        else:
            extra["quad"] = kqm.quad_table(index)
        out.append(Data(sc, pts, q, index, extra))
    return out


def _block_kernel(block):
    b = block()
    return lambda: bt.block_topk(b.views, b.q, S.K, b.lane_mask)


def _production(index, q, p):
    """(run, kernel) of ray_grid_knn over ``index`` at p probes."""
    run = lambda: tk.ray_grid_knn(index, q, k=S.K, probes=p)[:3]
    probes, _ = tk._box_probes(q, index.cell_size, index.table_size, p)
    packed = isinstance(index, tk.PackedGridIndex)
    qk = (tk._query_lattice(q, index.cell_size) if packed else q).contiguous()
    planes = tk.index_planes(index)
    mask = tk._lane_mask(p * index.max_per_cell)
    return run, lambda: tk.ray_topk(probes, planes, qk, S.K, mask)


def variants(data: List[Data]) -> List[Variant]:
    sheet, slab, rand = data
    return _sheet(sheet) + _slab(slab) + _random_rays(rand)


def _sheet(sheet: Data) -> List[Variant]:
    t, q, cs = sheet.extra["table"], sheet.q, sheet.scene.cell
    pos_tab = sheet.extra["pos_tab"]
    out = [
        Variant("v0", "-", "sine-sheet", 27,
                lambda: kp1.v0(sheet.index, q), None),
        Variant("v3", "P1", "sine-sheet", kp1.P,
                lambda: kp1.knn_rays(t, q, cs), None,
                lambda: kp1.block(t, q, cs)),
        Variant("v4", "P2", "sine-sheet", kp2.P,
                lambda: kp2.knn_rays(t, q, cs), None,
                lambda: kp2.block_v4(t, q, cs)),
        Variant("v5", "P2'", "sine-sheet", kp2.P2,
                lambda: kp2.knn_rays_v5(t, q, cs), None,
                lambda: kp2.block_v5(t, q, cs)),
        Variant("v6", "P3", "sine-sheet", kp3.P3,
                lambda: kp3.knn_rays_v6(t, q, cs), None,
                lambda: kp3.block_v6(t, q, cs)),
        Variant("v7", "P3", "sine-sheet", kp3.P3,
                lambda: kp3.knn_rays_v7(t, q, cs), None,
                lambda: kp3.block_v7(t, q, cs)),
        Variant("v8", "P4", "sine-sheet", kp3.P3,
                lambda: kp4.knn_rays_v8(t, q, cs), None,
                lambda: kp4.block_v8(t, q, cs)[0]),
        Variant("v8b", "P4", "sine-sheet", kp3.P3,
                lambda: kp4.knn_rays_v8b(t, pos_tab, q, cs), None,
                lambda: kp4.block_v8b(t, pos_tab, q, cs)[0]),
    ]
    for name, body, index in (("ray_grid_knn f32", "K2", sheet.index),
                              ("ray_grid_knn packed", "K1",
                               sheet.extra["packed"])):
        for p in (48, 27):
            run, kernel = _production(index, q, p)
            out.append(Variant(name, body, "sine-sheet", p, run, kernel))
    return out


def _slab(slab: Data) -> List[Variant]:
    t, q, cs = slab.extra["table"], slab.q, slab.scene.cell
    planes = tk.index_planes(slab.index)
    cm = slab.extra["table_cm"]
    return [
        Variant("v0", "-", "gaussian-slab", 27,
                lambda: kp1.v0(slab.index, q), None),
        Variant("A", "K2 body", "gaussian-slab", klm.P_RAY,
                lambda: klm.variant_a(t, q, cs), None,
                lambda: klm.block_a(t, q, cs)),
        Variant("B", "P5b", "gaussian-slab", klm.P_RAY,
                lambda: klm.variant_b(cm, q, cs), None,
                lambda: klm.block_b(cm, q, cs)),
        Variant("C", "P5c", "gaussian-slab", klm.P_RAY,
                lambda: klm.variant_c(planes, q, cs), None,
                lambda: klm.block_c(planes, q, cs)),
    ]


def _random_rays(rand: Data) -> List[Variant]:
    q, cs = rand.q, rand.scene.cell
    planes = tk.index_planes(rand.index)
    quad = rand.extra["quad"]
    return [
        Variant("v0", "-", "random-rays", 27,
                lambda: kp1.v0(rand.index, q), None),
        Variant("planes", "P6p", "random-rays", kqm.P_RAY,
                lambda: kqm.ray_knn_planes(planes, q, cs), None,
                lambda: klm.block_c(planes, q, cs)),
        Variant("quad", "P6q", "random-rays", kqm.P_RAY,
                lambda: kqm.ray_knn_quad(quad, q, cs), None,
                lambda: kqm.block_quad(quad, q, cs)),
    ]


def _fmt(ms: Optional[float], dev_ms: Optional[float]) -> str:
    if ms is None:
        return "not measured (cpu)"
    dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    return f"{ms:.4f} ms (device {dev})"


def run(device, points: Optional[int] = None, rays: Optional[int] = None,
        iters: int = 10, data: Optional[List[Data]] = None) -> List[dict]:
    """Run every variant once for the match, time it on a card, and print
    one line each. Returns the rows."""
    device = torch.device(device)
    timed = device.type == "cuda"
    data = data or prepare(device, points, rays)
    by_scene = {d.scene.name: d for d in data}
    ref = {}
    rows = []
    for v in variants(data):
        d = by_scene[v.scene]
        before = bt.LAUNCHES["block_topk"]
        with torch.no_grad():
            d2, idx, valid = v.run()
            exact = (d2 if v.name == "v0"
                     else S.exact_d2(d.points, d.q, idx, valid))
            if v.name == "v0":
                ref[v.scene] = d2
            match = S.dist_set_match(ref[v.scene], exact)
            kernel = v.kernel or (_block_kernel(v.block) if v.block else None)
            pipe_ms = kern_ms = pipe_dev = kern_dev = None
            if timed:
                pipe_ms, pipe_dev = (S.cuda_ms(v.run, iters),
                                     S.device_ms(v.run, iters))
                if kernel is not None:
                    kern_ms, kern_dev = (S.cuda_ms(kernel, iters),
                                         S.device_ms(kernel, iters))
        row = {"name": v.name, "body": v.body, "scene": v.scene,
               "rays": int(d.q.shape[0]), "p": v.p, "pipeline_ms": pipe_ms,
               "pipeline_device_ms": pipe_dev, "kernel_ms": kern_ms,
               "kernel_device_ms": kern_dev, "match_pct": match,
               "launches": bt.LAUNCHES["block_topk"] - before}
        rows.append(row)
        kern = "-" if kernel is None else _fmt(kern_ms, kern_dev)
        print(f"[study] {v.name:<19} {v.body:<7} {v.scene:<13} "
              f"R={row['rays']} P={v.p}: pipeline {_fmt(pipe_ms, pipe_dev)}"
              f", kernel {kern}, dist-set match vs v0 {match:.4f}%, "
              f"block_topk launches {row['launches']}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--points", type=int, default=None,
                    help="cloud size of every scene (default: 300000)")
    ap.add_argument("--rays", type=int, default=None,
                    help="rays of every scene (default: 5000/5024/5008)")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed calls a measurement, after warm-up")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("knn_study: CUDA is not available; pass "
                               "--device cpu to run the plain versions "
                               "(nothing is timed there)")
        print(f"[study] card: {S.card_line()}; "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    return run(args.device, args.points, args.rays, args.iters)


if __name__ == "__main__":
    main(sys.argv[1:])
