#!/usr/bin/env python3
"""GPU smoke test of point_slam_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this repository; exits
non-zero with no result line otherwise. In one pass it:

1. prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels from ``point_slam_tpu_torch/ops/csrc`` (nvcc, sm_90a);
2. phase A: builds the port's cell tables from the synthetic room's frame 0
   at bench.py's settings (table 2^16, C=64, P=27) and holds each ray top-k
   kernel against its plain PyTorch version at the main path's shapes
   (R=5000 mapping rays and R=1500 tracking rays, ns=5, k=8): keys and ids
   must be EQUAL; prints the median CUDA-event times of both;
3. phase B: runs the port's PointSLAM on configs/Synthetic/room.yaml with
   bench.py's overrides (680x1200; tracking 1500 rays x 40 iterations;
   mapping 5000 rays x 300 iterations every 5th frame; 6000 + 1000
   densification rays; window 12; CAP 2^17) over frames 0-6 (map 0, track
   2-6, map 5 and the last frame 6), and checks that the packed kernel ran
   in both tracking and mapping, poses are finite, ATE without alignment is
   below 2 cm and the cloud grew from map 0 to map 5; then a short run of
   frames 0-2 with the f32-plane cell table, which goes through the planes
   kernel;
4. prints one JSON line of the kernels, the card again, and last the line
   {"ok": true, "device": {...}}.

Weights are random (seeded) except the pretrained geometry decoder in
pretrained/middle_fine.npz; the data is the procedural synthetic room.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 1219
ITERS_FIRST = 1500          # bench.py's first-frame mapping iterations
REPEATS = 20                # timed launches per measurement (after warm-up)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bench_config(n_frames: int):
    """configs/Synthetic/room.yaml with bench.py's overrides."""
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", "room.yaml"),
                      os.path.join(HERE, "configs", "point_slam.yaml"))
    cfg["synthetic"].update({"n_frames": n_frames, "angular_step": 0.01})
    cfg["cam"].update({"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0,
                       "cx": 599.5, "cy": 339.5})
    cfg["tracking"].update({"pixels": 1500, "iters": 40,
                            "ignore_edge_W": 100, "ignore_edge_H": 100})
    cfg["mapping"].update({
        "pixels": 5000, "pixels_adding": 6000,
        "pixels_based_on_color_grad": 1000, "iters": 300,
        "iters_first": ITERS_FIRST, "geo_iter_first": 400,
        "mapping_window_size": 12, "keyframe_every": 5, "every_frame": 5,
        "lazy_start": False, "color_refine": False})
    cfg["rendering"]["sample_near_pcl"] = False
    cfg["cuda"].update({"point_capacity_init": 1 << 17,
                        "grid_table_size": 1 << 16, "grid_max_per_cell": 64,
                        "knn_probes": 27})
    cfg["verbose"] = True
    cfg["data"]["output"] = os.path.join(HERE, "output", "chip_smoke")
    return cfg


def cuda_ms(fn) -> float:
    """Median CUDA-event time of fn() in ms, after warm-up."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPEATS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def phase_a(dev):
    """Kernel against plain on the card at the main path's shapes."""
    import numpy as np
    import torch
    from point_slam_tpu_torch import renderer as R
    from point_slam_tpu_torch.common import camera, sampling
    from point_slam_tpu_torch.mapper import Mapper
    from point_slam_tpu_torch.models import decoders as D
    from point_slam_tpu_torch.datasets import get_dataset
    from point_slam_tpu_torch.ops import knn

    cfg = bench_config(7)
    cfg["mapping"]["iters_first"] = 0        # densify frame 0 only
    ds = get_dataset(cfg)
    _, color, depth, c2w = ds[0]
    mapper = Mapper(cfg, D.init_decoders(cfg, SEED, dev), len(ds),
                    np.random.default_rng(SEED), dev)
    mapper.map_frame(0, color, depth, c2w, c2w)
    cloud, n = mapper.cloud, mapper.n_points_host
    indexes = {"ray_topk_packed": mapper.index,
               "ray_topk_planes": knn.build_grid_index(
                   cloud.pos, cloud.n_points, mapper.cell_size,
                   mapper.table_size, mapper.max_per_cell)}
    print(f"[A] frame-0 cloud: {n} points, table {mapper.table_size} x "
          f"{mapper.max_per_cell}", flush=True)

    g = torch.Generator(device=dev).manual_seed(SEED)
    depth_d = torch.as_tensor(depth, device=dev)
    c2w_d = torch.as_tensor(c2w, device=dev)
    rc = mapper.rc
    p_ray, k, ns = rc.knn_probes, rc.nn_num, rc.n_surface
    results = {}
    for name, index in indexes.items():
        res = results[name] = {}
        for r in (5000, 1500):
            i, j = sampling.sample_pixels_uniform(0, cfg["cam"]["H"], 0,
                                                  cfg["cam"]["W"], r, g, dev)
            rays_o, rays_d = camera.rays_from_uv(
                i, j, c2w_d, cfg["cam"]["fx"], cfg["cam"]["fy"],
                cfg["cam"]["cx"], cfg["cam"]["cy"])
            dep = sampling.gather_pixels(depth_d, i, j)
            z = R.build_z_vals(rc, dep, torch.ones_like(dep, dtype=bool))
            q = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
            probes, compact = knn._box_probes(q, index.cell_size,
                                              index.table_size, p_ray)
            qk = (knn._query_lattice(q, index.cell_size)
                  if name == "ray_topk_packed" else q).contiguous()
            planes = knn.index_planes(index)
            lane_mask = knn._lane_mask(p_ray * index.max_per_cell)
            run = lambda: knn.ray_topk(probes, planes, qk, k, lane_mask)
            plain = lambda: knn.ray_topk_reference(probes, planes, qk, k,
                                                   lane_mask)
            keys, ids = run()
            rkeys, rids = plain()
            torch.cuda.synchronize()
            err = max((keys.long() - rkeys.long()).abs().max().item(),
                      (ids - rids).nan_to_num().abs().max().item())
            equal = torch.equal(keys, rkeys) and torch.equal(ids, rids)
            ms, plain_ms = cuda_ms(run), cuda_ms(plain)
            print(f"[A] {name} R={r} ns={ns} k={k} P={p_ray}: keys/ids equal "
                  f"to plain: {equal} (max abs err {err}, tolerance 0); "
                  f"valid slots {(keys < 0x7F800000).float().mean().item():.4f}"
                  f", compact rays {compact.float().mean().item():.4f}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            if not equal:
                raise AssertionError(f"{name} at R={r} differs from plain")
            res[r] = {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms}
    return results


def run_slam(dev, n_frames: int, packed_coords: bool, iters_first: int):
    """PointSLAM over frames 0..n_frames-1; returns (summary, slam,
    per-phase launch counts)."""
    from point_slam_tpu_torch.ops import knn
    from point_slam_tpu_torch.slam import PointSLAM

    cfg = bench_config(n_frames)
    cfg["mapping"]["iters_first"] = iters_first
    cfg["cuda"]["knn_packed_coords"] = packed_coords
    slam = PointSLAM(cfg, device=dev)
    per_phase = {"track": dict.fromkeys(knn.LAUNCHES, 0),
                 "map": dict.fromkeys(knn.LAUNCHES, 0)}

    def counted(fn, phase):
        def wrapped(*a, **kw):
            before = dict(knn.LAUNCHES)
            out = fn(*a, **kw)
            for name in knn.LAUNCHES:
                per_phase[phase][name] += knn.LAUNCHES[name] - before[name]
            return out
        return wrapped

    slam.tracker.track_frame = counted(slam.tracker.track_frame, "track")
    slam.mapper.map_frame = counted(slam.mapper.map_frame, "map")
    for name in knn.LAUNCHES:
        knn.LAUNCHES[name] = 0
    summary = slam.run()
    totals = dict(knn.LAUNCHES)
    return summary, slam, per_phase, totals


def phase_b(dev):
    import numpy as np
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate

    if ITERS_FIRST != 1500:
        print(f"[B] mapping.iters_first cut from 1500 to {ITERS_FIRST}")
    t0 = time.perf_counter()
    summary, slam, per_phase, totals = run_slam(dev, 7, True, ITERS_FIRST)
    wall = time.perf_counter() - t0
    name = "ray_topk_packed"
    print(f"[B] launches of {name}: tracking {per_phase['track'][name]}, "
          f"mapping {per_phase['map'][name]}; all kernels {totals}")
    if per_phase["track"][name] == 0 or per_phase["map"][name] == 0:
        raise AssertionError(f"{name} did not run in both tracking and "
                             f"mapping: {per_phase}")
    est = summary["estimate_c2w_list"]
    if not np.isfinite(est).all():
        raise AssertionError("non-finite poses")
    ate = evaluate_ate(summary["gt_c2w_list"], est, align=False)[
        "absolute_translational_error.rmse"]
    stats = slam.mapper.frame_stats
    print(f"[B] ATE no-align {ate * 100:.4f} cm; points after map 0 "
          f"{stats[0]['n_points']}, map 5 {stats[5]['n_points']}, final "
          f"{summary['n_points']}; keyframes {summary['keyframes']}")
    if not ate < 0.02:
        raise AssertionError(f"ATE no-align {ate} m >= 2 cm")
    if not 0 < stats[0]["n_points"] < stats[5]["n_points"]:
        raise AssertionError("the cloud did not grow from map 0 to map 5")
    ft = summary["frame_times"]
    tracked = [ft[i]["track"] for i in range(2, 7)]
    mapped = {i: ft[i]["map"] for i in (0, 5, 6)}
    print(f"[B] tracked frame times (s, frames 2-6): "
          f"{[round(t, 4) for t in tracked]}; mapped frame times (s): "
          f"{ {i: round(t, 4) for i, t in mapped.items()} } "
          f"(iterations {[stats[i]['n_iters'] for i in (0, 5, 6)]}); "
          f"frames 1-6 {6 / sum(ft[i]['track'] + ft[i]['map'] for i in range(1, 7)):.4f}"
          f" frames/s; run wall {wall:.2f} s; timing {summary['timing']}; "
          f"card {card_line()}", flush=True)

    # the f32-plane cell table (knn_packed_coords: false) goes through K2
    summary2, _, per_phase2, totals2 = run_slam(dev, 3, False, 100)
    print(f"[B] f32-plane run (frames 0-2): launches {per_phase2}")
    if per_phase2["map"]["ray_topk_planes"] == 0 or \
            per_phase2["track"]["ray_topk_planes"] == 0:
        raise AssertionError("ray_topk_planes did not run on the f32 planes")
    if not np.isfinite(summary2["estimate_c2w_list"]).all():
        raise AssertionError("non-finite poses in the f32-plane run")
    return {"ray_topk_packed": totals["ray_topk_packed"],
            "ray_topk_planes": totals2["ray_topk_planes"]}


def main():
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA card")
    print(card_line(), flush=True)
    from point_slam_tpu_torch.ops import _build
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.load_library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s)",
          flush=True)

    a = phase_a(dev)
    launches = phase_b(dev)

    replaces = {"ray_topk_packed": "point_slam_tpu/ops/knn.py:664",
                "ray_topk_planes": "point_slam_tpu/ops/knn.py:630"}
    kernels = [{"name": name, "route": "cuda",
                "source": "point_slam_tpu_torch/ops/csrc/ray_topk.cu",
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": max(a[name][r]["max_abs_err"] for r in a[name]),
                "ms": a[name][5000]["ms"], "plain_ms": a[name][5000]["plain_ms"]}
               for name in ("ray_topk_packed", "ray_topk_planes")]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
