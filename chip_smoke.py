#!/usr/bin/env python3
"""GPU smoke test of point_slam_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this repository; exits
non-zero with no result line otherwise. In one pass it:

1. prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels from ``point_slam_tpu_torch/ops/csrc`` (one nvcc per source, in
   parallel, sm_90a);
2. phase A: builds the port's cell tables (packed, f32 planes, fused) from
   the synthetic room's frame 0 at bench.py's settings (table 2^16, C=64,
   P=27) and holds each ray top-k kernel (K1, K2, K3) against its plain
   PyTorch version at the main path's shapes (R=5000 mapping rays and
   R=1500 tracking rays, ns=5, k=8): keys and ids must be EQUAL (K3's ids
   as bit patterns) and prints the fused kernel's persistent grid; then the
   row-Adam kernel (K4) against its plain version with the frame's frustum
   mask, on the live prefix of the (2^17, 72) buffer that the mapper hands
   it (the frame-0 cloud's rows) and on the whole buffer: p, m, v EQUAL.
   Prints, for each kernel, the median CUDA-event time (host launch cost
   included), its device time (torch.profiler's summed kernel time), its
   plain version's time and the least time the card could take on these
   inputs (the bound: K4's over the rows given);
3. phase B: runs the port's PointSLAM on configs/Synthetic/room.yaml with
   bench.py's overrides (680x1200; tracking 1500 rays x 40 iterations;
   mapping 5000 rays x 300 iterations every 5th frame; 6000 + 1000
   densification rays; window 12; CAP 2^17) over frames 0-6 (map 0, track
   2-6, map 5 and the last frame 6), and checks that the packed kernel ran
   in both tracking and mapping, poses are finite, ATE without alignment is
   below 2 cm and the cloud grew from map 0 to map 5; then a short run of
   frames 0-2 with the f32-plane cell table, which goes through the planes
   kernel;
4. phase C: runs configs/Synthetic/room_sensor.yaml (depth holes with
   near-cloud sampling, exposure latents, bundle adjustment, colour-gradient
   tracking pixels, colour refinement at the last frame) at the same widths
   over the fused cell table with the fused row-Adam, frames 0-12 with
   every_frame 2 and keyframe_every 2 (BA from frame 10, frame 12 refined),
   and checks that K3 ran in tracking and mapping, K4 once per mapping
   iteration, depth-free pixels were present, BA moved a keyframe pose, the
   refinement ran 5 windows, poses are finite and ATE without alignment is
   below 2 cm;
5. phase D: the kNN selection study (point_slam_tpu_torch.profiling).
   For each Pallas body of profiling/knn_pallas*.py, knn_layout_micro.py
   and knn_quad_micro.py (P1-P6) it holds the block top-k kernel against
   its plain version on the block that the body's study variant gathers,
   in its layout (separate planes, one row of planes, component-major,
   quad), with and without the id view, at the scripts' widths (up to
   P*C = 4096 lanes) on the scripts' scenes and on the same scenes with
   300 points: keys and ids EQUAL (ids as bit patterns). Prints kernel,
   plain and bound times; then runs the study at its default sizes (every
   variant's pipeline and kernel time and its match against per-sample
   grid_knn), counts its block top-k launches, and checks that every body
   ran, that the sine-sheet variants match per-sample grid_knn on >= 95% of
   slots and that the layouts of one scene select the same neighbours;
6. prints one JSON line of the kernels, the card again, and last the line
   {"ok": true, "device": {...}}.

Weights are random (seeded) except the pretrained geometry decoder in
pretrained/middle_fine.npz; the data is the procedural synthetic room.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 1219
ITERS_FIRST = 1500          # bench.py's first-frame mapping iterations
REPEATS = 20                # timed launches per measurement (after warm-up)
RAY_BATCHES = (5000, 1500)  # mapping and tracking rays a render call
# phase C's depth cut (the configuration's own: iters_first 1500, iters 300)
SENSOR_ITERS_FIRST = 300
SENSOR_ITERS = 100
SENSOR_FRAMES = 13
# phase D: each Pallas body of the kNN study -> (the study variant that
# runs it, the body's file:line)
STUDY_BODIES = {
    "P1": ("v3", "profiling/knn_pallas.py:111"),
    "P2": ("v4", "profiling/knn_pallas2.py:108"),
    "P2'": ("v5", "profiling/knn_pallas2.py:238"),
    "P3": ("v7", "profiling/knn_pallas3.py:52"),
    "P4": ("v8", "profiling/knn_pallas4.py:18"),
    "P5b": ("B", "profiling/knn_layout_micro.py:103"),
    "P5c": ("C", "profiling/knn_layout_micro.py:150"),
    "P6q": ("quad", "profiling/knn_quad_micro.py:60"),
    "P6p": ("planes", "profiling/knn_quad_micro.py:112"),
}
STUDY_LAYOUT = {"P1": "planes", "P2": "row", "P2'": "row", "P3": "row",
                "P4": "row", "P5b": "component", "P5c": "planes",
                "P6q": "quad", "P6p": "planes"}
STUDY_SPARSE_POINTS = 300   # most samples then have fewer than 8 candidates
STUDY_ITERS = 10            # timed calls a study measurement

# The card's published peaks (H100 SXM data sheet, at 700 W): HBM bytes/s
# and f32 flop/s outside the tensor cores. A kernel's bound is the larger of
# its bytes over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
KEY_FLOPS = 8               # a candidate-sample key: 3 sub, 3 mul, 2 add
ADAM_FLOPS = 15             # one row-Adam element (row_adam.cu)


def card_line() -> str:
    from point_slam_tpu_torch.profiling.scene import card_line as line
    return line()


def bench_config(n_frames: int, scene: str = "room.yaml"):
    """configs/Synthetic/<scene> with bench.py's overrides."""
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", scene),
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


def sensor_config():
    """configs/Synthetic/room_sensor.yaml at bench.py's widths, over the
    fused cell table with the fused row-Adam; its own window (10), exposure,
    BA, depth dropout (0.10), near-cloud sampling, colour-gradient tracking
    and colour refinement; every_frame 2, keyframe_every 2, depth cut."""
    from point_slam_tpu_torch.config import load_config
    own = load_config(os.path.join(HERE, "configs", "Synthetic",
                                   "room_sensor.yaml"),
                      os.path.join(HERE, "configs", "point_slam.yaml"))
    cfg = bench_config(SENSOR_FRAMES, "room_sensor.yaml")
    cfg["mapping"].update({
        "mapping_window_size": own["mapping"]["mapping_window_size"],
        "every_frame": 2, "keyframe_every": 2,
        "iters_first": SENSOR_ITERS_FIRST, "iters": SENSOR_ITERS,
        "color_refine": own["mapping"]["color_refine"]})
    cfg["rendering"]["sample_near_pcl"] = own["rendering"]["sample_near_pcl"]
    cfg["cuda"].update({"knn_packed_coords": "fused", "fused_adam": True})
    cfg["data"]["output"] = os.path.join(HERE, "output", "chip_smoke_sensor")
    return cfg


def bound(n_bytes: float, n_flops: float):
    """(least time in ms, what sets it) on the card's published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn) -> float:
    """Median CUDA-event time of fn() in ms (REPEATS calls after warm-up)."""
    from point_slam_tpu_torch.profiling.scene import cuda_ms as median_ms
    return median_ms(fn, REPEATS)


def device_ms(fn, bound_ms):
    """Device time of one fn() call in ms: the summed kernel durations that
    torch.profiler records (scene.device_ms). On the card machine the
    profiler now and then records no device activity, or loses records,
    for a window; a window that sums to less than the call's bound cannot
    be whole. After three windows with nothing or too little this is None,
    printed as "not measured"."""
    from point_slam_tpu_torch.profiling.scene import device_ms as summed_ms
    for _ in range(3):
        ms = summed_ms(fn, REPEATS)
        if ms is not None and ms >= bound_ms:
            return ms
    return None


def shown(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def topk_bound(name, probes, c, ns, k):
    """The least time of one ray top-k launch on these inputs, from the
    bytes it needs (the distinct probed rows: coordinates, or the whole
    2C-wide row of the fused layout; the winners' ids; the probes, queries
    and outputs) and its operations (a key per candidate and sample)."""
    import torch
    r, p = probes.shape
    rows = torch.unique(probes).numel()
    row_bytes = {"ray_topk_packed": c * 4, "ray_topk_planes": 3 * c * 4,
                 "ray_topk_fused": 2 * c * 4}[name]
    ids = 0 if name == "ray_topk_fused" else r * ns * k * 4
    n_bytes = (rows * row_bytes + ids + r * p * 4 + r * ns * 3 * 4
               + r * ns * k * 8)
    return bound(n_bytes, r * ns * p * c * KEY_FLOPS), rows


def phase_a(dev):
    """Kernel against plain on the card at the main path's shapes."""
    import numpy as np
    import torch
    from point_slam_tpu_torch import pointcloud as pc
    from point_slam_tpu_torch import renderer as R
    from point_slam_tpu_torch.common import camera, sampling
    from point_slam_tpu_torch.mapper import Mapper
    from point_slam_tpu_torch.models import decoders as D
    from point_slam_tpu_torch.datasets import get_dataset
    from point_slam_tpu_torch.ops import adam, knn

    cfg = bench_config(7)
    cfg["mapping"]["iters_first"] = 0        # densify frame 0 only
    ds = get_dataset(cfg)
    _, color, depth, c2w = ds[0]
    mapper = Mapper(cfg, D.init_decoders(cfg, SEED, dev), len(ds),
                    np.random.default_rng(SEED), dev)
    mapper.map_frame(0, color, depth, c2w, c2w)
    cloud, n = mapper.cloud, mapper.n_points_host
    args = (cloud.pos, cloud.n_points, mapper.cell_size, mapper.table_size,
            mapper.max_per_cell)
    indexes = {"ray_topk_packed": mapper.index,
               "ray_topk_planes": knn.build_grid_index(*args),
               "ray_topk_fused": knn.build_fused_grid_index(*args)}
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
        lanes = 2 if name == "ray_topk_fused" else 1
        for r in RAY_BATCHES:
            i, j = sampling.sample_pixels_uniform(0, cfg["cam"]["H"], 0,
                                                  cfg["cam"]["W"], r, g, dev)
            rays_o, rays_d = camera.rays_from_uv(
                i, j, c2w_d, cfg["cam"]["fx"], cfg["cam"]["fy"],
                cfg["cam"]["cx"], cfg["cam"]["cy"])
            dep = sampling.gather_pixels(depth_d, i, j)
            z, _ = R.build_z_vals(rc, index, rays_o, rays_d, dep,
                                  torch.full_like(dep, 0.16),
                                  torch.ones_like(dep, dtype=bool))
            q = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
            probes, compact = knn._box_probes(q, index.cell_size,
                                              index.table_size, p_ray)
            qk = (q if name == "ray_topk_planes"
                  else knn._query_lattice(q, index.cell_size)).contiguous()
            planes = knn.index_planes(index)
            c = index.max_per_cell
            lane_mask = knn._lane_mask(p_ray * c * lanes)
            run = lambda: knn.ray_topk(probes, planes, qk, k, lane_mask)
            plain = lambda: knn.ray_topk_reference(probes, planes, qk, k,
                                                   lane_mask)
            keys, ids = run()
            rkeys, rids = plain()
            torch.cuda.synchronize()
            # ids as int32 bit patterns (K3's may be NaN bits as floats)
            ib, rib = ids.view(torch.int32), rids.view(torch.int32)
            err = max((keys.long() - rkeys.long()).abs().max().item(),
                      (ib.long() - rib.long()).abs().max().item())
            equal = torch.equal(keys, rkeys) and torch.equal(ib, rib)
            ms, plain_ms = cuda_ms(run), cuda_ms(plain)
            (b_ms, b_by), rows = topk_bound(name, probes, c, ns, k)
            dev_ms = device_ms(run, b_ms)
            print(f"[A] {name} R={r} ns={ns} k={k} P={p_ray}: keys/ids equal "
                  f"to plain: {equal} (max abs err {err}, tolerance 0); "
                  f"valid slots {(keys < 0x7F800000).float().mean().item():.4f}"
                  f", compact rays {compact.float().mean().item():.4f}; "
                  f"kernel {ms:.4f} ms (device {shown(dev_ms)}), plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}; {rows} "
                  f"distinct rows)", flush=True)
            if not equal:
                raise AssertionError(f"{name} at R={r} differs from plain")
            if name == "ray_topk_fused":
                per_sm, smem = knn.fused_occupancy(p_ray, c, ns)
                n_sm = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                print(f"[A] ray_topk_fused: {per_sm} blocks an SM, grid "
                      f"{min(r, per_sm * n_sm)}, {smem} bytes of shared "
                      f"memory a block", flush=True)
            res[r] = {"max_abs_err": float(err), "ms": ms,
                      "device_ms": dev_ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by}
    results["row_adam"] = phase_a_row_adam(dev, cfg, cloud, n, depth_d,
                                           c2w_d)
    return results


def phase_a_row_adam(dev, cfg, cloud, n_live, depth_d, c2w_d):
    """K4 with the frame's frustum as the row mask, on the live prefix the
    mapper hands it (the frame-0 cloud's rows) and on the whole (CAP, 72)
    buffer: p, m, v EQUAL to the plain version (0 ulp)."""
    import torch
    from point_slam_tpu_torch import pointcloud as pc
    from point_slam_tpu_torch.ops import adam
    cap, w = cloud.packed.shape
    cam = cfg["cam"]
    frustum = pc.frustum_mask(cloud.pos, cloud.n_points,
                              torch.linalg.inv(c2w_d), depth_d, cam["fx"],
                              cam["fy"], cam["cx"], cam["cy"],
                              cfg["mapping"]["frustum_edge"]).float()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g_all = 1e-3 * torch.randn((cap, w), generator=gen, device=dev)
    m_all = 1e-4 * torch.randn((cap, w), generator=gen, device=dev)
    v_all = 1e-6 * torch.rand((cap, w), generator=gen, device=dev)
    t_row = torch.full((w,), 37.0, device=dev)   # geometry / rest columns
    t_row[32:64] = 12.0                          # colour columns restarted
    lr_row = torch.zeros(w, device=dev)
    lr_row[:32], lr_row[32:64] = 0.03, 0.005
    out = {}
    for rows in (n_live, cap):
        p0, g0, m0, v0, mask = (x[:rows].clone() for x in (
            cloud.packed, g_all, m_all, v_all, frustum))
        pk, sk = adam.update_rows(p0.clone(), g0, {"m": m0.clone(),
                                                   "v": v0.clone()},
                                  t_row, lr_row, mask)
        pr, sr = adam.update_rows_reference(p0, g0, {"m": m0, "v": v0},
                                            t_row, lr_row, mask)
        torch.cuda.synchronize()
        pairs = [(pk, pr), (sk["m"], sr["m"]), (sk["v"], sr["v"])]
        equal = all(torch.equal(a, b) for a, b in pairs)
        err = max((a - b).abs().max().item() for a, b in pairs)
        ulps = max((a.view(torch.int32).long() - b.view(torch.int32).long())
                   .abs().max().item() for a, b in pairs)
        buf = {"p": p0.clone(), "m": m0.clone(), "v": v0.clone()}
        run = lambda: adam.update_rows(buf["p"], g0, buf, t_row, lr_row,
                                       mask)
        plain = lambda: adam.update_rows_reference(p0, g0, {"m": m0, "v": v0},
                                                   t_row, lr_row, mask)
        ms, plain_ms = cuda_ms(run), cuda_ms(plain)
        # over the rows given: p, g, m, v read and p, m, v written once,
        # and the mask
        b_ms, b_by = bound(7 * rows * w * 4 + rows * 4,
                           rows * w * ADAM_FLOPS)
        dev_ms = device_ms(run, b_ms)
        print(f"[A] row_adam N={rows} W={w} ({int(mask.sum())} rows in the "
              f"frustum{'; the live prefix' if rows == n_live else ''}): "
              f"p/m/v equal to plain: {equal} (max abs err {err}, max "
              f"{ulps} ulp, tolerance 0); kernel {ms:.4f} ms through the "
              f"wrapper (device {shown(dev_ms)}), plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by})", flush=True)
        if not equal:
            raise AssertionError(f"row_adam differs from plain by {ulps} ulp")
        out[rows] = {"max_abs_err": float(err), "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
    return out


def run_slam(dev, cfg, setup=None):
    """PointSLAM over the config's frames; returns (summary, slam,
    per-phase launch counts, totals). Every kernel count is set to 0 just
    before the run and read just after it. ``setup(slam)`` runs first."""
    from point_slam_tpu_torch.ops import adam, knn
    from point_slam_tpu_torch.slam import PointSLAM

    def launches():
        return {**knn.LAUNCHES, **adam.LAUNCHES}

    slam = PointSLAM(cfg, device=dev)
    if setup is not None:
        setup(slam)
    per_phase = {"track": dict.fromkeys(launches(), 0),
                 "map": dict.fromkeys(launches(), 0)}

    def counted(fn, phase):
        def wrapped(*a, **kw):
            before = launches()
            out = fn(*a, **kw)
            for name, v in launches().items():
                per_phase[phase][name] += v - before[name]
            return out
        return wrapped

    slam.tracker.track_frame = counted(slam.tracker.track_frame, "track")
    slam.mapper.map_frame = counted(slam.mapper.map_frame, "map")
    for table in (knn.LAUNCHES, adam.LAUNCHES):
        for name in table:
            table[name] = 0
    summary = slam.run()
    return summary, slam, per_phase, launches()


def phase_b(dev):
    import numpy as np
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate

    if ITERS_FIRST != 1500:
        print(f"[B] mapping.iters_first cut from 1500 to {ITERS_FIRST}")
    cfg = bench_config(7)
    cfg["mapping"]["iters_first"] = ITERS_FIRST
    cfg["cuda"]["knn_packed_coords"] = True
    t0 = time.perf_counter()
    summary, slam, per_phase, totals = run_slam(dev, cfg)
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
    cfg = bench_config(3)
    cfg["mapping"]["iters_first"] = 100
    cfg["cuda"]["knn_packed_coords"] = False
    summary2, _, per_phase2, totals2 = run_slam(dev, cfg)
    print(f"[B] f32-plane run (frames 0-2): launches {per_phase2}")
    if per_phase2["map"]["ray_topk_planes"] == 0 or \
            per_phase2["track"]["ray_topk_planes"] == 0:
        raise AssertionError("ray_topk_planes did not run on the f32 planes")
    if not np.isfinite(summary2["estimate_c2w_list"]).all():
        raise AssertionError("non-finite poses in the f32-plane run")
    return {"ray_topk_packed": totals["ray_topk_packed"],
            "ray_topk_planes": totals2["ray_topk_planes"]}


def phase_c(dev):
    """The sensor-shaped path (room_sensor.yaml) through K3 and K4."""
    import numpy as np
    from point_slam_tpu_torch.datasets import get_dataset
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate

    cfg = sensor_config()
    print(f"[C] cut: synthetic.n_frames 120 -> {SENSOR_FRAMES}", flush=True)
    print(f"[C] cut: mapping.iters_first 1500 -> {SENSOR_ITERS_FIRST}",
          flush=True)
    print(f"[C] cut: mapping.iters 300 -> {SENSOR_ITERS}", flush=True)
    ds = get_dataset(cfg)
    holes = [int((ds[i][2] == 0).sum()) for i in range(SENSOR_FRAMES)]
    print(f"[C] zero-depth pixels per frame: {holes}", flush=True)
    if min(holes) == 0:
        raise AssertionError("a frame without depth-free pixels")

    kf_before = []   # the store's keyframe poses before BA can run

    def snapshot(slam):
        inner = slam.mapper.map_frame

        def wrapped(idx, *a, **kw):
            if idx == 10:
                kf_before.extend(p.copy() for p in slam.mapper.store.est_c2w)
            return inner(idx, *a, **kw)
        slam.mapper.map_frame = wrapped

    t0 = time.perf_counter()
    summary, slam, per_phase, totals = run_slam(dev, cfg, snapshot)
    wall = time.perf_counter() - t0
    stats = slam.mapper.frame_stats
    mapped = sorted(stats)
    last = mapped[-1]
    map_iters = sum(stats[i]["n_iters"] * stats[i]["outer_loops"]
                    for i in mapped)
    print(f"[C] launches: tracking {per_phase['track']}; mapping "
          f"{per_phase['map']}; mapping iterations {map_iters}", flush=True)
    if per_phase["track"]["ray_topk_fused"] == 0 or \
            per_phase["map"]["ray_topk_fused"] == 0:
        raise AssertionError("ray_topk_fused did not run in both tracking "
                             "and mapping")
    if per_phase["map"]["row_adam"] != map_iters or \
            totals["row_adam"] != map_iters:
        raise AssertionError(f"row_adam launched {totals['row_adam']} times "
                             f"for {map_iters} mapping iterations")
    shift = max(np.abs(p - slam.mapper.store.est_c2w[k]).max()
                for k, p in enumerate(kf_before))
    print(f"[C] BA on at frames {[i for i in mapped if stats[i]['ba']]}; "
          f"largest keyframe pose change {shift:.6f}; refinement windows "
          f"{stats[last]['outer_loops']} at frame {last} "
          f"({stats[last]['n_iters']} iterations each)", flush=True)
    if not shift > 1e-5:
        raise AssertionError("BA moved no keyframe pose")
    if stats[last]["outer_loops"] != 5:
        raise AssertionError("the last frame's refinement did not run 5 "
                             "windows")
    est = summary["estimate_c2w_list"]
    if not np.isfinite(est).all():
        raise AssertionError("non-finite poses")
    ate = evaluate_ate(summary["gt_c2w_list"], est, align=False)[
        "absolute_translational_error.rmse"]
    ft = summary["frame_times"]
    busy = sum(ft[i]["track"] + ft[i]["map"] for i in range(1, SENSOR_FRAMES))
    print(f"[C] ATE no-align {ate * 100:.4f} cm; points "
          f"{[stats[i]['n_points'] for i in mapped]}; keyframes "
          f"{summary['keyframes']}; exposure latents "
          f"{len(slam.mapper.exposure_feat_all)}", flush=True)
    print(f"[C] tracked frame times (s): "
          f"{ {i: round(ft[i]['track'], 4) for i in ft if ft[i]['track']} }; "
          f"mapped frame times (s): "
          f"{ {i: round(ft[i]['map'], 4) for i in mapped} } (iterations "
          f"{[stats[i]['n_iters'] * stats[i]['outer_loops'] for i in mapped]}"
          f"); frames 1-{SENSOR_FRAMES - 1} "
          f"{(SENSOR_FRAMES - 1) / busy:.4f} frames/s; run wall {wall:.2f} s;"
          f" timing {summary['timing']}; card {card_line()}", flush=True)
    if not ate < 0.02:
        raise AssertionError(f"ATE no-align {ate} m >= 2 cm")
    return {"ray_topk_fused": totals["ray_topk_fused"],
            "row_adam": totals["row_adam"]}


def phase_d(dev):
    """The kNN selection study: the block top-k against its plain version
    for each Pallas body of P1-P6 at the scripts' widths, on the scripts'
    dense scenes and on the same scenes with STUDY_SPARSE_POINTS points;
    then the study itself, whose block top-k launches are counted."""
    import torch
    from point_slam_tpu_torch.ops import block_topk as bt
    from point_slam_tpu_torch.profiling import knn_study as ks

    t0 = time.perf_counter()
    dense = ks.prepare(dev)
    sparse = ks.prepare(dev, points=STUDY_SPARSE_POINTS)
    by_name = [{v.name: v for v in ks.variants(d)} for d in (dense, sparse)]
    results = {}
    for rec, (vname, _) in STUDY_BODIES.items():
        b_dense, b_sparse = (names[vname].block() for names in by_name)
        err, short, layouts = 0, [], []
        for b in (b_dense, b_sparse):
            for views in {len(b.views): b.views, 3: b.views[:3]}.values():
                keys, ids = bt.block_topk(views, b.q, 8, b.lane_mask)
                rkeys, rids = bt.block_topk_reference(views, b.q, 8,
                                                      b.lane_mask)
                torch.cuda.synchronize()
                err = max(err, (keys.long() - rkeys.long()).abs().max()
                          .item())
                equal = torch.equal(keys, rkeys)
                if ids is not None:
                    ib, rib = ids.view(torch.int32), rids.view(torch.int32)
                    err = max(err, (ib.long() - rib.long()).abs().max()
                              .item())
                    equal = equal and torch.equal(ib, rib)
                layouts.append("ids" if ids is not None else "keys")
                if not equal:
                    raise AssertionError(f"block_topk differs from plain for "
                                         f"{rec} ({layouts[-1]})")
            short.append((keys >= 0x7F800000).float().mean().item())
        views, q, mask = b_dense
        r, p, c = views[0].shape
        ns = q[0].shape[1]
        run = lambda: bt.block_topk(views, q, 8, mask)
        plain = lambda: bt.block_topk_reference(views, q, 8, mask)
        ms, plain_ms = cuda_ms(run), cuda_ms(plain)
        with_ids = len(views) == 4
        # coordinates once, the winners' ids, the queries, keys (and ids)
        n_bytes = (r * 3 * p * c * 4 + r * ns * 3 * 4
                   + r * ns * 8 * 4 * (3 if with_ids else 1))
        b_ms, b_by = bound(n_bytes, r * ns * p * c * KEY_FLOPS)
        dev_ms = device_ms(run, b_ms)
        print(f"[D] {rec} ({vname}, {STUDY_LAYOUT[rec]} layout, "
              f"{'ids' if with_ids else 'keys only'}) R={r} ns={ns} P={p} "
              f"C={c} mask {mask}: keys/ids equal to plain: True for "
              f"{'/'.join(layouts)} on the dense and the sparse cloud (max "
              f"abs err {err}, tolerance 0; samples short of 8 candidates "
              f"{short[0]:.4f} dense, {short[1]:.4f} sparse); kernel "
              f"{ms:.4f} ms (device {shown(dev_ms)}), plain {plain_ms:.4f} "
              f"ms, bound {b_ms:.5f} ms ({b_by})", flush=True)
        results[rec] = {"max_abs_err": float(err), "ms": ms,
                        "device_ms": dev_ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by}

    # the study at its default sizes: the slice's main path
    bt.LAUNCHES["block_topk"] = 0
    rows = ks.run(dev, iters=STUDY_ITERS, data=dense)
    total = bt.LAUNCHES["block_topk"]
    print(f"[D] block_topk launches in the study: {total}; phase D wall "
          f"{time.perf_counter() - t0:.2f} s; card {card_line()}", flush=True)
    for rec in STUDY_BODIES:
        results[rec]["launches"] = sum(row["launches"] for row in rows
                                       if row["body"] == rec)
        if results[rec]["launches"] == 0:
            raise AssertionError(f"the study launched no block_topk for "
                                 f"{rec}")
    if total == 0:
        raise AssertionError("block_topk did not run in the study")
    match = {(row["name"], row["p"]): row["match_pct"] for row in rows}
    sheet = [row["match_pct"] for row in rows if row["scene"] == "sine-sheet"
             and row["body"] in STUDY_BODIES]
    if min(sheet) < 95.0:
        raise AssertionError(f"sine-sheet dist-set match {sheet} < 95%")
    if not (match[("A", 36)] == match[("B", 36)] == match[("C", 36)]
            and match[("planes", 36)] == match[("quad", 36)]
            and match[("v7", 48)] == match[("ray_grid_knn f32", 48)]):
        raise AssertionError(f"layouts of one scene disagree: {match}")
    return results


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="ABCD",
                    help="run only these phases (e.g. A); a partial run "
                         "prints no kernels line and no result line")
    phases = ap.parse_args().phases.upper()
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

    if phases != "ABCD":
        for name, phase in (("A", phase_a), ("B", phase_b), ("C", phase_c),
                            ("D", phase_d)):
            if name in phases:
                phase(dev)
        return
    a = phase_a(dev)
    launches = phase_b(dev)
    launches.update(phase_c(dev))
    study = phase_d(dev)
    print(json.dumps({"kernels": kernel_records(a, launches)
                      + study_records(study)}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def kernel_records(a, launches):
    """The kernels' JSON records from phase A's measurements and the main
    paths' launch counts."""
    replaces = {"ray_topk_packed": "point_slam_tpu/ops/knn.py:664",
                "ray_topk_planes": "point_slam_tpu/ops/knn.py:630",
                "ray_topk_fused": "point_slam_tpu/ops/knn.py:694",
                "row_adam": "point_slam_tpu/ops/adam.py:60"}
    kernels = []
    for name in replaces:
        # the main path's shapes: R=5000 mapping rays; the live prefix of
        # the frame-0 cloud for row_adam (the mapper's rows)
        shape = min(a[name]) if name == "row_adam" else max(a[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": ("point_slam_tpu_torch/ops/csrc/row_adam.cu"
                       if name == "row_adam" else
                       "point_slam_tpu_torch/ops/csrc/ray_topk.cu"),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(v["max_abs_err"] for v in a[name].values()),
            **{key: a[name][shape][key] for key in
               ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
            # no single PyTorch call computes any of the four functions
            "library_ms": None})
    return kernels


def study_records(study):
    """One record for each Pallas body of the kNN study, all launched
    through the one block top-k kernel."""
    return [{"name": f"block_topk {rec}", "route": "cuda",
             "source": "point_slam_tpu_torch/ops/csrc/block_topk.cu",
             "replaces": where, "launches": study[rec]["launches"],
             **{key: study[rec][key] for key in
                ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                 "bound_by")},
             # no single PyTorch call computes the keyed top-k with ids
             "library_ms": None}
            for rec, (_, where) in STUDY_BODIES.items()]


if __name__ == "__main__":
    main()
