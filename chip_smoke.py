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
   R=1500 tracking rays, ns=5, k=8): keys and ids must be EQUAL (ids as
   bit patterns) and prints each kernel's persistent grid; then the
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
6. phase E, in a process of its own (deterministic cuBLAS needs a fixed
   workspace, which would slow the other phases' matmuls): what a run
   leaves behind, on configs/Synthetic/room.yaml at phase B's widths
   over frames 0-10 with a checkpoint every 5 frames. A
   continuous run (it must write ckpts/00005.npz, metrics.jsonl,
   final_point_cloud.{npy,ply} and npc_cloud.npy), then a fresh PointSLAM
   resumed from ckpts/00005.npz over frames 6-10, both under
   torch.use_deterministic_algorithms: ATE without alignment under 2 cm
   for both and within 0.05 cm of each other, and the poses bit-equal
   unless an op had no deterministic version (named then). Then the
   end-of-run evaluation (tools/evaluate.py) of the continuous run:
   frames 0, 5 and 10 re-rendered at 680x1200 through K1 (launches
   counted), PSNR / MS-SSIM / depth L1, TSDF fusion at the config's
   meshing.voxel on the card, the native marching on the host, and the
   reconstruction metrics against the culled analytic room (3D, and the
   2D depth L1 over E_VIEWS_2D views with the native rasterizer). Prints
   each step's seconds, the metrics and the peak device memory; fails on
   a missing file, a missing or NaN metric, a non-finite F-score or an ATE
   at or over 2 cm;
7. phase F: the disk datasets. F1 builds the image decoders
   (point_slam_tpu_torch/native/imgcodec.cpp, g++) and requires each
   fixture of tests/data_torch to decode to the SHA-256 that OpenCV's
   cv2.imread gave (digests.json), then times the decode of the 680x1200
   JPEG. F2 writes a TUM-RGBD sequence (frames 0-8 of the synthetic room
   at configs/TUM_RGBD/freiburg3_office.yaml's camera as 8-bit RGB and
   16-bit depth PNGs with 5% depth holes; rgb.txt, depth.txt and
   groundtruth.txt with jittered, offset stamps and one extra entry that
   the 32 fps pick drops) and runs the port's PointSLAM on that config
   from disk at tum.yaml's widths (crop_edge 8: 464x624) on the host
   keyframe ring: 9 frames read, K1 in tracking and mapping, ATE without
   alignment under 2 cm; prints the reader's ms a frame, the io and wait
   buckets, the window upload per mapped frame, frames/s, frame times and
   peak device memory. F3 runs two frames with use_view_direction (with
   and without encode_viewd): finite losses, and a geometry-stage render
   equal to one without view directions;
8. phase G: the in-run visualiser and the render-path run keys. G1 runs
   phase B's configuration over frames 0-5 with vis_inside in both loops
   (tracking panels every 20 of 40 iterations, mapping every 100 with
   cuda.max_iters_per_launch 200; vis_freq 5; every mapped frame at 400
   iterations) and save_rendered_image: the panel files must be exactly
   the names the JAX package's rule gives (G1_PANELS), each a PNG that the
   port's decoder reads at 2H x 3W; the panels' K1 launches are counted
   apart. G2 runs phase B with cuda.bf16_features (and end-of-frame panels
   at vis_freq 2 / 5, their names by the same rule): K1 ran, finite poses,
   the cloud grew, the view's positions within test_bf16.py's relative
   bound; prints ATE without alignment and frames/s beside phase B's and
   the depth L1 between a bf16 and an f32 render of frame 0. G3 runs
   room_sensor.yaml's path (phase C's) over frames 0-4 with the bf16 view:
   K3 ran, K4 once per mapping iteration, finite poses. G4 holds the
   decoders on a mapping batch: cuda.mlp_precision 'highest' bit-equal to
   no setting, 'default' different (TF32) within G4_REL of it, the TF32
   switch off again after it and the prefetch thread's grey conversion
   unchanged under it; then phase B again with 'default': ATE without
   alignment under 2 cm, frames/s;
9. phase H: data parallelism (``point_slam_tpu_torch/parallel/dist.py``).
   H1 runs phase B's configuration over frames 0-6 (iters_first cut to
   H1_ITERS_FIRST) at ``data_parallel`` 2: two processes sharing the one
   card in a gloo group over a FileStore (NCCL refuses two ranks on one
   device), against the same configuration in one process without a
   group, both under deterministic mode. Checks: K1 ran in tracking and
   mapping on both ranks, the ranks' clouds, decoders and poses are
   bit-equal, map 0's points (from the GT pose) equal world size 1's and
   after map 0's first iteration its features lie within 2e-3 of world
   size 1's in all but H_FEAT_SHARE of the entries (the share after
   iterations 10, 100 and the last is printed: rounding differences grow
   through Adam), ATE without alignment under 2 cm; prints both runs'
   frames/s (W=2 shares the card's SMs: not a scaling result) and the
   bytes all-reduced a mapping iteration. H2
   runs phase C's configuration over frames 0-4 (colour refinement off)
   at ``data_parallel`` 2: K3 and K4 (once a mapping iteration) on both
   ranks, bit-equal replicas, ATE without alignment under 2 cm. H3, in a
   process of its own under deterministic mode: phase B's configuration
   over frames 0-2 in an NCCL group of one, bit-equal to the run without
   a group; ``tools/determinism.py --device cuda --self_check`` must
   print DETERMINISTIC; ``tools/pretrain_geo.py --device cuda --scenes 1
   --frames 4`` writes an npz under output/, which a 3-frame run loads
   (frozen) and renders finite. Prints each cut as ``[H] cut:`` and the
   phase's wall time; the ranks' launches go into the kernels line;
10. phase I: the layer-measurement tools (``point_slam_tpu_torch/
   profiling``) at bench.py's widths (CAP 2^17, 22,500 points on frame 0's
   surfaces). I1: the card's matmul, copy and launch rates
   (hw_calibration) and the gather / backward scatter-add row rates
   (gather_scatter_micro, scatter_micro). I2: the mapping iteration's
   ablation ladder (iter_breakdown) on the packed cell table (K1, K4 in
   rung 9), and its
   kNN rung on the f32 planes (K2) and the fused table (K3), each kernel
   held EQUAL to its plain version on its ladder's inputs; the render
   sub-ladder and the sampling stages. I3: trace_ops (a traced stretch of
   the SLAM loop) and trace_map_iter (30 mapping iterations), both with
   device activity. I4: the roofline's analytic table on the card's peaks
   beside I3's measured buckets; a bucket below its bound fails. I5:
   step_cost, iter_cost, tracker_cost, map_frame_overhead,
   track_frame_overhead and frame_overhead. Prints each depth cut as
   ``[I] cut:`` and the phase's wall time; its launches go into the
   kernels line;
11. phase J: the quality gate, the soak chain and the end-to-end A/Bs
   (``point_slam_tpu_torch/profiling``). J0 holds K1 EQUAL to its plain
   version at P = 36 (probes_ab's other probe count; its block and shared
   memory depend on P) on phase A's tables at R = 5000 and 1500. J1-J3
   run as four concurrent processes sharing the card under a temporary
   output root (in the whole smoke they start after phase D and run
   beside phases E-H, which measure nothing the kernels line carries):
   J1 the furnished gate (quality_gate) over 100 frames with its
   iterations cut, a tagged probe: every metric finite, ATE without
   alignment under 2 cm; J2 room_scannet_scale.yaml over 60 frames with a
   checkpoint every 20 under soak_runner, which kills the run once after
   its first checkpoint and resumes it (the host keyframe ring in both
   runs), then soak_eval at a stride and soak_summary: a finite summary,
   ATE without alignment under 2 cm; J3 bf16_ab's two variants and
   geo_decoder_ab's three at 4 frames: finite rows. Last, alone on the
   card, mlp_precision_ab and probes_ab (K1 EQUAL at P = 36 and 27 on the
   step's samples) and geo_fwd_split at their defaults (CAP 2^19, 300k
   points on frame 0's surfaces). Prints each cut as ``[J] cut:``; the
   children's and the A/Bs' launches go into the kernels line;
12. prints one JSON line of the kernels, the card again, and last the line
   {"ok": true, "device": {...}}.

Weights are random (seeded) except the pretrained geometry decoder in
pretrained/middle_fine.npz; the data is the procedural synthetic room
(phase F writes it to disk in the TUM-RGBD layout and reads it back).
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
# phase E: frames 0-10 of room.yaml, a checkpoint every 5 frames; the 2D
# reconstruction metric over E_VIEWS_2D virtual views (1000 in the config)
E_FRAMES = 11
E_CKPT_FREQ = 5
E_VIEWS_2D = 10
E_CUBLAS_WORKSPACE = ":4096:8"   # the setting deterministic cuBLAS needs
E_LAUNCHES_TAG = "[E] ray_topk_packed launches in phase E:"
# phase F: frames 0-8 of a TUM-RGBD sequence (one more stamp in the lists,
# which the 32 fps pick drops), written at freiburg3_office's camera
F_CONFIG = ("TUM_RGBD", "freiburg3_office.yaml")
F_FRAMES = 9
F_EXTRA_AFTER = 4           # the dropped entry comes 10 ms after frame 4
F_HOLES = 0.05              # share of zeroed depth pixels (sensor holes)
F_DECODE_REPEATS = 20
F3_ITERS_FIRST = 100        # phase F3's depth cut (the config's: 500)
# phase G: frames 0-5 (G1) and 0-4 (G3); the panels G1 must leave, by the
# JAX package's rule (vis_freq 5; tracking: a hook panel at iteration 20 of
# 40 on frame 5; mapping: frame 5's 400 iterations in launches of 200, the
# panel at the last multiple of 100 below 200; vis_inside writes no
# end-of-frame panel and so no rendered image)
G_FRAMES = 6
G_ITERS = 400               # every mapped frame of G1 (iters_first 1500)
G1_PANELS = {"tracking_vis": ["00005_0020"],
             "mapping_vis": ["00005_0100"],
             "rendered_image": []}
G3_FRAMES = 5
G4_POINTS = 25000           # a mapping batch: 5000 rays x 5 samples
G4_REL = 2e-2               # TF32 against IEEE f32, relative to max |out|
# phase H: data parallelism. H1 (phase B's configuration over frames 0-6)
# and H2 (phase C's over frames 0-4) at data_parallel 2: two processes on
# the one card in a gloo group (NCCL refuses two ranks on one device),
# under deterministic mode; H1 also in one process without a group. At
# world size 2 each render and MLP runs at half the rays (other GEMM
# kernels, other rounding), and Adam steps an entry whose gradient is at
# the rounding's level by its whole learning rate; over hundreds of
# iterations such steps move the features far apart (PERF.md §6).
# So H1 holds the all-reduced gradient of map 0's first iteration to
# world size 1's within H1_GRAD_REL of its norm (one rank's half lands
# far outside), map 0's features after that iteration (H1_HELD_AT) within
# test_parallel.py's 2e-3 in all but H_FEAT_SHARE of the entries, and
# prints the share after H1_SNAPSHOTS iterations. H3 in a process of its own: an NCCL group of one over
# frames 0-2, the determinism harness, pretrain_geo
H_WORLD = 2
H1_FRAMES = 7
H1_ITERS_FIRST = 300        # H1's depth cut (phase B's: 1500)
H2_FRAMES = 5
H3_FRAMES = 3
H3_ITERS_FIRST = 300        # H3's depth cut (phase B's: 1500)
H_TIMEOUT_S = 600           # the groups' timeout and the ranks' join limit
H_FEAT_TOL = 2e-3           # tests/test_parallel.py's feature tolerance
H_FEAT_SHARE = 1e-4         # tests/test_torch_parallel.py's STEP_FLIPS
H1_HELD_AT = 1
H1_SNAPSHOTS = (1, 10, 100)
H1_GRAD_REL = 1e-3          # map 0's first all-reduced gradient vs W=1's
H3_LAUNCHES_TAG = "[H3] ray_topk_packed launches in phase H3:"

# phase I: the layer-measurement tools at bench.py's widths (CAP 2^17 and
# 22,500 points: the TPU ladder's bench-matched IB_CAP / IB_NPTS), on a
# cloud on frame 0's surfaces (the TPU scripts' sine sheet lies outside the
# room's view: no sample finds a neighbour on it). The depth cuts below are
# printed as "[I] cut:".
I_CAP = 1 << 17
I_POINTS = 22_500
I_ITERS = 10                # timed iterations a ladder measurement (30)
I_REPEATS = 3
I_TRACE_ITERS = 30          # trace_map_iter's mapping iterations
I_TRACE_OPS = dict(warm=4, traced=2, iters_first=60, iters=60)
I_STEP_BUDGETS = (4, 24)    # step_cost's (4, 54)
I_ITER_BUDGETS = (20, 20, 80)   # iter_cost's (60, 60, 360)
I_FIRST = 60                # first-frame iterations of the I5 scripts
I_TRACK_REPS = 3            # track_frame_overhead's 20
I_REPS = 5                  # map/frame overhead repetitions (10, 20)

# phase J: the quality gate, the soak chain, the A/Bs
J_PROBES = 36               # probes_ab's other probe count (A runs 27)
J_GATE_FRAMES = 100
J_GATE_CUT = {"mapping": {"iters": 100, "iters_first": 500,
                          "geo_iter_first": 150}}
J_METRICS = ("ate_cm", "ate_noalign_cm", "fscore", "precision", "recall",
             "psnr", "ms_ssim", "depth_l1_cm")
J_JAX_GATE = (0.407, 87.56, 38.18)   # output/quality_gate.json (TPU run)
J_SOAK_FRAMES = 60
J_SOAK_CUT = {"mapping": {"ckpt_freq": 20, "iters": 30, "iters_first": 100,
                          "geo_iter_first": 40}}
J_SOAK_STRIDE = 4
J_AB_FRAMES = 4
J_AB_CUT = {"mapping": {"iters": 50, "iters_first": 100,
                        "geo_iter_first": 40}}
J_GEO_FREEZE = 3
J_CHILDREN = ("J1", "J2", "J3BF16", "J3GEO")
J_TIMEOUT_S = 900           # the children's limit, from their start
J_LAUNCHES_TAG = "[J] kernel launches in"

KEY_FLOPS = 8               # a candidate-sample key: 3 sub, 3 mul, 2 add
ADAM_FLOPS = 15             # one row-Adam element (row_adam.cu)


def card_line() -> str:
    from point_slam_tpu_torch.profiling.scene import card_line as line
    return line()


def bench_config(n_frames: int, scene: str = "room.yaml"):
    """configs/Synthetic/<scene> with bench.py's overrides
    (profiling/workload.py), verbose, writing under output/chip_smoke."""
    from point_slam_tpu_torch.profiling.workload import bench_config as make
    cfg = make(n_frames, scene, ITERS_FIRST)
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
    """(least time in ms, what sets it) on the card's published peaks
    (profiling/roofline.py: HBM bytes/s and f32 flop/s outside the tensor
    cores, H100 SXM data sheet at 700 W): the larger of the bytes over the
    first and the operations over the second."""
    from point_slam_tpu_torch.profiling.roofline import (F32_FLOP_PER_S,
                                                         HBM_BYTES_PER_S)
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


def a_tables(dev):
    """Phase A's inputs: the synthetic room's frame 0 densified at
    bench.py's settings, and its cell tables in the three layouts. Returns
    (cfg, mapper, {kernel name: table}, depth, c2w)."""
    import numpy as np
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
    cloud = mapper.cloud
    args = (cloud.pos, cloud.n_points, mapper.cell_size, mapper.table_size,
            mapper.max_per_cell)
    indexes = {"ray_topk_packed": mapper.index,
               "ray_topk_planes": knn.build_grid_index(*args),
               "ray_topk_fused": knn.build_fused_grid_index(*args)}
    return cfg, mapper, indexes, depth, c2w


def hold_ray_topk(tag, name, index, r, p_ray, cfg, rc, g, depth_d, c2w_d):
    """One ray top-k launch on R rays of the frame (samples placed as the
    renderer places them, P probe slots) against its plain version: keys
    and ids EQUAL (ids as bit patterns); prints its times, bound and
    persistent grid. Returns the record of the kernels line."""
    import torch
    from point_slam_tpu_torch import renderer as R
    from point_slam_tpu_torch.common import camera, sampling
    from point_slam_tpu_torch.ops import knn

    dev = depth_d.device
    k, ns = rc.nn_num, rc.n_surface
    lanes = 2 if name == "ray_topk_fused" else 1
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
    print(f"[{tag}] {name} R={r} ns={ns} k={k} P={p_ray}: keys/ids equal "
          f"to plain: {equal} (max abs err {err}, tolerance 0); "
          f"valid slots {(keys < 0x7F800000).float().mean().item():.4f}"
          f", compact rays {compact.float().mean().item():.4f}; "
          f"kernel {ms:.4f} ms (device {shown(dev_ms)}), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}; {rows} "
          f"distinct rows)", flush=True)
    if not equal:
        raise AssertionError(f"{name} at R={r}, P={p_ray} differs from "
                             "plain")
    per_sm, smem = knn.ray_topk_occupancy(planes, p_ray, ns)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[{tag}] {name}: {per_sm} blocks an SM, grid "
          f"{min(r, per_sm * n_sm)}, {smem} bytes of shared memory "
          f"a block", flush=True)
    return {"max_abs_err": float(err), "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_a(dev):
    """Kernel against plain on the card at the main path's shapes."""
    import torch

    cfg, mapper, indexes, depth, c2w = a_tables(dev)
    cloud, n = mapper.cloud, mapper.n_points_host
    print(f"[A] frame-0 cloud: {n} points, table {mapper.table_size} x "
          f"{mapper.max_per_cell}", flush=True)

    g = torch.Generator(device=dev).manual_seed(SEED)
    depth_d = torch.as_tensor(depth, device=dev)
    c2w_d = torch.as_tensor(c2w, device=dev)
    results = {}
    for name, index in indexes.items():
        results[name] = {
            r: hold_ray_topk("A", name, index, r, mapper.rc.knn_probes, cfg,
                             mapper.rc, g, depth_d, c2w_d)
            for r in RAY_BATCHES}
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


def run_slam(dev, cfg, setup=None, input_folder=None, stop=None):
    """PointSLAM over the config's frames (0..stop); returns (summary, slam,
    per-phase launch counts, totals). Every kernel count is set to 0 just
    before the run and read just after it. ``setup(slam)`` runs first."""
    from point_slam_tpu_torch.ops import adam, knn
    from point_slam_tpu_torch.slam import PointSLAM

    def launches():
        return {**knn.LAUNCHES, **adam.LAUNCHES}

    slam = PointSLAM(cfg, input_folder=input_folder, device=dev)
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
    summary = slam.run(stop=stop)
    return summary, slam, per_phase, launches()


def frames_per_s(summary):
    """Frames 1..n-1 over their tracking and mapping wall times."""
    ft = summary["frame_times"]
    n = summary["n_frames"]
    return (n - 1) / sum(ft[i]["track"] + ft[i]["map"] for i in range(1, n))


def phase_b(dev, ref):
    """The main path (room.yaml at bench.py's widths) through K1, then a
    short run through K2; fills ``ref`` with its ATE and frames/s."""
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
    ref.update(ate=ate, fps=frames_per_s(summary))
    print(f"[B] tracked frame times (s, frames 2-6): "
          f"{[round(t, 4) for t in tracked]}; mapped frame times (s): "
          f"{ {i: round(t, 4) for i, t in mapped.items()} } "
          f"(iterations {[stats[i]['n_iters'] for i in (0, 5, 6)]}); "
          f"frames 1-6 {ref['fps']:.4f}"
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


def phase_e(dev):
    """Checkpoints and resume, the run's artefacts and the end-of-run
    evaluation on room.yaml at phase B's widths. Returns the K1 launches
    of the phase (both runs and the re-render)."""
    import shutil
    import warnings
    import numpy as np
    import torch
    from point_slam_tpu_torch.ops import knn
    from point_slam_tpu_torch.slam import PointSLAM
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate
    from point_slam_tpu_torch.tools.evaluate import run_end_of_run_eval
    from point_slam_tpu_torch.utils import native
    from point_slam_tpu_torch.utils.memory import memory_report

    root = os.path.join(HERE, "output", "chip_smoke_resume")
    shutil.rmtree(root, ignore_errors=True)

    def config(name):
        cfg = bench_config(E_FRAMES)
        cfg["mapping"].update({"iters_first": ITERS_FIRST,
                               "ckpt_freq": E_CKPT_FREQ})
        cfg["cuda"]["knn_packed_coords"] = True
        cfg["render_datasets"] = ["synthetic"]
        cfg["reconstruction_datasets"] = ["synthetic"]
        cfg["rendering"]["eval_img"] = True
        cfg["meshing"].update({"eval_rec": True, "eval_2d": True,
                               "eval_2d_n_imgs": E_VIEWS_2D})
        cfg["data"]["output"] = os.path.join(root, name)
        return cfg

    cfg = config("continuous")
    print(f"[E] cut: frames 0-{E_FRAMES - 1} (bench.py runs 41); "
          f"mapping.ckpt_freq {E_CKPT_FREQ}; meshing.eval_2d on with "
          f"eval_2d_n_imgs 1000 -> {E_VIEWS_2D}; meshing.voxel "
          f"{cfg['meshing']['voxel']} m as configured", flush=True)
    knn.LAUNCHES["ray_topk_packed"] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    steps = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            t0 = time.perf_counter()
            slam = PointSLAM(cfg, device=dev)
            csum = slam.run()
            torch.cuda.synchronize()
            steps["continuous run"] = time.perf_counter() - t0
            run_peak = memory_report(dev)["device_peak_bytes_in_use"]
            ckpt = os.path.join(slam.output, "ckpts", "00005.npz")
            t0 = time.perf_counter()
            resumed = PointSLAM(config("resumed"), device=dev)
            rsum = resumed.run(resume_from=ckpt)
            torch.cuda.synchronize()
            steps["resumed run"] = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(False)
    refused = sorted({str(w.message).split(" does not have")[0]
                      for w in caught
                      if "deterministic" in str(w.message)})
    for name in ("ckpts/00005.npz", "metrics.jsonl", "final_point_cloud.npy",
                 "final_point_cloud.ply", "npc_cloud.npy"):
        if not os.path.exists(os.path.join(slam.output, name)):
            raise AssertionError(f"the run wrote no {name}")
    est_c, est_r = csum["estimate_c2w_list"], rsum["estimate_c2w_list"]
    ate_c, ate_r = (evaluate_ate(csum["gt_c2w_list"], e, align=False)[
        "absolute_translational_error.rmse"] for e in (est_c, est_r))
    diff = float(np.abs(est_c - est_r).max())
    print(f"[E] continuous run (frames 0-{E_FRAMES - 1}) ATE no-align "
          f"{ate_c * 100:.4f} cm; resumed from {os.path.relpath(ckpt, HERE)}"
          f" (frames 6-{E_FRAMES - 1}) {ate_r * 100:.4f} cm; largest pose "
          f"difference {diff:.3e}; cloud {csum['n_points']} and "
          f"{rsum['n_points']} points; deterministic mode: "
          f"{'every op had a deterministic version' if not refused else 'refused by ' + '; '.join(refused)}",
          flush=True)
    if not (np.isfinite(est_c).all() and np.isfinite(est_r).all()):
        raise AssertionError("non-finite poses")
    if not (ate_c < 0.02 and ate_r < 0.02):
        raise AssertionError(f"ATE no-align {ate_c} / {ate_r} m >= 2 cm")
    if not abs(ate_c - ate_r) < 0.0005:
        raise AssertionError(f"resumed ATE {ate_r} m is not within 0.05 cm "
                             f"of the continuous run's {ate_c} m")
    if not refused and not (np.array_equal(est_c, est_r) and torch.equal(
            slam.mapper.cloud.packed[:slam.mapper.n_points_host],
            resumed.mapper.cloud.packed[:resumed.mapper.n_points_host])):
        raise AssertionError("deterministic resumed run differs from the "
                             "continuous one")
    slam_launches = knn.LAUNCHES["ray_topk_packed"]

    knn.LAUNCHES["ray_topk_packed"] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = run_end_of_run_eval(slam, slam.output)
    steps["evaluation"] = time.perf_counter() - t0
    eval_peak = memory_report(dev)["device_peak_bytes_in_use"]
    k1 = knn.LAUNCHES["ray_topk_packed"]
    print(f"[E] step seconds: { {k: round(v, 2) for k, v in steps.items()} }"
          f"; in the evaluation "
          f"{ {k[5:]: round(v, 2) for k, v in res.items() if k.startswith('time_')} }"
          f" (fuse {res.get('mesh_time_fuse', float('nan')):.2f}, extract "
          f"{res.get('mesh_time_extract', float('nan')):.2f})", flush=True)
    print(f"[E] re-render of frames {list(range(0, E_FRAMES, 5))} at "
          f"{cfg['cam']['H']}x{cfg['cam']['W']}: ray_topk_packed launches "
          f"{k1}; frame_cnt {res.get('frame_cnt')}; depth_l1_render "
          f"{res.get('depth_l1_render')}; avg_psnr {res.get('avg_psnr')}; "
          f"avg_ms_ssim {res.get('avg_ms_ssim')}; avg_lpips "
          f"{res.get('avg_lpips')!r}", flush=True)
    print(f"[E] mesh: TSDF grid {res.get('mesh_tsdf_dims')} at voxel "
          f"{cfg['meshing']['voxel']} m on the card, {res.get('mesh_n_verts')}"
          f" vertices, {res.get('mesh_n_faces')} faces; the marching and "
          f"raster backend: native (libraries loaded "
          f"{sorted(native._libs)})", flush=True)
    print(f"[E] recon: " + "; ".join(
        f"{k} {res.get(k)}" for k in (
            "recon_precision", "recon_recall", "recon_F_score",
            "recon_accuracy", "recon_completion", "recon_depth_l1_2d")),
        flush=True)
    print(f"[E] peak device memory: SLAM runs {run_peak / 2 ** 30:.3f} GiB, "
          f"evaluation {eval_peak / 2 ** 30:.3f} GiB (memory_report); "
          f"phase E wall {sum(steps.values()):.2f} s; card {card_line()}",
          flush=True)
    if "failed" in res:
        raise AssertionError(f"evaluation steps failed: {res['failed']}")
    need = ("ate_rmse", "ate_rmse_no_align", "depth_l1_render", "avg_psnr",
            "avg_ms_ssim", "recon_precision", "recon_recall",
            "recon_F_score", "recon_accuracy", "recon_completion",
            "recon_depth_l1_2d")
    missing = [k for k in need if k not in res]
    if missing:
        raise AssertionError(f"evaluation results lack {missing}")
    if not all(np.isfinite(res[k]) for k in need):
        raise AssertionError(f"a NaN or infinite metric: "
                             f"{ {k: res[k] for k in need} }")
    if not os.path.exists(res["mesh"]) or res["frame_cnt"] != 3:
        raise AssertionError("no mesh, or not three frames re-rendered")
    if k1 == 0:
        raise AssertionError("the re-render launched no ray_topk_packed")
    if sorted(native._libs) != ["marching", "raster"]:
        raise AssertionError("the native marching or raster did not run")
    print(f"{E_LAUNCHES_TAG} {slam_launches + k1}", flush=True)
    return slam_launches + k1


def phase_e_child(dev):
    """Phase E in a process of its own (``--phases E``), with cuBLAS's
    fixed workspace set from its start; returns its K1 launches. Fails if
    the process fails."""
    import subprocess
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=E_CUBLAS_WORKSPACE)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--phases", "E"], env=env,
                            stdout=subprocess.PIPE, text=True)
    launches = None
    for line in proc.stdout:
        print(line, end="", flush=True)
        if line.startswith(E_LAUNCHES_TAG):
            launches = int(line.split()[-1])
    if proc.wait() != 0 or launches is None:
        raise AssertionError(f"phase E failed (exit code {proc.returncode})")
    return launches


def quat_xyzw(r):
    """A rotation matrix's unit quaternion (x, y, z, w)."""
    import numpy as np
    t = np.trace(r)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        q = ((r[2, 1] - r[1, 2]) * s, (r[0, 2] - r[2, 0]) * s,
             (r[1, 0] - r[0, 1]) * s, 0.25 / s)
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k])
        q = [0.0, 0.0, 0.0, (r[k, j] - r[j, k]) / s]
        q[i] = 0.25 * s
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
    return np.asarray(q) / np.linalg.norm(q)


def tum_config():
    """configs/TUM_RGBD/freiburg3_office.yaml as the port loads it."""
    from point_slam_tpu_torch.config import load_config
    return load_config(os.path.join(HERE, "configs", *F_CONFIG),
                       os.path.join(HERE, "configs", "point_slam.yaml"))


def write_tum_sequence(root, cfg):
    """Frames 0..F_FRAMES-1 of the synthetic room (room.yaml, phase B's
    angular step) rendered at ``cfg``'s camera with crop_edge 0, written in
    the TUM-RGBD layout under ``root``. Returns the dataset-convention
    poses of the frames written."""
    import numpy as np
    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.datasets import Synthetic, _flip_yz
    from point_slam_tpu_torch.utils.png import write_png
    scfg = load_config(os.path.join(HERE, "configs", "Synthetic",
                                    "room.yaml"),
                       os.path.join(HERE, "configs", "point_slam.yaml"))
    scfg["cam"].update({k: cfg["cam"][k] for k in
                        ("H", "W", "fx", "fy", "cx", "cy",
                         "png_depth_scale")})
    scfg["cam"]["crop_edge"] = 0
    scfg["synthetic"].update({"n_frames": F_FRAMES, "angular_step": 0.01})
    ds = Synthetic(scfg)
    rng = np.random.default_rng(SEED)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    head = ["# timestamp filename"]
    rgb, dep, gt = list(head), list(head), [
        "# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    order = list(range(F_FRAMES))
    order.insert(F_EXTRA_AFTER + 1, F_EXTRA_AFTER)
    t_prev = None
    poses = []
    for n, i in enumerate(order):
        extra = n == F_EXTRA_AFTER + 1
        t = (t_prev + 0.010 if extra else
             1341845688.0 + i / 30.0 + rng.uniform(-1e-3, 1e-3))
        if not extra:
            t_prev = t
        td = t + rng.uniform(0.005, 0.015)
        tp = t + rng.uniform(0.003, 0.008)
        _, packed, _ = ds.wire(i)
        d16 = np.ascontiguousarray(packed[..., 3:5]).view(np.uint16)[..., 0]
        d16 = np.where(rng.uniform(size=d16.shape) < F_HOLES, 0, d16) \
            .astype(np.uint16)
        write_png(os.path.join(root, "rgb", f"{t:.6f}.png"),
                  np.ascontiguousarray(packed[..., :3]))
        write_png(os.path.join(root, "depth", f"{td:.6f}.png"), d16)
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{td:.6f} depth/{td:.6f}.png")
        pose = _flip_yz(ds.poses[i])
        gt.append(f"{tp:.6f} " + " ".join(
            f"{v:.9f}" for v in [*pose[:3, 3], *quat_xyzw(pose[:3, :3])]))
        if not extra:
            poses.append(pose)
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep),
                        ("groundtruth.txt", gt)):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return poses


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def phase_f1():
    """The image decoders built on this machine against the digests of
    OpenCV's decodes; the decode time of a Replica-sized JPEG."""
    import hashlib
    import numpy as np
    from point_slam_tpu_torch.utils import imgcodec, native
    data = os.path.join(HERE, "tests", "data_torch")
    with open(os.path.join(data, "digests.json")) as f:
        rec = json.load(f)
    t0 = time.perf_counter()
    native.load("imgcodec")
    built = time.perf_counter() - t0
    for name, want in sorted(rec["files"].items()):
        img = imgcodec.imread(os.path.join(data, name),
                              unchanged=want["unchanged"])
        digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()) \
            .hexdigest()
        if (digest != want["sha256"] or list(img.shape) != want["shape"]
                or str(img.dtype) != want["dtype"]):
            raise AssertionError(f"{name} decodes to other bytes than "
                                 f"OpenCV {rec['opencv']}'s cv2.imread")
    big = os.path.join(data, "room_680x1200_q95.jpg")
    times = []
    for _ in range(F_DECODE_REPEATS + 1):
        t0 = time.perf_counter()
        imgcodec.imread(big)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times[1:]))
    print(f"[F1] imgcodec built with g++ in {built:.2f} s; "
          f"{len(rec['files'])} fixtures byte-equal to OpenCV "
          f"{rec['opencv']}'s cv2.imread (SHA-256); decode of the 680x1200 "
          f"q95 JPEG {ms:.3f} ms (median of {F_DECODE_REPEATS}, host); "
          f"card {card_line()}", flush=True)
    return ms


def phase_f2(dev, root):
    """PointSLAM from a TUM-RGBD directory on the host keyframe ring."""
    import numpy as np
    import torch
    from point_slam_tpu_torch.datasets import get_dataset
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate
    from point_slam_tpu_torch.utils.memory import memory_report

    cfg = tum_config()
    print(f"[F] config {'/'.join(F_CONFIG)}: cam {cfg['cam']['H']}x"
          f"{cfg['cam']['W']} fx {cfg['cam']['fx']} fy {cfg['cam']['fy']} cx "
          f"{cfg['cam']['cx']} cy {cfg['cam']['cy']} png_depth_scale "
          f"{cfg['cam']['png_depth_scale']} crop_edge "
          f"{cfg['cam']['crop_edge']}; tracking {cfg['tracking']['pixels']} "
          f"px x {cfg['tracking']['iters']}, mapping "
          f"{cfg['mapping']['pixels']} px x {cfg['mapping']['iters']} (first"
          f" {cfg['mapping']['iters_first']}), every "
          f"{cfg['mapping']['every_frame']} frames, window "
          f"{cfg['mapping']['mapping_window_size']}, sample_with_color_grad "
          f"{cfg['tracking']['sample_with_color_grad']}", flush=True)
    print(f"[F] cut: the sequence to frames 0-{F_FRAMES - 1}; "
          f"mapping.lazy_start {cfg['mapping']['lazy_start']} -> 0 (the "
          f"config maps every frame up to frame "
          f"{cfg['mapping']['lazy_start']}, then every "
          f"{cfg['mapping']['every_frame']}nd)", flush=True)
    t0 = time.perf_counter()
    poses = write_tum_sequence(root, cfg)
    print(f"[F] wrote the TUM-RGBD sequence ({F_FRAMES + 1} stamps) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cfg["mapping"]["lazy_start"] = 0
    cfg["cuda"]["keyframe_host_ring"] = True
    cfg["verbose"] = True
    cfg["data"]["output"] = os.path.join(HERE, "output", "chip_smoke_tum")

    probe = get_dataset(cfg, root)
    if len(probe) != F_FRAMES:
        raise AssertionError(f"the reader kept {len(probe)} frames, not "
                             f"{F_FRAMES}")
    rel = [np.linalg.inv(poses[0]) @ p for p in poses]
    err = max(float(np.abs(probe.poses[i][:3] - (rel[i] * [1, -1, -1, 1])
                           [:3]).max()) for i in range(F_FRAMES))
    read_ms = []
    for i in range(F_FRAMES):
        t0 = time.perf_counter()
        _, packed, _ = probe.wire(i)
        read_ms.append((time.perf_counter() - t0) * 1e3)
    e = cfg["cam"]["crop_edge"]
    shape = (cfg["cam"]["H"] - 2 * e, cfg["cam"]["W"] - 2 * e, 5)
    print(f"[F] reader: {len(probe)} frames of {packed.shape}, the 32 fps "
          f"pick dropped the extra stamp; poses within {err:.2e} of the "
          f"written ones; decode + wire {np.median(read_ms):.3f} ms a frame "
          f"(median, host)", flush=True)
    if packed.shape != shape or err > 1e-6:
        raise AssertionError(f"wire frame {packed.shape} (want {shape}) or "
                             f"pose error {err}")

    uploads = []

    def timed_uploads(slam):
        store = slam.mapper.store
        if not store.host_mode:
            raise AssertionError("the keyframe store is not on the host ring")
        inner = store._upload_window

        def upload(*a, **kw):
            _sync(dev)
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            _sync(dev)
            uploads.append((time.perf_counter() - t0) * 1e3)
            return out
        store._upload_window = upload

    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    summary, slam, per_phase, totals = run_slam(dev, cfg, timed_uploads,
                                                input_folder=root)
    _sync(dev)
    wall = time.perf_counter() - t0
    k1 = "ray_topk_packed"
    print(f"[F2] launches: tracking {per_phase['track']}; mapping "
          f"{per_phase['map']}", flush=True)
    if summary["n_frames"] != F_FRAMES:
        raise AssertionError(f"{summary['n_frames']} frames run")
    if per_phase["track"][k1] == 0 or per_phase["map"][k1] == 0:
        raise AssertionError(f"{k1} did not run in both tracking and mapping")
    if not slam.mapper.store.host_mode or not uploads:
        raise AssertionError("no window went through the host ring")
    est = summary["estimate_c2w_list"]
    if not np.isfinite(est).all():
        raise AssertionError("non-finite poses")
    ate = evaluate_ate(summary["gt_c2w_list"], est, align=False)[
        "absolute_translational_error.rmse"]
    ft = summary["frame_times"]
    tracked = [ft[i]["track"] for i in ft if ft[i]["track"]]
    mapped = [ft[i]["map"] for i in ft if ft[i]["map"]]
    busy = sum(ft[i]["track"] + ft[i]["map"] for i in range(1, F_FRAMES))
    tm = summary["timing"]
    mem = memory_report(dev).get("device_peak_bytes_in_use", 0) / 2 ** 30
    print(f"[F2] {F_FRAMES} frames from disk on the host ring: ATE no-align "
          f"{ate * 100:.4f} cm; keyframes {summary['keyframes']}; mapped "
          f"{sorted(slam.mapper.frame_stats)}; points {summary['n_points']}",
          flush=True)
    print(f"[F2] io {tm['io']:.4f} s, wait {tm['wait']:.4f} s, prefetch "
          f"fetch {tm['prefetch_fetch']:.4f} s; window upload "
          f"{np.mean(uploads):.3f} ms a window ({len(uploads)} windows of "
          f"{tuple(slam.mapper.store._staging.shape)} u8 over "
          f"{len(slam.mapper.frame_stats)} mapped frames, the last one "
          f"refined); frames 1-"
          f"{F_FRAMES - 1} {(F_FRAMES - 1) / busy:.4f} frames/s; tracked "
          f"frame p50 {np.median(tracked):.4f} s, mapped frame p50 "
          f"{np.median(mapped):.4f} s (frame 0 {ft[0]['map']:.4f} s); run "
          f"wall {wall:.2f} s; peak device memory {mem:.3f} GiB; card "
          f"{card_line()}", flush=True)
    if not ate < 0.02:
        raise AssertionError(f"ATE no-align {ate} m >= 2 cm")
    return totals


def phase_f3(dev, root):
    """Two frames with view directions, with and without encode_viewd."""
    import numpy as np
    import torch
    from point_slam_tpu_torch import renderer as R
    from point_slam_tpu_torch.slam import PointSLAM

    print(f"[F3] cut: frames 0-1; mapping.iters_first 500 -> "
          f"{F3_ITERS_FIRST}", flush=True)
    for encode in (True, False):
        cfg = tum_config()
        cfg["model"].update({"use_view_direction": True,
                             "encode_viewd": encode})
        cfg["mapping"].update({"lazy_start": 0,
                               "iters_first": F3_ITERS_FIRST})
        cfg["data"]["output"] = os.path.join(HERE, "output",
                                             "chip_smoke_viewd")
        cfg["verbose"] = False
        slam = PointSLAM(cfg, input_folder=root, device=dev)
        summary = slam.run(stop=1)
        st = slam.mapper.frame_stats
        losses = [st[i][k] for i in st for k in ("geo_loss", "color_loss")]
        if not np.isfinite(losses).all() or \
                not np.isfinite(summary["estimate_c2w_list"]).all():
            raise AssertionError(f"non-finite losses or poses: {losses}")
        m = slam.mapper
        _, _, depth, c2w = slam.dataset[1]
        hw = depth.shape
        rc = R.make_render_config(cfg, 0.1, dev)
        gen = torch.Generator(device=dev)
        fill = R.draw_fill(gen.manual_seed(SEED), dev)[None].repeat(
            -(-hw[0] * hw[1] // rc.ray_batch), 1, 1)
        cam = slam.cfg["cam"]                   # after the crop
        intr = (cam["fx"], cam["fy"], cam["cx"], cam["cy"])
        args = (m.decoders, m.cloud, m.index, torch.as_tensor(
            summary["estimate_c2w_list"][1], device=dev), intr, hw)
        kw = dict(gt_depth=torch.as_tensor(depth, device=dev), fill=fill)
        with_v = R.render_img(*args, rc, stage_color=False, **kw)
        without = R.render_img(*args, rc._replace(use_view_direction=False),
                               stage_color=False, **kw)
        colour = R.render_img(*args, rc, stage_color=True, **kw)[2]
        same = all(torch.equal(a, b) for a, b in zip(with_v, without))
        print(f"[F3] use_view_direction with encode_viewd {encode}: colour "
              f"MLP input {m.decoders.col.pts_linears[0].in_features} wide; "
              f"losses {[round(v, 4) for v in losses]}; geometry-stage "
              f"render equal to one without view directions: {same}; "
              f"colour render finite: "
              f"{bool(torch.isfinite(colour).all())}", flush=True)
        if not same or not torch.isfinite(colour).all():
            raise AssertionError("view directions changed the geometry "
                                 "render, or a non-finite colour")


def phase_f(dev):
    """The disk datasets: decoders (F1), a TUM-RGBD run on the host ring
    (F2), view directions (F3). Returns F2's kernel launches."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    decode_ms = phase_f1()
    root = tempfile.mkdtemp(prefix="chip_smoke_tum_")
    try:
        totals = phase_f2(dev, root)
        phase_f3(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[F] phase F wall {time.perf_counter() - t0:.2f} s "
          f"(JPEG decode {decode_ms:.3f} ms)", flush=True)
    return totals


def panel_names(root):
    """The stems of the panels and rendered images under a run's output."""
    import glob
    return {d: sorted(os.path.splitext(os.path.basename(p))[0]
                      for p in glob.glob(os.path.join(root, d, "*")))
            for d in ("tracking_vis", "mapping_vis", "rendered_image")}


def check_panel_files(root, want, hw):
    """The panels and rendered images are exactly ``want`` (the JAX rule's
    names) and each is a PNG that the port's decoder reads at its size."""
    from point_slam_tpu_torch.utils import imgcodec
    got = panel_names(root)
    if got != want:
        raise AssertionError(f"panel files {got}; the JAX rule gives {want}")
    h, w = hw
    for d, stems in got.items():
        size = (h, w, 3) if d == "rendered_image" else (2 * h, 3 * w, 3)
        for stem in stems:
            img = imgcodec.imread(os.path.join(root, d, stem + ".png"))
            if img.shape != size:
                raise AssertionError(f"{d}/{stem}.png is {img.shape}, not "
                                     f"{size}")


def count_panels(slam, rec):
    """Wrap both visualizers' vis() to count the panels, their seconds
    (synchronised) and their K1 launches into ``rec``."""
    from point_slam_tpu_torch.ops import knn
    rec.update(panels=0, seconds=0.0, tracking_vis=0, mapping_vis=0)
    for name, vis in (("tracking_vis", slam.track_vis),
                      ("mapping_vis", slam.map_vis)):
        def timed(*a, _inner=vis.vis, _name=name, **kw):
            _sync(slam.device)
            k0, t0 = knn.LAUNCHES["ray_topk_packed"], time.perf_counter()
            out = _inner(*a, **kw)
            _sync(slam.device)
            if out is not None:
                rec["panels"] += 1
                rec["seconds"] += time.perf_counter() - t0
            rec[_name] += knn.LAUNCHES["ray_topk_packed"] - k0
            return out
        vis.vis = timed


def phase_g1(dev):
    """The visualiser inside both loops (vis_inside) at phase B's widths."""
    import shutil
    import numpy as np
    cfg = bench_config(G_FRAMES)
    cfg["tracking"].update({"vis_freq": 5, "vis_inside": True,
                            "vis_inside_freq": 20})
    cfg["mapping"].update({"vis_freq": 5, "vis_inside": True,
                           "vis_inside_freq": 100, "iters_first": G_ITERS,
                           "iters": G_ITERS // 2, "min_iter_ratio": 2.0,
                           "save_rendered_image": True})
    cfg["cuda"].update({"knn_packed_coords": True,
                        "max_iters_per_launch": 200})
    out = cfg["data"]["output"] = os.path.join(HERE, "output",
                                               "chip_smoke_vis")
    shutil.rmtree(out, ignore_errors=True)
    print(f"[G] cut: frames 0-{G_FRAMES - 1}; mapping.iters_first 1500 -> "
          f"{G_ITERS}; every later mapped frame {G_ITERS} iterations "
          f"(mapping.iters 300 -> {G_ITERS // 2}, min_iter_ratio -> 2.0)",
          flush=True)
    rec = {}
    summary, slam, per_phase, totals = run_slam(
        dev, cfg, lambda s: count_panels(s, rec))
    k1 = "ray_topk_packed"
    stats = slam.mapper.frame_stats
    print(f"[G1] launches of {k1}: in the panels {rec['tracking_vis']} + "
          f"{rec['mapping_vis']}; tracking without them "
          f"{per_phase['track'][k1] - rec['tracking_vis']}, mapping "
          f"{per_phase['map'][k1] - rec['mapping_vis']}; mapped frames' "
          f"iterations { {i: stats[i]['n_iters'] for i in sorted(stats)} }",
          flush=True)
    if [stats[i]["n_iters"] for i in sorted(stats)] != [G_ITERS, G_ITERS]:
        raise AssertionError(f"the mapped frames did not run {G_ITERS} "
                             f"iterations each")
    check_panel_files(out, G1_PANELS, (cfg["cam"]["H"], cfg["cam"]["W"]))
    if rec["panels"] != 2 or not rec["tracking_vis"] or \
            not rec["mapping_vis"]:
        raise AssertionError(f"panels {rec}")
    if not np.isfinite(summary["estimate_c2w_list"]).all():
        raise AssertionError("non-finite poses")
    print(f"[G1] panels {panel_names(out)}, as the JAX rule gives; "
          f"{rec['seconds'] / rec['panels']:.3f} s a panel (render through "
          f"K1, 2x3 tiles of {cfg['cam']['H']}x{cfg['cam']['W']}, PNG); "
          f"card {card_line()}", flush=True)
    return totals


def phase_g2(dev, ref, precision="highest"):
    """Phase B's run with the bf16 view (or, with ``precision``
    'default', with the TF32 MLP blocks and f32 features); end-of-frame
    panels at vis_freq 2 (tracking) and 5 (mapping). ``ref``: phase B's
    ATE and frames/s in this call, if it ran."""
    import shutil
    import numpy as np
    import torch
    from point_slam_tpu_torch import pointcloud as pc
    from point_slam_tpu_torch import renderer as R
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate
    tag = "G2" if precision == "highest" else "G4"
    cfg = bench_config(7)
    cfg["cuda"].update({"knn_packed_coords": True,
                        "bf16_features": tag == "G2",
                        "mlp_precision": precision})
    cfg["tracking"]["vis_freq"] = 2
    cfg["mapping"]["vis_freq"] = 5
    out = cfg["data"]["output"] = os.path.join(HERE, "output",
                                               f"chip_smoke_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    rec = {}
    summary, slam, per_phase, totals = run_slam(
        dev, cfg, lambda s: count_panels(s, rec))
    k1 = "ray_topk_packed"
    stats = slam.mapper.frame_stats
    est = summary["estimate_c2w_list"]
    ate = evaluate_ate(summary["gt_c2w_list"], est, align=False)[
        "absolute_translational_error.rmse"]
    fps = frames_per_s(summary)
    phase_b = (f"phase B: ATE no-align {ref['ate'] * 100:.4f} cm, "
               f"{ref['fps']:.4f} frames/s" if ref else
               "phase B did not run in this call")
    what = "bf16 view" if tag == "G2" else "mlp_precision 'default' (TF32)"
    print(f"[{tag}] {what}: ATE no-align {ate * 100:.4f} cm, frames 1-6 "
          f"{fps:.4f} frames/s ({phase_b}); launches of {k1}: tracking "
          f"{per_phase['track'][k1]}, mapping {per_phase['map'][k1]}, "
          f"panels {rec['tracking_vis'] + rec['mapping_vis']}; points "
          f"{[stats[i]['n_points'] for i in sorted(stats)]}; timing "
          f"{summary['timing']}; card {card_line()}", flush=True)
    if per_phase["track"][k1] == 0 or per_phase["map"][k1] == 0:
        raise AssertionError(f"{k1} did not run in both tracking and "
                             f"mapping")
    if not np.isfinite(est).all():
        raise AssertionError("non-finite poses")
    if not 0 < stats[0]["n_points"] < stats[5]["n_points"]:
        raise AssertionError("the cloud did not grow from map 0 to map 5")
    check_panel_files(out, {
        "tracking_vis": ["00002_0039", "00004_0039"],
        "mapping_vis": [f"00005_{stats[5]['n_iters'] - 1:04d}"],
        "rendered_image": ["frame_00005"]},
        (cfg["cam"]["H"], cfg["cam"]["W"]))
    if tag == "G4":
        if not ate < 0.02:
            raise AssertionError(f"ATE no-align {ate} m >= 2 cm")
        return totals, fps
    m = slam.mapper
    live = m.cloud.packed[:m.n_points_host]
    pos = pc.neighbor_pos(pc.encode_render(live))
    ref = live[:, pc.POS_SL]
    rel = ((pos - ref).abs() / (ref.abs() + 1e-12)).max().item()
    _, _, depth, c2w = slam.dataset[0]
    cam = cfg["cam"]
    renders = []
    for cloud in (m.cloud, m.cloud._replace(packed=pc.encode_render(
            m.cloud.packed))):
        renders.append(R.render_img(
            m.decoders, cloud, m.index, torch.as_tensor(est[0], device=dev),
            (cam["fx"], cam["fy"], cam["cx"], cam["cy"]),
            (cam["H"], cam["W"]), m.rc,
            gt_depth=torch.as_tensor(depth, device=dev),
            generator=torch.Generator(device=dev).manual_seed(SEED))[0])
    hit = torch.as_tensor(depth, device=dev) > 0
    l1 = (renders[0] - renders[1])[hit].abs().mean().item()
    print(f"[G2] the view's decoded positions within {rel:.3e} relative of "
          f"the f32 master (bound 5e-5, test_bf16.py); depth L1 between a "
          f"bf16 and an f32 render of frame 0 {l1 * 100:.3e} cm", flush=True)
    if not rel < 5e-5:
        raise AssertionError(f"decoded positions off by {rel} relative")
    return totals, fps


def phase_g3(dev):
    """room_sensor.yaml's path (phase C) over frames 0-4 with the bf16
    view, the fused table and the fused row-Adam."""
    import numpy as np
    cfg = sensor_config()
    cfg["cuda"]["bf16_features"] = True
    cfg["data"]["output"] = os.path.join(HERE, "output", "chip_smoke_G3")
    print(f"[G3] cut: phase C's configuration to frames 0-{G3_FRAMES - 1}",
          flush=True)
    summary, slam, per_phase, totals = run_slam(dev, cfg,
                                                stop=G3_FRAMES - 1)
    stats = slam.mapper.frame_stats
    map_iters = sum(stats[i]["n_iters"] * stats[i]["outer_loops"]
                    for i in stats)
    print(f"[G3] launches: tracking {per_phase['track']}; mapping "
          f"{per_phase['map']}; mapping iterations {map_iters}; ATE "
          f"no-align {summary_ate(summary) * 100:.4f} cm; card "
          f"{card_line()}", flush=True)
    if per_phase["track"]["ray_topk_fused"] == 0 or \
            per_phase["map"]["ray_topk_fused"] == 0:
        raise AssertionError("ray_topk_fused did not run in both tracking "
                             "and mapping")
    if totals["row_adam"] != map_iters:
        raise AssertionError(f"row_adam launched {totals['row_adam']} times "
                             f"for {map_iters} mapping iterations")
    if not np.isfinite(summary["estimate_c2w_list"]).all():
        raise AssertionError("non-finite poses")
    return totals


def summary_ate(summary):
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate
    return evaluate_ate(summary["gt_c2w_list"], summary["estimate_c2w_list"],
                        align=False)["absolute_translational_error.rmse"]


def phase_g4_decoders(dev):
    """The decoders on a mapping batch at each mlp_precision."""
    import torch
    from point_slam_tpu_torch.common import image
    from point_slam_tpu_torch.datasets import get_dataset
    from point_slam_tpu_torch.models import decoders as D
    cfg = bench_config(1)
    dec = D.init_decoders(cfg, SEED, dev)
    D.load_pretrained_geo(dec, os.path.join(HERE, "pretrained",
                                            "middle_fine.npz"))
    _, color, depth, c2w = get_dataset(cfg)[0]
    g = torch.Generator(device=dev).manual_seed(SEED)
    # surface points of frame 0 with neighbours around them
    d = torch.as_tensor(depth, device=dev).reshape(-1)
    flat = torch.nonzero(d > 0).squeeze(1)
    pick = flat[torch.randint(0, flat.numel(), (G4_POINTS,), generator=g,
                              device=dev)]
    cam = cfg["cam"]
    jj, ii = pick // cam["W"], pick % cam["W"]
    z = d[pick]
    pc_ = torch.stack([(ii - cam["cx"]) / cam["fx"] * z,
                       -(jj - cam["cy"]) / cam["fy"] * z, -z], -1)
    c2w_d = torch.as_tensor(c2w, device=dev)
    p = pc_ @ c2w_d[:3, :3].T + c2w_d[:3, 3]
    c = 0.1 * torch.randn((G4_POINTS, 32), generator=g, device=dev)
    nbp = p[:, None, :] + 0.03 * torch.randn((G4_POINTS, 8, 3), generator=g,
                                             device=dev)
    nbf = 0.1 * torch.randn((G4_POINTS, 8, 32), generator=g, device=dev)

    def run(prec):
        with torch.no_grad():
            return (dec.geo(p, c, precision=prec),
                    dec.col(p, c, precision=prec),
                    dec.col.encode_neighbor_feats(nbp, p, nbf,
                                                  precision=prec))
    base = run(None)
    high = run("highest")
    tf32 = run("default")
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(base, high))
    differ = any(not torch.equal(a, b) for a, b in zip(base, tf32))
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(tf32, base)]
    err = max((a - b).abs().max().item() for a, b in zip(tf32, base))
    off = torch.backends.cuda.matmul.allow_tf32 is False
    # the prefetch thread's one matmul (the grey conversion of the radius
    # maps) under the switch: cuBLAS's matrix-vector product has no TF32
    col = torch.as_tensor(color, device=dev)
    grey = image.rgb2gray(col)
    with D._tf32():
        grey_tf32 = image.rgb2gray(col)
    grey_same = torch.equal(grey, grey_tf32)
    print(f"[G4] decoders on {G4_POINTS} samples (geometry, colour, "
          f"F_theta): 'highest' bit-equal to no setting: {same}; 'default' "
          f"differs: {differ}, max abs err {err:.3e}, relative to max |out| "
          f"{[f'{r:.3e}' for r in rel]} (bound {G4_REL}); TF32 switch off "
          f"after: {off}; grey conversion unchanged under it: {grey_same}",
          flush=True)
    if not (same and differ and off and grey_same and max(rel) < G4_REL):
        raise AssertionError("mlp_precision: 'highest' not bit-equal, "
                             "'default' not TF32, or outside the bound")
    return err


def phase_g(dev, ref):
    """The visualiser (G1), the bf16 view (G2, G3), TF32 (G4); ``ref``:
    phase B's numbers in this call, if it ran. Returns the kernel launches
    of the phase."""
    t0 = time.perf_counter()
    launches = phase_g1(dev)
    for totals in (phase_g2(dev, ref)[0], phase_g3(dev)):
        for name, v in totals.items():
            launches[name] += v
    phase_g4_decoders(dev)
    totals, _ = phase_g2(dev, ref, precision="default")
    for name, v in totals.items():
        launches[name] += v
    print(f"[G] phase G wall {time.perf_counter() - t0:.2f} s; launches "
          f"{launches}", flush=True)
    return launches


def snapshot_map0(store):
    """A run_slam setup: keep the live rows of the cloud after map 0 in
    ``store["map0"]``, and after map 0's iterations H1_SNAPSHOTS in
    ``store["map0_at"]`` (the mapping loop's hook fires after every
    cuda.max_iters_per_launch iterations; H1 sets it to 1); map 0's first
    gradient bucket (the flat packed-prefix, decoder and statistics
    gradients that the loop hands to ``parallel.dist.all_reduce_flat``)
    before and after the reduction in ``store["grad0_local"]`` and
    ``store["grad0"]``; and the bytes all-reduced while mapping in
    ``store["map_bytes"]``."""
    def setup(slam):
        import torch
        from point_slam_tpu_torch.parallel import dist as pdist
        inner = slam.mapper.map_frame
        reduce = pdist.all_reduce_flat
        store["map_bytes"] = 0
        store["map0_at"] = {}

        def flat(tensors):
            return torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()

        def capture(tensors):
            first = "grad0" not in store
            if first:
                store["grad0_local"] = flat(tensors)
            reduce(tensors)
            if first:
                store["grad0"] = flat(tensors)

        def hook(idx, it_prev, it_now, n_iters, c2w):
            if idx == 0 and it_now in H1_SNAPSHOTS:
                m = slam.mapper
                store["map0_at"][it_now] = \
                    m.cloud.packed[:m.n_points_host].cpu().numpy()
        slam.mapper.vis_hook = hook

        def wrapped(idx, *a, **kw):
            sent = pdist.SENT["all_reduce"]
            if idx == 0:
                pdist.all_reduce_flat = capture
            try:
                out = inner(idx, *a, **kw)
            finally:
                pdist.all_reduce_flat = reduce
            store["map_bytes"] += pdist.SENT["all_reduce"] - sent
            if idx == 0:
                m = slam.mapper
                store["map0"] = m.cloud.packed[:m.n_points_host].cpu().numpy()
            return out
        slam.mapper.map_frame = wrapped
    return setup


def h_config(job, dp):
    """H1: phase B's configuration over frames 0-6 (depth cut); H2: phase
    C's over frames 0-4; at ``data_parallel`` dp."""
    if job == "H1":
        cfg = bench_config(H1_FRAMES)
        cfg["mapping"]["iters_first"] = H1_ITERS_FIRST
        cfg["cuda"].update({"knn_packed_coords": True,
                            "max_iters_per_launch": 1})
    else:
        cfg = sensor_config()
        cfg["synthetic"]["n_frames"] = H2_FRAMES
        cfg["mapping"]["color_refine"] = False
    cfg["cuda"]["data_parallel"] = dp
    cfg["verbose"] = False
    cfg["data"]["output"] = os.path.join(HERE, "output",
                                         f"chip_smoke_{job}_dp{dp}")
    return cfg


def h_run(dev, job, dp):
    """One run of ``job`` under deterministic mode: what phase H compares
    of it (host arrays)."""
    import warnings
    import torch
    store = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        t0 = time.perf_counter()
        summary, slam, per_phase, totals = run_slam(
            dev, h_config(job, dp), snapshot_map0(store))
        wall = time.perf_counter() - t0
    m = slam.mapper
    stats = m.frame_stats
    return {"packed": m.cloud.packed[:m.n_points_host].cpu().numpy(),
            "decoders": {k: v.cpu().numpy()
                         for k, v in m.decoders.state_dict().items()},
            "est": summary["estimate_c2w_list"],
            "gt": summary["gt_c2w_list"], "map0": store["map0"],
            "map0_at": store["map0_at"], "grad0": store["grad0"],
            "grad0_local": store["grad0_local"],
            "fps": frames_per_s(summary), "wall": wall,
            "map_iters": sum(st["n_iters"] * st["outer_loops"]
                             for st in stats.values()),
            "map_bytes": store["map_bytes"], "per_phase": per_phase,
            "totals": totals,
            "refused": sorted({str(w.message).split(" does not have")[0]
                               for w in caught
                               if "deterministic" in str(w.message)})}


def h_rank(job, rank, world, tmp, device):
    """One process of H1 or H2 on ``device`` (cuda:0 for every rank):
    rank ``rank`` of a gloo group over a FileStore under ``tmp``, or with
    ``world`` 0 a run without a group; saves its record there."""
    import datetime
    # deterministic cuBLAS needs its workspace fixed before the first
    # CUDA call of the process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", E_CUBLAS_WORKSPACE)
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    if world:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=H_TIMEOUT_S))
    try:
        torch.save(h_run(dev, job, max(world, 1)),
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if world:
            dist.destroy_process_group()


def h_spawn(job, dev, world):
    """``job`` in ``world`` processes of a gloo group on ``dev`` (world 0:
    one process without a group), joined within H_TIMEOUT_S (killed past
    it); their records in rank order."""
    import multiprocessing as mp
    import shutil
    import torch
    tmp = os.path.join(HERE, "output", f"chip_smoke_{job}_w{world}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=h_rank, args=(job, r, world, tmp, str(dev)))
             for r in range(max(world, 1))]
    for p in procs:
        p.start()
    deadline = time.monotonic() + H_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    if hung or any(p.exitcode for p in procs):
        raise AssertionError(f"[{job}] processes ended with "
                             f"{[p.exitcode for p in procs]} (killed at "
                             f"{H_TIMEOUT_S} s: {len(hung)})")
    recs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]
    for r, rec in enumerate(recs):
        if rec["refused"]:
            raise AssertionError(f"[{job}] process {r}: no deterministic "
                                 f"version of {rec['refused']}")
    return recs


def ate_cm(rec):
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate
    return 100 * evaluate_ate(rec["gt"], rec["est"], align=False)[
        "absolute_translational_error.rmse"]


def check_replicas(job, ranks):
    """Every rank's cloud, decoders and poses bit-equal to rank 0's."""
    import numpy as np
    r0 = ranks[0]
    for r in ranks[1:]:
        same = (np.array_equal(r0["packed"], r["packed"])
                and np.array_equal(r0["est"], r["est"])
                and all(np.array_equal(v, r["decoders"][k])
                        for k, v in r0["decoders"].items()))
        if not same:
            raise AssertionError(f"[{job}] the ranks' replicas differ")
    print(f"[{job}] replicas bit-equal on {len(ranks)} ranks: cloud "
          f"{r0['packed'].shape}, {len(r0['decoders'])} decoder tensors, "
          f"{len(r0['est'])} poses", flush=True)


def phase_h1(dev):
    """Phase B's configuration at data_parallel 2 (two processes sharing
    the card) against world size 1 (one process without a group), both
    under deterministic mode. Returns the ranks' launches."""
    import numpy as np
    t0 = time.perf_counter()
    print(f"[H] cut: H1 mapping.iters_first {ITERS_FIRST} -> "
          f"{H1_ITERS_FIRST} (frames 0-{H1_FRAMES - 1} as phase B)",
          flush=True)
    one = h_spawn("H1", dev, 0)[0]
    ranks = h_spawn("H1", dev, H_WORLD)
    name = "ray_topk_packed"
    for r, rec in enumerate(ranks):
        print(f"[H1] rank {r}: {name} launches tracking "
              f"{rec['per_phase']['track'][name]}, mapping "
              f"{rec['per_phase']['map'][name]}", flush=True)
        if not (rec["per_phase"]["track"][name] and
                rec["per_phase"]["map"][name]):
            raise AssertionError(f"[H1] rank {r}: {name} did not run in "
                                 f"tracking and mapping")
    check_replicas("H1", ranks)
    two = ranks[0]
    share = {}
    at = {rec_id: {**rec["map0_at"], H1_ITERS_FIRST: rec["map0"]}
          for rec_id, rec in (("one", one), ("two", two))}
    for it in sorted(at["one"]):
        a0, b0 = at["one"][it], at["two"][it]
        if len(a0) != len(b0) or not np.array_equal(a0[:, 64:67],
                                                    b0[:, 64:67]):
            raise AssertionError("[H1] map 0's points differ from world "
                                 "size 1's")
        off = ~np.isclose(b0[:, :64], a0[:, :64], rtol=H_FEAT_TOL,
                          atol=H_FEAT_TOL)
        share[it] = off.mean()
        print(f"[H1] map 0 (GT pose) after iteration {it} of "
              f"{H1_ITERS_FIRST}, W=2 against W=1: {len(b0)} points, "
              f"positions equal, feature entries beyond {H_FEAT_TOL}: "
              f"{int(off.sum())} of {off.size} ({100 * off.mean():.3f}%), "
              f"largest difference "
              f"{np.abs(b0[:, :64] - a0[:, :64]).max():.3e}", flush=True)
    a, b = one["packed"], two["packed"]
    print(f"[H1] final cloud: points {len(a)} (W=1) / {len(b)} (W=2); "
          f"ATE no-align {ate_cm(one):.4f} cm (W=1) / {ate_cm(two):.4f} cm "
          f"(W=2); largest pose difference "
          f"{np.abs(one['est'] - two['est']).max():.3e}", flush=True)
    print(f"[H1] frames 1-{H1_FRAMES - 1}: {one['fps']:.4f} frames/s (W=1) "
          f"/ {two['fps']:.4f} frames/s (W=2: two processes sharing the one "
          f"card's SMs, not a scaling result); run wall {one['wall']:.2f} / "
          f"{two['wall']:.2f} s; all-reduced "
          f"{two['map_bytes'] / two['map_iters']:.0f} bytes a mapping "
          f"iteration a rank ({two['map_iters']} iterations); phase H1 wall "
          f"{time.perf_counter() - t0:.2f} s; card {card_line()}",
          flush=True)
    # the reduction itself: map 0's first gradient bucket (same cloud,
    # decoders and draws on both sides) summed over the two half-batch
    # renders against the whole batch's, relative to its norm; rank 0's
    # own half before the sum shows how far a missing or wrong sum lands
    # (the bucket ends in the 3 logged statistics: held apart, as their
    # counts would swamp the gradients' norm)
    if one["grad0"].shape != two["grad0"].shape:
        raise AssertionError("[H1] map 0's first gradient buckets differ "
                             "in size")
    rels = {}
    for part, sl in (("gradients", slice(0, -3)), ("statistics",
                                                   slice(-3, None))):
        g1, g2, half = (x[sl] for x in (one["grad0"], two["grad0"],
                                        two["grad0_local"]))
        norm = np.linalg.norm(g1)
        rels[part] = (np.linalg.norm(g2 - g1) / norm,
                      np.linalg.norm(half - g1) / norm)
        print(f"[H1] map 0's first all-reduced bucket, {part} ({g1.size} "
              f"floats), W=2 against W=1: relative error "
              f"{rels[part][0]:.3e} (bound {H1_GRAD_REL}), largest "
              f"difference {np.abs(g2 - g1).max():.3e} of max |x| "
              f"{np.abs(g1).max():.3e}; rank 0's half before the "
              f"all-reduce: relative error {rels[part][1]:.3e}", flush=True)
    for part, (rel, rel_half) in rels.items():
        if not rel < H1_GRAD_REL < rel_half:
            raise AssertionError(f"[H1] the all-reduced {part} are "
                                 f"{rel:.3e} from world size 1's (bound "
                                 f"{H1_GRAD_REL}; one rank's half: "
                                 f"{rel_half:.3e})")
    if share[H1_HELD_AT] > H_FEAT_SHARE:
        raise AssertionError(f"[H1] {100 * share[H1_HELD_AT]:.3f}% of map "
                             f"0's feature entries beyond {H_FEAT_TOL} of "
                             f"world size 1's after iteration {H1_HELD_AT}")
    if not (ate_cm(one) < 2.0 and ate_cm(two) < 2.0):
        raise AssertionError(f"[H1] ATE no-align {ate_cm(one)} / "
                             f"{ate_cm(two)} cm >= 2 cm")
    return [rec["totals"] for rec in ranks]


def phase_h2(dev):
    """Phase C's sensor path at data_parallel 2 over frames 0-4."""
    t0 = time.perf_counter()
    print(f"[H] cut: H2 phase C's frames 0-{SENSOR_FRAMES - 1} -> 0-"
          f"{H2_FRAMES - 1} (BA starts past four keyframes: not reached; "
          f"the CPU tests cover BA under data parallelism); "
          f"mapping.color_refine off", flush=True)
    ranks = h_spawn("H2", dev, H_WORLD)
    for r, rec in enumerate(ranks):
        pp = rec["per_phase"]
        print(f"[H2] rank {r}: ray_topk_fused tracking "
              f"{pp['track']['ray_topk_fused']}, mapping "
              f"{pp['map']['ray_topk_fused']}; row_adam {pp['map']['row_adam']}"
              f" for {rec['map_iters']} mapping iterations", flush=True)
        if not (pp["track"]["ray_topk_fused"] and pp["map"]["ray_topk_fused"]):
            raise AssertionError(f"[H2] rank {r}: ray_topk_fused did not run "
                                 f"in tracking and mapping")
        if rec["totals"]["row_adam"] != rec["map_iters"]:
            raise AssertionError(f"[H2] rank {r}: row_adam ran "
                                 f"{rec['totals']['row_adam']} times for "
                                 f"{rec['map_iters']} mapping iterations")
    check_replicas("H2", ranks)
    two = ranks[0]
    print(f"[H2] ATE no-align {ate_cm(two):.4f} cm; {len(two['packed'])} "
          f"points; frames 1-{H2_FRAMES - 1} {two['fps']:.4f} frames/s; "
          f"all-reduced {two['map_bytes'] / two['map_iters']:.0f} bytes a "
          f"mapping iteration a rank; phase H2 wall "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if not ate_cm(two) < 2.0:
        raise AssertionError(f"[H2] ATE no-align {ate_cm(two)} cm >= 2 cm")
    return [rec["totals"] for rec in ranks]


def phase_h3(dev):
    """In a process of its own under deterministic mode: phase B's
    configuration over frames 0-2 in an NCCL group of one, bit-equal to
    the run without a group; the determinism harness's self-check on the
    card; pretrain_geo on the card, its npz loaded and rendered. Returns
    the phase's K1 launches. (On a CPU ``dev``, a rehearsal, the group is
    gloo's.)"""
    import datetime
    import shutil
    import warnings
    import numpy as np
    import torch
    import torch.distributed as dist
    from point_slam_tpu_torch.models import decoders as D
    from point_slam_tpu_torch.ops import knn
    from point_slam_tpu_torch.parallel import dist as pdist
    from point_slam_tpu_torch.slam import PointSLAM
    from point_slam_tpu_torch.tools import determinism, pretrain_geo

    t0 = time.perf_counter()
    root = os.path.join(HERE, "output", "chip_smoke_H3")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[H] cut: H3 frames 0-{H3_FRAMES - 1} (phase B: 0-6), "
          f"mapping.iters_first {ITERS_FIRST} -> {H3_ITERS_FIRST}", flush=True)
    print("[H] cut: pretrain_geo --scenes 1 --frames 4 (the tool's default: "
          "4 scenes of 40 frames)", flush=True)
    cfg = bench_config(H3_FRAMES)
    cfg["mapping"]["iters_first"] = H3_ITERS_FIRST
    cfg["cuda"]["knn_packed_coords"] = True
    cfg["verbose"] = False
    k1 = 0
    runs = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for group in (False, True):
                if group:
                    if dev.type == "cuda":
                        torch.cuda.set_device(dev.index or 0)
                    dist.init_process_group(
                        "nccl" if dev.type == "cuda" else "gloo",
                        store=dist.FileStore(
                            os.path.join(root, "store"), 1),
                        rank=0, world_size=1,
                        timeout=datetime.timedelta(seconds=H_TIMEOUT_S))
                cfg["data"]["output"] = os.path.join(root, f"group_{group}")
                sent = pdist.SENT["all_reduce"]
                try:
                    summary, slam, _, totals = run_slam(dev, cfg)
                finally:
                    if group:
                        dist.destroy_process_group()
                if (pdist.SENT["all_reduce"] > sent) != group:
                    raise AssertionError("[H3] the loops' collectives do "
                                         "not follow the process group")
                k1 += totals["ray_topk_packed"]
                m = slam.mapper
                runs[group] = (summary["estimate_c2w_list"],
                               m.cloud.packed[:m.n_points_host].cpu(),
                               {k: v.cpu() for k, v in
                                m.decoders.state_dict().items()})
        finally:
            torch.use_deterministic_algorithms(False)
    refused = sorted({str(w.message).split(" does not have")[0]
                      for w in caught if "deterministic" in str(w.message)})
    (ea, pa, da), (eb, pb, db) = runs[False], runs[True]
    equal = (np.array_equal(ea, eb) and torch.equal(pa, pb)
             and all(torch.equal(v, db[k]) for k, v in da.items()))
    print(f"[H3] NCCL group of one vs no group (frames 0-{H3_FRAMES - 1}, "
          f"deterministic mode: "
          f"{'every op had a deterministic version' if not refused else 'refused by ' + '; '.join(refused)}"
          f"): bit-equal {equal}; cloud {tuple(pa.shape)}", flush=True)
    if refused or not equal:
        raise AssertionError("[H3] the NCCL world-size-1 run differs from "
                             "the run without a group")

    knn.LAUNCHES["ray_topk_packed"] = 0
    t1 = time.perf_counter()
    if determinism.main(["--device", dev.type, "--self_check"]) != 0:
        raise AssertionError("[H3] the determinism harness's self-check "
                             "failed on the card")
    print(f"[H3] determinism harness on the card: {time.perf_counter() - t1:.2f}"
          f" s", flush=True)
    t1 = time.perf_counter()
    npz = os.path.join(root, "pretrain", "middle_fine.npz")
    pretrain_geo.main(["--device", dev.type, "--scenes", "1", "--frames", "4",
                       "--out", npz, "--workdir",
                       os.path.join(root, "pretrain", "work")])
    cfg = determinism.config(3)
    cfg["pretrained_decoders"] = {"middle_fine": npz}
    cfg["mapping"]["fix_geo_decoder"] = True
    slam = PointSLAM(cfg, output=os.path.join(root, "pretrained_run"),
                     device=dev)
    with np.load(npz) as z:
        if not np.array_equal(z["embedder._B"],
                              slam.mapper.decoders.geo.embedder_B.detach()
                              .cpu().numpy()):
            raise AssertionError("[H3] the pretrained npz did not load")
    slam.run()
    _, color, depth, c2w = slam.dataset[0]
    dep, _, col = slam.map_vis.render_frame(slam.mapper, c2w, depth, color)
    finite = bool(torch.isfinite(dep).all() and torch.isfinite(col).all())
    k1 += knn.LAUNCHES["ray_topk_packed"]
    print(f"[H3] pretrain_geo on the card and a 3-frame run from its npz: "
          f"{time.perf_counter() - t1:.2f} s; render of frame 0 finite "
          f"{finite}, geometry decoder frozen "
          f"{cfg['mapping']['fix_geo_decoder']}; phase H3 wall "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if not finite:
        raise AssertionError("[H3] non-finite render from the pretrained npz")
    print(f"{H3_LAUNCHES_TAG} {k1}", flush=True)
    return k1


def phase_h3_child():
    """Phase H3 in a process of its own (``--phases H3``), with cuBLAS's
    fixed workspace set from its start; returns its K1 launches."""
    import subprocess
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=E_CUBLAS_WORKSPACE)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--phases", "H3"], env=env,
                            stdout=subprocess.PIPE, text=True)
    launches = None
    for line in proc.stdout:
        print(line, end="", flush=True)
        if line.startswith(H3_LAUNCHES_TAG):
            launches = int(line.split()[-1])
    if proc.wait() != 0 or launches is None:
        raise AssertionError(f"phase H3 failed (exit code {proc.returncode})")
    return launches


def phase_h(dev):
    """Data parallelism: H1, H2 and H3. Returns the kernel launches of
    every rank and process (H1's world-size-1 run is not counted)."""
    t0 = time.perf_counter()
    launches = {"ray_topk_packed": 0, "ray_topk_planes": 0,
                "ray_topk_fused": 0, "row_adam": 0}
    for totals in phase_h1(dev) + phase_h2(dev):
        for name in launches:
            launches[name] += totals[name]
    launches["ray_topk_packed"] += phase_h3_child()
    print(f"[H] phase H wall {time.perf_counter() - t0:.2f} s; launches "
          f"(all ranks) {launches}", flush=True)
    return launches


def i_drive(totals, fn, *args, **kw):
    """One piece of phase I's path: every kernel count set to 0 just
    before it, read just after and added to ``totals``."""
    from point_slam_tpu_torch.ops import adam, knn
    for table in (knn.LAUNCHES, adam.LAUNCHES):
        for name in table:
            table[name] = 0
    out = fn(*args, **kw)
    for name, v in {**knn.LAUNCHES, **adam.LAUNCHES}.items():
        totals[name] = totals.get(name, 0) + v
    return out


def i_hold(res):
    print(f"[I] {res['name']} on its ladder's inputs: equal to plain: "
          f"{res['equal']} (max abs err {res['max_abs_err']}, tolerance 0)",
          flush=True)
    if not res["equal"]:
        raise AssertionError(f"{res['name']} differs from plain in phase I")


def phase_i_ladders(dev, totals):
    """I2's ladders: the whole ladder on the packed cell table (K1; K4 in
    rung 9), rung 2 on the f32 planes (K2) and the fused table (K3); each
    kernel held against its plain version on its ladder's inputs."""
    import torch
    from point_slam_tpu_torch.profiling import iter_breakdown as IB
    from point_slam_tpu_torch.profiling import workload as W
    out = {}
    for layout in ("packed", "planes", "fused"):
        cfg = W.bench_config(4)
        cfg["cuda"]["point_capacity_init"] = I_CAP
        b = IB.build(cfg, dev, I_POINTS, layout, "surface")
        d = IB.draw(b)
        i_hold(IB.hold_ray_topk(b, d, layout))
        if layout == "packed":
            i_hold(IB.hold_row_adam(b, d))
            stepped = IB.rung_full(b, d)[0]
            if not bool(torch.isfinite(stepped).all()):
                raise AssertionError("phase I: rung 7's step is not finite")
        vs, ins, cs = IB.neighbour_shares(b)
        print(f"[I] ladder {layout} ({IB.KERNEL_OF[layout]}): valid "
              f"neighbour slots {vs:.4f}, within the query radius "
              f"{ins:.4f}, compact rays {cs:.4f}; rung 2 includes the "
              f"non-compact fallback's host sync (q_rays[need])", flush=True)
        out[layout] = i_drive(totals, IB.run, b,
                              None if layout == "packed" else [2], I_ITERS,
                              I_REPEATS, f"I2 {layout}")
        del b
        torch.cuda.empty_cache()
    return out


def phase_i(dev):
    """The layer-measurement tools (point_slam_tpu_torch/profiling) on the
    card. Returns phase I's kernel launches."""
    import torch
    from point_slam_tpu_torch.profiling import (
        frame_overhead, gather_scatter_micro, hw_calibration, iter_cost,
        map_frame_overhead, render_breakdown, roofline as RL, sample_stages,
        scatter_micro, step_cost, trace_map_iter, trace_ops,
        track_frame_overhead, tracker_cost, workload as W)
    t0 = time.perf_counter()
    for cut in (
            f"the ladders at CAP {I_CAP} and {I_POINTS} points on frame 0's "
            "surfaces (the TPU script's defaults: CAP 2^19, 300k points on "
            "the sine sheet)",
            f"{I_ITERS} timed iterations x {I_REPEATS} repeats a rung "
            "(the TPU script's chain: 30)",
            f"trace_ops: warm frames 1-{I_TRACE_OPS['warm']}, traced "
            f"{I_TRACE_OPS['traced']}, {I_TRACE_OPS['iters']} mapping "
            "iterations a mapped frame (warm 10, traced 5, 300)",
            f"step_cost budgets {I_STEP_BUDGETS} (4, 54); iter_cost "
            f"{I_ITER_BUDGETS} (60, 60, 360); first frames at {I_FIRST} "
            "iterations (150-300)",
            f"track_frame_overhead {I_TRACK_REPS} repetitions (20); map and "
            f"frame overhead {I_REPS} (10, 20)"):
        print(f"[I] cut: {cut}", flush=True)
    totals = {}

    # I1: the card's peaks and row rates
    print("[I1] calibration", flush=True)
    calib = hw_calibration.calibrate(dev)
    gather = gather_scatter_micro.run(dev)
    scatter_micro.run(dev)

    # I2: the ladders, the render sub-ladder, the sampling stages
    ladders = phase_i_ladders(dev, totals)
    render_breakdown.run(dev, I_CAP, I_POINTS)
    sample_stages.run(dev)

    # I3: the op trace of the loop and of 30 mapping iterations
    path = i_drive(totals, trace_ops.capture,
                   os.path.join(W.OUTPUT, "trace_ops_torch"), dev,
                   **I_TRACE_OPS)
    ops = trace_ops.analyze(path, top=12)
    if not ops["device"]:
        raise AssertionError("phase I: trace_ops recorded no device work")
    cfg = W.bench_config(4)
    cfg["cuda"]["point_capacity_init"] = I_CAP
    mit = i_drive(totals, trace_map_iter.run, cfg, dev, I_POINTS, "surface",
                  I_TRACE_ITERS, 12)
    if not mit["device"]:
        raise AssertionError("phase I: trace_map_iter recorded no device "
                             "activity in three windows")

    # I4: the roofline beside I3's buckets
    rungs, peak = RL.iteration_model(R=5000, cap=I_CAP, probes=27)
    rows = RL.table(rungs, peak)
    RL.print_table(rows, peak)
    buckets = RL.parse_trace(mit["listing"])
    checks = RL.check(buckets, rows, I_TRACE_ITERS)
    RL.print_measured(buckets, checks, I_TRACE_ITERS)
    W.save_json("roofline_torch.json", {"model": rows, "checks": checks})
    if not all(c["ok"] for c in checks):
        raise AssertionError("phase I: a measured bucket is below its "
                             "roofline bound")

    # I5: steady state and fixed costs
    cfg = W.bench_config(4, iters_first=I_FIRST)
    cfg["cuda"]["point_capacity_init"] = I_CAP
    mapper, color, depth, c2w = i_drive(totals, step_cost.setup, cfg, dev,
                                        I_POINTS, "surface")
    costs = {"map": i_drive(totals, step_cost.map_costs, cfg, mapper, color,
                            depth, c2w, dev, I_STEP_BUDGETS, 1),
             "track": i_drive(totals, step_cost.track_cost, cfg, mapper,
                              color, depth, c2w, dev, 1)}
    del mapper
    costs["iter"] = i_drive(totals, iter_cost.run, dev, I_ITER_BUDGETS,
                            I_CAP)
    costs["tracker"] = i_drive(totals, tracker_cost.run, dev,
                               (4, 4, 44, 44, 4, 44), I_CAP, I_FIRST)
    cfg = W.bench_config(4, iters_first=I_FIRST)
    cfg["cuda"]["point_capacity_init"] = I_CAP
    i_drive(totals, map_frame_overhead.run, cfg, dev, I_POINTS, "surface",
            I_REPS)
    cfg = W.bench_config(6, iters_first=I_FIRST)
    cfg["cuda"]["point_capacity_init"] = I_CAP
    i_drive(totals, track_frame_overhead.run, cfg, dev, I_TRACK_REPS)
    frame_overhead.run(W.bench_config(2), dev, I_REPS)
    for name in ("map", "track", "iter", "tracker"):
        if not 0 < costs[name]["per_iter_ms"] < 1e4:
            raise AssertionError(f"phase I: {name} per-iteration cost "
                                 f"{costs[name]['per_iter_ms']} ms")
    for name in ("ray_topk_packed", "ray_topk_planes", "ray_topk_fused",
                 "row_adam"):
        if not totals.get(name):
            raise AssertionError(f"phase I: {name} was not launched on its "
                                 "path")
    torch.cuda.synchronize()
    rate = gather["gather f32 (N,K,72)"]["rows_per_s_device"]
    print(f"[I] phase I wall {time.perf_counter() - t0:.2f} s; launches "
          f"{totals}; f32 matmul "
          f"{calib['matmul f32 (TF32 off)']['rate']:.2f} TFLOP/s, gather "
          f"{(rate or 0) / 1e6:.1f}M rows/s; ladder rungs "
          f"{len(ladders['packed'])}", flush=True)
    return totals


# ---------------------------------------------------------------- phase J


def j_cut(cfg, cut):
    """Apply a depth cut {section: {key: value}} to a config."""
    for sec, kv in cut.items():
        cfg[sec].update(kv)


def j_counted(fn, *args, **kw):
    """fn(...) with every kernel count set to 0 just before it; returns
    (its result, the counts just after)."""
    from point_slam_tpu_torch.ops import adam, knn
    for table in (knn.LAUNCHES, adam.LAUNCHES):
        for name in table:
            table[name] = 0
    out = fn(*args, **kw)
    return out, {**knn.LAUNCHES, **adam.LAUNCHES}


def j_launched(tag, counts):
    """The child's launch line, which the parent reads."""
    print(f"{J_LAUNCHES_TAG} {tag}: {json.dumps(counts)}", flush=True)
    if not counts.get("ray_topk_packed"):
        raise AssertionError(f"{tag}: ray_topk_packed was not launched")


def j_finite_row(tag, row, keys):
    import math
    bad = [k for k in keys if not isinstance(row.get(k), (int, float))
           or not math.isfinite(row[k])]
    if bad or "failed" in row:
        raise AssertionError(f"{tag}: missing or non-finite {bad}; failed "
                             f"{row.get('failed')}")


def phase_j0(dev):
    """K1 at P = 36 (probes_ab's other probe count) on phase A's tables,
    at R = 5000 and 1500, EQUAL to its plain version."""
    import torch
    cfg, mapper, indexes, depth, c2w = a_tables(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    name = "ray_topk_packed"
    return {r: hold_ray_topk("J0", name, indexes[name], r, J_PROBES, cfg,
                             mapper.rc, g, torch.as_tensor(depth, device=dev),
                             torch.as_tensor(c2w, device=dev))
            for r in RAY_BATCHES}


def phase_j1(dev, root):
    """The furnished gate at 100 frames (depth cut), a tagged probe under
    ``root``: every metric finite, ATE without alignment under 2 cm."""
    from point_slam_tpu_torch.profiling import quality_gate as QG
    (row, _), counts = j_counted(
        QG.run_gate, J_GATE_FRAMES, "smoke", device="cuda", root=root,
        overrides={}, cfg_hook=lambda cfg: j_cut(cfg, J_GATE_CUT))
    j_finite_row("J1", row, J_METRICS)
    print(f"[J1] gate ({row['n_frames']} frames, commit {row['commit']}, "
          f"{row['device']}): ATE {row['ate_cm']} cm (no-align "
          f"{row['ate_noalign_cm']}), F {row['fscore']} (P {row['precision']}"
          f", R {row['recall']}), PSNR {row['psnr']}, MS-SSIM "
          f"{row['ms_ssim']}, depth L1 {row['depth_l1_cm']} cm, "
          f"{row['n_points']} points, run wall {row['wall_s']} s, timing "
          f"{row['timing_s']}; the JAX package's standing TPU gate (quality "
          f"only): ATE no-align {J_JAX_GATE[0]} cm, F {J_JAX_GATE[1]}, PSNR "
          f"{J_JAX_GATE[2]}", flush=True)
    if not row["ate_noalign_cm"] < 2.0:
        raise AssertionError(f"J1: ATE no-align {row['ate_noalign_cm']} cm "
                             ">= 2 cm")
    j_launched("J1", counts)


def phase_j2(dev, root):
    """room_scannet_scale.yaml cut to J_SOAK_FRAMES frames under
    soak_runner, killed once after its first checkpoint and resumed; then
    soak_eval at a stride and soak_summary."""
    import ast
    from point_slam_tpu_torch.profiling import soak_eval as SE
    from point_slam_tpu_torch.profiling import soak_runner as SR
    from point_slam_tpu_torch.profiling import soak_summary as SS
    cfg_path = os.path.join(root, "soak.yaml")
    with open(cfg_path, "w") as f:
        f.write(f"inherit_from: {os.path.join(HERE, 'configs', 'Synthetic', 'room_scannet_scale.yaml')}\n"
                f"synthetic: {{n_frames: {J_SOAK_FRAMES}}}\n"
                f"mapping: {json.dumps(J_SOAK_CUT['mapping'])}\n")
    out, logs = os.path.join(root, "soak", "run"), os.path.join(root, "soak")
    cmd = [sys.executable, "-m", "point_slam_tpu_torch.run", cfg_path,
           "--output", out, "--device", "cuda"]
    runner = SR.Runner(cmd, out, logs, max_attempts=3, stall_s=300,
                       poll_s=1.0, pause_s=1.0,
                       healthy=lambda: SR.health("cuda", 180),
                       kill_after_checkpoint=True)
    if runner.run() != 0:
        raise AssertionError("J2: the soak did not finish")
    log = open(os.path.join(logs, "soak.log")).read()
    runs = [open(os.path.join(logs, f"run_{k}.log")).read()
            for k in (1, 2)]
    if "injected stall" not in log or "attempt 2 (resume='--resume')" \
            not in log or "[resume] from" not in runs[1]:
        raise AssertionError("J2: no kill and resume in the soak log")
    if not all("[init] keyframe images on the host ring" in r for r in runs):
        raise AssertionError("J2: the runs did not use the host ring")
    line = [ln for ln in runs[1].splitlines()
            if ln.startswith("kernel launches: ")][-1]
    run_counts = ast.literal_eval(line[len("kernel launches: "):])
    _, eval_counts = j_counted(SE.evaluate, out, J_SOAK_STRIDE, cfg_path,
                               "cuda")
    summary = SS.summarize(out, os.path.join(logs, "soak.log"), cfg_path)
    j_finite_row("J2", {**summary, **summary["recon_eval"],
                        **summary["render_metrics"]},
                 ("ate_rmse_cm", "ate_rmse_noalign_cm", "recon_F_score",
                  "avg_psnr", "depth_l1_render"))
    print(f"[J2] soak ({summary['n_frames']} frames, checkpoints "
          f"{summary['checkpoints']}, keyframes {summary['n_keyframes']} on "
          f"the {summary['keyframe_ring']} ring, {summary['n_points']} "
          f"points, CAP {summary['point_capacity_final']}): ATE "
          f"{summary['ate_rmse_cm']} cm (no-align "
          f"{summary['ate_rmse_noalign_cm']}, max "
          f"{summary['ate_max_noalign_cm']}); kill/resume "
          f"{summary['kill_resume_log']}; active wall "
          f"{summary['wall_active_s']} s (gaps "
          f"{summary['wall_excluded_gaps_s']}); eval at stride "
          f"{J_SOAK_STRIDE}: PSNR {summary['render_metrics']['avg_psnr']:.3f}"
          f", F {summary['recon_eval']['recon_F_score']:.3f} over "
          f"{summary['recon_eval']['n_fused_frames']} fused frames; resumed "
          f"run launches {run_counts}", flush=True)
    if summary["keyframe_ring"] != "host":
        raise AssertionError("J2: the soak config did not keep the host ring")
    if not summary["ate_rmse_noalign_cm"] < 2.0:
        raise AssertionError(f"J2: ATE no-align "
                             f"{summary['ate_rmse_noalign_cm']} cm >= 2 cm")
    j_launched("J2", {k: run_counts.get(k, 0) + eval_counts[k]
                      for k in eval_counts})


def phase_j3_ab(dev, root, which):
    """bf16_ab's two variants or geo_decoder_ab's three, at J_AB_FRAMES
    frames (depth cut), one after the other."""
    from point_slam_tpu_torch.profiling import bf16_ab as AB
    from point_slam_tpu_torch.profiling import geo_decoder_ab as GEO
    cut = lambda cfg: j_cut(cfg, J_AB_CUT)
    if which == "bf16":
        rows, counts = j_counted(AB.run, J_AB_FRAMES, dev, None, root, cut)
    else:
        rows, counts = j_counted(GEO.run, J_AB_FRAMES, J_GEO_FREEZE, dev,
                                 None, root, cut)
    for row in rows:
        j_finite_row(f"J3 {row['variant']}", row,
                     ("ate_cm", "fscore", "psnr", "ms_ssim", "depth_l1_cm"))
        print(f"[J3] {which} {row['variant']}: {json.dumps(row)}",
              flush=True)
    if len(rows) != (2 if which == "bf16" else 3):
        raise AssertionError(f"J3 {which}: rows {[r['variant'] for r in rows]}")
    j_launched(f"J3 {which}", counts)


def j_child(name, root):
    """Phase J's sub-phase ``name`` in a process of its own (its output in
    root/<name>.log), started now; returns the Popen."""
    import subprocess
    with open(os.path.join(root, f"{name}.log"), "w") as log:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phases", name,
             "--j-root", root], stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="2"),
            start_new_session=True)


class JChildren:
    """J1, J2 and J3's pipelines as concurrent processes sharing the card
    (each host-bound; their times are not measurements), under a temporary
    output root: started on entry, joined by ``join`` (their summed
    launches), and every process, its children and the root gone on
    exit."""

    def __enter__(self):
        import tempfile
        self.root = tempfile.mkdtemp(prefix="chip_smoke_j_")
        self.t0 = time.perf_counter()
        self.procs = {name: j_child(name, self.root) for name in J_CHILDREN}
        print(f"[J] started {list(self.procs)} in {self.root}", flush=True)
        return self

    def join(self):
        import subprocess
        launches, failed = {}, []
        for name, proc in self.procs.items():
            left = max(J_TIMEOUT_S - (time.perf_counter() - self.t0), 1.0)
            try:
                rc = proc.wait(left)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            with open(os.path.join(self.root, f"{name}.log")) as f:
                lines = f.read().splitlines()
            for ln in lines:
                if ln.startswith("[J"):
                    print(ln, flush=True)
            tagged = [ln for ln in lines if ln.startswith(J_LAUNCHES_TAG)]
            if rc != 0 or not tagged:
                failed.append(name)
                print(f"[J] {name} failed ({rc}); its last lines:\n"
                      + "\n".join(lines[-40:]), flush=True)
                continue
            for k, v in json.loads(tagged[-1].split(": ", 1)[1]).items():
                launches[k] = launches.get(k, 0) + v
            print(f"[J] {name} done by {time.perf_counter() - self.t0:.1f} s "
                  "after the start", flush=True)
        if failed:
            raise AssertionError(f"phase J: {failed} failed")
        return launches

    def __exit__(self, *exc):
        import shutil
        import signal
        for proc in self.procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        shutil.rmtree(self.root, ignore_errors=True)
        return False


def phase_j3_steps(dev):
    """mlp_precision_ab, probes_ab and geo_fwd_split at their defaults,
    alone on the card; returns their launches."""
    import torch
    from point_slam_tpu_torch.profiling import geo_fwd_split as GF
    from point_slam_tpu_torch.profiling import mlp_precision_ab as MP
    from point_slam_tpu_torch.profiling import probes_ab as PA
    from point_slam_tpu_torch.profiling import workload as W
    totals = {}
    # the scripts' defaults: CAP 2^19, 300k points on frame 0's surfaces,
    # the packed cell table; one ladder serves all three
    b = MP.build(dev, 1 << 19, 300_000, "surface")
    mp = i_drive(totals, MP.run, b)
    pa = i_drive(totals, PA.run, b)
    gf = i_drive(totals, GF.run, b)
    del b
    torch.cuda.empty_cache()
    st = gf["stages"]
    print(f"[J3] mlp_precision_ab: loss rel delta "
          f"{mp['loss']['rel_delta']:.3e}; step wall highest "
          f"{W.spread_str(mp['highest']['wall'])}, default "
          f"{W.spread_str(mp['default']['wall'])}; device highest "
          f"{W.shown(mp['highest']['busy_ms'])}, default "
          f"{W.shown(mp['default']['busy_ms'])}", flush=True)
    print("[J3] probes_ab: " + "; ".join(
        f"{tag} wall {W.spread_str(r['wall'])}, device "
        f"{W.shown(r['busy_ms'])}" for tag, r in pa["grid"].items()),
        flush=True)
    print(f"[J3] geo_fwd_split: non-compact rays {gf['non_compact']} of "
          f"{gf['rays']}; fallback wall "
          f"{gf.get('diff_wall', {}).get('fallback', float('nan')):.3f} ms, "
          f"device {gf.get('diff_busy_ms', {}).get('fallback', float('nan')):.4f}"
          f" ms; " + "; ".join(
              f"{n} {W.spread_str(r['wall'])} ({W.shown(r['busy_ms'])})"
              for n, r in st.items()), flush=True)
    if not mp["loss"]["rel_delta"] > 0:
        raise AssertionError("J3: TF32 left the loss unchanged on the card")
    if not all(h["equal"] for h in pa["hold"].values()):
        raise AssertionError("J3: K1 differs from plain in probes_ab")
    return totals


def phase_j(dev, children=None):
    """The quality gate, the soak chain and the end-to-end A/Bs. Returns
    phase J's kernel launches (J0's comparisons not counted).
    ``children``: the launches of J1-J3's pipelines when they already ran
    (beside phases E-H in the whole smoke); run here otherwise."""
    t0 = time.perf_counter()
    for cut in (
            f"J1: the furnished gate at {J_GATE_FRAMES} frames with "
            f"{J_GATE_CUT} (room_furnished.yaml: mapping iters 300, "
            "iters_first 1500, geo_iter_first 400)",
            f"J2: room_scannet_scale.yaml at {J_SOAK_FRAMES} frames (5000), "
            f"mapping {J_SOAK_CUT['mapping']} (ckpt_freq 500, iters 150, "
            f"iters_first 800, geo_iter_first 200); soak_eval at stride "
            f"{J_SOAK_STRIDE}",
            f"J3: bf16_ab and geo_decoder_ab at {J_AB_FRAMES} frames (100, "
            f"150) with {J_AB_CUT}, freeze after {J_GEO_FREEZE} (20)",
            f"J1-J3's pipelines run as {len(J_CHILDREN)} concurrent "
            "processes sharing the card (in the whole smoke beside phases "
            "E-H): their times, and E-H's, are not measurements"):
        print(f"[J] cut: {cut}", flush=True)
    phase_j0(dev)
    if children is None:
        with JChildren() as jc:
            children = jc.join()
    launches = dict(children)
    for k, v in phase_j3_steps(dev).items():
        launches[k] = launches.get(k, 0) + v
    print(f"[J] phase J wall {time.perf_counter() - t0:.2f} s; launches "
          f"{launches}", flush=True)
    return launches


def phase_j_child(name, root):
    """One of J_CHILDREN, in this process."""
    import torch
    dev = torch.device("cuda")
    if name == "J1":
        phase_j1(dev, root)
    elif name == "J2":
        phase_j2(dev, root)
    else:
        phase_j3_ab(dev, root, {"J3BF16": "bf16", "J3GEO": "geo"}[name])


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="ABCDEFGHIJ",
                    help="run only these phases (e.g. A); a partial run "
                         "prints no kernels line and no result line")
    ap.add_argument("--j-root", default=None,
                    help="(phase J's children) the temporary output root")
    args = ap.parse_args()
    phases = args.phases.upper()
    sys.path.insert(0, HERE)
    if phases in ("E", "H3"):
        # phase E's (and H3's) deterministic mode needs cuBLAS's fixed
        # workspace from the process's first CUDA call; it slows every
        # matmul (phase B ran ~27% slower under it), so these phases run
        # alone in a process
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", E_CUBLAS_WORKSPACE)
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

    b_ref = {}                  # phase B's ATE and frames/s, for phase G
    if phases == "H3":
        phase_h3(dev)
        return
    if phases in J_CHILDREN:
        phase_j_child(phases, args.j_root)
        return
    if phases != "ABCDEFGHIJ":
        for name, phase in (("A", phase_a),
                            ("B", lambda d: phase_b(d, b_ref)),
                            ("C", phase_c), ("D", phase_d),
                            ("E", phase_e if phases == "E" else phase_e_child),
                            ("F", phase_f),
                            ("G", lambda d: phase_g(d, b_ref)),
                            ("H", phase_h), ("I", phase_i),
                            ("J", phase_j)):
            if name in phases:
                phase(dev)
        return
    a = phase_a(dev)
    launches = phase_b(dev, b_ref)
    launches.update(phase_c(dev))
    study = phase_d(dev)
    # phase J's pipelines (host-bound processes) run beside phases E-H,
    # which measure nothing that the kernels line carries
    with JChildren() as jc:
        launches["ray_topk_packed"] += phase_e_child(dev)
        f_launches = phase_f(dev)
        g_launches = phase_g(dev, b_ref)
        h_launches = phase_h(dev)
        j_children = jc.join()
    i_totals = phase_i(dev)
    j_totals = phase_j(dev, j_children)
    for name in launches:
        launches[name] += (f_launches.get(name, 0) + g_launches.get(name, 0)
                           + h_launches.get(name, 0)
                           + i_totals.get(name, 0) + j_totals.get(name, 0))
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
