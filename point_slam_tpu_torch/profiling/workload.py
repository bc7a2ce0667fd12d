"""What the layer-measurement scripts share: the bench workload, the
steady-state cloud, the keyframe window, the device switch and the timers.

* ``bench_config``: ``configs/Synthetic/room.yaml`` with ``bench.py``'s
  overrides (680x1200; tracking 1500 rays x 40 iterations; mapping 5000
  rays x 300 iterations every 5th frame; 6000 + 1000 densification rays;
  window 12; CAP 2^17; table 2^16 x 64; 27 probes). ``small=True`` cuts it
  to a 48x64 camera and a few hundred rays for a run on the host.
* ``inflate``: the ~300k-point steady-state cloud the TPU scripts
  inflated the mapper's cloud to (``sine_sheet``: points on z = -2 + 0.3
  sin(3x) over a 5 m square), or one on frame 0's own surfaces
  (``surface_cloud``), with its cell table.
* ``frame0_window``: the keyframe window holding frame 0 in slot 0.
* ``color_config`` / ``densified_frame0``: the colour probes' workload
  (``profiling/color_*.py``): frame 0 of the synthetic room densified
  once over the f32-plane cell table.
* ``device``: ``cuda`` unless ``--device cpu`` is given; raises without
  CUDA. ``wall_ms`` / ``busy_ms``: CUDA-event and profiler times, None on
  the host (nothing is timed there).
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch.profiling import scene as S

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUTPUT = os.path.join(HERE, "output")


# bench.py's camera, and the 48x64 camera of the host runs
CAM = {"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0, "cx": 599.5,
       "cy": 339.5}
SMALL_CAM = {"H": 48, "W": 64, "fx": 40.0, "fy": 40.0, "cx": 31.5,
             "cy": 23.5}


def bench_widths(small: bool = False) -> Dict[str, Dict[str, Any]]:
    """bench.py's camera and mapping-ray widths as overrides by section:
    the 680x1200 camera (focal 600) at ``angular_step`` 0.01, 5000 mapping
    rays, 6000 uniform and 1000 colour-gradient densification rays,
    window 12, no near-cloud sampling; ``small``: the 48x64 camera (focal
    40) with 400, 200 and 50 rays."""
    rays = (400, 200, 50) if small else (5000, 6000, 1000)
    return {"synthetic": {"angular_step": 0.01},
            "cam": dict(SMALL_CAM if small else CAM),
            "mapping": {**dict(zip(("pixels", "pixels_adding",
                                    "pixels_based_on_color_grad"), rays)),
                        "mapping_window_size": 12},
            "rendering": {"sample_near_pcl": False}}


def override(cfg, updates: Dict[str, Dict[str, Any]]):
    """``cfg`` with each section updated from ``updates``."""
    for sec, upd in updates.items():
        cfg[sec].update(upd)
    return cfg


def bench_config(n_frames: int, scene: str = "room.yaml",
                 iters_first: int = 1500, small: bool = False):
    """configs/Synthetic/<scene> with bench.py's overrides; ``small``: a
    48x64 camera, 300 tracking and 400 mapping rays, window 5, CAP 2^13."""
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", scene),
                      os.path.join(HERE, "configs", "point_slam.yaml"))
    override(cfg, bench_widths(small))
    cfg["synthetic"]["n_frames"] = n_frames
    cfg["tracking"].update({"pixels": 1500, "iters": 40,
                            "ignore_edge_W": 100, "ignore_edge_H": 100})
    cfg["mapping"].update({
        "iters": 300, "iters_first": iters_first, "geo_iter_first": 400,
        "keyframe_every": 5, "every_frame": 5, "lazy_start": False,
        "color_refine": False})
    cfg["cuda"].update({"point_capacity_init": 1 << 17,
                        "grid_table_size": 1 << 16, "grid_max_per_cell": 64,
                        "knn_probes": 27})
    if small:
        cfg["tracking"].update({"pixels": 300, "iters": 2,
                                "ignore_edge_W": 5, "ignore_edge_H": 5})
        cfg["mapping"]["mapping_window_size"] = 5
        cfg["cuda"].update({"point_capacity_init": 1 << 13,
                            "grid_table_size": 1 << 14})
    cfg["verbose"] = False
    cfg["data"]["output"] = os.path.join(OUTPUT, "profiling_torch")
    return cfg


def color_config(small: bool = False):
    """The colour probes' config (``profiling/color_debug.py:19-27``):
    configs/Synthetic/room.yaml over 2 frames at 240x320 (focal 200),
    mapping 2000 rays and 4000 densification rays, no near-cloud sampling;
    ``small``: a 48x64 camera (focal 40), 200 and 400 rays, CAP 2^13 and
    a 2^14-bucket cell table."""
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(HERE, "configs", "Synthetic", "room.yaml"),
                      os.path.join(HERE, "configs", "point_slam.yaml"))
    cfg["synthetic"].update({"n_frames": 2, "angular_step": 0.01})
    if small:
        cfg["cam"].update(SMALL_CAM)
        cfg["mapping"].update({"pixels": 200, "pixels_adding": 400})
        cfg["cuda"].update({"point_capacity_init": 1 << 13,
                            "grid_table_size": 1 << 14})
    else:
        cfg["cam"].update({"H": 240, "W": 320, "fx": 200.0, "fy": 200.0,
                           "cx": 159.5, "cy": 119.5})
        cfg["mapping"].update({"pixels": 2000, "pixels_adding": 4000})
    cfg["rendering"]["sample_near_pcl"] = False
    cfg["verbose"] = False
    cfg["data"]["output"] = os.path.join(OUTPUT, "profiling_torch")
    return cfg


class Frame0(NamedTuple):
    """Frame 0 densified once: the mapper (its cloud, cell table and
    decoders) and the frame's device tensors."""
    mapper: object
    color: torch.Tensor          # (H, W, 3)
    depth: torch.Tensor          # (H, W)
    c2w: torch.Tensor            # (4, 4)
    r_query: torch.Tensor        # (H, W)


def densified_frame0(cfg, dev, n_rays: int, n_add: int = 3, seed: int = 0,
                     draws=None, decoders=None) -> Frame0:
    """What the colour probes share (``profiling/color_debug.py:19-41``):
    the mapper on ``cfg`` (decoders from ``seed``, or ``decoders``),
    frame 0's radius maps, one densification of the mapper's add_max
    candidate rays (the first ``n_rays`` valid, ``n_add`` points along
    each accepted ray at depth x [0.98, 1.02]) and the cell table rebuilt
    over the cloud as f32 planes, as the scripts build it. ``draws``:
    (i, j, (geo, col)) the candidates' pixels and the new points'
    features (a test hands both packages the same); drawn from a
    generator seeded with ``seed`` + 1 otherwise."""
    from point_slam_tpu_torch import mapper as M
    mapper = make_mapper(cfg, dev, seed)
    if decoders is not None:
        mapper.decoders = decoders
    color, depth, c2w = frame(cfg, 0)
    cd, dd, cw = (torch.as_tensor(a, device=dev) for a in (color, depth, c2w))
    r_add, r_query = mapper.radius_maps(cd)[:2]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    i, j, feats = draws if draws is not None else (None, None, None)
    o, d, dep, col, ra, valid = M.sample_add_rays(mapper.ms, cw, cd, dd,
                                                  r_add, n_rays, g, i, j)
    mapper._ensure_capacity(o.shape[0] * n_add)
    mapper.cloud, _ = pc.add_points(mapper.cloud, mapper.index, o, d, dep,
                                    col, valid, ra, 0.98, 1.02, n_add=n_add,
                                    generator=g, feats=feats)
    mapper.n_points_host = int(mapper.cloud.n_points)
    mapper.index = pc.build_index(mapper.cloud, mapper.cell_size,
                                  mapper.table_size, mapper.max_per_cell)
    return Frame0(mapper, cd, dd, cw, r_query)


def pixel_batch(f0: Frame0, i: torch.Tensor, j: torch.Tensor):
    """(gt_depth, gt_color, r_query, rays_o, rays_d) of frame 0 at the
    pixels (i columns, j rows)."""
    from point_slam_tpu_torch.common import camera, sampling
    ms = f0.mapper.ms
    ro, rd = camera.rays_from_uv(i, j, f0.c2w, ms.fx, ms.fy, ms.cx, ms.cy)
    return (sampling.gather_pixels(f0.depth, i, j),
            sampling.gather_pixels(f0.color, i, j),
            sampling.gather_pixels(f0.r_query, i, j), ro, rd)


def pixel_draws(f0: Frame0, n: int, seed: int, fill: bool = False):
    """draws(t) -> {"i", "j"[, "fill"]}: n uniform pixels of the frame
    (and a render's random-fill vectors) for step t, from one generator
    seeded with ``seed``."""
    from point_slam_tpu_torch import renderer as R
    from point_slam_tpu_torch.common import sampling
    ms, dev = f0.mapper.ms, f0.depth.device
    g = torch.Generator(device=dev).manual_seed(seed)

    def draws(t: int):
        i, j = sampling.sample_pixels_uniform(0, ms.h, 0, ms.w, n, g, dev)
        out = {"i": i, "j": j}
        if fill:
            out["fill"] = R.draw_fill(g, dev)
        return out
    return draws


CLOUDS = ("sheet", "surface")


def sine_sheet(cap: int, n_points: int, seed: int = 0) -> np.ndarray:
    """(cap, 3) positions of the TPU scripts' steady-state cloud: n_points
    on the sheet z = -2 + 0.3 sin(3x), x, y uniform in [-2.5, 2.5], padding
    rows at 1e6. The synthetic room's cameras do not see it: the room's
    surfaces lie at z 1-2.6 m."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-2.5, 2.5, (n_points, 2)).astype(np.float32)
    pts = np.stack([u[:, 0], u[:, 1], -2.0 + 0.3 * np.sin(u[:, 0] * 3)],
                   -1).astype(np.float32)
    pos = np.full((cap, 3), 1e6, np.float32)
    pos[:n_points] = pts
    return pos


def surface_cloud(cap: int, n_points: int, depth: np.ndarray,
                  c2w: np.ndarray, cam, seed: int = 0) -> np.ndarray:
    """(cap, 3) positions of a cloud on the frame's own surfaces: n_points
    pixels with depth drawn uniformly (with replacement), each back-projected
    at depth x U(0.98, 1.02), the band the mapper adds points in; padding
    rows at 1e6."""
    rng = np.random.default_rng(seed)
    jj, ii = np.nonzero(depth > 0)
    pick = rng.integers(0, jj.size, n_points)
    j, i = jj[pick].astype(np.float32), ii[pick].astype(np.float32)
    d = depth[jj[pick], ii[pick]] * rng.uniform(0.98, 1.02, n_points)
    dirs = np.stack([(i - cam["cx"]) / cam["fx"], -(j - cam["cy"]) / cam["fy"],
                     -np.ones_like(i)], -1)
    pts = (dirs * d[:, None]) @ c2w[:3, :3].T + c2w[:3, 3]
    pos = np.full((cap, 3), 1e6, np.float32)
    pos[:n_points] = pts
    return pos


def inflate(mapper, n_points: int, cloud: str = "sheet", frame=None,
            cam=None, seed: int = 0, features: bool = False):
    """Replace the mapper's cloud by a steady-state one of n_points at its
    capacity: the TPU scripts' ``sheet`` or the ``surface`` of ``frame``
    (color, depth, c2w) seen with ``cam``. ``features``: N(0, 0.1) geometry
    and colour columns (the cloud's own columns otherwise). Rebuilds the
    cell table."""
    cap = mapper.cloud.packed.shape[0]
    if n_points > cap:
        raise ValueError(f"inflate: {n_points} points exceed CAP {cap}")
    if cloud not in CLOUDS:
        raise ValueError(f"inflate: cloud {cloud!r} not in {CLOUDS}")
    pos = (sine_sheet(cap, n_points, seed) if cloud == "sheet" else
           surface_cloud(cap, n_points, frame[1], frame[2], cam, seed))
    packed = mapper.cloud.packed.clone()
    if features:
        g = torch.Generator(device=mapper.device).manual_seed(seed)
        packed[:, :2 * pc.C_DIM] = 0.1 * torch.randn(
            (cap, 2 * pc.C_DIM), generator=g, device=mapper.device)
    packed[:, pc.POS_SL] = torch.from_numpy(pos).to(mapper.device)
    mapper.cloud = mapper.cloud._replace(
        packed=packed, n_points=torch.tensor(n_points, device=mapper.device))
    mapper.n_points_host = n_points
    mapper.index = pc.build_index(mapper.cloud, mapper.cell_size,
                                  mapper.table_size, mapper.max_per_cell,
                                  mapper.packed_coords)


def add_cloud_args(ap: argparse.ArgumentParser, cap: int = 1 << 19,
                   points: int = 300_000, cloud: str = "surface") -> None:
    ap.add_argument("--cap", type=int, default=cap,
                    help="the cloud's capacity (point_capacity_init)")
    ap.add_argument("--points", type=int, default=points,
                    help="points of the steady-state cloud")
    ap.add_argument("--cloud", default=cloud, choices=CLOUDS,
                    help="sheet: the TPU scripts' sine sheet (outside the "
                         "room's view); surface: frame 0's surfaces")
    ap.add_argument("--small", action="store_true",
                    help="a 48x64 camera and a few hundred rays")


def make_mapper(cfg, dev, seed: int = 0):
    from point_slam_tpu_torch.mapper import Mapper
    from point_slam_tpu_torch.models import decoders as D
    return Mapper(cfg, D.init_decoders(cfg, seed, dev), 100,
                  np.random.default_rng(seed), dev)


def frame(cfg, idx: int = 0):
    """(color, depth, c2w) numpy of the synthetic frame ``idx``."""
    from point_slam_tpu_torch.datasets import get_dataset
    _, color, depth, c2w = get_dataset(cfg)[idx]
    return (np.asarray(color, np.float32), np.asarray(depth, np.float32),
            np.asarray(c2w, np.float32))


def frame0_window(mapper, color, depth, c2w):
    """The (color, depth, r_query) window with the frame in slot 0 (the
    others zero, r_query 1e6) and its (f_max, 4, 4) poses."""
    dev = mapper.device
    f = mapper.ms.f_max
    cd = torch.as_tensor(color, device=dev)
    dd = torch.as_tensor(depth, device=dev)
    r_query = mapper.radius_maps(cd)[1]
    wc = torch.zeros((f,) + cd.shape, device=dev)
    wd = torch.zeros((f,) + dd.shape, device=dev)
    wr = torch.full((f,) + dd.shape, 1e6, device=dev)
    wc[0], wd[0], wr[0] = cd, dd, r_query
    w_c2w = torch.eye(4, device=dev).repeat(f, 1, 1)
    w_c2w[0] = torch.as_tensor(c2w, device=dev)
    return (wc, wd, wr), w_c2w


# ---------------------------------------------------------------- device


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; raises without a card) or cpu "
                         "(the plain versions; nothing is timed)")


def device(name: str, script: str) -> torch.device:
    """The script's device: CUDA raises without a card, never falls back."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{script}: CUDA is not available; pass --device "
                           "cpu to run the plain versions (nothing is timed "
                           "there)")
    dev = torch.device(name)
    if dev.type == "cuda":
        print(f"[{script}] card: {S.card_line()}; "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    return dev


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------- timers


def wall_ms(fn: Callable, dev, iters: int = 10, warmup: int = 2
            ) -> Optional[float]:
    """Wall ms per call of ``iters`` back-to-back calls between two CUDA
    events (after ``warmup`` calls): the host's launch cost and the card's
    work, ending on the card. On the host fn runs once and None is
    returned (nothing is timed there)."""
    if torch.device(dev).type != "cuda":
        fn()
        return None
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def call_ms(fn: Callable, dev, iters: int = 8, warmup: int = 1
            ) -> Optional[List[float]]:
    """Sorted wall ms of single calls, each between its own CUDA events
    (the card idle before each); None on the host."""
    if torch.device(dev).type != "cuda":
        fn()
        return None
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return sorted(out)


def busy_ms(fn: Callable, dev, iters: int = 10) -> Optional[float]:
    """Device-busy ms per call: the summed durations of the kernels and
    copies torch.profiler records over ``iters`` calls (scene.device_ms),
    without the card's waits for the host. The profiler on the card
    machine now and then records no device activity for a window: up to
    three windows are taken; None if all three were empty, and on the
    host."""
    if torch.device(dev).type != "cuda":
        return None
    for _ in range(3):
        ms = S.device_ms(fn, iters)
        if ms is not None:
            return ms
    return None


def host_s(fn: Callable, dev):
    """(fn(), the host seconds it took ending in a device sync): a
    frame-level time."""
    import time
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def shown(ms: Optional[float], unit: str = "ms") -> str:
    return "not measured (cpu)" if ms is None else f"{ms:.4f} {unit}"


def spread(values: Sequence[Optional[float]]) -> Dict[str, Optional[float]]:
    """Median, min and max of repeat measurements (None on the host)."""
    if any(v is None for v in values):
        return {"median": None, "min": None, "max": None}
    return {"median": float(np.median(values)), "min": float(min(values)),
            "max": float(max(values))}


def spread_str(s: Dict[str, Optional[float]]) -> str:
    if s["median"] is None:
        return "not measured (cpu)"
    return f"{s['median']:.4f} ms [{s['min']:.4f}-{s['max']:.4f}]"


def save_json(name: str, obj) -> str:
    """Write ``obj`` to output/<name> (the directory .gitignore lists)."""
    import json
    path = os.path.join(OUTPUT, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=float)
    return path
