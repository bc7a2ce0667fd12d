"""The study's scenes and shared helpers.

Each scene is what one of the TPU study's scripts built at module level,
as a function of (seed, sizes); with seed 0 and the default sizes the
numpy draws are the script's own:

* ``sine_sheet``: ``profiling/knn_pallas*.py`` (CAP 2^19, 300k points on
  z = 2 + 0.3 sin(3x), cell 0.16, 5000 near-vertical rays hitting it);
* ``gaussian_slab``: ``profiling/knn_layout_micro.py`` (300k points in a
  slab of Gaussian thickness, cell 0.16, 5024 rays of samples jittered
  around cloud points);
* ``random_rays``: ``profiling/knn_quad_micro.py`` (a sine sheet, cell
  0.08, 5008 rays of random direction through cloud points).

Every scene has table 2^16 x 64 and 5 samples a ray.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

INF_BITS = 0x7F800000         # the key of a sample with no finite candidate
TABLE = 1 << 16
C = 64
NS = 5
K = 8


class Scene(NamedTuple):
    name: str
    points: np.ndarray        # (CAP, 3) f32, padding rows at 1e6
    n_points: int
    q: np.ndarray             # (R, NS, 3) f32 ray samples
    cell: float


def _padded(pts: np.ndarray, cap: int) -> np.ndarray:
    pos = np.full((max(cap, pts.shape[0]), 3), 1e6, np.float32)
    pos[:pts.shape[0]] = pts
    return pos


def sine_sheet(seed: int = 0, n_points: int = 300_000, rays: int = 5000,
               cap: int = 1 << 19) -> Scene:
    """knn_pallas*.py's scene."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 6, (n_points, 2)).astype(np.float32)
    pts = np.stack([u[:, 0], u[:, 1], 2.0 + 0.3 * np.sin(u[:, 0] * 3)], -1
                   ).astype(np.float32)
    o = np.concatenate([rng.uniform(0.5, 5.5, (rays, 2)),
                        np.zeros((rays, 1))], -1).astype(np.float32)
    d = np.concatenate([rng.normal(0, 0.05, (rays, 2)), np.ones((rays, 1))],
                       -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depth = (2.0 + 0.3 * np.sin(o[:, 0] * 3)).astype(np.float32)
    t = np.linspace(0.98, 1.02, NS).astype(np.float32)
    zv = depth[:, None] * t[None, :]
    q = (o[:, None, :] + d[:, None, :] * zv[..., None]).astype(np.float32)
    return Scene("sine-sheet", _padded(pts, cap), n_points, q, 0.16)


def gaussian_slab(seed: int = 0, n_points: int = 300_000,
                  rays: int = 5024) -> Scene:
    """knn_layout_micro.py's scene (its cloud has no padding rows)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2.5, 2.5, n_points),
                    rng.uniform(-2.5, 2.5, n_points),
                    -2.0 + 0.3 * rng.standard_normal(n_points)], -1
                   ).astype(np.float32)
    base = pts[rng.integers(0, n_points, rays)]
    q = (base[:, None, :] + rng.normal(0, 0.01, (rays, NS, 3)).astype(
        np.float32)).astype(np.float32)
    return Scene("gaussian-slab", pts, n_points, q, 0.16)


def random_rays(seed: int = 0, n_points: int = 300_000,
                rays: int = 5008) -> Scene:
    """knn_quad_micro.py's scene (its cloud has no padding rows)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-2.5, 2.5, (n_points, 2)).astype(np.float32)
    pts = np.stack([u[:, 0], u[:, 1], -2.0 + 0.3 * np.sin(u[:, 0] * 3)], -1
                   ).astype(np.float32)
    centers = pts[rng.integers(0, n_points, rays)]
    dirs = rng.normal(size=(rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    depth = rng.uniform(1.5, 4.0, rays).astype(np.float32)
    t = np.linspace(0.98, 1.02, NS).astype(np.float32)
    z = depth[:, None] * t[None, :]
    q = ((centers - dirs * depth[:, None])[:, None, :]
         + dirs[:, None, :] * z[..., None]).astype(np.float32)
    return Scene("random-rays", pts, n_points, q, 0.08)


def interleaved_table(index) -> torch.Tensor:
    """What the JAX GridIndex's ``.table`` was: (TABLE+1, C, 4) f32 rows of
    [x|y|z|id] per slot. Row TABLE is the index's +inf sentinel row."""
    return torch.stack([index.px, index.py, index.pz, index.pid], -1)


class Block(NamedTuple):
    """A block top-k's inputs: the candidate views, the query planes and
    the lane mask (see ops/block_topk.py)."""
    views: Tuple[torch.Tensor, ...]
    q: Tuple[torch.Tensor, ...]
    lane_mask: int


def finish(keys: torch.Tensor, ids: torch.Tensor, lane_mask: int,
           k: int = K):
    """The scripts' epilogue for ids taken in the kernel: (d2q, idx, valid)
    as (R*ns, k), d2q the selection-quantised d^2 (+inf where invalid)."""
    valid = keys < INF_BITS
    idx = torch.where(valid, ids, 0.0).long()
    d2q = torch.where(valid, (keys & ~lane_mask).view(torch.float32),
                      torch.inf)
    return (d2q.reshape(-1, k), idx.reshape(-1, k), valid.reshape(-1, k))


def exact_d2(points: torch.Tensor, q: torch.Tensor, idx: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Exact d^2 of each winner from its id: (R*ns, k), +inf where
    invalid."""
    w = points[idx]
    d2 = ((w - q.reshape(-1, 1, 3)) ** 2).sum(-1)
    return torch.where(valid, d2, torch.inf)


def dist_set_match(ref: torch.Tensor, got: torch.Tensor) -> float:
    """The scripts' parity: % of sorted top-k d^2 slots within rtol 1e-5
    (atol 1e-10) of the reference's, or where the reference has none."""
    a = torch.sort(ref.double(), dim=1).values
    b = torch.sort(got.double(), dim=1).values
    ok = torch.isclose(a, b, rtol=1e-5, atol=1e-10) | ~torch.isfinite(a)
    return float(ok.double().mean()) * 100.0


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms over ``iters`` calls, after
    ``warmup`` calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms: times are taken on a CUDA card only")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def device_ms(fn, iters: int = 10) -> Optional[float]:
    """Device time of one fn() call in ms: the summed durations of the
    kernels and copies the card ran for it, from torch.profiler over
    ``iters`` calls after one warm-up. The gaps in which the card waits for
    the host to launch the next op are left out, so on a pipeline of many
    small eager ops this is far below its CUDA-event time. None if the
    profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else None


def sheet(device, n_points: Optional[int] = None, rays: Optional[int] = None,
          cap: int = 1 << 19, c: int = C, build=None, seed: int = 0):
    """The sine-sheet scene (``sine_sheet``) on ``device``: (scene, points
    (CAP, 3), q (R, NS, 3), its cell table). ``build``: the table's
    builder (ops/knn.py's build_grid_index, build_packed_grid_index or
    build_fused_grid_index; default the f32 planes), at TABLE x ``c``."""
    from point_slam_tpu_torch.ops import knn as tk
    size = {"cap": cap}
    if n_points is not None:
        size["n_points"] = n_points
    if rays is not None:
        size["rays"] = rays
    sc = sine_sheet(seed, **size)
    pts = torch.from_numpy(sc.points).to(device)
    q = torch.from_numpy(sc.q).to(device)
    index = (build or tk.build_grid_index)(pts, sc.n_points, sc.cell, TABLE,
                                           c)
    return sc, pts, q, index


def jitter(q: torch.Tensor, g: torch.Generator,
           scale: float = 0.002) -> torch.Tensor:
    """The scripts' per-iteration query jitter: q + scale * N(0, 1)."""
    return q + scale * torch.randn(q.shape, generator=g, device=q.device)


def stage_times(fn, device, iters: int = 20):
    """(median CUDA-event ms, device ms) of fn() on a card (device ms: the
    profiler's summed kernel time a call, up to three windows; None if
    none recorded device activity). On the host fn runs once and nothing
    is timed: (None, None)."""
    if torch.device(device).type != "cuda":
        fn()
        return None, None
    ms = cuda_ms(fn, iters)
    for _ in range(3):
        dev_ms = device_ms(fn, iters)
        if dev_ms is not None:
            return ms, dev_ms
    return ms, None


def shown_ms(ms: Optional[float], dev_ms: Optional[float]) -> str:
    if ms is None:
        return "not measured (cpu)"
    dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    return f"{ms:.4f} ms (device {dev})"


def launch_counts() -> dict:
    """The CUDA kernels' launch counts (ops/knn.py's and
    ops/block_topk.py's), by kernel."""
    from point_slam_tpu_torch.ops import block_topk, knn
    return {**knn.LAUNCHES, **block_topk.LAUNCHES}


def run_stages(tag: str, stages, device, iters: int = 20) -> dict:
    """Time each (name, fn) of ``stages`` with ``stage_times`` and print a
    line each; returns {name: {"ms": .., "device_ms": .., "launches":
    {kernel: launches of the stage's runs}}}."""
    rows = {}
    for name, fn in stages:
        before = launch_counts()
        ms, dev_ms = stage_times(fn, device, iters)
        launches = {k: v - before[k] for k, v in launch_counts().items()
                    if v != before[k]}
        rows[name] = {"ms": ms, "device_ms": dev_ms, "launches": launches}
        print(f"[{tag}] {name:<24} {shown_ms(ms, dev_ms)}", flush=True)
    return rows


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
