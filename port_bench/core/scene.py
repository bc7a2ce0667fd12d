"""The synthetic furnished room, ray-cast on the device, and the on-disk
sequences the benchmark's traffic writes from it.

The scene follows the synthetic room of the system's datasets (a textured
axis-aligned box with spheres and boxes as furniture, seen from an orbit
inside it), rewritten in PyTorch so that a whole sequence is made on the
card in set-up. A traffic file fixes what sets the work of each frame:
the room's extent, the object count and placement, the colours and the
texture (drawn from its ``texture_seed``), the orbit's phase, the motion
per frame and the hole fraction. Point-SLAM maps a frame for longer the
more new surface it adds, and its add radius follows the colour gradient,
so the scene and the path stay the traffic's. The run's seed draws the
sensor noise and which pixels lose their depth.

``write_sequence`` writes the frames in the layout of the configuration's
dataset: Replica (``results/frame*.jpg``, ``results/depth*.png``,
``traj.txt``) or TUM RGB-D (``rgb/``, ``depth/``, ``rgb.txt``,
``depth.txt``, ``groundtruth.txt``).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

from core import codecs
from point_slam_tpu_torch.utils.png import encode_png


class Room(NamedTuple):
    half: np.ndarray          # (3,) half extent
    spheres: np.ndarray       # (S, 4) cx cy cz r
    boxes: np.ndarray         # (B, 6) lo xyz, hi xyz
    palette: np.ndarray       # (1 + S + B, 3) albedo tint, walls first
    phases: np.ndarray        # (9,) texture phases
    tex_freq: float
    tex_detail: float


def place_objects(half, n_objects: int, layout_seed: int):
    """Alternating spheres and boxes placed as the system's synthetic room
    places them, kept off the camera orbit (radius 0.8 in xz)."""
    rng = np.random.default_rng(layout_seed * 31 + 5)
    spheres, boxes = [], []
    for k in range(n_objects):
        ang = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(1.4, 2.3)
        c = np.array([rad * np.cos(ang) * half[0] / 3.0,
                      rng.uniform(-1.4, 0.9),
                      rad * np.sin(ang) * half[2] / 3.0])
        c = np.clip(c, -half + 0.55, half - 0.55)
        if np.hypot(c[0], c[2]) < 1.35:
            c[[0, 2]] *= 1.35 / max(np.hypot(c[0], c[2]), 1e-6)
        size = rng.uniform(0.22, 0.48)
        if k % 2 == 0:
            spheres.append([c[0], c[1], c[2], size])
        else:
            hb = rng.uniform(0.18, 0.42, 3)
            boxes.append(list(c - hb) + list(c + hb))
    return (np.asarray(spheres, np.float64).reshape(-1, 4),
            np.asarray(boxes, np.float64).reshape(-1, 6))


def make_room(traffic: Dict[str, Any]) -> Room:
    rng = np.random.default_rng(int(traffic["texture_seed"]))
    half = np.asarray(traffic["half_extent"], np.float64)
    spheres, boxes = place_objects(half, int(traffic["objects"]),
                                   int(traffic["layout_seed"]))
    n = 1 + len(spheres) + len(boxes)
    palette = 0.55 + 0.45 * rng.uniform(size=(n, 3))
    palette[0] = 1.0
    return Room(half, spheres, boxes, palette,
                rng.uniform(0, 2 * np.pi, 9), float(traffic["texture_freq"]),
                float(traffic["texture_detail"]))


def orbit_pose(ang: float) -> np.ndarray:
    """c2w (x right, y up, z backward) on the orbit at angle ``ang``."""
    radius = 0.8
    eye = np.array([radius * np.cos(ang), 0.25 * np.sin(2 * ang),
                    radius * np.sin(ang)])
    tgt = ang + 0.9
    target = np.array([2.5 * np.cos(tgt), 0.4 * np.sin(tgt),
                       2.2 * np.sin(tgt)])
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w


def flip_yz(c2w: np.ndarray) -> np.ndarray:
    """The datasets' y-down, z-forward camera axes (its own inverse)."""
    c2w = c2w.copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w


def _undistorted_dirs(u, v, cam, dist):
    """Normalised pinhole coordinates whose image under the radial and
    tangential distortion ``dist`` (k1 k2 p1 p2 k3) lands on pixel (u, v):
    the fixed-point inversion undistortPoints does."""
    xd = (u - cam["cx"]) / cam["fx"]
    yd = (v - cam["cy"]) / cam["fy"]
    k1, k2, p1, p2, k3 = dist
    x, y = xd.clone(), yd.clone()
    for _ in range(20):
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / rad
        y = (yd - dy) / rad
    return x, y


def render(room: Room, c2w: np.ndarray, cam: Dict[str, Any], device,
           distortion=None):
    """(colour (H,W,3) f64 in [0,1], depth (H,W) f64) of one pose; with
    ``distortion`` the colour is rendered through the lens model (the
    depth stays on the pinhole grid, as a registered depth map is)."""
    h, w = cam["H"], cam["W"]
    f64 = dict(dtype=torch.float64, device=device)
    jj, ii = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64),
                            indexing="ij")
    rot = torch.as_tensor(c2w[:3, :3], **f64)
    ro = torch.as_tensor(c2w[:3, 3], **f64)

    def cast(x, y):
        dirs = torch.stack([x, -y, -torch.ones_like(x)], -1)
        rd = dirs @ rot.T
        half = torch.as_tensor(room.half, **f64)
        t1 = (half - ro) / rd
        t2 = (-half - ro) / rd
        t_best = torch.clamp(torch.maximum(t1, t2).amin(-1), max=1e9)
        obj = torch.zeros(t_best.shape, dtype=torch.long, device=device)
        oid = 1
        for cx, cy, cz, r in room.spheres:
            oc = ro - torch.as_tensor([cx, cy, cz], **f64)
            a = (rd * rd).sum(-1)
            b = 2.0 * (rd * oc).sum(-1)
            cq = (oc * oc).sum() - r * r
            disc = b * b - 4 * a * cq
            t_hit = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2 * a)
            ok = (disc > 0) & (t_hit > 1e-6) & (t_hit < t_best)
            t_best = torch.where(ok, t_hit, t_best)
            obj = torch.where(ok, oid, obj)
            oid += 1
        for lo_hi in room.boxes:
            lo = torch.as_tensor(lo_hi[:3], **f64)
            hi = torch.as_tensor(lo_hi[3:], **f64)
            ta = (lo - ro) / rd
            tb = (hi - ro) / rd
            t_near = torch.clamp(torch.minimum(ta, tb).amax(-1), min=1e-6)
            t_far = torch.maximum(ta, tb).amin(-1)
            ok = (t_near < t_far) & (t_near < t_best)
            t_best = torch.where(ok, t_near, t_best)
            obj = torch.where(ok, oid, obj)
            oid += 1
        return t_best, ro + rd * t_best[..., None], obj

    depth, _, _ = cast((ii - cam["cx"]) / cam["fx"],
                       (jj - cam["cy"]) / cam["fy"])
    if distortion is not None:
        x, y = _undistorted_dirs(ii, jj, cam, distortion)
        _, pts, obj = cast(x, y)
    else:
        _, pts, obj = cast((ii - cam["cx"]) / cam["fx"],
                           (jj - cam["cy"]) / cam["fy"])
    return color_field(room, pts, obj), depth


def color_field(room: Room, pts: torch.Tensor, obj: torch.Tensor):
    """The room's procedural texture, tinted by each object's albedo."""
    f, ph = room.tex_freq, room.phases
    x, y, z = pts[..., 0] * f, pts[..., 1] * f, pts[..., 2] * f
    s, c = torch.sin, torch.cos
    r = 0.5 + 0.25 * s(2.1 * x + ph[0]) * c(1.3 * z) + 0.25 * s(3.7 * y + ph[1])
    g = 0.5 + 0.25 * c(1.7 * x + 2.0 * y + ph[2]) + 0.25 * s(2.9 * z + ph[3])
    b = 0.5 + 0.25 * s(1.1 * x + 1.9 * z + ph[4]) + 0.25 * c(2.3 * y + ph[5])
    col = torch.stack([r, g, b], -1)
    d = room.tex_detail
    if d > 0:
        col = col + d * 0.5 * torch.stack([
            s(9.7 * x + 3.1 * s(2.9 * y) + ph[6]) * c(8.3 * z),
            s(11.3 * y + 2.7 * c(3.7 * z) + ph[7]) * c(7.9 * x),
            s(8.9 * z + 3.3 * s(3.1 * x) + ph[8]) * c(10.1 * y)], -1)
    pal = torch.as_tensor(room.palette, dtype=col.dtype, device=col.device)
    return torch.clamp(col * pal[obj], 0.0, 1.0)


class Sequence(NamedTuple):
    """What the benchmark wrote: the ground-truth c2w (codebase axes) of
    each frame and the u16 depth maps as stored (the reader's input)."""
    poses: List[np.ndarray]
    depth_u16: List[np.ndarray]
    n_bytes: int


def write_sequence(root: str, cfg: Dict[str, Any], traffic: Dict[str, Any],
                   seed: int, n_frames: int, device) -> Sequence:
    """Ray-cast ``n_frames`` frames of the traffic's orbit, with the sensor
    noise and holes drawn from ``seed``, and write them under ``root`` in
    the layout of ``cfg['dataset']``."""
    rng = np.random.default_rng([seed, 17])
    room = make_room(traffic)
    cam = cfg["cam"]
    layout = cfg["dataset"]
    if layout not in ("replica", "tumrgbd"):
        raise ValueError(f"write_sequence: no on-disk layout for {layout!r}")
    phase = float(traffic["orbit_phase"])
    step = float(traffic["angular_step"])
    noise = float(traffic.get("depth_noise", 0.0))
    holes = float(traffic.get("depth_dropout", 0.0))
    scale = float(cam["png_depth_scale"])
    dist = cam.get("distortion") if layout == "tumrgbd" else None
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    poses, depths, futures = [], [], []
    sub = ("results", "results") if layout == "replica" else ("rgb", "depth")
    for d in set(sub):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))
    dt = float(traffic.get("frame_dt", 1.0 / 30.0))
    stamps = [1305031102.0 + i * dt for i in range(n_frames)]

    def put(path, blob_fn):
        # each file reaches the disk in set-up: the kernel's write-back of
        # a sequence left in the page cache would run inside the window
        def job():
            blob = blob_fn()
            with open(path, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            return len(blob)
        return pool.submit(job)

    for i in range(n_frames):
        c2w = orbit_pose(phase + step * i)
        color, depth = render(room, c2w, cam, device, dist)
        if noise > 0:
            depth = depth * (1 + noise * torch.randn(
                depth.shape, generator=gen, device=device,
                dtype=depth.dtype))
        if holes > 0:
            drop = torch.rand(depth.shape, generator=gen, device=device,
                              dtype=depth.dtype) < holes
            depth = torch.where(drop, 0.0, depth)
        d16 = torch.clamp(torch.round(depth * scale), 0, 65535).to(
            torch.int32).cpu().numpy().astype(np.uint16)
        rgb = torch.round(color * 255.0).to(torch.uint8)
        poses.append(c2w)
        depths.append(d16)
        if layout == "replica":
            cpath = os.path.join(root, "results", f"frame{i:06d}.jpg")
            dpath = os.path.join(root, "results", f"depth{i:06d}.png")
            q = int(traffic.get("jpeg_quality", 95))
            futures.append(put(cpath, lambda a=rgb.cpu(), q=q:
                               codecs.encode_jpeg(a, q)))
        else:
            cpath = os.path.join(root, "rgb", f"{stamps[i]:.6f}.png")
            dpath = os.path.join(root, "depth", f"{stamps[i]:.6f}.png")
            futures.append(put(cpath, lambda a=rgb.cpu().numpy():
                               encode_png(a, level=1)))
        futures.append(put(dpath, lambda a=d16: encode_png(a, level=1)))
    n_bytes = sum(f.result() for f in futures)
    pool.shutdown()
    if layout == "replica":
        lines = [" ".join(f"{v:.12f}" for v in flip_yz(p).reshape(-1))
                 for p in poses]
        _write_text(os.path.join(root, "traj.txt"), lines)
    else:
        _write_text(os.path.join(root, "rgb.txt"), ["# color images"] + [
            f"{t:.6f} rgb/{t:.6f}.png" for t in stamps])
        _write_text(os.path.join(root, "depth.txt"), ["# depth maps"] + [
            f"{t:.6f} depth/{t:.6f}.png" for t in stamps])
        rows = ["# timestamp tx ty tz qx qy qz qw"]
        for t, p in zip(stamps, poses):
            q = matrix_to_quat(flip_yz(p)[:3, :3])
            tx, ty, tz = flip_yz(p)[:3, 3]
            rows.append(f"{t:.6f} {tx:.9f} {ty:.9f} {tz:.9f} "
                        + " ".join(f"{v:.9f}" for v in q))
        _write_text(os.path.join(root, "groundtruth.txt"), rows)
    return Sequence(poses, depths, n_bytes)


def _write_text(path: str, lines: List[str]) -> None:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (x, y, z, w) unit quaternion."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        w, x = 0.25 * s, (m[2, 1] - m[1, 2]) / s
        y, z = (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w, x = (m[2, 1] - m[1, 2]) / s, 0.25 * s
        y, z = (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w, x = (m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s
        y, z = 0.25 * s, (m[1, 2] + m[2, 1]) / s
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w, x = (m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s
        y, z = (m[1, 2] + m[2, 1]) / s, 0.25 * s
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def gt_trajectory(seq: Sequence, layout: str) -> np.ndarray:
    """The c2w (codebase axes) the reader reports for each frame: TUM's
    poses are relative to the first frame's."""
    poses = np.stack(seq.poses)
    if layout != "tumrgbd":
        return poses
    first = np.linalg.inv(flip_yz(poses[0]))
    return np.stack([flip_yz(first @ flip_yz(p)) for p in poses])
