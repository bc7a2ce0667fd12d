"""Shared fixtures of the port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs: made with numpy from a seed, or drawn
from a jax.random key on the JAX side and handed to the port as explicit
draws. State built by the JAX package crosses over through
point_slam_tpu_torch.interop as numpy arrays.
"""

import os

import numpy as np
import torch
import jax
import jax.numpy as jnp

# the tests run several workers on one host: keep each one's intra-op pool
# small (and its sums' order fixed)
torch.set_num_threads(2)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(HERE, "configs")
PRETRAINED = os.path.join(HERE, "pretrained", "middle_fine.npz")


def tiny_cfgs(n_frames=12):
    """tests/test_slam_e2e.py's tiny synthetic config (48x64) for both
    packages: (JAX cfg with a 'tpu' section, port cfg with 'cuda')."""
    from point_slam_tpu.config import load_config as jload
    from point_slam_tpu_torch.config import load_config as tload
    out = []
    for load, sec in ((jload, "tpu"), (tload, "cuda")):
        cfg = load(os.path.join(CONFIGS, "Synthetic", "room.yaml"),
                   os.path.join(CONFIGS, "point_slam.yaml"))
        cfg["synthetic"]["n_frames"] = n_frames
        cfg["synthetic"]["angular_step"] = 0.02
        cfg["cam"].update({"H": 48, "W": 64, "fx": 40.0, "fy": 40.0,
                           "cx": 31.5, "cy": 23.5})
        cfg["tracking"].update({"pixels": 300, "iters": 20,
                                "ignore_edge_W": 5, "ignore_edge_H": 5})
        cfg["mapping"].update({
            "pixels": 400, "pixels_adding": 200,
            "pixels_based_on_color_grad": 50, "iters": 20, "iters_first": 30,
            "geo_iter_first": 10, "mapping_window_size": 4,
            "keyframe_every": 4, "every_frame": 2, "lazy_start": False,
            "color_refine": False})
        cfg[sec].update({"point_capacity_init": 1 << 13,
                         "point_capacity_max": 1 << 16,
                         "grid_table_size": 1 << 14,
                         "grid_max_per_cell": 64})
        cfg["verbose"] = False
        out.append(cfg)
    return out


def jax_fill(key):
    """The two random-fill vectors JAX's render_rays draws from ``key``
    (geometry, colour), as the port's (2, 32) ``fill``."""
    kg, kc = jax.random.split(key)
    return torch.from_numpy(np.stack([
        np.asarray(0.01 * jax.random.normal(kg, (32,), jnp.float32)),
        np.asarray(0.01 * jax.random.normal(kc, (32,), jnp.float32))]))


def jax_decoders(cfg, seed=0):
    from point_slam_tpu.models import decoders as JD
    params = JD.init_decoders(jax.random.key(seed), cfg)
    return JD.load_pretrained_geo(params, PRETRAINED)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def t(x, dtype=None):
    """A numpy/JAX array as a CPU torch tensor (a copy)."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def n(x):
    """A torch tensor or JAX array as numpy."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class Scene:
    """A mapped synthetic frame for both packages: frame 0 of the tiny
    config densified by the JAX package (add_points with its own key), the
    pretrained decoders, and the index in the requested layout, each also
    carried into the port."""

    def __init__(self, packed_coords=False, n_frames=4, seed=0,
                 cap=1 << 13):
        from point_slam_tpu import pointcloud as jpc
        from point_slam_tpu.common import camera as jcam
        from point_slam_tpu.datasets import get_dataset
        from point_slam_tpu_torch import interop
        self.jcfg, self.tcfg = tiny_cfgs(n_frames)
        self.ds = get_dataset(self.jcfg)
        self.frames = [self.ds[i] for i in range(n_frames)]
        _, color, depth, c2w = self.frames[0]
        h, w = depth.shape
        self.cell = 0.16
        self.params = jax_decoders(self.jcfg, seed)
        self.tdec = interop.decoders_from_numpy(to_numpy(self.params),
                                                self.tcfg)
        # frame-0 densification over a pixel lattice (deterministic rays)
        jj, ii = np.meshgrid(np.arange(0, h, 2), np.arange(0, w, 2),
                             indexing="ij")
        i = jnp.asarray(ii.ravel(), jnp.float32)
        j = jnp.asarray(jj.ravel(), jnp.float32)
        o, d = jcam.rays_from_uv(i, j, jnp.asarray(c2w), 40.0, 40.0, 31.5,
                                 23.5)
        dep = jnp.asarray(depth)[j.astype(int), i.astype(int)]
        col = jnp.asarray(color)[j.astype(int), i.astype(int)]
        state = jpc.init_cloud(cap, 32, 3)
        index = jpc.build_index(state, self.cell, 1 << 14, 64)
        state, _ = jpc.add_points(state, index, o, d, dep, col,
                                  jnp.ones(o.shape[0], bool),
                                  jnp.full(o.shape[0], 0.04),
                                  jax.random.key(seed + 1), 0.98, 1.02)
        self.jcloud = state
        self.jindex = jpc.build_index(state, self.cell, 1 << 14, 64,
                                      packed_coords)
        self.tcloud = interop.cloud_from_numpy(*to_numpy(tuple(state)))
        self.tindex = interop.index_from_numpy(
            to_numpy(self.jindex._asdict()))


def room_frames(n, h=48, w=64, depth_scale=5000.0, angular_step=0.02):
    """n frames of the furnished synthetic room at h x w (focal 40 at
    48x64, scaled with the size), as a disk dataset stores them: (BGR u8,
    u16 depth at ``depth_scale`` with 5% sensor holes, c2w in the
    datasets' y-down convention)."""
    from point_slam_tpu_torch import datasets as TDS
    from point_slam_tpu_torch.config import load_config
    cfg = load_config(os.path.join(CONFIGS, "Synthetic", "room_furnished.yaml"),
                      os.path.join(CONFIGS, "point_slam.yaml"))
    cfg["cam"].update({"H": h, "W": w, "fx": 40.0 * w / 64,
                       "fy": 40.0 * h / 48, "cx": (w - 1) / 2,
                       "cy": (h - 1) / 2, "crop_edge": 0})
    cfg["synthetic"].update({"n_frames": n, "angular_step": angular_step})
    ds = TDS.Synthetic(cfg)
    frames = []
    for i in range(n):
        _, color, depth = ds[i][:3]
        bgr = np.rint(color[..., ::-1] * 255).astype(np.uint8)
        d16 = np.clip(np.rint(depth * depth_scale), 0, 65535).astype(
            np.uint16)
        d16[np.random.default_rng(i).uniform(size=d16.shape) < 0.05] = 0
        frames.append((bgr, d16, TDS._flip_yz(ds.poses[i])))
    return frames


def write_images(bgr, d16, cpath, dpath):
    import cv2
    cv2.imwrite(cpath, bgr, [cv2.IMWRITE_JPEG_QUALITY, 95]
                if cpath.endswith(".jpg") else [])
    cv2.imwrite(dpath, d16)


def write_replica(root, frames):
    """A Replica-layout directory (results/frame*.jpg, depth*.png,
    traj.txt) at ``root``."""
    os.makedirs(os.path.join(root, "results"))
    lines = []
    for i, (bgr, d16, pose) in enumerate(frames):
        write_images(bgr, d16,
                     os.path.join(root, "results", f"frame{i:06d}.jpg"),
                     os.path.join(root, "results", f"depth{i:06d}.png"))
        lines.append(" ".join(f"{v:.9f}" for v in pose.reshape(-1)))
    with open(os.path.join(root, "traj.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
