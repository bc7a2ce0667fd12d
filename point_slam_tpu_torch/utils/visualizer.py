"""In-run visualisation: 2x3 panels of the sensor and the rendered frame.

The port of ``point_slam_tpu.utils.visualizer``, with its firing rules: a
panel fires at frames ``idx % vis_freq == 0``, at the last iteration of
the loop, or with ``vis_inside`` at iterations ``it % vis_inside_freq ==
0`` (``should_fire``); the loops' hooks fire between chunks through
``vis_chunk``. A panel re-renders the whole frame from the current map
with the mapper's render config, under ``torch.no_grad`` and from its own
random stream (seed 0 each render, as the JAX package's ``key(0)``), so
turning visualisation on changes no draw of the run.

The panel is drawn here, without matplotlib: sensor depth, rendered depth,
depth residual (top row, matplotlib's ``plasma`` with vmin 0 and vmax the
sensor's largest depth, its lookup rule included), input rgb, rendered rgb,
rgb residual (bottom row, clipped to [0, 1], u8 by truncation as
matplotlib's ``imshow`` converts), residuals zero where the sensor has no
depth, each tile at full resolution. It is saved as
``<vis_dir>/{idx:05d}_{it:04d}.png`` (the JAX package saves a titled
matplotlib figure as .jpg); ``save_rendered_image`` also writes the
rendered colour as ``<img_dir>/frame_{idx:05d}.png``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from point_slam_tpu_torch import renderer as R
from point_slam_tpu_torch.utils.plasma import PLASMA
from point_slam_tpu_torch.utils.png import write_png

# plasma as matplotlib's bytes=True lookup table: (256, 3) u8, truncated
_PLASMA_U8 = (np.asarray(PLASMA, np.float64) * 255).astype(np.uint8)
_PNG_LEVEL = 1      # zlib level: a 680x1200 panel is 1360x3600 pixels


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plasma_u8(x: np.ndarray, vmax: float) -> np.ndarray:
    """(H,W) -> (H,W,3) u8: matplotlib's ``plasma`` at
    Normalize(0, vmax), with its rounding (f32 data divided in f64) and
    lookup (index int(x*256) in [0, 255], values below 0 the first colour,
    NaN black)."""
    x = np.asarray(x, np.float32)
    xa = (x.astype(np.float64) / vmax).astype(np.float32) * np.float32(256)
    xa[xa == 256] = 255
    nan = np.isnan(xa)
    idx = np.clip(np.where(nan, 0, xa), 0, 255).astype(np.int64)
    out = _PLASMA_U8[idx]
    out[nan] = 0
    return out


def rgb_u8(x: np.ndarray) -> np.ndarray:
    """(H,W,3) colour in [0, 1] (clipped) -> u8 by truncation."""
    return (np.clip(np.asarray(x, np.float32), 0, 1)
            * np.float32(255)).astype(np.uint8)


def panel(gt_depth, gt_color, depth, color) -> np.ndarray:
    """The (2H, 3W, 3) u8 panel of one frame (see the module)."""
    gt_depth = np.asarray(gt_depth, np.float32)
    gt_color = np.asarray(gt_color, np.float32)
    depth_res = np.abs(gt_depth - depth)
    depth_res[gt_depth == 0] = 0
    color_res = np.abs(gt_color - np.clip(color, 0, 1))
    color_res[gt_depth == 0] = 0
    vmax = max(float(gt_depth.max()), 1e-3)
    top = [plasma_u8(d, vmax) for d in (gt_depth, depth, depth_res)]
    bottom = [rgb_u8(c) for c in (gt_color, color, color_res)]
    return np.concatenate([np.concatenate(top, axis=1),
                           np.concatenate(bottom, axis=1)], axis=0)


class Visualizer:
    def __init__(self, freq: int, inside_freq: int, vis_dir: str,
                 verbose: bool = False, vis_inside: bool = False,
                 img_dir: Optional[str] = None):
        self.freq = max(freq, 1)
        self.inside_freq = max(inside_freq, 1)
        self.vis_dir = vis_dir
        self.img_dir = img_dir
        self.verbose = verbose
        self.vis_inside = vis_inside
        os.makedirs(vis_dir, exist_ok=True)
        if img_dir:
            os.makedirs(img_dir, exist_ok=True)

    def should_fire(self, idx: int, it: int, total_iters: int,
                    freq_override: bool = False) -> bool:
        if freq_override:
            return True
        if self.vis_inside:
            return idx % self.freq == 0 and it % self.inside_freq == 0
        return idx % self.freq == 0 and it == total_iters - 1

    def vis_chunk(self, idx: int, it_prev: int, it_now: int, total: int,
                  mapper, c2w, gt_depth, gt_color) -> Optional[str]:
        """A vis_inside panel between chunks [it_prev, it_now) of a loop:
        once, at the largest multiple of inside_freq below it_now, if that
        lies in the chunk."""
        if not self.vis_inside or idx % self.freq != 0:
            return None
        m = (max(it_now, 1) - 1) // self.inside_freq * self.inside_freq
        if m < it_prev:
            return None
        return self.vis(idx, m, total, mapper, c2w, gt_depth, gt_color,
                        freq_override=True)

    def render_frame(self, mapper, c2w, gt_depth, gt_color,
                     generator: Optional[torch.Generator] = None,
                     r_query=None):
        """The whole frame rendered from the mapper's current state:
        (depth (H,W), uncertainty (H,W), colour (H,W,3)) device tensors."""
        cam = mapper.cfg["cam"]
        dev = mapper.device
        depth = torch.as_tensor(gt_depth, device=dev)
        if r_query is None:
            r_query = mapper.radius_maps(torch.as_tensor(gt_color,
                                                         device=dev))[1]
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return R.render_img(
            mapper.decoders, mapper.cloud, mapper.index,
            torch.as_tensor(c2w, dtype=torch.float32, device=dev),
            (cam["fx"], cam["fy"], cam["cx"], cam["cy"]),
            (cam["H"], cam["W"]), mapper.rc, gt_depth=depth,
            r_query=r_query, generator=generator)

    def vis_value_only(self, mapper, c2w, gt_depth, gt_color,
                       generator: Optional[torch.Generator] = None):
        dep, _, col = self.render_frame(mapper, c2w, gt_depth, gt_color,
                                        generator)
        return dep, col

    def vis(self, idx: int, it: int, total_iters: int, mapper, c2w,
            gt_depth, gt_color, freq_override: bool = False,
            save_rendered_image: bool = False,
            r_query=None) -> Optional[str]:
        """Render and write the panel if it fires; returns its path."""
        if not self.should_fire(idx, it, total_iters, freq_override):
            return None
        dep, _, col = self.render_frame(mapper, c2w, gt_depth, gt_color,
                                        r_query=r_query)
        col = _host(col)
        out = os.path.join(self.vis_dir, f"{idx:05d}_{it:04d}.png")
        write_png(out, panel(_host(gt_depth), _host(gt_color), _host(dep),
                             col), _PNG_LEVEL)
        if save_rendered_image and self.img_dir:
            write_png(os.path.join(self.img_dir, f"frame_{idx:05d}.png"),
                      rgb_u8(col), _PNG_LEVEL)
        if self.verbose:
            print(f"saved visualization {out}", flush=True)
        return out
