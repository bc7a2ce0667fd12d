"""TSDF fusion on the device in PyTorch.

The port of ``point_slam_tpu.tools.tsdf``: weighted-average truncated
signed distance integration over a dense axis-aligned grid bounded by the
observed scene (the reference integrates rendered RGB-D at voxel 5/512 m,
trunc 0.04 m, depth_trunc 30). The grids live on the device; each frame is
integrated in chunks of ``chunk`` voxels; extraction quantises the grids
for the device -> host copy and runs marching tetrahedra on the host
(tools/marching.py).

Camera model: the framework's x-right / y-up / z-back convention.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from point_slam_tpu_torch.common.camera import project_points


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('TSDFVolume: CUDA is not available on this host; '
                           'pass device="cpu" to fuse on the host instead')
    return device


class TSDFVolume:
    def __init__(self, origin, dims, voxel: float = 5.0 / 512.0,
                 sdf_trunc: float = 0.04, depth_trunc: float = 30.0,
                 normal_weighting: bool = False, device="cuda"):
        """``device``: "cuda" (the default) or another torch device; the
        grids live there."""
        self.device = _device(device)
        self.origin = np.asarray(origin, np.float32)
        self.dims = tuple(int(d) for d in dims)
        self.voxel = float(voxel)
        self.trunc = float(sdf_trunc)
        self.depth_trunc = float(depth_trunc)
        # cos(view angle) integration weights: slanted observations carry a
        # depth-direction bias up to trunc*(1/cos-1), so down-weighting them
        # sharpens oblique walls. Off by default, as in the reference.
        self.normal_weighting = bool(normal_weighting)
        n = int(np.prod(self.dims))
        self.tsdf = torch.zeros(n, device=self.device)
        self.weight = torch.zeros(n, device=self.device)
        self.color = torch.zeros((n, 3), device=self.device)
        self.chunk = 1 << 22

    @classmethod
    def from_bounds(cls, lo, hi, voxel=5.0 / 512.0, sdf_trunc=0.04,
                    margin=0.1, normal_weighting: bool = False,
                    device="cuda"):
        lo = np.asarray(lo, np.float64) - margin
        hi = np.asarray(hi, np.float64) + margin
        dims = np.maximum(np.ceil((hi - lo) / voxel).astype(int) + 1, 2)
        return cls(lo, dims, voxel, sdf_trunc,
                   normal_weighting=normal_weighting, device=device)

    def _centers(self, start: int, size: int) -> torch.Tensor:
        _, ny, nz = self.dims
        idx = torch.arange(start, start + size, device=self.device)
        grid = torch.stack([idx // (ny * nz), (idx // nz) % ny, idx % nz],
                           -1).float()
        return grid * self.voxel + torch.as_tensor(self.origin,
                                                   device=self.device)

    def integrate(self, depth, color, c2w, fx, fy, cx, cy) -> None:
        """Fuse one RGB-D frame (depth (H,W) meters, color (H,W,3) [0,1];
        numpy arrays or tensors)."""
        dev = self.device
        w2c = torch.as_tensor(
            np.linalg.inv(np.asarray(c2w, np.float64)).astype(np.float32),
            device=dev)
        depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
        color = torch.as_tensor(color, dtype=torch.float32, device=dev)
        fx, fy, cx, cy = float(fx), float(fy), float(cx), float(cy)
        wmap = (cos_weight_map(depth, fx, fy, cx, cy)
                if self.normal_weighting else torch.ones_like(depth))
        n = self.tsdf.shape[0]
        for start in range(0, n, self.chunk):
            sl = slice(start, min(start + self.chunk, n))
            _integrate_chunk(self.tsdf[sl], self.weight[sl], self.color[sl],
                             self._centers(start, sl.stop - start), w2c,
                             depth, color, wmap, fx, fy, cx, cy, self.trunc,
                             self.depth_trunc)

    def wire_grids(self):
        """The grids quantised for the host copy: tsdf, a weighted mean in
        [-1, 1], as i16 (vertex error trunc/32767); weight, read only as
        > 0, as u8; colour, a weighted mean in [0, 1], as u8 (the PLY's
        precision). 20 bytes a voxel become 6."""
        sdf16 = torch.round(torch.clamp(self.tsdf, -1.0, 1.0) * 32767.0
                            ).to(torch.int16)
        wgt8 = (self.weight > 0).to(torch.uint8)
        col8 = torch.round(torch.clamp(self.color, 0.0, 1.0) * 255.0
                           ).to(torch.uint8)
        return sdf16, wgt8, col8

    def extract_mesh(self, min_component_verts: Optional[int] = None):
        """Marching tetrahedra over the observed voxels, on the host (the
        native library). Returns (verts, faces, colors)."""
        from point_slam_tpu_torch.tools.marching import (
            connected_components_filter, marching_tetrahedra)
        sdf16, wgt8, col8 = (g.cpu().numpy() for g in self.wire_grids())
        sdf = (sdf16.astype(np.float32) / 32767.0).reshape(self.dims)
        wgt = wgt8.reshape(self.dims)
        col = (col8.astype(np.float32) / 255.0).reshape(self.dims + (3,))
        verts, faces, vcols = marching_tetrahedra(
            sdf, 0.0, self.origin, self.voxel, weight=wgt, color=col)
        if min_component_verts and len(verts):
            verts, faces, keep = connected_components_filter(
                verts, faces, min_component_verts)
            if vcols is not None:
                vcols = vcols[keep]
        return verts, faces, vcols


def cos_weight_map(depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Per-pixel |cos| between the surface normal (from depth-image finite
    differences) and the viewing ray, floored at 0.1 so every observation
    still contributes. Invalid-depth neighbourhoods fall back to weight 1."""
    h, w = depth.shape
    jj, ii = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij")
    dirs = torch.stack([(ii - cx) / fx, -(jj - cy) / fy,
                        -torch.ones_like(ii)], -1)
    pts = dirs * depth[..., None]                            # camera space
    dx = torch.roll(pts, -1, dims=1) - torch.roll(pts, 1, dims=1)
    dy = torch.roll(pts, -1, dims=0) - torch.roll(pts, 1, dims=0)
    nrm = torch.linalg.cross(dx, dy)
    nlen = torch.linalg.norm(nrm, dim=-1)
    view = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    cos = torch.abs((nrm * view).sum(-1)) / torch.clamp(nlen, min=1e-12)
    ok = ((depth > 0)
          & (torch.roll(depth, -1, 1) > 0) & (torch.roll(depth, 1, 1) > 0)
          & (torch.roll(depth, -1, 0) > 0) & (torch.roll(depth, 1, 0) > 0)
          & (nlen > 1e-12))
    return torch.where(ok, torch.clamp(cos, min=0.1), 1.0)


def _integrate_chunk(tsdf, weight, color_acc, centers, w2c, depth_img,
                     color_img, wmap, fx, fy, cx, cy, trunc, depth_trunc):
    """Fold one frame into a chunk of the grids (views, updated in place)."""
    h, w = depth_img.shape
    u, v, z = project_points(centers, w2c, fx, fy, cx, cy)
    ui = torch.round(u).long()
    vi = torch.round(v).long()
    inside = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (z < 0)
    ui = torch.clamp(ui, 0, w - 1)
    vi = torch.clamp(vi, 0, h - 1)
    d = depth_img[vi, ui]
    sdf = d + z
    valid = inside & (d > 0) & (d < depth_trunc) & (sdf >= -trunc)
    tsdf_new = torch.clamp(sdf / trunc, max=1.0)
    w_obs = wmap[vi, ui]
    w_new = weight + w_obs
    t_out = torch.where(valid, (tsdf * weight + tsdf_new * w_obs) / w_new,
                        tsdf)
    c_pix = color_img[vi, ui]
    c_out = torch.where(valid[:, None],
                        (color_acc * weight[:, None] + c_pix * w_obs[:, None])
                        / w_new[:, None], color_acc)
    w_out = torch.where(valid, w_new, weight)
    tsdf.copy_(t_out)
    weight.copy_(w_out)
    color_acc.copy_(c_out)
