"""Alpha compositing for depth-guided volumetric rendering.

Same math as ``point_slam_tpu.common.compositing.raw2outputs``:
alpha = sigmoid(coef * occupancy); weights = alpha * shifted
cumprod(1 - alpha + 1e-10); rgb/depth are normalised by the weight sum
(+1e-10); the depth variance is not.
"""

from __future__ import annotations

import torch


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor,
                rays_d: torch.Tensor, coef: float = 0.1):
    """Composite per-sample (r,g,b,occ) predictions along rays.

    raw (N, S, 4), z_vals (N, S), rays_d (N, 3). Returns depth (N,),
    depth_var (N,), rgb (N,3), weights (N,S).
    """
    rgb = raw[..., :-1]
    alpha = (torch.sigmoid(coef * raw[..., -1]) if coef is not None
             else raw[..., -1])
    shifted = torch.cat(
        [torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1)
    weights = alpha * torch.cumprod(shifted, dim=-1)[..., :-1]

    weights_sum = torch.sum(weights, dim=-1, keepdim=True) + 1e-10
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2) / weights_sum
    depth_map = torch.sum(weights * z_vals, dim=-1) / weights_sum[..., 0]
    tmp = z_vals - depth_map[..., None]
    depth_var = torch.sum(weights * tmp * tmp, dim=-1)
    return depth_map, depth_var, rgb_map, weights
