"""Image-space ops: grayscale, Sobel gradients, dynamic radius maps, masked
order statistics and the (H,W,5) u8 wire codec (as
``point_slam_tpu.common.image``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# skimage rgb2gray weights (ITU-R 601-2).
_GRAY_W = (0.2125, 0.7154, 0.0721)
# skimage sobel_h kernel (horizontal edges, gradient along rows), /4.
_SOBEL_H = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float32) / 4.0


def rgb2gray(img: torch.Tensor) -> torch.Tensor:
    """(H,W,3) float RGB -> (H,W) luminance, skimage-compatible."""
    return img.float() @ torch.tensor(_GRAY_W, dtype=torch.float32,
                                      device=img.device)


def decode_wire_frame(packed: torch.Tensor, depth_inv_scale: float):
    """(H,W,5) u8 wire frame -> (color f32 [0,1], depth f32 metres).

    Channels 0..2 are u8 colour, 3..4 the little-endian bytes of u16 depth;
    the same f32 multiplies as the host decode ``datasets.dequantize_wire``.
    """
    color = packed[..., :3].float() * np.float32(1.0 / 255.0)
    du16 = packed[..., 3].int() | (packed[..., 4].int() << 8)
    return color, du16.float() * np.float32(depth_inv_scale)


def encode_wire_frame(color: torch.Tensor, depth: torch.Tensor,
                      depth_scale: float) -> torch.Tensor:
    """Inverse of decode_wire_frame: f32 color/depth -> (H,W,5) u8. Exact
    round trip for values on the sensor lattice (every frame the SLAM loop
    sees, since the dataset quantises at the source)."""
    cu8 = torch.clamp(torch.round(color * np.float32(255.0)), 0, 255
                      ).to(torch.uint8)
    du = torch.clamp(torch.round(depth * np.float32(depth_scale)), 0, 65535
                     ).to(torch.int32)
    lo = (du & 0xFF).to(torch.uint8)
    hi = (du >> 8).to(torch.uint8)
    return torch.cat([cu8, lo[..., None], hi[..., None]], dim=-1)


def _conv2_reflect(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """2D correlation with edge-duplicating padding (scipy 'reflect' ==
    numpy 'symmetric', which at width 1 is torch 'replicate')."""
    k = torch.as_tensor(kernel, device=img.device)[None, None]
    padded = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")
    return F.conv2d(padded, k)[0, 0]


def sobel_h(img: torch.Tensor) -> torch.Tensor:
    return _conv2_reflect(img, _SOBEL_H)


def sobel_v(img: torch.Tensor) -> torch.Tensor:
    return _conv2_reflect(img, np.ascontiguousarray(_SOBEL_H.T))


def color_gradient_magnitude(color: torch.Tensor) -> torch.Tensor:
    """|grad gray(color)| via Sobel, (H,W)."""
    intensity = rgb2gray(color)
    gy = sobel_h(intensity)
    gx = sobel_v(intensity)
    return torch.sqrt(gx * gx + gy * gy)


def piecewise_linear(x: torch.Tensor, xs, ys) -> torch.Tensor:
    """``jnp.interp`` over the breakpoints (xs, ys), clamped at both ends."""
    xp = torch.tensor(xs, dtype=torch.float32, device=x.device)
    fp = torch.tensor(ys, dtype=torch.float32, device=x.device)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, len(xs) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.spacing(np.finfo(np.float32).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def dynamic_radius_maps(color: torch.Tensor, radius_add_max: float,
                        radius_add_min: float, radius_query_ratio: float,
                        color_grad_threshold: float):
    """Per-pixel (r_add, r_query) from colour gradients: the gradient
    magnitude clipped to [0, thr] through the ramp
    [0, 0.01, thr] -> [r_max, r_max, r_min] (times the ratio for query)."""
    g = torch.clamp(color_gradient_magnitude(color), 0.0,
                    color_grad_threshold)
    xs = [0.0, 0.01, color_grad_threshold]
    r_add = piecewise_linear(
        g, xs, [radius_add_max, radius_add_max, radius_add_min])
    r_query = piecewise_linear(
        g, xs, [radius_query_ratio * radius_add_max,
                radius_query_ratio * radius_add_max,
                radius_query_ratio * radius_add_min])
    return r_add, r_query


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over masked entries with torch.median semantics: the LOWER
    middle, sorted[(n-1)//2]; +inf if the mask is empty. Sort-based and
    free of host syncs (the index stays a device tensor)."""
    inf = torch.tensor(torch.inf, dtype=x.dtype, device=x.device)
    vals, _ = torch.sort(torch.where(mask, x, inf))
    n = mask.sum()
    val = vals[torch.clamp(n - 1, min=0) // 2]
    return torch.where(n > 0, val, inf)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = torch.clamp(mask.sum(), min=1)
    return torch.sum(torch.where(mask, x, 0.0)) / n


def masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.where(mask, x, -torch.inf))
