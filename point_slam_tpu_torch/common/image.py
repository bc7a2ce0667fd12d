"""Image-space ops: grayscale, Sobel gradients, dynamic radius maps, masked
order statistics and the (H,W,5) u8 wire codec (as
``point_slam_tpu.common.image``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from point_slam_tpu_torch.utils import spans

# skimage rgb2gray weights (ITU-R 601-2).
_GRAY_W = (0.2125, 0.7154, 0.0721)
# skimage sobel_h kernel (horizontal edges, gradient along rows), /4.
_SOBEL_H = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float32) / 4.0


def rgb2gray(img: torch.Tensor) -> torch.Tensor:
    """(H,W,3) float RGB -> (H,W) luminance, skimage-compatible."""
    return img.float() @ spans.upload(_GRAY_W, img.device, torch.float32)


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
    k = spans.upload(kernel, img.device)[None, None]
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
    xp = spans.upload(xs, x.device, torch.float32)
    fp = spans.upload(ys, x.device, torch.float32)
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
    middle, sorted[(n-1)//2]; +inf if the mask is empty. Sort-based; on
    CUDA the constant's upload and the index (a 0-dim device tensor, read
    by the indexing) each sync the host."""
    inf = spans.upload(torch.inf, x.device, x.dtype)
    vals, _ = torch.sort(torch.where(mask, x, inf))
    n = mask.sum()
    with spans.span("sync.median"):
        val = vals[torch.clamp(n - 1, min=0) // 2]
    return torch.where(n > 0, val, inf)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = torch.clamp(mask.sum(), min=1)
    return torch.sum(torch.where(mask, x, 0.0)) / n


def masked_max(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.where(mask, x, -torch.inf))


# ---------------------------------------------------------------------------
# Host-side resampling for the disk readers (numpy), with OpenCV's mappings:
# the readers of the JAX package call cv2.resize and cv2.undistort, and the
# port has to give the same bytes without OpenCV.

def resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (INTER_LINEAR) of a float (H,W[,C])
    image: half-pixel centres, source x = (dx+0.5)*scale-0.5 rounded to f32,
    weights (1-f, f) in f32, applied in the image's precision; columns
    clamp at the edges with weight 1, rows through the same weights on the
    clamped row. Exactly 2x smaller in both axes is a 2x2 mean, as OpenCV
    switches to INTER_AREA there. Same size returns ``img``."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img
    sx_scale, sy_scale = 1.0 / (w / sw), 1.0 / (h / sh)
    if sx_scale == 2.0 and sy_scale == 2.0:
        s = img[:2 * h, :2 * w]
        return ((s[0::2, 0::2] + s[0::2, 1::2]) + s[1::2, 0::2]
                + s[1::2, 1::2]) * img.dtype.type(0.25)

    def taps(n_dst, n_src, scale, clamp):
        f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
        i0 = np.floor(f).astype(np.int64)
        f = f - i0.astype(np.float32)
        if clamp:       # columns: outside the image the edge, weight 1
            lo, hi = i0 < 0, i0 >= n_src - 1
            f = np.where(lo | hi, np.float32(0.0), f)
            i0 = np.where(lo, 0, np.where(hi, n_src - 1, i0))
        w0 = (np.float32(1.0) - f).astype(img.dtype)
        return (np.clip(i0, 0, n_src - 1), np.clip(i0 + 1, 0, n_src - 1),
                w0, f.astype(img.dtype))

    x0, x1, wx0, wx1 = taps(w, sw, sx_scale, True)
    y0, y1, wy0, wy1 = taps(h, sh, sy_scale, False)
    shape = (1, -1) + (1,) * (img.ndim - 2)
    # OpenCV's last columns (no right neighbour) take the edge pixel alone
    edge = (x0 == sw - 1).reshape(shape)
    rows = np.where(edge, img[:, x0], img[:, x0] * wx0.reshape(shape)
                    + img[:, x1] * wx1.reshape(shape))
    shape_y = (-1,) + (1,) * (img.ndim - 1)
    return rows[y0] * wy0.reshape(shape_y) + rows[y1] * wy1.reshape(shape_y)


def resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_NEAREST)``: source
    index floor(dst * (1 / (dst_size / src_size))), clamped."""
    sh, sw = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))), sh - 1)
    return img[ys.astype(np.int64)][:, xs.astype(np.int64)]


def undistort(img: np.ndarray, fx: float, fy: float, cx: float, cy: float,
              dist) -> np.ndarray:
    """``cv2.undistort(img, K, dist)`` of a u8 (H,W[,C]) image with new
    K = K and R = I: the forward model (k1, k2, p1, p2[, k3]) maps each
    output pixel to a source point, computed in stripes of 4096 / W rows
    with the principal point shifted per stripe as OpenCV does, quantised
    to 1/32 px (INTER_BITS 5, round half to even); then bilinear taps with
    15-bit fixed-point weights that sum to 32768, taps outside the image
    counting as 0 (BORDER_CONSTANT)."""
    d = np.zeros(5)
    dist = np.asarray(dist, np.float64).ravel()
    d[:min(dist.size, 5)] = dist[:5]
    k1, k2, p1, p2, k3 = d
    h, w = img.shape[:2]
    stripe = min(max(1, 4096 // max(w, 1)), h)
    rows = np.arange(h)
    local = (rows % stripe).astype(np.float64)
    cy_s = cy - (rows - rows % stripe)          # the stripe's new-K cy
    x = ((np.arange(w) * (1.0 / fx) + (-cx / fx))[None, :]
         * np.ones((h, 1)))
    y = (local * (1.0 / fy) + (-cy_s / fy))[:, None] * np.ones((1, w))
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2
    u = fx * xd + cx
    v = fy * yd + cy
    iu = np.rint(u * 32.0).astype(np.int64)
    iv = np.rint(v * 32.0).astype(np.int64)
    sx, ax = iu >> 5, iu & 31
    sy, ay = iv >> 5, iv & 31
    src = img.reshape(h, w, -1).astype(np.int64)
    out = np.zeros(src.shape, np.int64)
    for dy, wy in ((0, 32 - ay), (1, ay)):
        for dx, wx in ((0, 32 - ax), (1, ax)):
            yy, xx = sy + dy, sx + dx
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            tap = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
            out += np.where(ok[..., None], tap, 0) * (wy * wx * 32)[..., None]
    out = np.clip((out + (1 << 14)) >> 15, 0, 255).astype(np.uint8)
    return out.reshape(img.shape)
