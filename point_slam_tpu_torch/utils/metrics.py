"""Image quality metrics: PSNR, MS-SSIM and LPIPS (AlexNet) in PyTorch.

The port of ``point_slam_tpu.utils.metrics``; each metric runs on its
inputs' device. MS-SSIM is the standard Wang et al. construction used by
pytorch_msssim: an 11x11 Gaussian window (sigma 1.5) applied separably,
K=(0.01, 0.03), 5 scales with weights [0.0448, 0.2856, 0.3001, 0.2363,
0.1333], 2x average-pool downsampling, the product of the
contrast-structure terms with the luminance term at the coarsest scale;
smaller images drop scales. LPIPS evaluates AlexNet-LPIPS from a weights
npz (``POINT_SLAM_LPIPS_NPZ`` or ``weights/lpips_alex.npz``) and returns
None when there is none. The convolutions are ``F.conv2d``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
WINDOW = 11

# AlexNet-LPIPS weight file (converted offline by tools/convert_lpips.py);
# the metric runs only when one is present
LPIPS_NPZ_ENV = "POINT_SLAM_LPIPS_NPZ"
_LPIPS_DEFAULT = "weights/lpips_alex.npz"

# the reason eval outputs give when the metric cannot run
LPIPS_UNAVAILABLE = ("unavailable: no AlexNet weights in this image — "
                     "convert them offline with python -m "
                     "point_slam_tpu_torch.tools.convert_lpips and point "
                     "POINT_SLAM_LPIPS_NPZ at the npz")


def _tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float() if device is None else x.to(device).float()
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def psnr(img, ref, mask=None) -> float:
    """PSNR over (optionally masked) pixels, data range 1.0."""
    img = _tensor(img)
    ref = _tensor(ref, img.device)
    diff = (img - ref) ** 2
    if mask is not None:
        mask = _tensor(mask, img.device) > 0
        per_px = diff.mean(-1) if diff.dim() == 3 else diff
        mse = (torch.where(mask, per_px, 0.0).sum()
               / torch.clamp(mask.sum(), min=1))
    else:
        mse = diff.mean()
    return float(-10.0 * torch.log10(mse))


def _gaussian_window(device, size=WINDOW, sigma=1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_sep(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode filtering over (N,C,H,W)."""
    k = win.shape[0]
    n, c, h, w = img.shape
    x = img.reshape(n * c, 1, h, w)
    x = F.conv2d(x, win.reshape(1, 1, k, 1))
    x = F.conv2d(x, win.reshape(1, 1, 1, k))
    return x.reshape(n, c, x.shape[-2], x.shape[-1])


def _ssim_terms(x, y, win, data_range=1.0, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _filter2d_sep(x, win)
    mu_y = _filter2d_sep(y, win)
    mu_xx = _filter2d_sep(x * x, win)
    mu_yy = _filter2d_sep(y * y, win)
    mu_xy = _filter2d_sep(x * y, win)
    sx = mu_xx - mu_x * mu_x
    sy = mu_yy - mu_y * mu_y
    sxy = mu_xy - mu_x * mu_y
    cs = (2 * sxy + c2) / (sx + sy + c2)
    ssim = ((2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)) * cs
    return ssim.mean(), cs.mean()


def ms_ssim(img, ref, data_range=1.0) -> float:
    """img/ref: (H,W,C) in [0, data_range]. Returns scalar MS-SSIM.

    The full 5-scale construction needs min side >= 11 * 2^4 = 176 px;
    smaller images drop scales (weights renormalised so the exponents sum
    to 1; at 5 levels the raw weights, which sum to 1.0001, as
    pytorch_msssim uses them). Images with min side < 11 raise."""
    x = _tensor(img)
    y = _tensor(ref, x.device)
    min_side = min(int(x.shape[0]), int(x.shape[1]))
    if min_side < WINDOW:
        raise ValueError(
            f"ms_ssim needs min(H, W) >= {WINDOW} (got {min_side}): one "
            "11x11 VALID gaussian window must fit at the finest scale")
    levels = 1
    while levels < len(MSSSIM_WEIGHTS) and (min_side >> levels) >= WINDOW:
        levels += 1
    w = torch.tensor(MSSSIM_WEIGHTS[:levels], device=x.device)
    if levels < len(MSSSIM_WEIGHTS):
        w = w / w.sum()
    x = x.permute(2, 0, 1)[None]
    y = y.permute(2, 0, 1)[None]
    win = _gaussian_window(x.device)
    mcs = []
    ssim_val = None
    for i in range(levels):
        ssim_val, cs = _ssim_terms(x, y, win, data_range)
        if i < levels - 1:
            mcs.append(torch.clamp(cs, min=0.0))
            x = F.avg_pool2d(x, 2)
            y = F.avg_pool2d(y, 2)
    val = torch.ones((), device=x.device)
    for m, wi in zip(mcs, w[:-1]):
        val = val * m ** wi
    return float(val * torch.clamp(ssim_val, min=0.0) ** w[-1])


def _conv(x, p, i, stride=1, pad=0):
    return F.conv2d(x, p[f"conv{i}_w"], p[f"conv{i}_b"], stride=stride,
                    padding=pad)


def _lpips_forward(a: torch.Tensor, b: torch.Tensor,
                   p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """LPIPS-alex: relu1..relu5 taps, unit-normalised channels, squared
    differences through the calibrated 1x1 linear heads, spatial mean,
    summed over the taps."""
    shift = p["shift"].reshape(1, 3, 1, 1)
    scale = p["scale"].reshape(1, 3, 1, 1)

    def feats(x):
        x = (2.0 * x - 1.0 - shift) / scale
        x0 = F.relu(_conv(x, p, 0, stride=4, pad=2))
        x1 = F.relu(_conv(F.max_pool2d(x0, 3, 2), p, 1, pad=2))
        x2 = F.relu(_conv(F.max_pool2d(x1, 3, 2), p, 2, pad=1))
        x3 = F.relu(_conv(x2, p, 3, pad=1))
        x4 = F.relu(_conv(x3, p, 4, pad=1))
        return x0, x1, x2, x3, x4

    total = torch.zeros((), device=a.device)
    for i, (xa, xb) in enumerate(zip(feats(a), feats(b))):
        na = xa / torch.sqrt((xa * xa).sum(1, keepdim=True) + 1e-10)
        nb = xb / torch.sqrt((xb * xb).sum(1, keepdim=True) + 1e-10)
        lin = p[f"lin{i}_w"].reshape(1, -1, 1, 1)
        total = total + ((na - nb) ** 2 * lin).sum(1).mean()
    return total


def lpips_weights_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.environ.get(LPIPS_NPZ_ENV, os.path.join(here, _LPIPS_DEFAULT))


def load_lpips_params(device="cpu") -> Optional[Dict[str, torch.Tensor]]:
    """The AlexNet-LPIPS weights on ``device``, or None without a file."""
    path = lpips_weights_path()
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k], dtype=torch.float32, device=device)
                for k in z.files}


def lpips_available() -> bool:
    """True iff a converted weights npz is present."""
    return os.path.exists(lpips_weights_path())


def lpips(img, ref, params: Optional[Dict[str, torch.Tensor]] = None
          ) -> Optional[float]:
    """LPIPS (AlexNet) of (H,W,3) images in [0,1], or None when no weights
    are available. ``params``: weights already on the images' device
    (``load_lpips_params``); read from the npz otherwise."""
    a = torch.clamp(_tensor(img), 0, 1).permute(2, 0, 1)[None]
    b = torch.clamp(_tensor(ref, a.device), 0, 1).permute(2, 0, 1)[None]
    if params is None:
        params = load_lpips_params(a.device)
        if params is None:
            return None
    return float(_lpips_forward(a, b, params))
