"""Pixel/ray sampling for the optimisation loops (fixed-size batches).

As ``point_slam_tpu.common.sampling``: every sampler returns fixed-size
batches plus validity masks, so losses are masked sums. Every random draw
comes from a ``torch.Generator`` the caller owns, or is passed in.
"""

from __future__ import annotations

import torch


def sample_pixels_uniform(h0: int, h1: int, w0: int, w1: int, n: int,
                          generator: torch.Generator, device):
    """n pixel coords (i=cols float, j=rows float), uniform with
    replacement from [h0,h1) x [w0,w1)."""
    i = torch.randint(w0, w1, (n,), generator=generator, device=device)
    j = torch.randint(h0, h1, (n,), generator=generator, device=device)
    return i.float(), j.float()


def gather_pixels(img: torch.Tensor, i: torch.Tensor, j: torch.Tensor):
    """img (H,W,...) values at integer pixel coords (i=cols, j=rows)."""
    return img[j.long(), i.long()]


def top_gradient_candidates(grad_mag: torch.Tensor, h0: int, h1: int,
                            w0: int, w1: int, n_top: int,
                            depth: torch.Tensor | None = None,
                            depth_limit: float | None = None):
    """Flat indices of the globally top-n_top gradient pixels, with a mask
    for those inside the region (and depth-valid). (n_top,), (n_top,)."""
    h, w = grad_mag.shape
    _, idx = torch.topk(grad_mag.reshape(-1), n_top)
    jj = idx // w
    ii = idx % w
    valid = (jj >= h0) & (jj < h1) & (ii >= w0) & (ii < w1)
    if depth is not None:
        dvals = depth.reshape(-1)[idx]
        if depth_limit is not None:
            valid &= (dvals <= depth_limit) & (dvals > 0)
        else:
            valid &= dvals > 0
    return idx, valid


def choose_without_replacement(valid: torch.Tensor, n: int,
                               generator: torch.Generator | None = None,
                               scores: torch.Tensor | None = None):
    """Pick n distinct positions among the valid entries, uniformly: random
    scores, invalid -> -inf, take the top n. ``scores`` may be passed in
    (same shape as ``valid``). Returns (positions (n,), ok (n,))."""
    if scores is None:
        scores = torch.rand(valid.shape, generator=generator,
                            device=valid.device)
    scores = torch.where(valid, scores, -torch.inf)
    _, pos = torch.topk(scores, n)
    return pos, valid[pos]


def flat_to_ij(flat_idx: torch.Tensor, w: int):
    """Flat image index -> (i cols float, j rows float)."""
    return (flat_idx % w).float(), (flat_idx // w).float()
