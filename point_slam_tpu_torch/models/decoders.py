"""Neural point decoders: geometry and colour MLPs with Gaussian Fourier
positional embeddings and distance-weighted neighbour feature interpolation.

The port of ``point_slam_tpu.models.decoders`` as ``nn.Module``s with the
JAX parameter tree's names (``pts_linears``, ``fc_c``, ``output_linear``,
``embedder_B``, ...), so ``interop.decoders_from_numpy`` and
``pretrained/middle_fine.npz`` load one to one. A JAX ``_linear`` computes
``x @ W + b`` with W (in, out); ``nn.Linear`` holds W (out, in).

* ``GeoDecoder``: 5 blocks, hidden 32, skip concat after block 2, per-block
  feature injection ``h + fc_c[i](c)``, ReLU, learnable sin-only Fourier
  embedding (3 -> 93, scale 25).
* ``ColorDecoder``: 5 blocks, hidden 128, fixed sin+cos Fourier embedding
  (3 -> 40, scale 32), Softplus(beta=100), the relative-position
  neighbour encoder F_theta (``mlp_col_neighbor``) and, with
  ``model.encode_exposure``, the exposure MLP (``mlp_exposure``) that maps a
  per-keyframe latent to a 3x3 + 3 colour affine. With
  ``model.use_view_direction`` the unit view direction joins the point
  embedding (at the input and at the skip): its own fixed Fourier
  embedding (``embedder_view_B``, 3 -> 40) with ``model.encode_viewd``,
  else the 3 raw components.

The kNN runs outside (ops/knn.py), so one search feeds both decoders.

``precision="default"`` (``cuda.mlp_precision``) runs the MLP blocks'
linears (``pts_linears``, ``fc_c``, ``output_linear``,
``mlp_col_neighbor``) in TF32 on CUDA, forward and backward, as a JAX dot
at precision DEFAULT runs its transposes; the Fourier embeddings and the
exposure MLP stay IEEE f32. On the CPU it changes nothing.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

C_DIM = 32
GEO_HIDDEN = 32
COL_HIDDEN = 128
N_BLOCKS = 5
SKIP = 2
GEO_EMB = 93     # sin-only -> 93 features
COL_EMB = 20     # sin+cos -> 40 features
REL_EMB = 10     # sin+cos -> 20 features


def _dense(in_dim, out_dim, activation="relu", generator=None) -> nn.Linear:
    """DenseLayer: xavier-uniform weight with the activation's gain, zero
    bias."""
    lin = nn.Linear(in_dim, out_dim)
    gain = math.sqrt(2.0) if activation == "relu" else 1.0
    bound = gain * math.sqrt(6.0 / (in_dim + out_dim))
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        lin.bias.zero_()
    return lin


def _torch_linear(in_dim, out_dim, generator=None) -> nn.Linear:
    """nn.Linear's default init (U(+-1/sqrt(in))), drawn from ``generator``."""
    lin = nn.Linear(in_dim, out_dim)
    bound = 1.0 / math.sqrt(in_dim)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


def _xavier_w_torch_b(in_dim, out_dim, generator=None) -> nn.Linear:
    lin = _torch_linear(in_dim, out_dim, generator)
    bound = math.sqrt(6.0 / (in_dim + out_dim))
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
    return lin


def _normal_w_torch_b(in_dim, out_dim, std=0.01, generator=None) -> nn.Linear:
    """N(0, std^2) weight, nn.Linear's default bias (the exposure MLP)."""
    lin = _torch_linear(in_dim, out_dim, generator)
    with torch.no_grad():
        lin.weight.normal_(0.0, std, generator=generator)
    return lin


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """torch.nn.Softplus(beta=100): log1p(exp(100 x)) / 100, and x itself
    where 100 x > 20."""
    return F.softplus(x, beta=100.0, threshold=20.0)


def fourier_embed(B: torch.Tensor, x: torch.Tensor, concat: bool):
    """Gaussian Fourier features: sin(2*pi*x @ B) (+cos)."""
    proj = (2.0 * math.pi * x) @ B
    if concat:
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
    return torch.sin(proj)


@contextlib.contextmanager
def _tf32():
    """TF32 for CUDA matmuls inside the block (a process-wide switch); the
    previous setting is back on exit, an exception's too."""
    m = torch.backends.cuda.matmul
    was = m.allow_tf32
    m.allow_tf32 = True
    try:
        yield
    finally:
        m.allow_tf32 = was


class _TF32Linear(torch.autograd.Function):
    """x @ W^T + b with the forward and the backward matmuls in TF32."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        with _tf32():
            return F.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        g2 = g.reshape(-1, g.shape[-1])
        gx = gw = gb = None
        with _tf32():
            if need_x:
                gx = g @ weight
            if need_w:
                gw = g2.t() @ x.reshape(-1, x.shape[-1])
        if need_b:
            gb = g2.sum(0)
        return gx, gw, gb


def _linear(lin: nn.Linear, x: torch.Tensor,
            precision: Optional[str] = None) -> torch.Tensor:
    """One MLP-block linear at ``precision`` (see the module)."""
    if precision == "default" and x.is_cuda:
        return _TF32Linear.apply(x, lin.weight, lin.bias)
    return lin(x)


def _block_dims(emb: int, hidden: int):
    return [(emb, hidden)] + [(hidden + emb if i == SKIP else hidden, hidden)
                              for i in range(N_BLOCKS - 1)]


def _mlp_forward(pts_linears, fc_c, emb, c, act, precision=None):
    h = emb
    for i in range(N_BLOCKS):
        h = act(_linear(pts_linears[i], h, precision))
        h = h + _linear(fc_c[i], c, precision)
        if i == SKIP:
            h = torch.cat([emb, h], dim=-1)
    return h


class GeoDecoder(nn.Module):
    """Occupancy logits for points p given interpolated features c."""

    def __init__(self, c_dim: int = C_DIM, generator=None):
        super().__init__()
        self.embedder_B = nn.Parameter(
            25.0 * torch.randn(3, GEO_EMB, generator=generator))
        self.pts_linears = nn.ModuleList(
            [_dense(i, o, generator=generator)
             for i, o in _block_dims(GEO_EMB, GEO_HIDDEN)])
        self.fc_c = nn.ModuleList([_torch_linear(c_dim, GEO_HIDDEN, generator)
                                   for _ in range(N_BLOCKS)])
        self.output_linear = _dense(GEO_HIDDEN, 1, "relu", generator)

    def forward(self, p: torch.Tensor, c: torch.Tensor,
                precision: Optional[str] = None) -> torch.Tensor:
        emb = fourier_embed(self.embedder_B, p, concat=False)
        h = _mlp_forward(self.pts_linears, self.fc_c, emb, c, torch.relu,
                         precision)
        return _linear(self.output_linear, h, precision)[..., 0]


class ColorDecoder(nn.Module):
    """RGB for points p; ``encode_neighbor_feats`` is F_theta."""

    def __init__(self, c_dim: int = C_DIM, use_view_direction: bool = False,
                 exposure_dim: int = 0, generator=None,
                 encode_viewd: bool = False):
        super().__init__()
        emb_in = 2 * COL_EMB
        if use_view_direction:
            emb_in += 2 * COL_EMB if encode_viewd else 3
        # fixed (never learned): a buffer, where JAX applies stop_gradient
        self.register_buffer(
            "embedder_B", 32.0 * torch.randn(3, COL_EMB, generator=generator))
        self.embedder_rel_B = nn.Parameter(
            32.0 * torch.randn(3, REL_EMB, generator=generator))
        self.mlp_col_neighbor = nn.ModuleDict({
            "l1": _xavier_w_torch_b(c_dim + 2 * REL_EMB, COL_HIDDEN, generator),
            "l2": _xavier_w_torch_b(COL_HIDDEN, c_dim, generator)})
        self.pts_linears = nn.ModuleList(
            [_dense(i, o, generator=generator)
             for i, o in _block_dims(emb_in, COL_HIDDEN)])
        self.fc_c = nn.ModuleList([_torch_linear(c_dim, COL_HIDDEN, generator)
                                   for _ in range(N_BLOCKS)])
        self.output_linear = _dense(COL_HIDDEN, 3, "linear", generator)
        if use_view_direction and encode_viewd:
            self.register_buffer("embedder_view_B", 32.0 * torch.randn(
                3, COL_EMB, generator=generator))
        if exposure_dim:
            self.mlp_exposure = nn.ModuleDict({
                "l1": _normal_w_torch_b(exposure_dim, COL_HIDDEN,
                                        generator=generator),
                "l2": _normal_w_torch_b(COL_HIDDEN, 12, generator=generator)})

    def forward(self, p: torch.Tensor, c: torch.Tensor,
                apply_sigmoid: bool = True,
                exposure_feat: torch.Tensor | None = None,
                views_d: torch.Tensor | None = None,
                precision: Optional[str] = None) -> torch.Tensor:
        """RGB (N, 3). ``views_d`` (N, 3): the samples' view directions
        (with ``use_view_direction``), normalised here. With
        ``exposure_feat`` (one latent) the exposure affine is applied, then
        the sigmoid."""
        emb = fourier_embed(self.embedder_B, p, concat=True)
        if views_d is not None:
            vnorm = views_d / torch.clamp(
                torch.linalg.norm(views_d, dim=-1, keepdim=True), min=1e-12)
            if hasattr(self, "embedder_view_B"):
                vnorm = fourier_embed(self.embedder_view_B, vnorm,
                                      concat=True)
            emb = torch.cat([emb, vnorm], dim=-1)
        h = _mlp_forward(self.pts_linears, self.fc_c, emb, c, softplus100,
                         precision)
        out = _linear(self.output_linear, h, precision)
        if exposure_feat is not None:
            rot, trans = self.exposure_affine(exposure_feat)
            return torch.sigmoid(out @ rot + trans)
        return torch.sigmoid(out) if apply_sigmoid else out

    def exposure_affine(self, exposure_feat: torch.Tensor):
        """Exposure latent(s) (..., dim) -> (rot (..., 3, 3), trans (..., 3))."""
        mp = self.mlp_exposure
        aff = mp["l2"](softplus100(mp["l1"](exposure_feat)))
        return aff[..., :9].reshape(*aff.shape[:-1], 3, 3), aff[..., 9:]

    def encode_neighbor_feats(self, neighbor_pos: torch.Tensor,
                              p: torch.Tensor, neighbor_feats: torch.Tensor,
                              precision: Optional[str] = None
                              ) -> torch.Tensor:
        """F_theta: (N,K,c) neighbour features + relative-position Fourier
        encoding -> (N,K,c)."""
        rel = neighbor_pos - p[:, None, :]
        emb = fourier_embed(self.embedder_rel_B, rel.reshape(-1, 3),
                            concat=True)
        emb = emb.reshape(neighbor_pos.shape[0], -1, 2 * REL_EMB)
        x = torch.cat([emb, neighbor_feats], dim=-1)
        mp = self.mlp_col_neighbor
        return _linear(mp["l2"], softplus100(_linear(mp["l1"], x, precision)),
                       precision)


class Decoders(nn.Module):
    """The geometry and colour decoders (the JAX {"geo", "col"} tree)."""

    def __init__(self, cfg: Dict[str, Any], generator=None):
        super().__init__()
        m = cfg["model"]
        if m["c_dim"] != C_DIM:
            raise NotImplementedError("the packed cloud layout is fixed at "
                                      f"c_dim={C_DIM}")
        self.geo = GeoDecoder(C_DIM, generator)
        self.col = ColorDecoder(
            C_DIM, bool(m.get("use_view_direction")),
            int(m["exposure_dim"]) if m.get("encode_exposure") else 0,
            generator, bool(m.get("encode_viewd")))


def init_decoders(cfg: Dict[str, Any], seed: int, device="cpu") -> Decoders:
    """Decoders with the JAX package's init distributions, drawn from a
    generator seeded with ``seed`` (the numbers differ from jax.random)."""
    g = torch.Generator().manual_seed(int(seed))
    return Decoders(cfg, generator=g).to(device)


def load_pretrained_geo(dec: Decoders, path: str) -> Decoders:
    """Load a converted NICE-SLAM 'middle' decoder (npz with
    pts_linears.{i}.{weight,bias}, fc_c.{i}.{weight,bias},
    output_linear.{weight,bias}, embedder._B) into the geometry MLP, in
    place. Arrays of another shape are skipped; a missing file changes
    nothing."""
    if not path or not os.path.exists(path):
        return dec
    data = dict(np.load(path))
    geo = dec.geo

    def put(lin: nn.Linear, name: str):
        for attr in ("weight", "bias"):
            arr = data.get(f"{name}.{attr}")
            dst = getattr(lin, attr)
            if arr is not None and tuple(arr.shape) == tuple(dst.shape):
                with torch.no_grad():
                    dst.copy_(torch.from_numpy(arr))

    for i in range(N_BLOCKS):
        put(geo.pts_linears[i], f"pts_linears.{i}")
        put(geo.fc_c[i], f"fc_c.{i}")
    put(geo.output_linear, "output_linear")
    b = data.get("embedder._B")
    if b is not None and b.shape == (3, GEO_EMB):
        with torch.no_grad():
            geo.embedder_B.copy_(torch.from_numpy(b))
    return dec


def interpolation_weights(dists, valid, radius_bound, weighting="distance"):
    """Per-neighbour interpolation weights: inverse squared distance (or
    'expo'), zero outside the query ball or on invalid slots, L1-normalised.
    dists (N,K) squared; radius_bound (N,) radius, not squared."""
    if weighting == "distance":
        w = 1.0 / (dists + 1e-10)
    else:  # 'expo'
        w = torch.exp(-20.0 * torch.sqrt(dists))
    bound2 = radius_bound.float().reshape(-1, 1) ** 2
    w = torch.where((dists > bound2) | ~valid, 0.0, w)
    norm = torch.clamp(torch.sum(torch.abs(w), dim=1, keepdim=True), min=1e-12)
    return w / norm


def random_fill_features(c: torch.Tensor, has_neighbors: torch.Tensor,
                         rnd: torch.Tensor) -> torch.Tensor:
    """Points lacking neighbours get ONE shared random vector ``rnd``
    (c_dim,), N(0, 0.01) in the callers, for every masked row."""
    return torch.where(has_neighbors[:, None], c, rnd[None, :])
