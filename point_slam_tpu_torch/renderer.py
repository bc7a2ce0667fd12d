"""Depth-guided volumetric renderer.

The port of ``point_slam_tpu.renderer``: z-value placement around the
sensor depth (or, for depth-free rays with ``sample_near_pcl``, between the
first two coarse samples near the cloud), ONE kNN over all ray samples
shared by both decoders, feature interpolation, the geometry and colour
MLPs (with the exposure affine under ``encode_exposure``), occupancy
masking of samples without neighbours, and normalised alpha compositing.
Rays carry a validity mask instead of being filtered; the losses are
masked sums.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch.common.compositing import raw2outputs
from point_slam_tpu_torch.common.image import masked_max, masked_mean
from point_slam_tpu_torch.models import decoders as D
from point_slam_tpu_torch.ops import knn
from point_slam_tpu_torch.utils import spans


class RenderConfig(NamedTuple):
    n_surface: int = 5
    near_end: float = 0.3
    near_end_surface: float = 0.98
    far_end_surface: float = 1.02
    sample_near_pcl: bool = False
    sigmoid_coef: float = 0.1
    weighting: str = "distance"
    min_nn_num: int = 2
    nn_num: int = 8
    encode_rel_pos_in_col: bool = True
    use_view_direction: bool = False
    encode_exposure: bool = False
    ray_batch: int = 3000
    # ray-shared kNN (ops/knn.ray_grid_knn, the CUDA kernel on the card)
    ray_knn: bool = False
    knn_probes: int = 36
    # the decoder MLP blocks' matmul precision: None (IEEE f32) or
    # 'default' (TF32 on CUDA); the Fourier embeddings stay f32
    mlp_precision: Optional[str] = None


def resolve_auto(mode, device) -> bool:
    """'auto' knobs resolve to True on CUDA and False on the CPU."""
    if mode == "auto":
        return torch.device(device).type == "cuda"
    return bool(mode)


def make_render_config(cfg: Dict[str, Any], sigmoid_coef: float,
                       device) -> RenderConfig:
    cu = cfg["cuda"]
    mlp_prec = cu.get("mlp_precision")
    if mlp_prec in ("", "global", "highest"):
        mlp_prec = None
    return RenderConfig(
        ray_knn=resolve_auto(cu.get("ray_knn", "auto"), device),
        mlp_precision=mlp_prec,
        knn_probes=int(cu.get("knn_probes", 0)) or knn._P_RAY_DEFAULT,
        n_surface=cfg["rendering"]["N_surface"],
        near_end=cfg["rendering"]["near_end"],
        near_end_surface=cfg["rendering"]["near_end_surface"],
        far_end_surface=cfg["rendering"]["far_end_surface"],
        sample_near_pcl=bool(cfg["rendering"]["sample_near_pcl"]),
        sigmoid_coef=sigmoid_coef,
        weighting=cfg["pointcloud"]["nn_weighting"],
        min_nn_num=cfg["pointcloud"]["min_nn_num"],
        nn_num=cfg["pointcloud"]["nn_num"],
        encode_rel_pos_in_col=cfg["model"]["encode_rel_pos_in_col"],
        use_view_direction=bool(cfg["model"]["use_view_direction"]),
        encode_exposure=bool(cfg["model"]["encode_exposure"]),
    )


def ray_far(gt_depth, ray_valid):
    """The far bound of depth-free rays' samples, a statistic of the
    batch: min(5 x mean, 1.2 x max) of its valid positive depths."""
    depth_pos = ray_valid & (gt_depth > 0)
    return torch.minimum(5.0 * masked_mean(gt_depth, depth_pos),
                         1.2 * masked_max(gt_depth, depth_pos))


def build_z_vals(rc: RenderConfig, index, rays_o, rays_d, gt_depth,
                 r_query, ray_valid, far=None):
    """Per-ray sample depths and the near-cloud mask: ns samples in
    [0.98 d, 1.02 d] for rays with depth; for depth-free rays, uniform
    near_end..far (``far``: ``ray_far`` of this batch unless given), or
    with ``sample_near_pcl`` the segment between the first two coarse
    samples near the cloud. Returns (z_vals (R, ns), near_pcl_ok (R,),
    False on depth-free rays that pass no cloud)."""
    ns = rc.n_surface
    r = gt_depth.shape[0]
    dev = gt_depth.device
    if far is None:
        far = ray_far(gt_depth, ray_valid)
    t = torch.linspace(0.0, 1.0, ns, device=dev)
    z_surface = (rc.near_end_surface * gt_depth[:, None] * (1 - t)[None, :]
                 + rc.far_end_surface * gt_depth[:, None] * t[None, :])
    near_pcl_ok = torch.ones(r, dtype=torch.bool, device=dev)
    if rc.sample_near_pcl:
        # only the depth-free rays' coarse samples are searched (the
        # others' results would be discarded); the subset costs one
        # device->host sync for its size
        z_zero = torch.zeros((r, ns), device=dev)
        with spans.span("sync.near_pcl"):
            sub = torch.nonzero(~(gt_depth > 0)).squeeze(1)
        if sub.numel():
            z_sub, invalid = pc.sample_near_pcl(
                index, rays_o.detach()[sub], rays_d.detach()[sub],
                rc.near_end, far, r_query[sub], num=ns)
            z_zero[sub] = z_sub
            near_pcl_ok[sub] = ~invalid
    else:
        z_zero = rc.near_end * (1 - t)[None, :] + far * t[None, :]
    z_vals = torch.where((gt_depth > 0)[:, None], z_surface, z_zero)
    return z_vals, near_pcl_ok


def _knn_core(index, pts: torch.Tensor, rc: RenderConfig):
    """kNN over the (R, ns, 3) samples. Returns (dists, idx, valid)
    flattened to (R*ns, K); with ray_knn the dists are None (the caller
    recomputes exact distances from the winners)."""
    pts = pts.detach()
    if rc.ray_knn:
        _, idx, valid, compact = knn.ray_grid_knn(index, pts, k=rc.nn_num,
                                                  probes=rc.knn_probes)
        # rays whose samples spread beyond the probed box go through
        # per-sample grid_knn
        i_f, v_f = knn.grid_knn_subset(index, pts, ~compact, k=rc.nn_num)
        rep = compact.repeat_interleave(pts.shape[1])[:, None]
        return (None, torch.where(rep, idx, i_f.reshape(-1, rc.nn_num)),
                torch.where(rep, valid, v_f.reshape(-1, rc.nn_num)))
    with torch.no_grad():
        return knn.grid_knn(index, pts.reshape(-1, 3), k=rc.nn_num)


def draw_fill(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The (2, 32) random-fill vectors (geometry, colour) of one render."""
    return 0.01 * torch.randn((2, pc.C_DIM), generator=generator,
                              device=device)


def render_rays(dec: D.Decoders, packed: torch.Tensor, index,
                rays_o, rays_d, gt_depth, r_query, ray_valid,
                rc: RenderConfig, stage_color: bool,
                is_tracker: bool = False, apply_sigmoid_color: bool = True,
                fill: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                exposure_feat: Optional[torch.Tensor] = None,
                far: Optional[torch.Tensor] = None):
    """Render a ray batch from the (CAP, 72) packed cloud, f32 or its
    bf16 view (``pointcloud.encode_render``).

    ``fill``: the (2, 32) random-fill vectors for samples without
    neighbours (geometry, colour); drawn from ``generator`` otherwise.
    Returns depth (R,), uncertainty (R,), color (R,3), valid_ray (R,).
    With ``is_tracker`` the neighbour distances are recomputed
    differentiably from the neighbours' coordinates so pose gradients flow;
    the kNN indices never carry gradients. With ``rc.encode_exposure`` the
    colour takes the exposure affine of ``exposure_feat`` and the sigmoid,
    or, without a latent, neither (the mapper applies each window slot's
    own). ``far``: the depth-free rays' far bound, ``ray_far`` of these
    rays unless given (a data-parallel rank passes its whole batch's).
    """
    r = rays_o.shape[0]
    ns = rc.n_surface
    if fill is None:
        fill = draw_fill(generator, rays_o.device)

    z_vals, near_pcl_ok = build_z_vals(rc, index, rays_o, rays_d, gt_depth,
                                       r_query, ray_valid, far)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    p = pts.reshape(-1, 3)
    r_query_pts = r_query.repeat_interleave(ns)

    dists, idx, valid = _knn_core(index, pts, rc)
    nb = packed[idx]                                          # (N,K,72)
    neigh_pos = pc.neighbor_pos(nb).detach()
    if rc.ray_knn or is_tracker:
        # exact distances from the winners (the ray kNN's are quantised);
        # differentiable in the sample points for the tracker
        p_q = p if is_tracker else p.detach()
        diff = neigh_pos - p_q[:, None, :]
        dists = torch.sum(diff * diff, dim=-1)
    counts = knn.neighbor_count(dists, valid, r_query_pts)
    has_neighbors = counts > rc.min_nn_num - 1

    w = D.interpolation_weights(dists, valid, r_query_pts, rc.weighting)
    c_geo = torch.sum(w[..., None] * pc.neighbor_geo(nb), dim=1)
    c_geo = D.random_fill_features(c_geo, has_neighbors, fill[0])
    prec = rc.mlp_precision
    occ = dec.geo(p, c_geo, precision=prec)

    valid_ray = torch.sum(has_neighbors.reshape(r, ns), dim=1) >= (ns // 2 + 1)
    valid_ray = valid_ray & near_pcl_ok

    if stage_color:
        neigh_feats = pc.neighbor_col(nb)
        if rc.encode_rel_pos_in_col:
            neigh_feats = dec.col.encode_neighbor_feats(
                neigh_pos, p, neigh_feats, precision=prec)
        c_col = torch.sum(w[..., None] * neigh_feats, dim=1)
        c_col = D.random_fill_features(c_col, has_neighbors, fill[1])
        views_d = (rays_d.repeat_interleave(ns, dim=0)
                   if rc.use_view_direction else None)
        if rc.encode_exposure and exposure_feat is not None:
            rgb = dec.col(p, c_col, exposure_feat=exposure_feat,
                          views_d=views_d, precision=prec)
        else:
            rgb = dec.col(p, c_col, apply_sigmoid=apply_sigmoid_color
                          and not rc.encode_exposure, views_d=views_d,
                          precision=prec)
    else:
        rgb = torch.zeros((p.shape[0], 3), device=p.device)

    occ = torch.where(has_neighbors, occ, -100.0)
    raw = torch.cat([rgb, occ[:, None]], dim=-1).reshape(r, ns, 4)
    depth, uncertainty, color, _ = raw2outputs(raw, z_vals, rays_d,
                                               coef=rc.sigmoid_coef)
    if not rc.sample_near_pcl:
        depth = torch.where(gt_depth > 0, depth, 0.0)
    return depth, uncertainty, color, valid_ray


@torch.no_grad()
def render_img(dec: D.Decoders, cloud: pc.CloudState, index, c2w, intrinsics,
               hw, rc: RenderConfig, gt_depth=None, r_query=None,
               stage_color: bool = True,
               generator: Optional[torch.Generator] = None,
               exposure_feat: Optional[torch.Tensor] = None,
               fill: Optional[torch.Tensor] = None):
    """Full-image render in chunks of ``rc.ray_batch`` rays. ``fill``: the
    (n_chunks, 2, 32) random-fill vectors, one pair a chunk; drawn from
    ``generator`` otherwise. Returns depth (H,W), uncertainty (H,W), color
    (H,W,3)."""
    from point_slam_tpu_torch.common.camera import rays_full_image
    h, w = hw
    fx, fy, cx, cy = intrinsics
    dev = cloud.packed.device
    rays_o, rays_d = rays_full_image(h, w, fx, fy, cx, cy, c2w)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    n = h * w
    gt = (torch.zeros(n, device=dev) if gt_depth is None
          else gt_depth.reshape(-1).float())
    rq = (torch.full((n,), 1e6, device=dev) if r_query is None
          else r_query.reshape(-1).float())
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    outs = []
    for c, i in enumerate(range(0, n, rc.ray_batch)):
        sl = slice(i, i + rc.ray_batch)
        outs.append(render_rays(dec, cloud.packed, index, rays_o[sl],
                                rays_d[sl], gt[sl], rq[sl], valid[sl], rc,
                                stage_color, generator=generator,
                                fill=None if fill is None else fill[c],
                                exposure_feat=exposure_feat)[:3])
    depth, unc, col = (torch.cat(o) for o in zip(*outs))
    return depth.reshape(h, w), unc.reshape(h, w), col.reshape(h, w, 3)
