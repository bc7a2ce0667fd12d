"""Tracker: per-frame camera pose optimisation.

The port of ``point_slam_tpu.tracker``: a Python loop over autograd in
place of the JAX while_loop. Each iteration samples pixels (uniformly in
the edge-cropped image, or with ``sample_with_color_grad`` from the frame's
top-gradient pool), renders them with neighbour distances differentiable in
the pose (and the current exposure latent), takes the robust depth (and
colour) L1 loss and steps Adam on the (w,x,y,z) quaternion and the
translation. The loop keeps the minimum-loss candidate on the device (the
host reads no loss per iteration; on CUDA it syncs on the uploads and
reads that ``mapper.py`` lists): with separate_LR it stores the pre-step
camera, otherwise the post-step one, and the quaternion gets 0.2x the
learning rate. The motion model and the quaternion hemisphere alignment against the
GT pose run on the host.

With ``cuda.bf16_features`` the loop renders from the cloud's bf16 view,
encoded once a frame (the map does not move while the pose does). With a
``vis_hook`` (``tracking.vis_inside``) the hook sees the current camera
after every ``vis_inside_freq``-th iteration below the last; it only
observes, so the loop's numbers do not change.

Under a process group (``parallel/dist.py``) the pixel batch, padded to a
multiple of ``cuda.data_parallel``, is split over the ranks: each renders
its block, and the pose gradient and the loss are summed over the ranks.

Spans (``utils/spans.py``, under the schedule's ``track_frame``):
``track.setup``, then a ``track.iter`` an iteration with ``track.sample``,
``track.render`` (the loss), ``track.backward`` and ``track.step`` (Adam
and the best-loss choice), and ``sync.pose_read`` for the one host fetch a
frame; ``sync.upload`` around each upload from the host.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch import renderer as R
from point_slam_tpu_torch.common import camera, image, sampling
from point_slam_tpu_torch.ops import adam
from point_slam_tpu_torch.parallel import dist as pdist
from point_slam_tpu_torch.utils import spans


class TrackerStatic(NamedTuple):
    h: int
    w: int
    fx: float
    fy: float
    cx: float
    cy: float
    pixels: int
    ignore_edge_w: int
    ignore_edge_h: int
    handle_dynamic: bool
    depth_limit: bool
    use_color: bool
    w_color_loss: float
    separate_lr: bool
    sample_with_color_grad: bool = False
    grad_top: int = 0     # size of the top-gradient candidate pool
    bf16_features: bool = False  # render from the bf16 view of the cloud


def sample_pixels(ts: TrackerStatic, generator: torch.Generator, device):
    """One iteration's pixel draw (i columns, j rows), edge-cropped."""
    return sampling.sample_pixels_uniform(
        ts.ignore_edge_h, ts.h - ts.ignore_edge_h, ts.ignore_edge_w,
        ts.w - ts.ignore_edge_w, ts.pixels, generator, device)


def candidate_pool(ts: TrackerStatic, gt_color, gt_depth):
    """The frame's colour-gradient candidate pool: the grad_top
    highest-gradient pixels, valid inside the edge crop with depth > 0
    (and <= 5 m with depth_limit). Returns (flat idx, ok)."""
    grad = image.color_gradient_magnitude(gt_color)
    return sampling.top_gradient_candidates(
        grad, ts.ignore_edge_h, ts.h - ts.ignore_edge_h, ts.ignore_edge_w,
        ts.w - ts.ignore_edge_w, ts.grad_top, depth=gt_depth,
        depth_limit=5.0 if ts.depth_limit else None)


def sample_pool_pixels(ts: TrackerStatic, cand_idx, cand_ok,
                       generator: Optional[torch.Generator] = None,
                       scores: Optional[torch.Tensor] = None):
    """``pixels`` distinct picks from the candidate pool (``scores``:
    optional uniform draws over the pool). Returns (i, j, ok)."""
    pos, ok = sampling.choose_without_replacement(cand_ok, ts.pixels,
                                                  generator, scores)
    i, j = sampling.flat_to_ij(cand_idx[pos], ts.w)
    return i, j, ok


def tracking_loss(ts: TrackerStatic, rc: R.RenderConfig, dec, packed, index,
                  gt_color, gt_depth, r_query_map, cam: torch.Tensor,
                  i: torch.Tensor, j: torch.Tensor, fill: torch.Tensor,
                  pix_ok: Optional[torch.Tensor] = None,
                  exposure_feat: Optional[torch.Tensor] = None):
    """Robust tracking loss of the 7-vector camera ``cam`` at pixels (i, j)
    (``pix_ok``: which picks are valid, all by default) with the (2, 32)
    random-fill vectors ``fill`` and the exposure latent ``exposure_feat``.
    Returns (loss, geo_loss, color_loss, n_mask).

    The pixels are the whole batch of every rank of the process group
    (``parallel.dist``): the depth cut and the far bound are taken on all
    of them, this rank renders its block, and the robust mask's mean or
    median is taken over every rank's rays; the returned sums are this
    rank's part (without a group, the block is the batch)."""
    c2w = camera.pose_matrix_from_tensor(cam)
    dep = sampling.gather_pixels(gt_depth, i, j)
    col = sampling.gather_pixels(gt_color, i, j)
    rq = sampling.gather_pixels(r_query_map, i, j)
    valid = dep > 0
    if pix_ok is not None:
        valid &= pix_ok
    if ts.depth_limit:
        valid &= dep < 5.0
    rays_o, rays_d = camera.rays_from_uv(i, j, c2w, ts.fx, ts.fy, ts.cx, ts.cy)
    med = image.masked_median(dep, valid)
    mx = image.masked_max(dep, valid)
    valid &= dep <= torch.minimum(10.0 * med, 1.2 * mx)
    far = R.ray_far(dep, valid)
    rays_o, rays_d, dep, col, rq, valid = (
        pdist.shard(x) for x in (rays_o, rays_d, dep, col, rq, valid))

    depth, uncertainty, color, _ = R.render_rays(
        dec, packed, index, rays_o, rays_d, dep, rq, valid, rc,
        stage_color=True, is_tracker=True, fill=fill,
        exposure_feat=exposure_feat, far=far)
    uncertainty = uncertainty.detach()
    nan_ok = ~(torch.isnan(depth) | torch.isnan(uncertainty))
    tmp = torch.abs(dep - depth) / torch.sqrt(uncertainty + 1e-10)
    if ts.handle_dynamic:
        thresh_ok = tmp < 10.0 * pdist.masked_mean(tmp, valid & nan_ok)
    else:
        err = torch.abs(dep - depth)
        thresh_ok = err < 10.0 * pdist.masked_median(err, valid & nan_ok)
    mask = thresh_ok & (dep > 0) & nan_ok & valid
    geo_loss = torch.sum(torch.where(mask, torch.clamp(tmp, 0.0, 1e3), 0.0))
    color_loss = torch.sum(torch.where(mask[:, None], torch.abs(col - color),
                                       0.0))
    loss = geo_loss + ts.w_color_loss * color_loss if ts.use_color else geo_loss
    return loss, geo_loss, color_loss, mask.sum()


def track_optimize(ts: TrackerStatic, rc: R.RenderConfig, dec, packed, index,
                   gt_color, gt_depth, r_query_map, cam_init: torch.Tensor,
                   lr: float, n_iters: int,
                   generator: Optional[torch.Generator] = None, draws=None,
                   pool=None, exposure_feat: Optional[torch.Tensor] = None,
                   hook=None, hook_every: int = 0):
    """Optimise the camera for one frame.

    ``pool``: the (cand_idx, cand_ok) candidate pool, with
    ``ts.sample_with_color_grad``. ``draws``: optional per-iteration list
    of (i, j, fill), or of (scores over the pool, fill) when sampling from
    the pool; drawn from ``generator`` otherwise. ``hook(it, cam)``, if
    given, is called after iterations it = hook_every, 2*hook_every, ...
    below n_iters with the current (7,) camera. Returns (best_cam (7,),
    final_cam (7,), first_loss, best_loss) as device tensors.

    Under a process group each rank's pose gradient and loss are summed
    over the ranks (in one all_reduce) before the Adam step and the
    best-loss choice, so every rank keeps the same cameras.
    """
    dev = cam_init.device
    if ts.bf16_features:
        packed = pc.encode_render(packed)
    quad = cam_init[:4].clone().requires_grad_(True)
    trans = cam_init[4:].clone().requires_grad_(True)
    state = adam.init_state([quad, trans])
    best_loss = spans.upload(1e20, dev)
    best_cam = cam_init.clone()
    first_loss = torch.zeros((), device=dev)
    lr_q = lr * 0.2 if ts.separate_lr else lr
    for it in range(n_iters):
        with spans.span("track.iter", it=it):
            with spans.span("track.sample"):
                ok = fill = None
                if ts.sample_with_color_grad:
                    scores, fill = (draws[it] if draws is not None
                                    else (None, None))
                    i, j, ok = sample_pool_pixels(ts, *pool, generator,
                                                  scores)
                elif draws is not None:
                    i, j, fill = draws[it]
                else:
                    i, j = sample_pixels(ts, generator, dev)
                if fill is None:
                    fill = R.draw_fill(generator, dev)
            with spans.span("track.render"):
                cam = torch.cat([quad, trans])
                loss = tracking_loss(ts, rc, dec, packed, index, gt_color,
                                     gt_depth, r_query_map, cam, i, j, fill,
                                     ok, exposure_feat)[0]
            with spans.span("track.backward"):
                g_q, g_t = torch.autograd.grad(loss, [quad, trans])
            with spans.span("track.step"), torch.no_grad():
                loss = loss.detach()
                pdist.all_reduce_flat([g_q, g_t, loss])
                cam_vec = cam.detach()
                (new_q, new_t), state = adam.update(
                    [quad.detach(), trans.detach()], [g_q, g_t], state,
                    float(it + 1), [lr_q, lr])
                stored = (cam_vec if ts.separate_lr
                          else torch.cat([new_q, new_t]))
                better = loss < best_loss
                best_loss = torch.where(better, loss, best_loss)
                best_cam = torch.where(better, stored, best_cam)
                if it == 0:
                    first_loss = loss
            quad = new_q.requires_grad_(True)
            trans = new_t.requires_grad_(True)
            if hook is not None and (it + 1) % hook_every == 0 \
                    and it + 1 < n_iters:
                hook(it + 1, torch.cat([quad, trans]).detach())
    final_cam = torch.cat([quad, trans]).detach()
    return best_cam, final_cam, first_loss, best_loss


class Tracker:
    """Host orchestration: motion model, quaternion init, per-frame
    optimisation. Owns the tracking random stream."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        cam = cfg["cam"]
        tr = cfg["tracking"]
        # the rays pad up to a multiple of the data-parallel ranks
        pix = pdist.padded(tr["pixels"], pdist.data_parallel(cfg))
        self.ts = TrackerStatic(
            h=cam["H"], w=cam["W"], fx=cam["fx"], fy=cam["fy"],
            cx=cam["cx"], cy=cam["cy"], pixels=pix,
            ignore_edge_w=tr["ignore_edge_W"], ignore_edge_h=tr["ignore_edge_H"],
            handle_dynamic=tr["handle_dynamic"], depth_limit=tr["depth_limit"],
            use_color=tr["use_color_in_tracking"],
            w_color_loss=tr["w_color_loss"], separate_lr=tr["separate_LR"],
            sample_with_color_grad=bool(tr["sample_with_color_grad"]),
            grad_top=min(15 * pix, cam["H"] * cam["W"]),
            bf16_features=R.resolve_auto(
                cfg["cuda"].get("bf16_features", False), self.device))
        self.rc = R.make_render_config(
            cfg, cfg["rendering"]["sigmoid_coef_tracker"], self.device)
        self.lr = tr["lr"]
        self.iters = tr["iters"]
        self.gt_camera = tr["gt_camera"]
        self.const_speed = tr["const_speed_assumption"]
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(cfg["setup_seed"]) + 1)
        # set by the orchestrator with tracking.vis_inside: called as
        # vis_hook(idx, it, iters, cam (7,)) inside the loop
        self.vis_hook = None
        self.inside_freq = max(int(tr.get("vis_inside_freq", 50)), 1)

    def initial_pose(self, idx: int, estimate_c2w_list: np.ndarray,
                     gt_c2w: np.ndarray) -> np.ndarray:
        """Constant-speed motion model + hemisphere-aligned quaternion."""
        pre_c2w = estimate_c2w_list[idx - 1].astype(np.float32)
        if self.const_speed and idx >= 2:
            delta = pre_c2w @ np.linalg.inv(
                estimate_c2w_list[idx - 2].astype(np.float32))
            est = delta @ pre_c2w
        else:
            est = pre_c2w
        cam = camera.tensor_from_pose_matrix(est)
        gt_cam = camera.tensor_from_pose_matrix(gt_c2w.astype(np.float32))
        if np.dot(cam[:4], gt_cam[:4]) < 0:
            cam = cam.copy()
            cam[:4] *= -1
        return cam

    def track_frame(self, idx: int, gt_color, gt_depth, gt_c2w,
                    estimate_c2w_list, mapper, r_query_map,
                    exposure_feat=None) -> Dict[str, Any]:
        """Track one frame against the current map; frames 0 and 1 take the
        GT pose. ``exposure_feat``: the mapper's current exposure latent
        (numpy), used with ``model.encode_exposure``. Returns a dict with
        c2w (4,4) numpy."""
        if idx <= 1 or self.gt_camera:
            return {"c2w": np.asarray(gt_c2w, np.float32), "tracked": False}
        with spans.span("track.setup"):
            cam_init = spans.upload(
                self.initial_pose(idx, estimate_c2w_list, gt_c2w),
                self.device)
            pool = (candidate_pool(self.ts, gt_color, gt_depth)
                    if self.ts.sample_with_color_grad else None)
            exp = (spans.upload(np.asarray(exposure_feat, np.float32),
                                self.device)
                   if exposure_feat is not None and self.rc.encode_exposure
                   else None)
        hook = None
        if self.vis_hook is not None:
            def hook(it, cam):
                self.vis_hook(idx, it, self.iters, cam)
        best_cam, _, first_loss, best_loss = track_optimize(
            self.ts, self.rc, mapper.decoders, mapper.cloud.packed,
            mapper.index, gt_color, gt_depth, r_query_map, cam_init,
            self.lr, self.iters, generator=self.generator, pool=pool,
            exposure_feat=exp, hook=hook, hook_every=self.inside_freq)
        # one host fetch per frame
        vals = torch.cat([camera.pose_matrix_from_tensor(best_cam).reshape(-1),
                          first_loss[None], best_loss[None]])
        with spans.span("sync.pose_read"):
            vals = vals.cpu().numpy()
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :4] = vals[:12].reshape(3, 4)
        return {"c2w": c2w, "tracked": True,
                "first_loss": float(vals[12]), "best_loss": float(vals[13])}
