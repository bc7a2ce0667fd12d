"""Mapper: per-frame scene optimisation.

The port of ``point_slam_tpu.mapper``. Per mapped frame the host picks the
keyframe window, densifies the cloud, computes the frustum gradient mask
and the iteration budget; then ``map_optimize`` runs the two-stage
(geometry -> colour) Adam optimisation as a Python loop over autograd:
rays sampled from the device-resident keyframe window, rendering, masked
losses, and per-group Adam steps. The packed (CAP, 72) cloud is one leaf
with per-column learning rates and step counts; the frustum row mask
multiplies its gradient (or rides into the fused row-Adam kernel). The
colour groups restart their step count at the geometry -> colour switch,
as torch.optim.Adam does for a group whose first gradient arrives there.
The loop reads no loss per iteration. On CUDA its host syncs an
iteration are the uploads of small constants from the host (the masked
median's, the probe tables', Adam's step count), the median's index, the
counts of non-compact and depth-free rays in the kNN paths, and the
compositing's ``cumprod`` backward, which reads whether its input holds a
zero.

With ``model.encode_exposure`` each window slot carries an exposure latent
(only the current frame's moves); with ``mapping.BA`` and more than four
keyframes the window cameras become optimised (quaternion, translation)
leaves, the oldest keyframe fixed; ``map_frame(color_refine=True)`` reruns
five random windows over the whole cloud with the colour decoder frozen.

With ``cuda.bf16_features`` every iteration renders from a bf16 view of
the current f32 master (``pointcloud.encode_render``); Adam steps the
master and its f32 moments. With a ``vis_hook`` (``mapping.vis_inside``)
the loop publishes its in-progress cloud at the end of every
``cuda.max_iters_per_launch`` iterations below the last and calls the
hook, where the JAX package splits its loop into launches; the loop
itself is not split.

Under a process group (``parallel/dist.py``) each iteration's ray batch,
padded to a multiple of ``cuda.data_parallel``, is split over the ranks:
each renders its block, and the gradients (the packed leaf's live prefix,
the decoders, the exposure latents, the BA cameras) and the logged loss
statistics are summed over the ranks in one all_reduce before the masks
and Adam. Densification, the window and the frustum mask are replicated.

Spans (``utils/spans.py``, under the schedule's ``map_frame``):
``map.densify`` (with ``pc.add_points`` and ``pc.insert_index`` inside,
counting ``points_added``), ``map.frustum``, ``map.window`` (the overlap
scores, then ``select_keyframes``, ``KeyframeStore.gather_window`` and the
BA cameras), ``sync.map_fetch`` (the densify counters and the scores),
``map.optimize`` with a ``map.iter`` an iteration (``map.sample``,
``map.render``, ``map.backward``, ``map.step``), ``sync.map_stats`` (the
loss statistics, the exposure latent, the BA cameras) and
``map.keyframe_append``; ``sync.*`` around each other host read of the
device and each upload from the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from point_slam_tpu_torch import pointcloud as pc
from point_slam_tpu_torch import renderer as R
from point_slam_tpu_torch.common import camera, image, sampling
from point_slam_tpu_torch.ops import adam
from point_slam_tpu_torch.parallel import dist as pdist
from point_slam_tpu_torch.utils import spans


class MapperStatic(NamedTuple):
    h: int
    w: int
    fx: float
    fy: float
    cx: float
    cy: float
    r_max: int            # ray batch size: mapping.pixels, padded to a
                          # multiple of cuda.data_parallel
    f_max: int            # window slots
    w_color_loss: float
    frustum_edge: float
    fix_geo_decoder: bool
    n_add: int
    near_end_surface_pc: float
    far_end_surface_pc: float
    add_max: int          # candidate rays for uniform densification
    grad_max: int         # candidate rays for colour-gradient densification
    grad_top: int         # top-k pool for colour-gradient selection
    encode_exposure: bool = False
    ba: bool = False      # bundle adjustment: optimise the window cameras
    fused_adam: bool = False  # the row-Adam kernel for the packed leaf
    bf16_features: bool = False  # render from the bf16 view of the leaf


def host_ring(cfg, n_img: int, keyframe_every: int) -> bool:
    """Whether a run keeps its keyframe images in host memory:
    ``cuda.keyframe_host_ring``, or with 'auto' when the expected keyframe
    count exceeds ``cuda.keyframe_device_budget``."""
    cu = cfg["cuda"]
    mode = cu["keyframe_host_ring"]
    if mode != "auto":
        return bool(mode)
    expected = n_img // max(keyframe_every, 1) + 4
    return expected > int(cu["keyframe_device_budget"])


class KeyframeStore:
    """Keyframe database: poses and exposure latents on the host, images as
    (H,W,5) u8 wire frames in one of two places:

    * the device ring (default): one (capacity, H, W, 5) tensor on the
      device; a window is a device gather.
    * the host ring (``cuda.keyframe_host_ring``: true, or 'auto' when the
      expected keyframe count exceeds ``cuda.keyframe_device_budget``):
      each wire frame is fetched to host memory once, at ``append``; a
      window is written into one (f_max, H, W, 5) staging buffer (pinned on
      CUDA) and uploaded with one host->device copy.

    Both decode the same wire bytes, so their windows are bit-equal.
    r_query is recomputed from the decoded colour when a window is
    gathered; bundle adjustment writes poses back with ``set_est_c2w``."""

    def __init__(self, cfg, h: int, w: int, n_img: int, keyframe_every: int,
                 device):
        cu = cfg["cuda"]
        expected = n_img // max(keyframe_every, 1) + 4
        budget = int(cu["keyframe_device_budget"])
        self.host_mode = host_ring(cfg, n_img, keyframe_every)
        self.h, self.w = h, w
        self.device = torch.device(device)
        self.est_c2w: List[np.ndarray] = []
        self.exposure_dim = int(cfg["model"]["exposure_dim"])
        self.exposure: List[np.ndarray] = []
        self.depth_scale = float(cfg["cam"]["png_depth_scale"])
        pcfg = cfg["pointcloud"]
        self.dyn = bool(cfg["use_dynamic_radius"])
        self.rq_args = (pcfg["radius_add_max"], pcfg["radius_add_min"],
                        pcfg["radius_query_ratio"], pcfg["color_grad_threshold"])
        self.rq_fixed = pcfg["radius_query"]
        if self.host_mode:
            self.frames: List[np.ndarray] = []
            self._staging: Optional[torch.Tensor] = None
            self._uploaded = None       # the last upload's CUDA event
        else:
            self.capacity = max(min(budget, expected), 4)
            self.ring = torch.zeros((self.capacity, h, w, 5),
                                    dtype=torch.uint8, device=device)

    def append(self, color_dev, depth_dev, est_c2w, exposure=None) -> None:
        slot = len(self.est_c2w)
        wire = image.encode_wire_frame(color_dev, depth_dev, self.depth_scale)
        if self.host_mode:
            with spans.span("sync.keyframe_fetch"):
                self.frames.append(wire.cpu().numpy())
        else:
            if slot >= self.capacity:
                raise RuntimeError(
                    f"keyframe ring overflow: keyframe #{slot + 1} exceeds "
                    f"the device ring capacity {self.capacity} "
                    f"(cuda.keyframe_device_budget). Set "
                    f"cuda.keyframe_host_ring: true (or leave it 'auto') to "
                    f"keep keyframe images in host memory.")
            self.ring[slot] = wire
        self.est_c2w.append(np.asarray(est_c2w, np.float32))
        self.exposure.append(
            np.zeros(self.exposure_dim, np.float32) if exposure is None
            else np.asarray(exposure, np.float32))

    def set_est_c2w(self, slot: int, c2w) -> None:
        self.est_c2w[slot] = np.asarray(c2w, np.float32)

    def est_c2w_padded(self, min_pad: int = 64) -> torch.Tensor:
        """(K',4,4) poses padded with identities to a power of two."""
        n = len(self.est_c2w)
        k = max(min_pad, 1 << max(n - 1, 0).bit_length())
        arr = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
        if n:
            arr[:n] = np.stack(self.est_c2w)
        return spans.upload(arr, self.device)

    def _upload_window(self, slots: List[int], f_max: int) -> torch.Tensor:
        """Host ring: the wire frames of ``slots`` in the staging buffer
        (zeros before the first keyframe, as the device ring's unused
        slots), copied to the device in one transfer. ``f_max`` is the
        mapper's fixed window size."""
        cuda = self.device.type == "cuda"
        if self._staging is None:
            self._staging = torch.empty((f_max, self.h, self.w, 5),
                                        dtype=torch.uint8, pin_memory=cuda)
        elif self._uploaded is not None:
            with spans.span("sync.window_upload"):
                self._uploaded.synchronize()    # the last copy has read it
        staging = self._staging.numpy()
        for k, s in enumerate(slots):
            staging[k] = self.frames[s] if self.frames else 0
        wire = self._staging.to(self.device, non_blocking=cuda)
        if cuda:
            self._uploaded = torch.cuda.Event()
            self._uploaded.record()
        return wire

    def gather_window(self, sel: Sequence[int], f_max: int):
        """Window tensors (f_max leading dim) for keyframe slots ``sel``:
        color, depth, r_query, c2w and the exposure latents; slots past
        len(sel) are padding (slot 0's frame, r_query 1e6, identity pose,
        zero latent)."""
        slots = (list(sel) + [0] * f_max)[:f_max]
        wire = (self._upload_window(slots, f_max) if self.host_mode
                else self.ring[spans.upload(slots, self.device)])
        color, depth = image.decode_wire_frame(wire, 1.0 / self.depth_scale)
        rq = torch.full(depth.shape, 1e6, device=self.device)
        for k in range(len(sel)):
            rq[k] = (image.dynamic_radius_maps(color[k], *self.rq_args)[1]
                     if self.dyn else self.rq_fixed)
        c2w = np.tile(np.eye(4, dtype=np.float32), (f_max, 1, 1))
        exp = np.zeros((f_max, self.exposure_dim), np.float32)
        for k, s in enumerate(sel):
            c2w[k] = self.est_c2w[s]
            exp[k] = self.exposure[s]
        return (color, depth, rq, spans.upload(c2w, self.device),
                spans.upload(exp, self.device))


def overlap_scores(ms: MapperStatic, ring_est_c2w, n_kf: int, cur_c2w,
                   gt_depth, i, j, n_samples: int = 8):
    """Fraction of the current frame's surface samples (at pixels i, j)
    inside each keyframe's frustum. (K,) scores; slots >= n_kf get -1."""
    dep = sampling.gather_pixels(gt_depth, i, j)
    ok = dep > 0
    rays_o, rays_d = camera.rays_from_uv(i, j, cur_c2w, ms.fx, ms.fy, ms.cx,
                                         ms.cy)
    t = torch.linspace(0.0, 1.0, n_samples, device=dep.device)
    near = (dep * 0.8)[:, None]
    far = (dep + 0.5)[:, None]
    z = near * (1 - t)[None, :] + far * t[None, :]
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    pt_ok = ok.repeat_interleave(n_samples)
    scores = []
    edge = 20
    for c2w in ring_est_c2w:
        with spans.span("sync.inv"):      # the inverse's error check
            w2c = torch.linalg.inv(c2w)
        u, v, zc = camera.project_points(pts, w2c, ms.fx, ms.fy, ms.cx,
                                         ms.cy)
        m = ((u < ms.w - edge) & (u > edge) & (v < ms.h - edge) & (v > edge)
             & (zc < 0) & pt_ok)
        scores.append(m.sum() / torch.clamp(pt_ok.sum(), min=1))
    scores = torch.stack(scores)
    k = ring_est_c2w.shape[0]
    return torch.where(torch.arange(k, device=dep.device) < n_kf, scores, -1.0)


def prepare_frame(color, r_add_max: float, r_add_min: float, ratio: float,
                  thr: float, grad_top: int):
    """Dynamic radius maps + colour-gradient candidate pool for one frame."""
    r_add, r_query = image.dynamic_radius_maps(color, r_add_max, r_add_min,
                                               ratio, thr)
    grad = image.color_gradient_magnitude(color)
    h, w = grad.shape
    cand_idx, cand_ok = sampling.top_gradient_candidates(grad, 0, h, 0, w,
                                                         grad_top)
    return r_add, r_query, cand_idx, cand_ok


def _sample_window_rays(ms: MapperStatic, window, n_frames: int,
                        pixs_per_image: int, i=None, j=None,
                        generator: Optional[torch.Generator] = None):
    """One iteration's ray batch from the keyframe window: pixel columns
    ``i`` and rows ``j`` (r_max each, drawn from ``generator`` when not
    given). Returns a dict of per-ray tensors with camera-space dirs, the
    window slot and the validity mask."""
    color, depth, rquery = window
    dev = depth.device
    rmax = ms.r_max
    slot = torch.arange(rmax, device=dev) // max(pixs_per_image, 1)
    ray_ok = slot < n_frames
    slot = torch.clamp(slot, max=ms.f_max - 1)
    if i is None:
        i = torch.randint(0, ms.w, (rmax,), generator=generator, device=dev)
        j = torch.randint(0, ms.h, (rmax,), generator=generator, device=dev)
    i, j = i.long(), j.long()
    col = color[slot, j, i]
    dep = depth[slot, j, i]
    rq = rquery[slot, j, i]
    dirs = torch.stack([(i.float() - ms.cx) / ms.fx,
                        -(j.float() - ms.cy) / ms.fy,
                        -torch.ones(rmax, device=dev)], -1)
    ray_ok &= dep > 0
    med = image.masked_median(dep, ray_ok)
    mx = image.masked_max(dep, ray_ok)
    ray_ok &= dep <= torch.minimum(10.0 * med, 1.2 * mx)
    return dict(dirs_cam=dirs, gt_depth=dep, gt_color=col, r_query=rq,
                slot=slot, ray_ok=ray_ok)


def _rays_world(rays, c2w_all):
    """World-space ray origins/directions from the per-slot poses."""
    c2w = c2w_all[rays["slot"]]
    rays_d = torch.einsum("rkl,rl->rk", c2w[:, :3, :3], rays["dirs_cam"])
    return c2w[:, :3, 3], rays_d


def _cam_poses(cams: torch.Tensor) -> torch.Tensor:
    """(F, 7) quaternion + translation cameras -> (F, 4, 4) poses,
    differentiable."""
    rt = camera.pose_matrix_from_tensor(cams)
    bottom = spans.upload([0.0, 0.0, 0.0, 1.0], cams.device)
    return torch.cat([rt, bottom.expand(rt.shape[0], 1, 4)], dim=1)


def _losses(ms: MapperStatic, rc: R.RenderConfig, dec, packed, index, rays,
            c2w_all, stage_color: bool, fill: torch.Tensor,
            window_exposure: Optional[torch.Tensor] = None, far=None):
    """Masked geometry (+colour) L1 losses of one ray batch. With
    ``ms.encode_exposure`` each ray's colour takes its window slot's
    exposure affine (``window_exposure`` (F, dim)); with ``ms.ba`` the
    neighbour distances are differentiable in the (BA) poses ``c2w_all``.
    ``far``: the depth-free rays' far bound (the renderer's, of these rays,
    by default). Returns (loss, geo_loss, color_loss, n_mask)."""
    rays_o, rays_d = _rays_world(rays, c2w_all)
    depth, _, color, valid_ray = R.render_rays(
        dec, packed, index, rays_o, rays_d, rays["gt_depth"],
        rays["r_query"], rays["ray_ok"], rc, stage_color=stage_color,
        is_tracker=ms.ba, apply_sigmoid_color=not ms.encode_exposure,
        fill=fill, far=far)
    mask = (rays["gt_depth"] > 0) & valid_ray & rays["ray_ok"]
    mask &= ~torch.isnan(depth)
    geo_loss = torch.sum(torch.where(mask, torch.abs(rays["gt_depth"] - depth),
                                     0.0))
    loss = geo_loss
    color_loss = torch.zeros((), device=depth.device)
    if stage_color:
        if ms.encode_exposure:
            rot, trans = dec.col.exposure_affine(window_exposure)
            slot = rays["slot"]
            color = torch.sigmoid(
                torch.einsum("rk,rkl->rl", color, rot[slot]) + trans[slot])
        color_loss = torch.sum(torch.where(
            mask[:, None], torch.abs(rays["gt_color"] - color), 0.0))
        loss = loss + ms.w_color_loss * color_loss
    return loss, geo_loss, color_loss, mask.sum()


def _column_rows(device):
    geo_cols = torch.zeros(pc.PACK_W, device=device)
    geo_cols[pc.GEO_SL] = 1.0
    col_cols = torch.zeros(pc.PACK_W, device=device)
    col_cols[pc.COL_SL] = 1.0
    return geo_cols, col_cols


def map_optimize(ms: MapperStatic, rc: R.RenderConfig, dec, packed, index,
                 window, n_frames: int, pixs_per_image: int, frustum,
                 lr_geo_stage: Sequence[float], lr_color_stage: Sequence[float],
                 fix_color: float, geo_iter_bound: int, n_iters: int,
                 generator: Optional[torch.Generator] = None, draws=None,
                 exposure: Optional[torch.Tensor] = None, cur_slot: int = 0,
                 lr_exposure: float = 0.001, ba: Optional[Dict] = None,
                 n_live: Optional[int] = None, chunk: int = 0,
                 chunk_hook=None):
    """The per-frame mapping optimisation, a loop of ``n_iters`` iterations.

    ``window``: (color (F,H,W,3), depth (F,H,W), r_query (F,H,W),
    c2w (F,4,4)). LR triples are [decoders, geometry_feats, color_feats] per
    stage; iteration ``it <= geo_iter_bound`` is the geometry stage.
    ``fix_color`` 0.0 freezes the colour decoder. ``draws``: optional
    per-iteration list of (i, j, fill); drawn from ``generator`` otherwise.

    ``exposure``: the window's (F, dim) exposure latents, a leaf whose
    gradient is masked to ``cur_slot`` (learning rate ``lr_exposure``, the
    colour step count). ``ba``: bundle adjustment, a dict of ``cams``
    (F, 7) initial cameras, ``mask`` (F,) 0/1 (0 for the oldest keyframe
    and the padding), ``lr`` and the iteration window ``lo``..``hi``
    outside which the camera learning rate is 0; the cameras take the
    geometry step count and replace the window poses.

    Each iteration's step is one ``adam.update(..., in_place=True)`` over
    every trained leaf (on the card one ``multi_adam`` launch), with the
    packed gradient masked by the frustum and the packed leaf stepped over
    its first ``n_live`` rows only (the cloud's points; all rows when
    None): rows past the cloud have zero gradient and moments, which Adam
    leaves bit for bit as they are. With ``ms.fused_adam`` the packed leaf
    steps instead through ``adam.update_rows`` (K4 on the card, in place)
    with the frustum as its row mask, over the same rows.

    The batch (and ``draws``) is the whole padded batch of every rank of
    the process group (``parallel.dist``): each rank renders its block and
    the gradients and statistics are summed over the ranks, the packed
    leaf's over its first ``n_live`` rows (the others get no gradient).
    Without a group the block is the batch and the sums are local.

    ``chunk_hook(it_prev, it_now, packed, stats)``, if given, is called
    after iterations it_now = chunk, 2*chunk, ... below n_iters with the
    packed leaf as it stands (it_prev = it_now - chunk) and the stats of
    iteration it_now - 1 (as returned below).

    Updates ``dec`` in place and returns (packed, stats (3,) device tensor
    [geo_loss, color_loss, n_mask] of the last iteration, the exposure
    latents or None, the BA cameras or None).
    """
    color, depth, rquery, c2w_all = window
    dev = packed.device
    col_params = list(dec.col.parameters())
    geo_params = [] if ms.fix_geo_decoder else list(dec.geo.parameters())
    # the step updates the packed leaf in place: own a copy
    leaves = [packed.detach().clone()] + col_params + geo_params
    n_col = len(col_params)
    n_dec = n_col + len(geo_params)
    i_exp = i_cam = None
    if exposure is not None:
        i_exp = len(leaves)
        leaves.append(exposure.detach().clone())
        exp_onehot = (torch.arange(exposure.shape[0], device=dev)
                      == cur_slot).float()[:, None]
    if ba is not None:
        i_cam = len(leaves)
        leaves.append(ba["cams"].detach().clone())
        ba_mask = ba["mask"].float()[:, None]
    state = adam.init_state(leaves)
    geo_cols, col_cols = _column_rows(dev)
    is_col = col_cols > 0
    lr_rows = [geo_cols * lrs[1] + col_cols * lrs[2]
               for lrs in (lr_geo_stage, lr_color_stage)]
    # zero gradients of the leaves a stage leaves unused, made once: the
    # step never writes a gradient (under a process group each iteration
    # makes its own, since the all-reduce sums into them)
    zeros: Dict[int, torch.Tensor] = {}

    def zero_grad(k: int) -> torch.Tensor:
        if k in zeros:
            return zeros[k]
        z = torch.zeros_like(leaves[k])
        if not pdist.active():
            zeros[k] = z
        return z

    frustum_f = frustum.float()
    n_rows = packed.shape[0] if n_live is None else n_live
    rows = [n_rows] + [None] * (len(leaves) - 1)
    if ms.fused_adam:
        # the live prefix of the packed leaf, its moments and its mask:
        # contiguous views that update_rows writes in place; the leaf keeps
        # its storage through the loop
        p_live, m_live, v_live, mask_live = (
            x[:n_rows] for x in (leaves[0].detach(), state["m"][0],
                                 state["v"][0], frustum_f))
    stats = torch.zeros(3, device=dev)
    for it in range(n_iters):
        with spans.span("map.iter", it=it):
            with spans.span("map.sample"):
                i, j, fill = (draws[it] if draws is not None
                              else (None, None, None))
                rays = _sample_window_rays(ms, (color, depth, rquery),
                                           n_frames, pixs_per_image, i, j,
                                           generator)
                if fill is None:
                    fill = R.draw_fill(generator, dev)
                far = R.ray_far(rays["gt_depth"], rays["ray_ok"])
                rays = {k: pdist.shard(v) for k, v in rays.items()}
            stage_geo = it <= geo_iter_bound
            leaves[0].requires_grad_(True)
            for k in (i_exp, i_cam):
                if k is not None:
                    leaves[k].requires_grad_(True)
            with spans.span("map.render"):
                loss, geo_l, col_l, n_mask = _losses(
                    ms, rc, dec,
                    (pc.encode_render(leaves[0]) if ms.bf16_features
                     else leaves[0]),
                    index, rays,
                    c2w_all if i_cam is None else _cam_poses(leaves[i_cam]),
                    stage_color=not stage_geo, fill=fill,
                    window_exposure=None if i_exp is None else leaves[i_exp],
                    far=far)
            with spans.span("map.backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            with spans.span("map.step"), torch.no_grad():
                grads = [zero_grad(k) if g is None else g
                         for k, g in enumerate(grads)]
                stats = torch.stack([geo_l.detach(), col_l.detach(),
                                     n_mask.float()])
                pdist.all_reduce_flat([grads[0][:n_rows]] + grads[1:]
                                      + [stats])
                if fix_color != 1.0:          # x * 1.0 is x
                    for k in range(1, 1 + n_col):
                        grads[k] = grads[k] * fix_color
                if i_exp is not None:
                    grads[i_exp] = grads[i_exp] * exp_onehot
                if i_cam is not None:
                    # the oldest keyframe anchors the map; padding slots too
                    grads[i_cam] = grads[i_cam] * ba_mask
                lrs = lr_geo_stage if stage_geo else lr_color_stage
                t_geo = float(it + 1)
                t_col = float(max(it - geo_iter_bound, 1))
                t_row = torch.where(is_col, t_col, t_geo)
                lr_row = lr_rows[0] if stage_geo else lr_rows[1]
                ts = [t_row] + [t_col] * n_col + [t_geo] * (n_dec - n_col)
                lr_all = [lr_row] + [lrs[0]] * n_dec
                if i_exp is not None:
                    ts.append(t_col)
                    lr_all.append(lr_exposure)
                if i_cam is not None:
                    # the cameras move only in iterations [lo, hi]
                    ts.append(t_geo)
                    lr_all.append(ba["lr"] if ba["lo"] <= it <= ba["hi"]
                                  else 0.0)
                # every leaf is stepped in place: the decoders' parameters,
                # the packed copy and the exposure and camera copies
                params = [p.detach() for p in leaves]
                if ms.fused_adam:
                    p0, s0 = adam.update_rows(
                        p_live, grads[0][:n_rows],
                        {"m": m_live, "v": v_live}, t_row, lr_row, mask_live)
                    for dst, src in ((p_live, p0), (m_live, s0["m"]),
                                     (v_live, s0["v"])):
                        if src is not dst:   # the CPU's plain version
                            dst.copy_(src)
                    adam.update(params[1:], grads[1:],
                                {"m": state["m"][1:], "v": state["v"][1:]},
                                ts[1:], lr_all[1:], in_place=True)
                else:
                    # rows past the cloud have no gradient to mask
                    grads[0][:n_rows].mul_(frustum_f[:n_rows, None])
                    adam.update(params, grads, state, ts, lr_all,
                                in_place=True, rows=rows)
            if chunk_hook is not None and (it + 1) % chunk == 0 \
                    and it + 1 < n_iters:
                chunk_hook(it + 1 - chunk, it + 1, leaves[0].detach(), stats)
    return (leaves[0].detach(), stats,
            None if i_exp is None else leaves[i_exp].detach(),
            None if i_cam is None else leaves[i_cam].detach())


def sample_add_rays(ms: MapperStatic, c2w, gt_color, gt_depth, r_add,
                    n_rays: int, generator=None, i=None, j=None):
    """Uniform candidate rays for densification: add_max candidates, the
    first n_rays marked valid."""
    dev = gt_depth.device
    if i is None:
        i, j = sampling.sample_pixels_uniform(0, ms.h, 0, ms.w, ms.add_max,
                                              generator, dev)
    valid = torch.arange(ms.add_max, device=dev) < n_rays
    rays_o, rays_d = camera.rays_from_uv(i, j, c2w, ms.fx, ms.fy, ms.cx, ms.cy)
    return (rays_o, rays_d, sampling.gather_pixels(gt_depth, i, j),
            sampling.gather_pixels(gt_color, i, j),
            sampling.gather_pixels(r_add, i, j), valid)


def sample_grad_rays(ms: MapperStatic, c2w, gt_color, gt_depth, r_add,
                     cand_idx, cand_ok, generator=None, scores=None):
    """Colour-gradient candidate rays: grad_max distinct picks from the
    top-gradient pool (``scores``: optional uniform draws over the pool)."""
    pos, ok = sampling.choose_without_replacement(cand_ok, ms.grad_max,
                                                  generator, scores)
    i, j = sampling.flat_to_ij(cand_idx[pos], ms.w)
    rays_o, rays_d = camera.rays_from_uv(i, j, c2w, ms.fx, ms.fy, ms.cx, ms.cy)
    return (rays_o, rays_d, sampling.gather_pixels(gt_depth, i, j),
            sampling.gather_pixels(gt_color, i, j),
            sampling.gather_pixels(r_add, i, j), ok)


class Mapper:
    """Host orchestration of per-frame mapping. Owns the cloud, the
    keyframe ring, the decoders, the exposure latent and the mapping random
    streams (a torch generator on the device, and a numpy one for the
    exposure initialisation and window selection)."""

    def __init__(self, cfg, decoders, n_img: int, rng: np.random.Generator,
                 device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.decoders = decoders
        self.n_img = n_img
        self.rng = rng
        cam = cfg["cam"]
        h, w = cam["H"], cam["W"]
        mp = cfg["mapping"]
        pcfg = cfg["pointcloud"]
        cu = cfg["cuda"]
        self.window = mp["mapping_window_size"] * (2 if n_img > 4000 else 1)
        self.ms = MapperStatic(
            h=h, w=w, fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
            r_max=pdist.padded(mp["pixels"], pdist.data_parallel(cfg)),
            f_max=2 * self.window + 2,
            w_color_loss=mp["w_color_loss"], frustum_edge=mp["frustum_edge"],
            fix_geo_decoder=mp["fix_geo_decoder"], n_add=pcfg["N_add"],
            near_end_surface_pc=pcfg["near_end_surface"],
            far_end_surface_pc=pcfg["far_end_surface"],
            add_max=mp["pixels_adding"] * 3,
            grad_max=max(mp["pixels_based_on_color_grad"], 1),
            grad_top=min(5 * max(mp["pixels_based_on_color_grad"], 1), h * w),
            encode_exposure=bool(cfg["model"]["encode_exposure"]),
            fused_adam=bool(cu.get("fused_adam", False)),
            bf16_features=R.resolve_auto(cu.get("bf16_features", False),
                                         self.device))
        self.rc = R.make_render_config(
            cfg, cfg["rendering"]["sigmoid_coef_mapper"], self.device)
        # set by the orchestrator with mapping.vis_inside: called as
        # vis_hook(idx, it_prev, it_now, n_iters, cur_c2w) every chunk
        self.vis_hook = None
        self.chunk = max(int(cu.get("max_iters_per_launch", 200)), 1)
        self.cloud = pc.init_cloud(cu["point_capacity_init"],
                                   cfg["model"]["c_dim"], pcfg["N_add"],
                                   self.device)
        self.n_points_host = 0
        self.cell_size = (pcfg["radius_query_ratio"] * pcfg["radius_add_max"]
                          if cfg["use_dynamic_radius"] else
                          max(pcfg["radius_query"], pcfg["radius_add"]))
        self.table_size = cu["grid_table_size"]
        self.max_per_cell = cu["grid_max_per_cell"]
        packed = cu.get("knn_packed_coords", "auto")
        self.packed_coords = (packed if packed == "fused"
                              else R.resolve_auto(packed, self.device))
        self.index = pc.build_index(self.cloud, self.cell_size,
                                    self.table_size, self.max_per_cell,
                                    self.packed_coords)
        self.store = KeyframeStore(cfg, h, w, n_img, mp["keyframe_every"],
                                   self.device)
        self.keyframe_list: List[int] = []
        self.refine_mode = False         # set per map_frame (color_refine)
        # drawn whether or not exposure is encoded, as the JAX package does
        # (it advances the window-selection stream the same way)
        self.exposure_feat = 0.01 * rng.standard_normal(
            cfg["model"]["exposure_dim"]).astype(np.float32)
        self.exposure_feat_all: List[np.ndarray] = []
        self.color_decoder_snapshots: List[Dict[str, torch.Tensor]] = []
        self.dyn = cfg["use_dynamic_radius"]
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(cfg["setup_seed"]))
        self.frame_stats: Dict[int, Dict[str, Any]] = {}

    def _ensure_capacity(self, worst_new: int):
        cap = self.cloud.packed.shape[0]
        cap_max = self.cfg["cuda"]["point_capacity_max"]
        grew = False
        while self.n_points_host + worst_new > cap and cap < cap_max:
            cap *= 2
            self.cloud = pc.grow_cloud(self.cloud, cap, self.ms.n_add)
            grew = True
        if self.n_points_host + worst_new > cap:
            raise RuntimeError("neural point cloud capacity exceeded")
        if grew:
            # keep the mean bucket occupancy near 8 points: an overfull
            # bucket drops points past max_per_cell
            while self.table_size < cap // 8:
                self.table_size *= 2
            self.index = pc.build_index(self.cloud, self.cell_size,
                                        self.table_size, self.max_per_cell,
                                        self.packed_coords)

    def radius_maps(self, color_dev):
        """(r_add, r_query, cand_idx, cand_ok) of one frame."""
        pcfg = self.cfg["pointcloud"]
        if not self.dyn:
            shape = (self.ms.h, self.ms.w)
            return (torch.full(shape, pcfg["radius_add"], device=self.device),
                    torch.full(shape, pcfg["radius_query"], device=self.device),
                    None, None)
        return prepare_frame(color_dev, pcfg["radius_add_max"],
                             pcfg["radius_add_min"], pcfg["radius_query_ratio"],
                             pcfg["color_grad_threshold"], self.ms.grad_top)

    def _overlap_scores(self, cur_c2w, gt_depth):
        """Device overlap scores, or None when the window selection does
        not use them (empty store, or the 'global' method)."""
        n_kf = len(self.keyframe_list)
        if (n_kf == 0 or self.refine_mode
                or self.cfg["mapping"]["keyframe_selection_method"]
                != "overlap"):
            return None
        i, j = sampling.sample_pixels_uniform(0, self.ms.h, 0, self.ms.w, 200,
                                              self.generator, self.device)
        return overlap_scores(self.ms, self.store.est_c2w_padded(), n_kf - 1,
                              cur_c2w, gt_depth, i, j)

    def select_keyframes(self, scores: Optional[np.ndarray]) -> List[int]:
        """Window of keyframe slots: up to window-2 picks (overlapping, or
        global; 2*window-2 random ones in colour refinement) plus the
        latest keyframe; the current frame rides separately as the last
        slot."""
        num = self.window - 2
        n_kf = len(self.keyframe_list)
        if n_kf == 0:
            return []
        if self.refine_mode:
            num = 2 * self.window - 2
            sel = list(self.rng.permutation(max(n_kf - 1, 0))[:num])
        elif scores is None:
            sel = list(self.rng.permutation(max(n_kf - 1, 0))[:num])
        else:
            qualifying = [k for k in range(n_kf - 1) if scores[k] > 0.0]
            sel = list(self.rng.permutation(qualifying)[:num])
        return [int(s) for s in sel] + [n_kf - 1]

    def _densify(self, init: bool, color, depth, cur_c2w_dev, r_add,
                 cand_idx, cand_ok, n_acc: list) -> None:
        """Add points from uniform and colour-gradient candidate rays;
        each insert's accepted count (a device tensor) goes to ``n_acc``.
        Frame 0 sizes its uniform batch by the depth's median (one host
        read)."""
        mp, ms = self.cfg["mapping"], self.ms
        if init:
            with spans.span("sync.first_depth"):
                d_host = depth.cpu().numpy()
            med = (float(np.median(d_host[d_host > 0]))
                   if (d_host > 0).any() else 2.5)
            add_n = int(np.clip(mp["pixels_adding"] * (med / 2.5) ** 2,
                                mp["pixels_adding"],
                                mp["pixels_adding"] * 3))
        else:
            add_n = mp["pixels_adding"]
        self._ensure_capacity((ms.add_max + ms.grad_max) * ms.n_add)
        fix = self.cfg["pointcloud"]["fix_interval_when_add_along_ray"]

        def densify(batch):
            o, d, dep, col, ra, valid = batch
            n_before = self.cloud.n_points
            with spans.span("pc.add_points"):
                self.cloud, n = pc.add_points(
                    self.cloud, self.index, o, d, dep, col, valid, ra,
                    ms.near_end_surface_pc, ms.far_end_surface_pc,
                    n_add=ms.n_add, fix_interval=fix,
                    generator=self.generator)
            with spans.span("pc.insert_index"):
                self.index = pc.insert_index(self.cloud, self.index,
                                             n_before,
                                             m=o.shape[0] * ms.n_add)
            n_acc.append(n)

        densify(sample_add_rays(ms, cur_c2w_dev, color, depth, r_add,
                                add_n, self.generator))
        if mp["pixels_based_on_color_grad"] > 0 and cand_idx is not None:
            # drawn after the first insert, so its dedup sees those
            # points
            densify(sample_grad_rays(ms, cur_c2w_dev, color, depth,
                                     r_add, cand_idx, cand_ok,
                                     self.generator))

    def _ba_cameras(self, sel: List[int], cur_c2w, n_frames: int,
                    n_iters: int) -> Dict[str, Any]:
        """Bundle adjustment's window cameras, their mask (the oldest
        keyframe and the padding held) and learning-rate window."""
        mp, ms, dev = self.cfg["mapping"], self.ms, self.device
        poses = [self.store.est_c2w[s] for s in sel] + [cur_c2w]
        # padding slots get IDENTITY quaternions: a zero one is a
        # NaN pose (2/|q|^2), which would poison every gradient
        pad_cam = np.array([1, 0, 0, 0, 0, 0, 0], np.float32)
        cams = np.stack([camera.tensor_from_pose_matrix(p) for p in poses]
                        + [pad_cam] * (ms.f_max - n_frames))
        mask = np.zeros(ms.f_max, np.float32)
        mask[:n_frames] = 1.0
        mask[int(np.argmin([self.keyframe_list[s] for s in sel]))] = 0.0
        ratio = mp["geo_iter_ratio"]
        return dict(cams=spans.upload(cams, dev),
                    mask=spans.upload(mask, dev),
                    lr=float(mp["BA_cam_lr"]),
                    lo=int(n_iters * (ratio + 0.2)),
                    hi=int(n_iters * (ratio + 0.3)))

    def map_frame(self, idx: int, gt_color, gt_depth, gt_c2w, cur_c2w,
                  color_refine: bool = False, radius=None) -> Dict[str, Any]:
        """Map one frame. ``gt_color``/``gt_depth`` may be numpy or device
        tensors; ``radius``: optional precomputed radius_maps(color).

        ``color_refine``: the end-of-sequence colour refinement: no
        densification, the whole cloud optimisable, 5 windows of 2*window-2
        random keyframes, 2*iters iterations each with only iteration 0 in
        the geometry stage, the colour decoder frozen and the colour
        features at color_lr/10. With BA the refined poses are written back
        to the keyframe store and the current one is returned as
        ``cur_c2w``."""
        mp = self.cfg["mapping"]
        init = idx == 0
        self.refine_mode = color_refine
        fga = mp.get("fix_geo_decoder_after") or 0
        if fga and not self.ms.fix_geo_decoder and idx >= fga:
            self.ms = self.ms._replace(fix_geo_decoder=True)

        dev = self.device
        color = spans.upload(gt_color, dev)
        depth = spans.upload(gt_depth, dev)
        cur_c2w = np.asarray(cur_c2w, np.float32)
        cur_c2w_dev = spans.upload(cur_c2w, dev)
        r_add, r_query, cand_idx, cand_ok = (
            radius if radius is not None else self.radius_maps(color))
        if cand_ok is not None:
            cand_ok = cand_ok & (depth.reshape(-1)[cand_idx] > 0)

        # ---- densification
        ms = self.ms
        n_acc = []
        densified = None
        if not color_refine:
            with spans.span("map.densify") as densified:
                self._densify(init, color, depth, cur_c2w_dev, r_add,
                              cand_idx, cand_ok, n_acc)

        # ---- frustum gradient mask (the whole cloud in refinement)
        with spans.span("map.frustum"):
            cap = self.cloud.packed.shape[0]
            if mp["frustum_feature_selection"] and not color_refine:
                with spans.span("sync.inv"):  # the inverse's error check
                    w2c = torch.linalg.inv(cur_c2w_dev)
                frustum = pc.frustum_mask(
                    self.cloud.pos, self.cloud.n_points, w2c, depth, ms.fx,
                    ms.fy, ms.cx, ms.cy, ms.frustum_edge)
            else:
                frustum = torch.arange(cap, device=dev) < self.cloud.n_points

        # ---- one host fetch: densify counters + overlap scores
        with spans.span("map.window"):
            scores_dev = self._overlap_scores(cur_c2w_dev, depth)
        fetch = []
        if n_acc:
            fetch += [torch.stack(n_acc).sum().float()[None],
                      self.cloud.n_points.float()[None]]
        if scores_dev is not None:
            fetch.append(scores_dev.float())
        host = np.zeros(0)
        if fetch:
            fetch = torch.cat(fetch)
            with spans.span("sync.map_fetch"):
                host = fetch.cpu().numpy()
        n_acc_total = 0
        if n_acc:
            n_acc_total = int(host[0])
            self.n_points_host = int(host[1])
            host = host[2:]
            if densified is not None:
                densified.count("points_added", n_acc_total)
        scores = host if scores_dev is not None else None

        # ---- iteration budget
        if init:
            n_iters, geo_bound = mp["iters_first"], mp["geo_iter_first"]
        elif color_refine:
            n_iters, geo_bound = 2 * mp["iters"], 0
        else:
            n_iters = int(np.clip(int(mp["iters"] * n_acc_total / 300),
                                  int(mp["min_iter_ratio"] * mp["iters"]),
                                  2 * mp["iters"]))
            geo_bound = int(n_iters * mp["geo_iter_ratio"])

        # ---- LR schedule
        sched = mp["init" if init else "stage"]
        lr_geo = [sched["geometry"][k] for k in
                  ("decoders_lr", "geometry_lr", "color_lr")]
        if color_refine:
            lr_col = [sched["color"]["decoders_lr"], 0.0,
                      sched["color"]["color_lr"] / 10.0]
            fix_color = 0.0
        else:
            lr_col = [sched["color"][k] for k in
                      ("decoders_lr", "geometry_lr", "color_lr")]
            fix_color = 0.0 if mp["fix_color_decoder"] else 1.0

        # ---- window + optimise; colour refinement reruns it 5 times
        outer_iters = 5 if color_refine else 1
        stats = np.zeros(3)
        outer_done = 0
        for outer in range(outer_iters):
            with spans.span("map.window"):
                sel = self.select_keyframes(scores if outer == 0 else None)
                n_frames = len(sel) + 1
                k = len(sel)
                w_color, w_depth, w_rq, w_c2w, w_exp = \
                    self.store.gather_window(sel, ms.f_max)
                w_color[k], w_depth[k], w_rq[k], w_c2w[k] = (
                    color, depth, r_query, cur_c2w_dev)
                w_exp[k] = spans.upload(self.exposure_feat, dev)

                # ---- bundle adjustment once more than 4 keyframes exist
                ba_on = bool(mp["BA"]) and len(self.keyframe_list) > 4
                if ba_on != self.ms.ba:
                    self.ms = ms = self.ms._replace(ba=ba_on)
                ba = None
                if ba_on:
                    ba = self._ba_cameras(sel, cur_c2w, n_frames, n_iters)

            hook = None
            if self.vis_hook is not None:
                def hook(it_prev, it_now, packed_now, _stats,
                         c2w=cur_c2w_dev):
                    # publish the in-progress cloud so the panel renders
                    # the current map (the decoders step in place)
                    self.cloud = self.cloud._replace(packed=packed_now)
                    self.vis_hook(idx, it_prev, it_now, n_iters, c2w)
            with spans.span("map.optimize"):
                packed, stats_dev, exp_out, cams_out = map_optimize(
                    ms, self.rc, self.decoders, self.cloud.packed,
                    self.index, (w_color, w_depth, w_rq, w_c2w), n_frames,
                    ms.r_max // n_frames, frustum, lr_geo, lr_col,
                    fix_color, geo_bound, n_iters, generator=self.generator,
                    exposure=w_exp if ms.encode_exposure else None,
                    cur_slot=k, lr_exposure=0.001, ba=ba,
                    n_live=self.n_points_host, chunk=self.chunk,
                    chunk_hook=hook)
            self.cloud = self.cloud._replace(packed=packed)
            with spans.span("sync.map_stats"):
                if ms.encode_exposure:
                    self.exposure_feat = exp_out[k].cpu().numpy()
                stats = stats_dev.cpu().numpy()
                cams_host = (cams_out[:n_frames].cpu().numpy() if ba_on
                             else None)
            if ba_on:
                # optimised keyframe poses back to the store; the refined
                # current pose is the frame's estimate
                new_poses = [camera.pose_matrix_from_tensor_np(c)
                             for c in cams_host]
                for kk, s in enumerate(sel):
                    self.store.set_est_c2w(s, new_poses[kk])
                cur_c2w = new_poses[k]
                cur_c2w_dev = spans.upload(cur_c2w, dev)
            outer_done += 1
        if ms.encode_exposure:
            self.exposure_feat_all.append(self.exposure_feat.copy())
            # the colour decoder each exposure latent was trained against
            with spans.span("sync.map_stats"):
                self.color_decoder_snapshots.append(
                    {n: p.detach().cpu().clone()
                     for n, p in self.decoders.col.state_dict().items()})

        # ---- keyframe bookkeeping
        if ((idx % mp["keyframe_every"] == 0 or idx == self.n_img - 2)
                and idx not in self.keyframe_list
                and np.isfinite(gt_c2w).all()):
            with spans.span("map.keyframe_append"):
                self.store.append(color, depth, cur_c2w, self.exposure_feat)
            self.keyframe_list.append(idx)

        out = {"geo_loss": float(stats[0]), "color_loss": float(stats[1]),
               "n_mask": float(stats[2]), "n_added": n_acc_total,
               "n_iters": n_iters, "n_points": self.n_points_host,
               "outer_loops": outer_done, "ba": ba_on,
               "cur_c2w": np.asarray(cur_c2w, np.float32)}
        self.frame_stats[idx] = out
        return out
