"""Plain PyTorch reference of one optimiser step of the tracker and of
the mapper.

Point-SLAM tracks a frame by Adam on the camera (a (w,x,y,z) quaternion
and a translation) under a robust depth and colour L1 loss, and maps a
frame by Adam on the map's feature columns and the decoders' weights
under a masked depth (then colour) L1 loss. Given the state before one
step (the camera or the map and weights, Adam's moments), the batch the
step drew (the pixels or window rays with their sensor depth, colour and
query radius, the random fill) and the configuration, this works out the
loss, its gradient and the state after the step, so a caller can set the
program's step beside it. The learning rates, step counts and masks come
from the configuration's rules; the frustum of optimisable map rows is
projected again here.

Adam is torch.optim.Adam's: b1 0.9, b2 0.999, eps 1e-8 outside the root,
bias correction in float32. Everything runs in float32 with TF32 off.

Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from reference import render as ref

B1, B2, EPS = 0.9, 0.999, 1e-8
GEO, COL, POS = ref.GEO, ref.COL, ref.POS


def adam(p, g, m, v, t, lr):
    """One Adam step of ``p``; ``t`` (1-based) and ``lr`` are numbers or
    tensors that broadcast against it. Returns (p, m, v)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=p.device)
    m = B1 * m + (1 - B1) * g
    v = B2 * v + (1 - B2) * g * g
    mh = m / (1.0 - B1 ** t)
    vh = v / (1.0 - B2 ** t)
    return p - lr * mh / (torch.sqrt(vh) + EPS), m, v


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(w,x,y,z) -> 3x3 rotation, scale-invariant (2/|q|^2)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    s = 2.0 / torch.sum(q * q)
    return torch.stack([
        torch.stack([1 - s * (y * y + z * z), s * (x * y - z * w),
                     s * (x * z + y * w)]),
        torch.stack([s * (x * y + z * w), 1 - s * (x * x + z * z),
                     s * (y * z - x * w)]),
        torch.stack([s * (x * z - y * w), s * (y * z + x * w),
                     1 - s * (x * x + y * y)])])


def intrinsics(cfg: Dict[str, Any]):
    """(fx, fy, cx, cy) of the frames as read: scaled to ``crop_size``,
    then ``crop_edge`` pixels cut from every side."""
    c = cfg["cam"]
    fx, fy, cx, cy, w, h = (c["fx"], c["fy"], c["cx"], c["cy"], c["W"],
                            c["H"])
    if c.get("crop_size") is not None:
        ch, cw = c["crop_size"]
        sx, sy = cw / w, ch / h
        fx, fy, cx, cy = fx * sx, fy * sy, cx * sx, cy * sy
    e = c.get("crop_edge") or 0
    return fx, fy, cx - e, cy - e


def lower_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The lower middle of the masked entries (+inf when none)."""
    vals = torch.sort(x[mask]).values
    if vals.numel() == 0:
        return torch.tensor(torch.inf, device=x.device)
    return vals[(vals.numel() - 1) // 2]


def masked_mean(x, mask):
    return torch.sum(torch.where(mask, x, 0.0)) / torch.clamp(mask.sum(),
                                                              min=1)


def depth_cut(dep: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Rays with depth, under min(10 x median, 1.2 x max) of the batch's."""
    ok = ok & (dep > 0)
    med = lower_median(dep, ok)
    mx = torch.max(torch.where(ok, dep, -torch.inf))
    return ok & (dep <= torch.minimum(10.0 * med, 1.2 * mx))


def frustum(pos, n: int, c2w, depth, fx, fy, cx, cy, edge):
    """Map rows 0..n-1 inside the camera's frustum, enlarged by ``edge``
    pixels, and no deeper than the bilinear sensor depth + 0.5 m there
    (the largest sampled depth where a sample reads 0)."""
    h, w = depth.shape
    w2c = torch.linalg.inv(c2w)
    cam = (torch.cat([pos, torch.ones_like(pos[:, :1])], 1) @ w2c.T)[:, :3]
    z = cam[:, 2] + 1e-5
    u = (-fx * cam[:, 0] + cx * cam[:, 2]) / z
    v = (fy * cam[:, 1] + cy * cam[:, 2]) / z
    x0, y0 = torch.floor(u).long(), torch.floor(v).long()
    du, dv = u - x0, v - y0
    samp = torch.zeros_like(u)
    for oy, ox, wt in ((0, 0, (1 - du) * (1 - dv)), (0, 1, du * (1 - dv)),
                       (1, 0, (1 - du) * dv), (1, 1, du * dv)):
        yy, xx = y0 + oy, x0 + ox
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        val = depth[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        samp = samp + torch.where(inside, val, 0.0) * wt
    samp = torch.where(samp == 0.0, samp.max(), samp)
    keep = (u < w - edge) & (u > edge) & (v < h - edge) & (v > edge)
    keep &= (-z >= 0) & (-z <= samp + 0.5)
    return keep & (torch.arange(pos.shape[0], device=pos.device) < n)


def track_step(k: Dict[str, Any], cfg: Dict[str, Any],
               rcfg: Dict[str, Any]) -> Dict[str, Any]:
    """The tracker's step ``k["it"]`` of the camera ``k["cam"]`` (7,):
    the pixels ``k["i"]`` (columns), ``k["j"]`` (rows) and their validity
    ``k["ok"]`` (or None), the frame's depth, colour and query radius
    images, the random fill, the map and the decoders' weights, Adam's
    moments of the quaternion and the translation. Returns the loss,
    the gradients and the camera after the step."""
    tr = cfg["tracking"]
    fx, fy, cx, cy = intrinsics(cfg)
    i, j = k["i"].long(), k["j"].long()
    dep = k["depth"][j, i]
    col = k["color"][j, i]
    rq = k["r_query"][j, i]
    valid = torch.ones_like(dep, dtype=torch.bool) if k["ok"] is None \
        else k["ok"].clone()
    if tr["depth_limit"]:
        valid &= dep < 5.0
    valid = depth_cut(dep, valid)
    quad = k["cam"][:4].clone().requires_grad_(True)
    trans = k["cam"][4:].clone().requires_grad_(True)
    dirs = torch.stack([(i.float() - cx) / fx, -(j.float() - cy) / fy,
                        -torch.ones_like(dep)], -1)
    with ref.ieee_f32():
        rd = dirs @ quat_to_rot(quad).T
        ro = trans.expand(rd.shape)
        depth, unc, color, _ = ref.render_train(
            k["packed"], k["weights"], ro, rd, dep, rq, valid, k["fill"],
            rcfg, True, True, pose_grad=True)
        unc = unc.detach()
        nan_ok = ~(torch.isnan(depth) | torch.isnan(unc))
        tmp = torch.abs(dep - depth) / torch.sqrt(unc + 1e-10)
        if tr["handle_dynamic"]:
            keep = tmp < 10.0 * masked_mean(tmp, valid & nan_ok)
        else:
            err = torch.abs(dep - depth)
            keep = err < 10.0 * lower_median(err.detach(), valid & nan_ok)
        mask = keep & (dep > 0) & nan_ok & valid
        geo = torch.sum(torch.where(mask, torch.clamp(tmp, 0.0, 1e3), 0.0))
        loss = geo
        if tr["use_color_in_tracking"]:
            loss = loss + tr["w_color_loss"] * torch.sum(torch.where(
                mask[:, None], torch.abs(col - color), 0.0))
        g_q, g_t = torch.autograd.grad(loss, [quad, trans])
    lr = float(tr["lr"])
    lr_q = 0.2 * lr if tr["separate_LR"] else lr
    t = k["it"] + 1
    new_q, _, _ = adam(quad.detach(), g_q, k["m"][0], k["v"][0], t, lr_q)
    new_t, _, _ = adam(trans.detach(), g_t, k["m"][1], k["v"][1], t, lr)
    return {"loss": float(loss.detach()), "grads": {"quad": g_q, "trans": g_t},
            "after": {"quad": new_q, "trans": new_t},
            "depth": depth.detach(), "color": color.detach()}


def map_lrs(cfg: Dict[str, Any], first: bool, colour_stage: bool,
            refine: bool):
    """(decoders, geometry features, colour features) learning rates; the
    colour refinement moves no geometry feature, and the colour features
    at a tenth of the colour stage's rate."""
    sched = cfg["mapping"]["init" if first else "stage"]
    stage = sched["color" if colour_stage else "geometry"]
    if refine:
        return (sched["color"]["decoders_lr"], 0.0,
                sched["color"]["color_lr"] / 10.0)
    return (stage["decoders_lr"], stage["geometry_lr"], stage["color_lr"])


def map_step(k: Dict[str, Any], cfg: Dict[str, Any],
             rcfg: Dict[str, Any], trained: List[str]) -> Dict[str, Any]:
    """The mapper's step ``k["it"]`` of a frame mapped for
    ``k["n_iters"]`` iterations: the window rays (camera-space
    directions, window slot, sensor depth, colour, query radius) over
    ``k["n_frames"]`` window frames of ``k["per_frame"]`` rays each, the
    window's poses, the random fill, the map (its rows, ``k["packed"]``),
    the decoders' weights and those of them in ``trained``, Adam's
    moments of each, and the current frame's pose and depth (the
    frustum). ``k["refine"]``: the frame is the sequence's last, mapped
    as the colour refinement (its first iteration alone in the geometry
    stage, the whole map optimisable, the colour decoder frozen). Returns
    the loss, the gradients and the leaves after the step, keyed
    "packed" and by weight name."""
    mp = cfg["mapping"]
    ratio = mp["geo_iter_ratio"]
    first = k["frame"] == 0
    refine = bool(k["refine"])
    geo_bound = (int(mp["geo_iter_first"]) if first else 0 if refine
                 else int(k["n_iters"] * ratio))
    it = k["it"]
    colour_stage = it > geo_bound
    rays = k["rays"]
    r = rays["gt_depth"].shape[0]
    slot_ok = torch.arange(r, device=rays["gt_depth"].device) \
        // max(k["per_frame"], 1) < k["n_frames"]
    ray_ok = depth_cut(rays["gt_depth"], slot_ok)
    c2w = k["c2w_window"][rays["slot"]]
    rd = torch.einsum("rkl,rl->rk", c2w[:, :3, :3], rays["dirs_cam"])
    ro = c2w[:, :3, 3]
    packed = k["packed"].clone().requires_grad_(True)
    weights = {n: (t.clone().requires_grad_(True) if n in trained else t)
               for n, t in k["weights"].items()}
    with ref.ieee_f32():
        depth, _, color, valid_ray = ref.render_train(
            packed, weights, ro, rd, rays["gt_depth"], rays["r_query"],
            ray_ok, k["fill"], rcfg, colour_stage, True)
        mask = (rays["gt_depth"] > 0) & valid_ray & ray_ok \
            & ~torch.isnan(depth)
        loss = torch.sum(torch.where(mask, torch.abs(rays["gt_depth"]
                                                     - depth), 0.0))
        if colour_stage:
            loss = loss + mp["w_color_loss"] * torch.sum(torch.where(
                mask[:, None], torch.abs(rays["gt_color"] - color), 0.0))
        leaves = [packed] + [weights[n] for n in trained]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    n = ref.live_rows(k["packed"])
    if mp["frustum_feature_selection"] and not refine:
        rows = frustum(k["packed"][:, POS], n, k["c2w"], k["frame_depth"],
                       *intrinsics(cfg), mp["frustum_edge"])
    else:
        rows = torch.arange(packed.shape[0], device=packed.device) < n
    g_packed = grads[0] * rows.float()[:, None]
    fix_color = 0.0 if mp["fix_color_decoder"] or refine else 1.0
    lr_dec, lr_geo, lr_col = map_lrs(cfg, first, colour_stage, refine)
    t_geo = float(it + 1)
    t_col = float(max(it - geo_bound, 1))
    w = packed.shape[1]
    cols = torch.arange(w, device=packed.device)
    is_geo = (cols >= GEO.start) & (cols < GEO.stop)
    is_col = (cols >= COL.start) & (cols < COL.stop)
    t_row = torch.where(is_col, t_col, t_geo)
    lr_row = torch.where(is_geo, lr_geo, torch.where(is_col, lr_col, 0.0))
    out = {"packed": adam(packed.detach(), g_packed, k["m"]["packed"],
                          k["v"]["packed"], t_row, lr_row)[0]}
    g_out = {"packed": g_packed}
    for name, g in zip(trained, grads[1:]):
        is_c = name.startswith("col.")
        g = g * fix_color if is_c else g
        g_out[name] = g
        zero = torch.zeros_like(g)    # a leaf the program never stepped
        out[name] = adam(weights[name].detach(), g, k["m"].get(name, zero),
                         k["v"].get(name, zero), t_col if is_c else t_geo,
                         lr_dec)[0]
    return {"loss": float(loss.detach()), "grads": g_out, "after": out,
            "rows": rows, "colour_stage": colour_stage}


def step_gaps(before: Dict[str, torch.Tensor],
              prog_after: Dict[str, torch.Tensor],
              ref_after: Dict[str, torch.Tensor],
              prog_grads: Optional[Dict[str, torch.Tensor]],
              ref_grads: Dict[str, torch.Tensor]):
    """Per leaf, the program's step (after - before) against the
    reference's, and its gradient against the reference's: the norm of
    their difference over the reference's norm of that leaf or of the
    median leaf, whichever is larger. The map's rows are judged as three
    leaves: geometry features, colour features, the rest (position).

    A leaf that the reference does not move at all (no gradient and no
    step: the map's positions, a frozen decoder, a buffer) is *frozen*:
    the program's largest move of one is returned as ``frozen_moved``.
    Of the others, leaves whose reference gradient is under a thousandth
    of the median leaf's (moved by round-off alone) are left out.
    Returns {"step": {leaf: gap}, "grad": {leaf: gap}, "frozen_moved",
    "left_out": [leaf]}."""
    def parts(d):
        out = {}
        for name, t in d.items():
            if name == "packed":
                out["packed.geo"] = t[:, GEO]
                out["packed.col"] = t[:, COL]
                out["packed.rest"] = t[:, COL.stop:]
            else:
                out[name] = t
        return out
    b, pa, ra = parts(before), parts(prog_after), parts(ref_after)
    rg = parts(ref_grads)
    pg = parts(prog_grads) if prog_grads is not None else {}
    d_ref = {n: (ra[n] - b[n]).double() for n in b}
    d_prog = {n: (pa[n] - b[n]).double() for n in b}
    norm = torch.linalg.vector_norm
    gnorm = {n: float(norm(rg[n].double())) if n in rg else 0.0 for n in b}
    snorm = {n: float(norm(d_ref[n])) for n in b}
    frozen = [n for n in b if gnorm[n] == 0.0 and snorm[n] == 0.0]
    live = [n for n in b if n not in frozen]

    def median(vals):
        vals = sorted(vals)
        return vals[(len(vals) - 1) // 2] if vals else 0.0
    g_med = median(gnorm[n] for n in live)
    s_med = median(snorm[n] for n in live)
    steps, grads, left = {}, {}, []
    for n in live:
        if gnorm[n] < 1e-3 * g_med:
            left.append(n)
            continue
        steps[n] = float(norm(d_prog[n] - d_ref[n])) / max(snorm[n], s_med,
                                                          1e-30)
        if n in pg:
            grads[n] = float(norm(pg[n].double() - rg[n].double())) \
                / max(gnorm[n], g_med, 1e-30)
    moved = max((float(d_prog[n].abs().max()) for n in frozen
                 if d_prog[n].numel()), default=0.0)
    return {"step": steps, "grad": grads, "frozen_moved": moved,
            "left_out": left}
