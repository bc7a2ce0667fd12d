"""Port parity, tracker.py and ops/adam.py: one tracking step's robust loss
and pose gradient on the same map, pixels and random-fill draws; the loss
of JAX's own track_optimize at its first iteration with its key's draws
replayed into the port; the motion model; and the Adam formula.

Tolerances: the loss 1e-4 relative and the pose gradient 2e-3 of its
largest component (sums over 300 rays of decoder outputs whose Fourier
phases reach ~1e3 rad, see test_torch_decoders.py); Adam 1e-6; host-side
pose code exact."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu import renderer as JR
from point_slam_tpu import tracker as JT
from point_slam_tpu.common import camera as jcam
from point_slam_tpu.common import image as jimg
from point_slam_tpu.common import sampling as jsamp
from point_slam_tpu.ops import adam as jadam
from point_slam_tpu_torch import renderer as TR
from point_slam_tpu_torch import tracker as TT
from point_slam_tpu_torch.common import image as timg
from point_slam_tpu_torch.ops import adam as tadam

from torch_parity import Scene, jax_fill, n, t

STATIC = dict(h=48, w=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5, pixels=300,
              ignore_edge_w=5, ignore_edge_h=5, handle_dynamic=True,
              depth_limit=False, use_color=True, w_color_loss=0.5,
              separate_lr=True)


@pytest.fixture(scope="module")
def setup():
    scene = Scene(packed_coords=False)
    _, color, depth, c2w = scene.frames[2]
    rq = np.asarray(jimg.dynamic_radius_maps(jnp.asarray(color), 0.08, 0.02,
                                             2, 0.15)[1])
    cam = jcam.tensor_from_pose_matrix(c2w)
    cam = cam + np.array([0, 0.002, -0.001, 0.001, 0.01, -0.008, 0.006],
                         np.float32)
    jts = JT.TrackerStatic(**STATIC, sample_with_color_grad=False,
                           grad_top=4500, max_iters=160)
    jrc = JR.RenderConfig(sample_near_pcl=False, sigmoid_coef=0.1)
    return scene, color, depth, rq, cam, jts, jrc


def jax_tracking_loss(ts, rc, params, packed, n_points, index, gt_color,
                      gt_depth, rq_map, cam, i, j, key):
    """The loss body of point_slam_tpu.tracker.track_optimize, with the
    pixel draw given instead of drawn."""
    c2w = jcam.pose_matrix_from_tensor(cam)
    dep = jsamp.gather_pixels(gt_depth, i, j)
    col = jsamp.gather_pixels(gt_color, i, j)
    rq = jsamp.gather_pixels(rq_map, i, j)
    valid = dep > 0
    rays_o, rays_d = jcam.rays_from_uv(i, j, c2w, ts.fx, ts.fy, ts.cx, ts.cy)
    med = jimg.masked_median(dep, valid)
    mx = jimg.masked_max(dep, valid)
    valid &= dep <= jnp.minimum(10.0 * med, 1.2 * mx)
    depth, unc, color, _ = JR.render_rays(
        params, packed, n_points, index, rays_o, rays_d, dep, rq, valid, key,
        rc, stage_color=True, is_tracker=True)
    unc = jax.lax.stop_gradient(unc)
    tmp = jnp.abs(dep - depth) / jnp.sqrt(unc + 1e-10)
    nan_ok = ~(jnp.isnan(depth) | jnp.isnan(unc))
    mask = (tmp < 10.0 * jimg.masked_mean(tmp, valid & nan_ok)) & (dep > 0) \
        & nan_ok & valid
    geo = jnp.sum(jnp.where(mask, jnp.clip(tmp, 0.0, 1e3), 0.0))
    colr = jnp.sum(jnp.where(mask[:, None], jnp.abs(col - color), 0.0))
    return geo + ts.w_color_loss * colr


def test_tracking_loss_and_pose_gradient_match_jax(setup):
    scene, color, depth, rq, cam, jts, jrc = setup
    rng = np.random.default_rng(0)
    i = rng.integers(5, 59, 300).astype(np.float32)
    j = rng.integers(5, 43, 300).astype(np.float32)
    key = jax.random.key(9)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda c: jax_tracking_loss(
            jts, jrc, scene.params, scene.jcloud.packed, scene.jcloud.n_points,
            scene.jindex, jnp.asarray(color), jnp.asarray(depth),
            jnp.asarray(rq), c, jnp.asarray(i), jnp.asarray(j), key)))(
        jnp.asarray(cam))
    tcam = t(cam).requires_grad_(True)
    tl, _, _, n_mask = TT.tracking_loss(
        TT.TrackerStatic(**STATIC), TR.RenderConfig(), scene.tdec,
        scene.tcloud.packed, scene.tindex, t(color), t(depth), t(rq), tcam,
        t(i), t(j), jax_fill(key))
    tl.backward()
    assert int(n_mask) > 200
    np.testing.assert_allclose(n(tl), np.asarray(jl), rtol=1e-4)
    jg = np.asarray(jg)
    np.testing.assert_allclose(n(tcam.grad), jg, rtol=2e-3,
                               atol=2e-3 * np.abs(jg).max())


def test_first_loss_matches_jax_track_optimize(setup):
    """JAX's compiled loop, one iteration, with its key's pixel and fill
    draws replayed into the port's loop."""
    scene, color, depth, rq, cam, jts, jrc = setup
    key = jax.random.key(4)
    best, _, first, best_loss, _ = JT.track_optimize(
        jts, jrc, scene.params, scene.jcloud.packed, scene.jcloud.n_points,
        scene.jindex, jnp.asarray(color), jnp.asarray(depth), jnp.asarray(rq),
        jnp.asarray(cam), jnp.zeros(1, jnp.int32), jnp.zeros(1, bool),
        jnp.asarray(0.002, jnp.float32), jnp.asarray(1), key)
    _, k_it = jax.random.split(key)
    k_pix, k_render = jax.random.split(k_it)
    i, j = jsamp.sample_pixels_uniform(k_pix, 5, 43, 5, 59, 300)
    tbest, _, tfirst, tbest_loss = TT.track_optimize(
        TT.TrackerStatic(**STATIC), TR.RenderConfig(), scene.tdec,
        scene.tcloud.packed, scene.tindex, t(color), t(depth), t(rq), t(cam),
        0.002, 1, draws=[(t(i), t(j), jax_fill(k_render))])
    np.testing.assert_allclose(n(tfirst), np.asarray(first), rtol=1e-4)
    np.testing.assert_allclose(n(tbest_loss), np.asarray(best_loss), rtol=1e-4)
    # separate_LR keeps the PRE-step camera of the best iteration
    np.testing.assert_array_equal(n(tbest), cam)
    np.testing.assert_array_equal(np.asarray(best), cam)


def test_tracking_reduces_the_loss(setup):
    scene, color, depth, rq, cam, _, _ = setup
    g = torch.Generator().manual_seed(0)
    best, final, first, best_loss = TT.track_optimize(
        TT.TrackerStatic(**STATIC), TR.RenderConfig(), scene.tdec,
        scene.tcloud.packed, scene.tindex, t(color), t(depth), t(rq), t(cam),
        0.002, 8, generator=g)
    assert float(best_loss) < float(first)
    assert torch.isfinite(final).all() and not torch.equal(final, t(cam))


def test_motion_model_matches_jax():
    from torch_parity import tiny_cfgs
    jcfg, tcfg = tiny_cfgs(6)
    jtr = JT.Tracker(jcfg, 6)
    ttr = TT.Tracker(tcfg, "cpu")
    rng = np.random.default_rng(3)
    est = np.zeros((6, 4, 4), np.float32)
    for k in range(6):
        q = rng.normal(size=7).astype(np.float32)
        est[k] = np.eye(4)
        est[k, :3, :4] = np.asarray(jcam.pose_matrix_from_tensor(
            jnp.asarray(q)))
    for idx in (2, 3, 5):
        np.testing.assert_array_equal(
            ttr.initial_pose(idx, est, est[idx]),
            jtr.initial_pose(idx, est, est[idx]))
    # frames 0 and 1 take the GT pose
    res = ttr.track_frame(1, None, None, est[1], est, None, None)
    assert not res["tracked"] and np.array_equal(res["c2w"], est[1])


@pytest.mark.parametrize("per_column", [False, True])
def test_adam_update_matches_jax(per_column):
    rng = np.random.default_rng(5)
    p, g, m = (rng.normal(size=(64, 72)).astype(np.float32) for _ in range(3))
    v = rng.uniform(0, 1, (64, 72)).astype(np.float32)
    if per_column:
        tt = rng.integers(1, 40, 72).astype(np.float32)
        lr = rng.uniform(0, 0.01, 72).astype(np.float32)
    else:
        tt, lr = np.float32(7.0), np.float32(0.003)
    jp, js = jadam.update(jnp.asarray(p), jnp.asarray(g),
                          {"m": jnp.asarray(m), "v": jnp.asarray(v)},
                          jnp.asarray(tt), jnp.asarray(lr))
    (tp,), ts = tadam.update([t(p)], [t(g)], {"m": [t(m)], "v": [t(v)]},
                             t(tt), t(lr))
    np.testing.assert_allclose(n(tp), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n(ts["m"][0]), np.asarray(js["m"]), rtol=1e-6)
    np.testing.assert_allclose(n(ts["v"][0]), np.asarray(js["v"]), rtol=1e-6)


def test_masked_median_has_no_host_sync_shape():
    """The port's median stays a device tensor (no .item() in the loops)."""
    x = torch.arange(10.0)
    out = timg.masked_median(x, x > 2)
    assert isinstance(out, torch.Tensor) and out.dim() == 0 and out == 6.0
