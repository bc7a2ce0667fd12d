"""Port parity, mapper.py: one mapping step's ray batch, loss and packed
(CAP, 72) gradient on the same map and keyframe window, with JAX's key
draws replayed into the port; the keyframe store's window; the overlap
scores; and the per-group Adam semantics of map_optimize (frustum row mask,
fixed position columns, the colour groups' step-count restart).

Tolerances: ray batches exact (same pixels, same decode); the loss 1e-4
relative and the packed gradient 2e-3 of its largest entry (decoder
Fourier phases, see test_torch_decoders.py; the row scatter-add sums in
another order); overlap scores within 2 of 1600 samples (frustum-edge
ulps)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu import mapper as JM
from point_slam_tpu import renderer as JR
from point_slam_tpu.common import image as jimg
from point_slam_tpu.common import sampling as jsamp
from point_slam_tpu_torch import mapper as TM
from point_slam_tpu_torch import renderer as TR
from point_slam_tpu_torch.ops import knn as tk

from torch_parity import Scene, jax_fill, n, t, tiny_cfgs

COMMON = dict(h=48, w=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5, r_max=400,
              f_max=10, w_color_loss=0.1, frustum_edge=-4.0,
              fix_geo_decoder=True, n_add=3, near_end_surface_pc=0.98,
              far_end_surface_pc=1.02, add_max=600, grad_max=50, grad_top=250)


@pytest.fixture(scope="module")
def setup():
    scene = Scene(packed_coords=False)
    jms = JM.MapperStatic(**COMMON, encode_exposure=False, max_iters=200)
    tms = TM.MapperStatic(**COMMON)
    f = COMMON["f_max"]
    color = np.zeros((f, 48, 64, 3), np.float32)
    depth = np.zeros((f, 48, 64), np.float32)
    rq = np.full((f, 48, 64), 1e6, np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    for slot, idx in enumerate((0, 2)):      # keyframe 0 + current frame 2
        _, color[slot], depth[slot], c2w[slot] = scene.frames[idx]
        rq[slot] = np.asarray(jimg.dynamic_radius_maps(
            jnp.asarray(color[slot]), 0.08, 0.02, 2, 0.15)[1])
    return scene, jms, tms, (color, depth, rq, c2w)


def _rays(setup, key):
    scene, jms, tms, (color, depth, rq, c2w) = setup
    jrays = JM._sample_window_rays(
        jms, key, dict(color=jnp.asarray(color), depth=jnp.asarray(depth),
                       r_query=jnp.asarray(rq)), jnp.asarray(2),
        jnp.asarray(200))
    ki, kj = jax.random.split(key)
    i = jax.random.randint(ki, (400,), 0, 64)
    j = jax.random.randint(kj, (400,), 0, 48)
    trays = TM._sample_window_rays(tms, (t(color), t(depth), t(rq)), 2, 200,
                                   t(i), t(j))
    return jrays, trays


def test_window_rays_match_jax(setup):
    jrays, trays = _rays(setup, jax.random.key(1))
    for k in ("gt_depth", "gt_color", "r_query", "slot", "ray_ok"):
        np.testing.assert_array_equal(n(trays[k]), np.asarray(jrays[k]),
                                      err_msg=k)
    np.testing.assert_allclose(n(trays["dirs_cam"]),
                               np.asarray(jrays["dirs_cam"]), rtol=1e-6)


@pytest.mark.parametrize("stage_color", [False, True])
def test_mapping_loss_and_packed_gradient_match_jax(setup, stage_color):
    scene, jms, tms, window = setup
    c2w = window[3]
    jrays, trays = _rays(setup, jax.random.key(2))
    key = jax.random.key(3)
    jrc = JR.RenderConfig(sample_near_pcl=False)

    def jloss(pk):
        return JM._losses(jms, jrc, scene.params, pk, jnp.zeros((10, 8)),
                          scene.jcloud.n_points, scene.jindex, jrays,
                          jnp.asarray(c2w), key, stage_color)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(scene.jcloud.packed)
    packed = scene.tcloud.packed.clone().requires_grad_(True)
    tl, geo, col, n_mask = TM._losses(tms, TR.RenderConfig(), scene.tdec,
                                      packed, scene.tindex, trays, t(c2w),
                                      stage_color, jax_fill(key))
    tl.backward()
    assert int(n_mask) > 250
    np.testing.assert_allclose(n(tl), np.asarray(jl), rtol=1e-4)
    jg = np.asarray(jg)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(n(packed.grad), jg, rtol=2e-3,
                               atol=2e-3 * np.abs(jg).max())
    if not stage_color:
        assert (n(packed.grad)[:, 32:] == 0).all()


def test_keyframe_window_matches_jax():
    jcfg, tcfg = tiny_cfgs(8)
    from point_slam_tpu.datasets import get_dataset
    ds = get_dataset(jcfg)
    jstore = JM.KeyframeStore(jcfg, 48, 64, 8, 8, 4)
    tstore = TM.KeyframeStore(tcfg, 48, 64, 8, 4, "cpu")
    for idx in (0, 4):
        _, color, depth, c2w = ds[idx]
        jstore.append(jnp.asarray(color), jnp.asarray(depth), c2w, c2w,
                      np.zeros(8, np.float32))
        tstore.append(t(color), t(depth), c2w)
    jw = jstore.gather_window([1, 0], 6)
    tw = tstore.gather_window([1, 0], 6)
    for k, (a, b) in enumerate(zip(tw, jw[:4])):
        if k == 2:                           # r_query: Sobel + interp
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5)
        else:
            np.testing.assert_array_equal(n(a), np.asarray(b))


def test_overlap_scores_match_jax(setup):
    scene, jms, tms, (color, depth, _, c2w) = setup
    ring = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    for k in range(3):
        ring[k] = scene.frames[k][3]
    ring[2, :3, 3] += 3.0                    # a pose looking elsewhere
    key = jax.random.key(6)
    js = JM.overlap_scores(jms, jnp.asarray(ring), jnp.asarray(3),
                           jnp.asarray(c2w[1]), jnp.asarray(color[1]),
                           jnp.asarray(depth[1]), key)
    i, j = jsamp.sample_pixels_uniform(key, 0, 48, 0, 64, 200)
    ts = TM.overlap_scores(tms, t(ring), 3, t(c2w[1]), t(depth[1]), t(i),
                           t(j))
    np.testing.assert_allclose(n(ts), np.asarray(js), atol=2 / 1600)
    # (the 20-pixel edge leaves a small window at 48x64)
    assert n(ts)[0] > 0 and (n(ts)[3:] == -1).all()


def test_map_optimize_group_semantics(setup):
    """Iteration 0 is geometry (colour columns get no gradient and lr 0),
    iteration 1 colour: the colour groups' first step has step count 1, so
    its bias-corrected size is the learning rate itself (0.744x without the
    restart). Rows outside the frustum and the position columns never
    move."""
    scene, _, tms, (color, depth, rq, c2w) = setup
    packed0 = scene.tcloud.packed
    dec = scene.tdec
    col_before = [p.detach().clone() for p in dec.col.parameters()]
    npts = int(scene.tcloud.n_points)
    frustum = torch.arange(packed0.shape[0]) < npts
    frustum[: npts // 2] = False
    lr_geo, lr_col = [0.001, 0.03, 0.0], [0.005, 0.005, 0.005]
    packed, stats, _, _ = TM.map_optimize(
        tms, TR.RenderConfig(), dec, packed0, scene.tindex,
        (t(color), t(depth), t(rq), t(c2w)), 2, 200, frustum, lr_geo, lr_col,
        1.0, 0, 2, generator=torch.Generator().manual_seed(0))
    try:
        delta = (packed - packed0).abs()
        assert torch.isfinite(packed).all() and float(stats[2]) > 0
        assert (delta[~frustum] == 0).all()
        assert (delta[:, 64:] == 0).all()
        moved = delta[:, 32:64][delta[:, 32:64] > 0]
        assert moved.numel() > 0
        np.testing.assert_allclose(float(moved.max()), 0.005, rtol=1e-3)
        steps = [(p.detach() - q).abs().max() for p, q in
                 zip(dec.col.parameters(), col_before)]
        np.testing.assert_allclose(float(max(steps)), 0.005, rtol=1e-3)
    finally:
        with torch.no_grad():
            for p, q in zip(dec.col.parameters(), col_before):
                p.copy_(q)


def test_map_optimize_hands_adam_what_the_benchmark_captures(setup,
                                                            monkeypatch):
    """The benchmark's check (port_bench/core/check.py::Steps) wraps
    adam.update through the module attribute and reads its arguments:
    one call an iteration; params[0] the packed leaf that the next
    _losses renders (its storage), at full size with its moments; its
    gradient the raw one times the frustum rows; params[1:] the trained
    decoder parameters, found by data_ptr. The in-place step over the live
    rows equals the functional step over every row."""
    scene, _, tms, (color, depth, rq, c2w) = setup
    packed0 = scene.tcloud.packed
    dec = scene.tdec
    kept = [p.detach().clone() for p in dec.parameters()]
    npts = int(scene.tcloud.n_points)
    frustum = torch.arange(packed0.shape[0]) < npts
    frustum[: npts // 2] = False
    names = {p.data_ptr(): n for n, p in dec.named_parameters()}
    real_update, real_losses = TM.adam.update, TM._losses
    real_grad = torch.autograd.grad
    calls, rendered, raw = [], [], []

    def losses(ms, rc, dec_, packed, *a, **k):
        rendered.append(packed.data_ptr())
        return real_losses(ms, rc, dec_, packed, *a, **k)

    def grad(outputs, inputs, *a, **k):
        out = real_grad(outputs, inputs, *a, **k)
        raw.append(out[0].clone())
        return out

    def update(params, grads, state, t, lr, *a, **k):
        clone = lambda xs: [x.clone() for x in xs]        # noqa: E731
        want, _ = real_update(clone(params), grads, {
            "m": clone(state["m"]), "v": clone(state["v"])}, t, lr)
        calls.append(dict(
            ptr=params[0].data_ptr(), grad=grads[0].clone(),
            shapes={tuple(x.shape) for x in (params[0], grads[0],
                                             state["m"][0], state["v"][0])},
            names=[names.get(p.data_ptr()) for p in params[1:]]))
        out = real_update(params, grads, state, t, lr, *a, **k)
        calls[-1]["equal"] = all(torch.equal(x, y)
                                 for x, y in zip(out[0], want))
        return out

    monkeypatch.setattr(TM.adam, "update", update)
    monkeypatch.setattr(TM, "_losses", losses)
    monkeypatch.setattr(torch.autograd, "grad", grad)
    try:
        TM.map_optimize(
            tms, TR.RenderConfig(), dec, packed0, scene.tindex,
            (t(color), t(depth), t(rq), t(c2w)), 2, 200, frustum,
            [0.001, 0.03, 0.0], [0.005, 0.005, 0.005], 1.0, 0, 3,
            generator=torch.Generator().manual_seed(0), n_live=npts)
    finally:
        with torch.no_grad():
            for p, q in zip(dec.parameters(), kept):
                p.copy_(q)
    trained = [nm for nm, _ in dec.named_parameters()
               if nm.startswith("col.")]
    assert len(calls) == 3 and len(rendered) == 3 and len(raw) == 3
    for it, c in enumerate(calls):
        assert c["ptr"] == rendered[it]
        if it + 1 < len(rendered):
            assert c["ptr"] == rendered[it + 1]
        assert c["shapes"] == {tuple(packed0.shape)}
        assert torch.equal(c["grad"], raw[it] * frustum.float()[:, None])
        assert c["names"] == trained
        assert c["equal"]


def test_ensure_capacity_grows_cloud_and_table():
    _, tcfg = tiny_cfgs(4)
    tcfg["cuda"]["point_capacity_init"] = 1 << 10
    from point_slam_tpu_torch.models import decoders as TD
    mapper = TM.Mapper(tcfg, TD.init_decoders(tcfg, 0), 4,
                       np.random.default_rng(0), "cpu")
    mapper._ensure_capacity(3000)
    assert mapper.cloud.packed.shape[0] == 1 << 12
    assert mapper.table_size == 1 << 14          # unchanged: >= cap // 8
    # 'auto' resolves to the f32 planes on the CPU
    assert isinstance(mapper.index, tk.GridIndex)
    assert mapper.index.px.shape == (mapper.table_size + 1, 64)
    with pytest.raises(RuntimeError, match="capacity"):
        mapper._ensure_capacity(1 << 17)
