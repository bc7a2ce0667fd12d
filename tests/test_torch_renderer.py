"""Port parity, renderer.py: render_rays on the same map (a synthetic-room
cloud densified by the JAX package and carried across by interop) with the
same rays and the JAX key's random-fill draws injected into the port.
Both the per-sample grid_knn path (the CPU default) and the ray-shared
path over the lattice-packed index (the CUDA default; JAX runs its Pallas
kernel in interpret mode) are compared.

Tolerance 2e-4: the decoders' Fourier phases reach ~1e3 rad (see
test_torch_decoders.py); validity masks are exact."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu import renderer as JR
from point_slam_tpu.common import camera as jcam
from point_slam_tpu_torch import renderer as TR

from torch_parity import Scene, jax_fill, n, t

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", params=[False, True],
                ids=["grid_knn", "ray_knn_packed"])
def setup(request):
    ray = request.param
    scene = Scene(packed_coords=ray)
    _, _, depth, c2w = scene.frames[1]
    rng = np.random.default_rng(0)
    i = rng.integers(0, 64, 160).astype(np.float32)
    j = rng.integers(0, 48, 160).astype(np.float32)
    o, d = jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j), jnp.asarray(c2w),
                             40.0, 40.0, 31.5, 23.5)
    dep = depth[j.astype(int), i.astype(int)].copy()
    dep[:4] = 0.0                          # depth-free rays: uniform samples
    rq = rng.uniform(0.1, 0.16, 160).astype(np.float32)
    ok = np.ones(160, bool)
    ok[-3:] = False
    jrc = JR.RenderConfig(sample_near_pcl=False, ray_knn=ray, knn_probes=27)
    trc = TR.RenderConfig(ray_knn=ray, knn_probes=27)
    return scene, (np.asarray(o), np.asarray(d), dep, rq, ok), jrc, trc


@pytest.mark.parametrize("stage_color,is_tracker",
                         [(False, False), (True, False), (True, True)])
def test_render_rays_matches_jax(setup, stage_color, is_tracker):
    scene, rays, jrc, trc = setup
    key = jax.random.key(5)
    jout = JR.render_rays(scene.params, scene.jcloud.packed,
                          scene.jcloud.n_points, scene.jindex,
                          *map(jnp.asarray, rays), key, jrc,
                          stage_color=stage_color, is_tracker=is_tracker)
    tout = TR.render_rays(scene.tdec, scene.tcloud.packed, scene.tindex,
                          *map(t, rays), trc, stage_color=stage_color,
                          is_tracker=is_tracker, fill=jax_fill(key))
    names = ("depth", "uncertainty", "color")
    for name, a, b in zip(names, tout[:3], jout[:3]):
        np.testing.assert_allclose(n(a), np.asarray(b), err_msg=name, **TOL)
    np.testing.assert_array_equal(n(tout[3]), np.asarray(jout[3]))
    assert n(tout[3]).mean() > 0.5          # most rays see the map
    assert (n(tout[0])[:4] == 0).all()      # depth-free rays render 0


def test_render_gradients_reach_the_packed_features(setup):
    scene, rays, _, trc = setup
    packed = scene.tcloud.packed.clone().requires_grad_(True)
    depth, _, color, valid = TR.render_rays(
        scene.tdec, packed, scene.tindex, *map(t, rays), trc,
        stage_color=True, fill=torch.zeros(2, 32))
    (depth.sum() + color.sum()).backward()
    g = packed.grad
    assert torch.isfinite(g).all() and g[:, :64].abs().sum() > 0
    assert (g[:, 64:] == 0).all()           # positions never get gradients


def test_render_img_chunks(setup):
    scene, _, _, trc = setup
    _, _, depth, c2w = scene.frames[1]
    d, u, c = TR.render_img(scene.tdec, scene.tcloud, scene.tindex, t(c2w),
                            (40.0, 40.0, 31.5, 23.5), (48, 64),
                            trc._replace(ray_batch=1000), gt_depth=t(depth),
                            r_query=torch.full((48, 64), 0.16),
                            generator=torch.Generator().manual_seed(0))
    assert d.shape == (48, 64) and c.shape == (48, 64, 3)
    assert torch.isfinite(d).all() and torch.isfinite(c).all()
    hit = d > 0
    assert hit.float().mean() > 0.5
    assert (d[hit] - t(depth)[hit]).abs().median() < 0.1
