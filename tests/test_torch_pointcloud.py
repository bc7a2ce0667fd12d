"""Port parity, pointcloud.py: densification (add_points with the JAX
package's own N(0, 0.1) feature draws handed to the port), the incremental
index insert, and the frustum gradient mask, on a synthetic-room cloud
carried across by interop.

Tolerances: exact for counts, accept decisions, ids and index planes; 1e-6
for positions (the same f32 ops, possibly fused differently)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu import pointcloud as jpc
from point_slam_tpu.common import camera as jcam
from point_slam_tpu_torch import pointcloud as tpc

from torch_parity import Scene, n, t


@pytest.fixture(scope="module", params=[False, True], ids=["planes", "packed"])
def scene(request):
    return Scene(packed_coords=request.param)


def _frame_rays(scene, idx, step=3):
    _, color, depth, c2w = scene.frames[idx]
    h, w = depth.shape
    jj, ii = np.meshgrid(np.arange(1, h, step), np.arange(1, w, step),
                         indexing="ij")
    i = ii.ravel().astype(np.float32)
    j = jj.ravel().astype(np.float32)
    o, d = jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j), jnp.asarray(c2w),
                             40.0, 40.0, 31.5, 23.5)
    ii, jj = i.astype(int), j.astype(int)
    return (np.asarray(o), np.asarray(d), depth[jj, ii], color[jj, ii])


def test_add_points_matches_jax(scene):
    o, d, dep, col = _frame_rays(scene, 2)
    b = o.shape[0]
    valid = np.arange(b) % 7 != 0
    rad = np.full(b, 0.04, np.float32)
    key = jax.random.key(11)
    jstate, jacc = jpc.add_points(
        scene.jcloud, scene.jindex, *map(jnp.asarray, (o, d, dep, col, valid,
                                                       rad)),
        key, 0.98, 1.02)
    kg, kc = jax.random.split(key)
    feats = (t(0.1 * jax.random.normal(kg, (b * 3, 32), jnp.float32)),
             t(0.1 * jax.random.normal(kc, (b * 3, 32), jnp.float32)))
    tstate, tacc = tpc.add_points(
        scene.tcloud, scene.tindex, *map(t, (o, d, dep, col, valid, rad)),
        0.98, 1.02, feats=feats)
    assert int(tacc) == int(jacc) > 0
    assert int(tstate.n_points) == int(jstate.n_points)
    assert int(tstate.n_inputs) == int(jstate.n_inputs)
    np.testing.assert_allclose(n(tstate.packed), np.asarray(jstate.packed),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(tstate.input_pos),
                               np.asarray(jstate.input_pos), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(n(tstate.input_rgb),
                               np.asarray(jstate.input_rgb), rtol=1e-6)

    # incremental insert == JAX insert == the port's own rebuild
    n_old = int(scene.jcloud.n_points)
    m = b * 3
    jidx = jpc.insert_index(jstate, scene.jindex, jnp.asarray(n_old), m=m)
    tidx = tpc.insert_index(tstate, scene.tindex, scene.tcloud.n_points, m=m)
    for name in jidx._fields:
        a, b_ = n(getattr(tidx, name)), np.asarray(getattr(jidx, name))
        if name in ("px", "py", "pz"):   # positions, as above
            np.testing.assert_allclose(a, b_, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b_, err_msg=name)
    packed = not hasattr(tidx, "px")
    rebuilt = tpc.build_index(tstate, scene.cell, 1 << 14, 64, packed)
    for a, b_ in zip(tidx, rebuilt):
        assert torch.equal(a, b_)


def test_add_points_on_an_empty_cloud_accepts_every_valid_ray():
    cloud = tpc.init_cloud(1 << 10, 32, 3)
    index = tpc.build_index(cloud, 0.16, 1 << 10, 64)
    o = torch.zeros((20, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(20, 3) + \
        torch.linspace(0, 0.1, 20)[:, None] * torch.tensor([1.0, 0.0, 0.0])
    dep = torch.full((20,), 2.0)
    dep[3] = 0.0
    g = torch.Generator().manual_seed(0)
    state, acc = tpc.add_points(cloud, index, o, d, dep, torch.rand(20, 3),
                                torch.ones(20, dtype=bool),
                                torch.full((20,), 0.04), 0.98, 1.02,
                                generator=g)
    assert int(acc) == 19 and int(state.n_points) == 57
    assert torch.all(state.pos[57:] == 1e6)


def test_grow_cloud_keeps_rows():
    cloud = tpc.init_cloud(1 << 8, 32, 3)
    cloud = cloud._replace(packed=torch.randn(1 << 8, 72))
    grown = tpc.grow_cloud(cloud, 1 << 9, 3)
    assert grown.packed.shape == (1 << 9, 72)
    assert torch.equal(grown.packed[:1 << 8], cloud.packed)
    assert torch.all(grown.pos[1 << 8:] == 1e6)
    assert grown.input_pos.shape == ((1 << 9) // 3, 3)


def test_frustum_mask_matches_jax(scene):
    _, _, depth, c2w = scene.frames[3]
    w2c = np.linalg.inv(c2w).astype(np.float32)
    jm = jpc.frustum_mask(scene.jcloud.pos, scene.jcloud.n_points,
                          jnp.asarray(w2c), jnp.asarray(depth), 40.0, 40.0,
                          31.5, 23.5, -4.0)
    tm = tpc.frustum_mask(scene.tcloud.pos, scene.tcloud.n_points, t(w2c),
                          t(depth), 40.0, 40.0, 31.5, 23.5, -4.0)
    jm, tm = np.asarray(jm), n(tm)
    assert 0 < tm.sum() <= int(scene.jcloud.n_points)
    # a point whose projection lands within an ulp of the frustum edge may
    # flip (the 4x4 product sums in another order): allow 1 in 1000
    assert (jm != tm).mean() <= 1e-3
