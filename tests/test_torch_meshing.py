"""Port parity, the meshing and reconstruction tools: TSDF fusion on the
device (tools/tsdf.py) of the box room of tests/test_meshing.py against
the JAX package's, marching tetrahedra and the connected-components filter
(tools/marching.py), the rasterizer and frustum test (utils/raster.py),
the mesh cull (tools/cull_mesh.py) and the 3D / 2D reconstruction metrics
(tools/eval_recon.py), each on the same seeded inputs.

Tolerances: TSDF grids atol 1e-5 (the same f32 projection and weighted
means, summed in another order); marching, rasterizer, cull and metrics
exact or atol 1e-6 / rtol 1e-6: they are host code with the same
arithmetic (the native libraries are built from byte-equal copies of the
same C++ sources with the same flags)."""

import os

import numpy as np
import pytest

from point_slam_tpu.tools import marching as jmarch
from point_slam_tpu.tools import tsdf as jtsdf
from point_slam_tpu.utils import raster as jraster
from point_slam_tpu_torch.tools import marching as tmarch
from point_slam_tpu_torch.tools import tsdf as ttsdf
from point_slam_tpu_torch.utils import raster as traster
from point_slam_tpu_torch.utils.ply import write_ply

from torch_parity import CONFIGS


@pytest.fixture(scope="module")
def box_room():
    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.datasets import get_dataset
    cfg = load_config(os.path.join(CONFIGS, "Synthetic", "room.yaml"),
                      os.path.join(CONFIGS, "point_slam.yaml"))
    cfg["synthetic"].update({"n_frames": 8, "angular_step": 0.25})
    cfg["cam"].update({"H": 60, "W": 80, "fx": 45.0, "fy": 45.0,
                       "cx": 39.5, "cy": 29.5})
    ds = get_dataset(cfg)
    return ds, [ds[i] for i in range(8)]


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain_weights", "normal_weighting"])
def volumes(request, box_room):
    ds, frames = box_room
    kw = dict(voxel=0.08, sdf_trunc=0.24, margin=0.1,
              normal_weighting=request.param)
    jv = jtsdf.TSDFVolume.from_bounds(-ds.box, ds.box, **kw)
    tv = ttsdf.TSDFVolume.from_bounds(-ds.box, ds.box, device="cpu", **kw)
    tv.chunk = 1 << 16                  # several chunks a frame
    for _, color, depth, c2w in frames:
        jv.integrate(depth, color, c2w, ds.fx, ds.fy, ds.cx, ds.cy)
        tv.integrate(depth, color, c2w, ds.fx, ds.fy, ds.cx, ds.cy)
    return ds, jv, tv


def test_tsdf_grids_match_jax(volumes):
    _, jv, tv = volumes
    assert tv.dims == jv.dims and tv.tsdf.device.type == "cpu"
    np.testing.assert_allclose(tv.origin, jv.origin)
    for name in ("tsdf", "weight", "color"):
        np.testing.assert_allclose(getattr(tv, name).numpy(),
                                   np.asarray(getattr(jv, name)), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert (tv.weight > 0).float().mean() > 0.05


def test_tsdf_wire_grids_and_mesh_match_jax(volumes):
    ds, jv, tv = volumes
    for a, b in zip(tv.wire_grids(), jtsdf._wire_grids(jv.tsdf, jv.weight,
                                                        jv.color)):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        # one quantisation step where the f32 grids differ in the last bits
        assert np.abs(a.numpy().astype(np.int64) - b).max() <= 1
    tverts, tfaces, tcols = tv.extract_mesh()
    jverts, jfaces, jcols = jv.extract_mesh()
    assert len(tverts) > 200
    np.testing.assert_array_equal(tfaces, jfaces)
    # an i16 step of the sdf moves a vertex by < voxel / 32767 * 2
    np.testing.assert_allclose(tverts, jverts, atol=0.08 * 2 / 32767 * 16)
    np.testing.assert_allclose(tcols, jcols, atol=1.5 / 255)
    # on the box walls, as tests/test_meshing.py checks the JAX mesh
    q = np.abs(tverts) - ds.box[None, :]
    d = np.linalg.norm(np.maximum(q, 0), axis=1) + np.minimum(q.max(1), 0)
    assert np.abs(d).mean() < 0.06


def test_tsdf_cos_weight_map_matches_jax(box_room):
    import torch
    ds, frames = box_room
    depth = frames[3][2].copy()
    depth[10:14, 20:30] = 0.0                      # a hole: weight 1 there
    want = np.asarray(jtsdf._cos_weight_map(depth, ds.fx, ds.fy, ds.cx,
                                            ds.cy))
    got = ttsdf.cos_weight_map(torch.from_numpy(depth), ds.fx, ds.fy, ds.cx,
                               ds.cy).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got.min() >= 0.1 and (got[10:14, 20:30] == 1.0).all()


def _noisy_sphere(seed=7):
    rng = np.random.default_rng(seed)
    nx, ny, nz = 40, 36, 28
    x, y, z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    sdf = np.clip((np.sqrt((x - 20.0) ** 2 + (y - 18.0) ** 2
                           + (z - 14.0) ** 2) - 9.0) / 3.0, -1, 1
                  ).astype(np.float32)
    sdf += 0.05 * rng.normal(size=sdf.shape).astype(np.float32)
    w = (np.abs(sdf) < 1).astype(np.float32)
    col = rng.random((nx, ny, nz, 3)).astype(np.float32)
    return sdf, w, col


def _keys(v, voxel=0.04):
    q = np.round(v / voxel * 1e5).astype(np.int64)
    return q[np.lexsort(q.T)]


def test_marching_native_numpy_and_jax_agree():
    sdf, w, col = _noisy_sphere()
    kw = dict(iso=0.0, origin=(0.5, -0.25, 1.0), voxel=0.04, weight=w,
              color=col)
    tn = tmarch.marching_tetrahedra(sdf, backend="native", **kw)
    tp = tmarch.marching_tetrahedra(sdf, backend="numpy", **kw)
    jn = jmarch.marching_tetrahedra(sdf, native=True, **kw)
    jp = jmarch.marching_tetrahedra(sdf, native=False, **kw)
    assert jmarch._load_native() is not None
    # the same code path gives the same arrays, in the same order
    for got, want in ((tn, jn), (tp, jp)):
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=0)
    # native and numpy: the same welded vertex set, the same faces as
    # position triples
    assert len(tn[0]) == len(tp[0]) > 1000 and len(tn[1]) == len(tp[1])
    np.testing.assert_array_equal(_keys(tn[0]), _keys(tp[0]))

    def faces(v, f):
        q = np.round(v / 0.04 * 1e5).astype(np.int64)
        tri = np.sort(q[f].reshape(len(f), 3, 3), axis=1).reshape(len(f), 9)
        return tri[np.lexsort(tri.T)]

    np.testing.assert_array_equal(faces(*tn[:2]), faces(*tp[:2]))


def test_marching_backend_is_explicit():
    sdf, _, _ = _noisy_sphere()
    with pytest.raises(ValueError, match="backend"):
        tmarch.marching_tetrahedra(sdf, backend="auto")


def test_connected_components_filter_matches_jax():
    ax = np.linspace(-1, 1, 32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = np.minimum(np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.5,
                     np.sqrt((x - 0.85) ** 2 + (y - 0.85) ** 2
                             + (z - 0.85) ** 2) - 0.06)
    verts, faces, _ = tmarch.marching_tetrahedra(sdf, 0.0, (-1, -1, -1),
                                                 ax[1] - ax[0])
    for min_verts in (1, 100, 10 ** 6):
        got = tmarch.connected_components_filter(verts, faces, min_verts)
        want = jmarch.connected_components_filter(verts, faces, min_verts)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    kept = tmarch.connected_components_filter(verts, faces, 100)
    assert 0 < len(kept[0]) < len(verts)


def _sphere_mesh(r=0.5, n=40):
    ax = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = np.sqrt(x ** 2 + y ** 2 + z ** 2) - r
    v, f, _ = tmarch.marching_tetrahedra(sdf, 0.0, (-1, -1, -1),
                                         ax[1] - ax[0])
    return v, f


@pytest.fixture(scope="module")
def sphere():
    return _sphere_mesh()


@pytest.mark.parametrize("z", [2.0, 0.7], ids=["outside", "near"])
def test_rasterizer_native_numpy_and_jax_agree(sphere, z):
    v, f = sphere
    c2w = np.eye(4)
    c2w[2, 3] = z
    w2c = np.linalg.inv(c2w)
    args = (v, f, w2c, 80.0, 80.0, 39.5, 29.5, 60, 80)
    tn = traster.rasterize_depth(*args, backend="native")
    tp = traster.rasterize_depth(*args, backend="numpy")
    jn = jraster.rasterize_depth(*args)
    jp = jraster.rasterize_depth(*args, force_numpy=True)
    assert jraster._load_native() is not None
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tn, tp, atol=1e-5, rtol=0)
    assert (tn > 0).mean() > 0.1


def test_points_in_any_frustum_native_numpy_and_jax_agree():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-3, 3, (5000, 3)).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    c2w[:, 0, 3] = [-1.0, 0.0, 1.5]
    w2c = np.linalg.inv(c2w).astype(np.float32)
    args = (pts, w2c, 40.0, 40.0, 31.5, 23.5, 48, 64)
    tn = traster.points_in_any_frustum(*args, backend="native")
    tp = traster.points_in_any_frustum(*args, backend="numpy")
    np.testing.assert_array_equal(tn, jraster.points_in_any_frustum(*args))
    np.testing.assert_array_equal(
        tp, jraster.points_in_any_frustum(*args, force_numpy=True))
    np.testing.assert_array_equal(tn, tp)
    assert 0 < tn.mean() < 1
    with pytest.raises(ValueError, match="backend"):
        traster.points_in_any_frustum(*args, backend="ctypes")


def test_cull_mesh_matches_jax(sphere):
    from point_slam_tpu.tools.cull_mesh import cull_mesh as jcull
    from point_slam_tpu_torch.tools.cull_mesh import cull_mesh as tcull
    v, f = sphere
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.0
    kw = dict(H=100, W=100, fx=600, fy=600, cx=49.5, cy=49.5)
    got, want = tcull(v, f, c2w[None], **kw), jcull(v, f, c2w[None], **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert 0 < len(got[1]) < len(f)


@pytest.fixture(scope="module")
def mesh_pair(sphere, tmp_path_factory):
    """A sphere and a deformed, shifted copy as ply files."""
    v, f = sphere
    tmp = tmp_path_factory.mktemp("recon")
    gt, rec = str(tmp / "gt.ply"), str(tmp / "rec.ply")
    write_ply(gt, v, f)
    rv = v * (1.0 + 0.06 * np.sin(5 * v[:, :1])) + np.array([0.01, 0, 0])
    write_ply(rec, rv.astype(np.float32), f)
    return rec, gt


@pytest.mark.parametrize("icp", [True, False], ids=["icp", "no_icp"])
def test_calc_3d_metric_matches_jax(mesh_pair, icp):
    from point_slam_tpu.tools.eval_recon import calc_3d_metric as j3d
    from point_slam_tpu_torch.tools.eval_recon import calc_3d_metric as t3d
    rec, gt = mesh_pair
    got = t3d(rec, gt, n_samples=20_000, icp_align=icp)
    want = j3d(rec, gt, n_samples=20_000, icp_align=icp)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert 0 < got["F-score"] < 100


def test_calc_2d_metric_matches_jax(mesh_pair):
    from point_slam_tpu.tools.eval_recon import calc_2d_metric as j2d
    from point_slam_tpu_torch.tools.eval_recon import calc_2d_metric as t2d
    rec, gt = mesh_pair
    got = t2d(rec, gt, n_imgs=4, seed=3)
    want = j2d(rec, gt, n_imgs=4, seed=3)
    assert got["depth l1"] == pytest.approx(want["depth l1"], rel=1e-6)
    assert np.isfinite(got["depth l1"]) and got["depth l1"] > 0
