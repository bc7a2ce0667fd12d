"""Port parity for the sensor-shaped slice: the fused coords|ids cell table
and its ray top-k (K3), the fused row-Adam (K4), near-cloud sampling, the
exposure MLP, and the renderer, tracker and mapper paths that
configs/Synthetic/room_sensor.yaml turns on, each against the JAX package
on the same inputs. JAX's Pallas kernels run in interpret mode on the CPU,
as tests/test_knn.py and tests/test_mapper.py run them; the port runs the
kernels' plain versions.

Tolerances: exact for the index planes, counts, keys, validity and the
near-cloud mask; winner ids equal as int32 bit patterns (an id read from a
lane past the candidates may be NaN bits); Adam 1e-6 relative (JAX's own
docstring allows a 1-ulp FMA drift); z-values 1e-6; decoder and render
outputs 2e-4 (Fourier phases, see test_torch_decoders.py); the tracker loss
1e-4; the mapping loss and its camera gradient 2e-3."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from point_slam_tpu import mapper as JM
from point_slam_tpu import pointcloud as jpc
from point_slam_tpu import renderer as JR
from point_slam_tpu import tracker as JT
from point_slam_tpu.common import camera as jcam
from point_slam_tpu.common import image as jimg
from point_slam_tpu.models import decoders as JD
from point_slam_tpu.ops import adam as jadam
from point_slam_tpu.ops import knn as jk
from point_slam_tpu_torch import interop
from point_slam_tpu_torch import mapper as TM
from point_slam_tpu_torch import pointcloud as tpc
from point_slam_tpu_torch import renderer as TR
from point_slam_tpu_torch import tracker as TT
from point_slam_tpu_torch.models import decoders as TD
from point_slam_tpu_torch.ops import adam as tadam
from point_slam_tpu_torch.ops import knn as tk

from torch_parity import (Scene, jax_decoders, jax_fill, n, t, tiny_cfgs,
                          to_numpy)

PHASE_TOL = dict(rtol=2e-4, atol=2e-4)


def make_cloud(n_pts, cap, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    pts = np.full((cap, 3), 1e6, np.float32)
    pts[:n_pts] = rng.uniform(-scale, scale, (n_pts, 3)).astype(np.float32)
    return pts, rng


def ray_queries(pts, n_pts, rng, n_rays, ns=5):
    """Ray-structured samples clustered within 0.04*depth."""
    centers = pts[rng.integers(0, n_pts, n_rays)]
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    depth = rng.uniform(1.5, 4.0, n_rays).astype(np.float32)
    z = depth[:, None] * np.linspace(0.98, 1.02, ns).astype(np.float32)
    return ((centers - dirs * depth[:, None])[:, None, :]
            + dirs[:, None, :] * z[..., None]).astype(np.float32)


def fused_indexes(pts, n_pts, cell=0.2, table=1 << 12, c=64):
    return (jk.build_fused_grid_index(jnp.asarray(pts), jnp.asarray(n_pts),
                                      jnp.asarray(cell), table_size=table,
                                      max_per_cell=c),
            tk.build_fused_grid_index(t(pts), n_pts, cell, table_size=table,
                                      max_per_cell=c))


def assert_fused_equal(ji, ti):
    np.testing.assert_array_equal(n(ti.plane), np.asarray(ji.plane))
    np.testing.assert_array_equal(n(ti.counts), np.asarray(ji.counts))
    np.testing.assert_array_equal(n(ti.cell_size), np.asarray(ji.cell_size))


# ------------------------------------------------------------ fused index

def test_fused_build_and_insert_match_jax():
    """Plane (coords and id bits) and counts bit for bit, for the build and
    an insert; the insert equals the port's own rebuild; the pxyz/pid views
    equal the packed layout's planes."""
    pts, _ = make_cloud(3000, 4096, seed=2)
    n0 = 2000
    ji, ti = fused_indexes(pts, n0)
    assert_fused_equal(ji, ti)
    ids = np.arange(n0, 4096, dtype=np.int32)
    valid = ids < 3000
    ji2 = jk.insert_grid_index(ji, jnp.asarray(pts[n0:]), jnp.asarray(ids),
                               jnp.asarray(valid))
    ti2 = tk.insert_grid_index(ti, t(pts[n0:]), t(ids, torch.long), t(valid))
    assert isinstance(ti2, tk.FusedGridIndex)
    assert_fused_equal(ji2, ti2)
    _, full = fused_indexes(pts, 3000)
    for a, b in zip(ti2, full):
        assert torch.equal(a, b)
    packed = tk.build_packed_grid_index(t(pts), 3000, 0.2, 1 << 12, 64)
    assert torch.equal(full.pxyz, packed.pxyz)
    assert torch.equal(full.pid, packed.pid)


def test_grid_knn_over_the_fused_index_matches_jax():
    pts, rng = make_cloud(3000, 4096, seed=4)
    ji, ti = fused_indexes(pts, 3000)
    q = rng.uniform(-2.2, 2.2, (500, 3)).astype(np.float32)
    jd, jidx, jv = jk.grid_knn(ji, jnp.asarray(q), k=8)
    td, tidx, tv = tk.grid_knn(ti, t(q), k=8)
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    np.testing.assert_array_equal(n(tidx), np.asarray(jidx))
    jd, td = np.asarray(jd), n(td)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------------ K3

def jax_fused_kernel(ji, q, p_ray=27, k=8, blk=32):
    """JAX's _ray_topk_kernel_fused through pallas_call in interpret mode,
    as ray_grid_knn launches it; R must be a multiple of ``blk``. Returns
    (probes, query lattice coords, lane_mask, keys, ids)."""
    r, ns, _ = q.shape
    probes, _ = jk._box_probes(q, ji.cell_size, ji.table_size, p_ray)
    c = ji.max_per_cell
    pc2 = p_ray * 2 * c
    lane_mask = (1 << (pc2 - 1).bit_length()) - 1
    cv = ji.plane[probes].reshape(r, pc2)
    qm = jk._query_lattice(q, ji.cell_size)
    bs_c = pl.BlockSpec((blk, pc2), lambda i: (i, 0), memory_space=pltpu.VMEM)
    bs_q = pl.BlockSpec((blk, ns), lambda i: (i, 0), memory_space=pltpu.VMEM)
    bs_o = pl.BlockSpec((blk, ns * k), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    keys, ids = pl.pallas_call(
        jk._ray_topk_kernel_fused(ns, k, pc2, lane_mask, c),
        grid=(r // blk,), in_specs=[bs_c, bs_q, bs_q, bs_q],
        out_specs=[bs_o, bs_o],
        out_shape=[jax.ShapeDtypeStruct((r, ns * k), jnp.int32),
                   jax.ShapeDtypeStruct((r, ns * k), jnp.float32)],
        interpret=True)(cv, qm[..., 0], qm[..., 1], qm[..., 2])
    return probes, qm, lane_mask, keys, ids


@pytest.mark.parametrize("c", [64, 48, 96])
@pytest.mark.parametrize("n_pts", [3000, 150], ids=["dense", "sparse"])
def test_ray_topk_reference_fused_matches_the_jax_kernel(n_pts, c):
    """Keys equal; ids equal as int32 bit patterns, including the winners
    of samples with fewer than k finite candidates (the sparse cloud),
    whose ids come from id lanes' +C neighbours; at C = 64 and at the
    generic kernel's widths 48 and 96 (96 the JAX package's default)."""
    pts, rng = make_cloud(n_pts, 4096, seed=5)
    ji, ti = fused_indexes(pts, n_pts, c=c)
    q = ray_queries(pts, n_pts, rng, 64)
    probes, qm, lane_mask, jkeys, jids = jax_fused_kernel(ji, jnp.asarray(q))
    assert lane_mask == tk._lane_mask(27 * 2 * c) == (8191 if c == 96
                                                     else 4095)
    keys, ids = tk.ray_topk_reference(t(probes), (ti.plane,), t(qm), 8,
                                      lane_mask)
    np.testing.assert_array_equal(n(keys), np.asarray(jkeys))
    np.testing.assert_array_equal(n(ids.view(torch.int32)),
                                  np.asarray(jids).view(np.int32))
    short = (n(keys) >= 0x7F800000).mean()
    assert (short > 0.3) if n_pts == 150 else (short < 0.05), short
    # the dispatcher takes the plain version on the CPU and counts nothing
    before = dict(tk.LAUNCHES)
    got = tk.ray_topk(t(probes), (ti.plane,), t(qm), 8, lane_mask)
    assert tk.LAUNCHES == before
    assert torch.equal(got[0], keys)
    assert torch.equal(got[1].view(torch.int32), ids.view(torch.int32))


def test_fused_ray_topk_widths_and_the_cpu_path():
    """The kernels take every C whose block fits in the shared memory
    (C = 16 here; on the card a block past it raises,
    tests/test_torch_cuda.py); the CPU path, the plain version, takes any
    C and counts no launch."""
    assert not hasattr(tk, "RAY_TOPK_WIDTHS")
    assert tk.check_ray_topk_shape("ray_topk_fused", 27, 16, 5) == (
        tk.ray_topk_smem_bytes("ray_topk_fused", 27, 16, 5))
    before = dict(tk.LAUNCHES)
    pts, rng = make_cloud(400, 1024, seed=8)
    index = tk.build_fused_grid_index(t(pts), 400, 0.2, table_size=1 << 10,
                                      max_per_cell=16)
    q = t(ray_queries(pts, 400, rng, 16))
    probes, _ = tk._box_probes(q, index.cell_size, index.table_size, 27)
    qm = tk._query_lattice(q, index.cell_size)
    got = tk.ray_topk(probes, (index.plane,), qm, 8, 1023)
    want = tk.ray_topk_reference(probes, (index.plane,), qm, 8, 1023)
    assert torch.equal(got[0], want[0]) and got[0].shape == (16, 40)
    assert tk.LAUNCHES == before


def test_ray_grid_knn_over_the_fused_index_matches_jax():
    """Valid masks and compact flags equal, winner ids equal on >= 99.9% of
    slots, exact recomputed d^2 within 1e-6, quantised d^2 as in
    test_torch_knn.py (one more lane bit: 2^-10 relative)."""
    pts, rng = make_cloud(3000, 4096, seed=6)
    ji, ti = fused_indexes(pts, 3000)
    q = ray_queries(pts, 3000, rng, 96)
    jd, jidx, jv, jc = jk.ray_grid_knn(ji, jnp.asarray(q), k=8, probes=27)
    td, tidx, tv, tc = tk.ray_grid_knn(ti, t(q), k=8, probes=27)
    np.testing.assert_array_equal(n(tv), np.asarray(jv))
    np.testing.assert_array_equal(n(tc), np.asarray(jc))
    same = n(tidx) == np.asarray(jidx)
    assert same.mean() >= 0.999, same.mean()
    flat = q.reshape(-1, 3)
    exact = lambda idx, v: np.where(
        v, ((flat[:, None, :] - pts[idx]) ** 2).sum(-1), np.inf)
    np.testing.assert_allclose(exact(n(tidx), n(tv)),
                               exact(np.asarray(jidx), np.asarray(jv)),
                               rtol=1e-6, atol=1e-9)
    td, jd = n(td), np.asarray(jd)
    assert (td == jd).mean() >= 0.999
    np.testing.assert_allclose(td, jd, rtol=2 ** -10)


# ------------------------------------------------------------------ K4

def adam_inputs(n_rows=1024, w=72, seed=11):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n_rows, w)).astype(np.float32)
    g = rng.standard_normal((n_rows, w)).astype(np.float32)
    m = (0.1 * rng.standard_normal((n_rows, w))).astype(np.float32)
    v = (0.01 * np.abs(rng.standard_normal((n_rows, w)))).astype(np.float32)
    mask = rng.random(n_rows) < 0.7
    t_row = rng.integers(1, 40, w).astype(np.float32)
    lr_row = rng.uniform(1e-4, 3e-2, w).astype(np.float32)
    return p, g, m, v, mask, t_row, lr_row


def test_update_rows_reference_matches_jax_update_rows():
    p, g, m, v, mask, t_row, lr_row = adam_inputs()
    jp, js = jadam.update_rows(jnp.asarray(p), jnp.asarray(g),
                               {"m": jnp.asarray(m), "v": jnp.asarray(v)},
                               jnp.asarray(t_row), jnp.asarray(lr_row),
                               jnp.asarray(mask))
    tp, ts = tadam.update_rows_reference(
        t(p), t(g), {"m": t(m), "v": t(v)}, t(t_row), t(lr_row),
        t(mask).float())
    np.testing.assert_allclose(n(tp), np.asarray(jp), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(n(ts["m"]), np.asarray(js["m"]), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(n(ts["v"]), np.asarray(js["v"]), rtol=1e-6,
                               atol=1e-8)
    # masked rows keep decayed moments and do not move
    np.testing.assert_array_equal(n(tp)[~mask][:, m[~mask].all(0) == 0],
                                  p[~mask][:, m[~mask].all(0) == 0])


def test_update_rows_reference_on_the_live_prefix_matches_jax_on_the_full_buffer():
    """The mapper's live-prefix update: the port's plain row-Adam over rows
    [0, n) with the rows past n kept equals JAX's update_rows over the
    whole buffer (its Pallas kernel in interpret mode) whose rows past n
    have zero gradient, moments and mask, as map_optimize's have; JAX
    leaves those rows bit for bit as they were. Tolerance as
    test_update_rows_reference_matches_jax_update_rows."""
    p, g, m, v, mask, t_row, lr_row = adam_inputs(seed=13)
    live = 700
    for a in (g, m, v):
        a[live:] = 0.0
    mask[live:] = False
    jp, js = jadam.update_rows(jnp.asarray(p), jnp.asarray(g),
                               {"m": jnp.asarray(m), "v": jnp.asarray(v)},
                               jnp.asarray(t_row), jnp.asarray(lr_row),
                               jnp.asarray(mask))
    tp, ts = tadam.update_rows_reference(
        t(p[:live]), t(g[:live]), {"m": t(m[:live]), "v": t(v[:live])},
        t(t_row), t(lr_row), t(mask[:live]).float())
    for got, kept, want in ((tp, p, jp), (ts["m"], m, js["m"]),
                            (ts["v"], v, js["v"])):
        want = np.asarray(want)
        np.testing.assert_array_equal(want[live:], kept[live:])
        np.testing.assert_allclose(np.concatenate([n(got), kept[live:]]),
                                   want, rtol=1e-6, atol=1e-8)


def test_update_rows_on_cpu_is_the_reference_and_counts_nothing():
    p, g, m, v, mask, t_row, lr_row = adam_inputs(seed=12)
    args = (t(p), t(g), {"m": t(m), "v": t(v)}, t(t_row), t(lr_row),
            t(mask).float())
    before = dict(tadam.LAUNCHES)
    got = tadam.update_rows(*args)
    want = tadam.update_rows_reference(*args)
    assert tadam.LAUNCHES == before
    assert torch.equal(got[0], want[0])
    for k in ("m", "v"):
        assert torch.equal(got[1][k], want[1][k])
    with pytest.raises(RuntimeError, match="unsupported device"):
        tadam.update_rows(*(x.to("meta") if isinstance(x, torch.Tensor)
                            else x for x in args[:2]), args[2], *args[3:])


# -------------------------------------------------------- sample_near_pcl

@pytest.fixture(scope="module", params=[False, True, "fused"],
                ids=["planes", "packed", "fused"])
def scene(request):
    return Scene(packed_coords=request.param)


def test_sample_near_pcl_matches_jax(scene):
    """All three layouts: z-values 1e-6 relative, the near-cloud mask
    equal; rays that miss the cloud fall back to uniform samples."""
    _, _, depth, c2w = scene.frames[1]
    rng = np.random.default_rng(1)
    i = rng.integers(0, 64, 120).astype(np.float32)
    j = rng.integers(0, 48, 120).astype(np.float32)
    o, d = jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j), jnp.asarray(c2w),
                             40.0, 40.0, 31.5, 23.5)
    o = np.asarray(o).copy()
    o[:10] += np.float32(50.0)                 # rays far from the cloud
    rq = rng.uniform(0.08, 0.16, 120).astype(np.float32)
    jz, jinv = jpc.sample_near_pcl(scene.jindex, jnp.asarray(o),
                                   jnp.asarray(np.asarray(d)), 0.3,
                                   jnp.asarray(4.0), jnp.asarray(rq), num=5)
    tz, tinv = tpc.sample_near_pcl(scene.tindex, t(o), t(np.asarray(d)), 0.3,
                                   torch.tensor(4.0), t(rq), num=5)
    np.testing.assert_array_equal(n(tinv), np.asarray(jinv))
    np.testing.assert_allclose(n(tz), np.asarray(jz), rtol=1e-6, atol=1e-7)
    inv = n(tinv)
    assert inv[:10].all() and not inv[10:].all()


# ------------------------------------------------- exposure, render, track

@pytest.fixture(scope="module")
def exposure_scene():
    """The fused-layout scene with decoders that carry the exposure MLP."""
    scene = Scene(packed_coords="fused")
    for cfg in (scene.jcfg, scene.tcfg):
        cfg["model"]["encode_exposure"] = True
    scene.params = jax_decoders(scene.jcfg, 0)
    scene.tdec = interop.decoders_from_numpy(to_numpy(scene.params),
                                             scene.tcfg)
    rng = np.random.default_rng(7)
    scene.exposure = (0.3 * rng.standard_normal((10, 8))).astype(np.float32)
    return scene


def test_exposure_affine_and_color_decoder_match_jax(exposure_scene):
    sc = exposure_scene
    rng = np.random.default_rng(2)
    p = rng.uniform(-2.5, 2.5, (256, 3)).astype(np.float32)
    c = rng.normal(0, 0.1, (256, 32)).astype(np.float32)
    jrot, jtrans = JD.exposure_affine(sc.params["col"],
                                      jnp.asarray(sc.exposure))
    trot, ttrans = sc.tdec.col.exposure_affine(t(sc.exposure))
    np.testing.assert_allclose(n(trot), np.asarray(jrot), **PHASE_TOL)
    np.testing.assert_allclose(n(ttrans), np.asarray(jtrans), **PHASE_TOL)
    assert n(trot).shape == (10, 3, 3) and np.abs(n(trot)).max() > 0
    want = JD.col_decoder_apply(sc.params["col"], jnp.asarray(p),
                                jnp.asarray(c),
                                exposure_feat=jnp.asarray(sc.exposure[3]))
    got = sc.tdec.col(t(p), t(c), exposure_feat=t(sc.exposure[3]))
    np.testing.assert_allclose(n(got), np.asarray(want), **PHASE_TOL)


@pytest.mark.parametrize("ray_knn", [False, True],
                         ids=["grid_knn", "ray_knn_fused"])
def test_render_rays_with_near_pcl_and_exposure_matches_jax(exposure_scene,
                                                            ray_knn):
    """Depth-free rays go through sample_near_pcl (no zero-depth clamp),
    valid_ray folds in the near-cloud mask, the colour takes the exposure
    affine; tolerance as test_torch_renderer.py."""
    sc = exposure_scene
    _, _, depth, c2w = sc.frames[1]
    rng = np.random.default_rng(0)
    i = rng.integers(0, 64, 160).astype(np.float32)
    j = rng.integers(0, 48, 160).astype(np.float32)
    o, d = jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j), jnp.asarray(c2w),
                             40.0, 40.0, 31.5, 23.5)
    dep = depth[j.astype(int), i.astype(int)].copy()
    dep[:12] = 0.0
    rq = rng.uniform(0.1, 0.16, 160).astype(np.float32)
    ok = np.ones(160, bool)
    rays = (np.asarray(o), np.asarray(d), dep, rq, ok)
    key = jax.random.key(5)
    jrc = JR.RenderConfig(sample_near_pcl=True, encode_exposure=True,
                          ray_knn=ray_knn, knn_probes=27)
    trc = TR.RenderConfig(sample_near_pcl=True, encode_exposure=True,
                          ray_knn=ray_knn, knn_probes=27)
    exp = sc.exposure[2]
    jout = JR.render_rays(sc.params, sc.jcloud.packed, sc.jcloud.n_points,
                          sc.jindex, *map(jnp.asarray, rays), key, jrc,
                          stage_color=True, exposure_feat=jnp.asarray(exp))
    tout = TR.render_rays(sc.tdec, sc.tcloud.packed, sc.tindex,
                          *map(t, rays), trc, stage_color=True,
                          fill=jax_fill(key), exposure_feat=t(exp))
    for name, a, b in zip(("depth", "uncertainty", "color"), tout[:3],
                          jout[:3]):
        np.testing.assert_allclose(n(a), np.asarray(b), err_msg=name,
                                   **PHASE_TOL)
    np.testing.assert_array_equal(n(tout[3]), np.asarray(jout[3]))
    assert n(tout[3]).mean() > 0.5
    assert (n(tout[0])[:12] != 0).any()      # no zero-depth clamp


def test_tracking_loss_with_color_grad_pixels_matches_jax(exposure_scene):
    """JAX's track_optimize, one iteration with sample_with_color_grad and
    the exposure latent; its candidate pool, its key's pool draw (uniform
    scores) and fill replayed into the port. The port's own pool equals
    JAX's on >= 99% of its entries (the top-k order of equal gradient
    magnitudes may differ)."""
    sc = exposure_scene
    _, color, depth, c2w = sc.frames[2]
    depth = depth.copy()
    depth[::7, ::5] = 0.0                      # sensor holes
    rq = np.asarray(jimg.dynamic_radius_maps(jnp.asarray(color), 0.08, 0.02,
                                             2, 0.15)[1])
    cam = jcam.tensor_from_pose_matrix(c2w) + np.array(
        [0, 0.002, -0.001, 0.001, 0.01, -0.008, 0.006], np.float32)
    static = dict(h=48, w=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5,
                  pixels=300, ignore_edge_w=5, ignore_edge_h=5,
                  handle_dynamic=True, depth_limit=False, use_color=True,
                  w_color_loss=0.5, separate_lr=True,
                  sample_with_color_grad=True, grad_top=1000)
    jts = JT.TrackerStatic(**static, max_iters=160)
    tts = TT.TrackerStatic(**static)
    jrc = JR.RenderConfig(sample_near_pcl=True, encode_exposure=True,
                          sigmoid_coef=0.1)
    trc = TR.RenderConfig(sample_near_pcl=True, encode_exposure=True)
    pool = TT.candidate_pool(tts, t(color), t(depth))
    grad = jimg.color_gradient_magnitude(jnp.asarray(color))
    from point_slam_tpu.common import sampling as jsamp
    jidx, jok = jsamp.top_gradient_candidates(grad, 5, 43, 5, 59, 1000,
                                              depth=jnp.asarray(depth))
    assert (n(pool[0]) == np.asarray(jidx)).mean() >= 0.99
    assert (n(pool[1]) == np.asarray(jok)).mean() >= 0.99
    assert len(set(n(pool[0])) ^ set(np.asarray(jidx).tolist())) <= 20
    exp = sc.exposure[4]
    key = jax.random.key(4)
    _, _, first, _, _ = JT.track_optimize(
        jts, jrc, sc.params, sc.jcloud.packed, sc.jcloud.n_points, sc.jindex,
        jnp.asarray(color), jnp.asarray(depth), jnp.asarray(rq),
        jnp.asarray(cam), jidx, jok, jnp.asarray(0.002, jnp.float32),
        jnp.asarray(1), key, exposure_feat=jnp.asarray(exp))
    _, k_it = jax.random.split(key)
    k_pix, k_render = jax.random.split(k_it)
    scores = jax.random.uniform(k_pix, jok.shape)
    _, _, tfirst, _ = TT.track_optimize(
        tts, trc, sc.tdec, sc.tcloud.packed, sc.tindex, t(color), t(depth),
        t(rq), t(cam), 0.002, 1, draws=[(t(scores), jax_fill(k_render))],
        pool=(t(jidx), t(jok)), exposure_feat=t(exp))
    np.testing.assert_allclose(n(tfirst), np.asarray(first), rtol=1e-4)
    assert float(tfirst) > 0


# ---------------------------------------------------------------- mapper

COMMON = dict(h=48, w=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5, r_max=400,
              f_max=10, w_color_loss=0.1, frustum_edge=-4.0,
              fix_geo_decoder=True, n_add=3, near_end_surface_pc=0.98,
              far_end_surface_pc=1.02, add_max=600, grad_max=50, grad_top=250)


@pytest.fixture(scope="module")
def window(exposure_scene):
    """Keyframes 0 and 1 plus the current frame 2 in a 10-slot window,
    their BA cameras, and one iteration's rays (JAX draws, replayed)."""
    sc = exposure_scene
    f = COMMON["f_max"]
    color = np.zeros((f, 48, 64, 3), np.float32)
    depth = np.zeros((f, 48, 64), np.float32)
    rq = np.full((f, 48, 64), 1e6, np.float32)
    for slot in range(3):
        _, color[slot], depth[slot], _ = sc.frames[slot]
        depth[slot, ::6, ::4] = 0.0
        rq[slot] = np.asarray(jimg.dynamic_radius_maps(
            jnp.asarray(color[slot]), 0.08, 0.02, 2, 0.15)[1])
    cams = np.tile(np.array([1, 0, 0, 0, 0, 0, 0], np.float32), (f, 1))
    for slot in range(3):
        cams[slot] = jcam.tensor_from_pose_matrix(sc.frames[slot][3])
    cams[2, 4:] += np.float32(0.01)            # a perturbed current pose
    jms = JM.MapperStatic(**COMMON, encode_exposure=True, max_iters=200,
                          ba=True)
    key = jax.random.key(2)
    jrays = JM._sample_window_rays(
        jms, key, dict(color=jnp.asarray(color), depth=jnp.asarray(depth),
                       r_query=jnp.asarray(rq)), jnp.asarray(3),
        jnp.asarray(133))
    ki, kj = jax.random.split(key)
    ij = (t(jax.random.randint(ki, (400,), 0, 64)),
          t(jax.random.randint(kj, (400,), 0, 48)))
    return (color, depth, rq, cams), jms, jrays, ij


def test_mapping_losses_with_exposure_and_ba_match_jax(exposure_scene,
                                                        window):
    """_losses with per-slot exposure affines and differentiable BA poses:
    the loss and its gradient with respect to the cameras within 2e-3."""
    sc = exposure_scene
    (color, depth, rq, cams), jms, jrays, (i, j) = window
    key = jax.random.key(3)
    jrc = JR.RenderConfig(sample_near_pcl=True, encode_exposure=True)

    def jloss(c):
        rt = jax.vmap(jcam.pose_matrix_from_tensor)(c)
        bottom = jnp.tile(jnp.asarray([[0., 0., 0., 1.]]), (c.shape[0], 1, 1))
        return JM._losses(jms, jrc, sc.params, sc.jcloud.packed,
                          jnp.asarray(sc.exposure), sc.jcloud.n_points,
                          sc.jindex, jrays,
                          jnp.concatenate([rt, bottom], axis=1), key,
                          True)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(cams))
    tms = TM.MapperStatic(**COMMON, encode_exposure=True, ba=True)
    trays = TM._sample_window_rays(tms, (t(color), t(depth), t(rq)), 3, 133,
                                   i, j)
    for k in ("gt_depth", "slot", "ray_ok"):
        np.testing.assert_array_equal(n(trays[k]), np.asarray(jrays[k]))
    tc = t(cams).requires_grad_(True)
    tl, _, col_l, n_mask = TM._losses(
        tms, TR.RenderConfig(sample_near_pcl=True, encode_exposure=True),
        sc.tdec, sc.tcloud.packed, sc.tindex, trays, TM._cam_poses(tc), True,
        jax_fill(key), t(sc.exposure))
    tl.backward()
    assert int(n_mask) > 200 and float(col_l.detach()) > 0
    np.testing.assert_allclose(n(tl), np.asarray(jl), rtol=2e-3)
    jg = np.asarray(jg)
    assert np.abs(jg[:3]).max() > 0 and (jg[3:] == 0).all()
    np.testing.assert_allclose(n(tc.grad), jg, rtol=2e-3,
                               atol=2e-3 * np.abs(jg).max())


def _optimize(sc, window, n_iters, fused, exposure=None, ba=None,
              geo_bound=0, n_live=None):
    (color, depth, rq, cams), *_ = window
    tms = TM.MapperStatic(**COMMON, encode_exposure=exposure is not None,
                          ba=ba is not None, fused_adam=fused)
    dec = interop.decoders_from_numpy(to_numpy(sc.params), sc.tcfg)
    c2w = np.tile(np.eye(4, dtype=np.float32), (10, 1, 1))
    for slot in range(3):
        c2w[slot] = sc.frames[slot][3]
    npts = int(sc.tcloud.n_points)
    frustum = torch.arange(sc.tcloud.packed.shape[0]) < npts
    frustum[: npts // 3] = False
    packed0 = sc.tcloud.packed.clone()
    out = TM.map_optimize(
        tms, TR.RenderConfig(sample_near_pcl=True,
                             encode_exposure=exposure is not None),
        dec, sc.tcloud.packed, sc.tindex,
        (t(color), t(depth), t(rq), t(c2w)), 3, 133, frustum,
        [0.001, 0.03, 0.0], [0.005, 0.005, 0.005], 1.0, geo_bound, n_iters,
        generator=torch.Generator().manual_seed(0), exposure=exposure,
        cur_slot=2, ba=ba, n_live=n_live)
    assert torch.equal(sc.tcloud.packed, packed0)   # the input is kept
    return out, frustum, dec


def test_map_optimize_moves_only_the_current_exposure(exposure_scene, window):
    sc = exposure_scene
    exp0 = t(sc.exposure)
    (packed, stats, exp, cams), _, _ = _optimize(sc, window, 3, False,
                                                 exposure=exp0)
    assert cams is None and torch.isfinite(packed).all()
    moved = (exp - exp0).abs().amax(dim=1)
    assert float(moved[2]) > 0
    assert (moved[torch.arange(10) != 2] == 0).all()


def test_map_optimize_moves_ba_cameras_only_inside_the_window(
        exposure_scene, window):
    """Cameras move only in iterations [lo, hi] and never where the mask
    is 0 (the oldest keyframe and the padding)."""
    sc = exposure_scene
    cams0 = t(window[0][3])
    mask = torch.tensor([0, 1, 1] + [0] * 7, dtype=torch.float32)
    base = dict(cams=cams0, mask=mask, lr=2e-4)
    (_, _, _, before), _, _ = _optimize(sc, window, 3, False,
                                        ba=dict(base, lo=5, hi=6))
    assert torch.equal(before, cams0)          # the window was not reached
    (_, _, _, cams), _, _ = _optimize(sc, window, 3, False,
                                      ba=dict(base, lo=1, hi=2))
    moved = (cams - cams0).abs().amax(dim=1)
    assert float(moved[1]) > 0 and float(moved[2]) > 0
    assert float(moved[0]) == 0 and (moved[3:] == 0).all()


def test_fused_adam_on_and_off_give_equal_buffers(exposure_scene, window,
                                                  monkeypatch):
    """Bit-equal under deterministic algorithms (the CPU's parallel
    scatter-add of the packed gradient sums in a varying order), with the
    fused Adam given the cloud's n_points live rows only: update_rows sees
    exactly those rows each iteration, and the rows past them come out
    bit-identical to the input."""
    sc = exposure_scene
    npts = int(sc.tcloud.n_points)
    rows = []
    real = tadam.update_rows

    def spy(params, *a, **kw):
        rows.append(tuple(params.shape))
        return real(params, *a, **kw)

    monkeypatch.setattr(tadam, "update_rows", spy)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        (p_off, s_off, _, _), frustum, dec_off = _optimize(sc, window, 3,
                                                           False)
        assert rows == []
        (p_on, s_on, _, _), _, dec_on = _optimize(sc, window, 3, True,
                                                  n_live=npts)
    finally:
        torch.use_deterministic_algorithms(was)
    assert rows == [(npts, sc.tcloud.packed.shape[1])] * 3
    assert npts < sc.tcloud.packed.shape[0]
    assert torch.equal(p_on[npts:], sc.tcloud.packed[npts:])
    assert torch.equal(p_on, p_off) and torch.equal(s_on, s_off)
    for a, b in zip(dec_on.parameters(), dec_off.parameters()):
        assert torch.equal(a, b)
    delta = (p_on - sc.tcloud.packed).abs()
    assert (delta[~frustum] == 0).all() and float(delta.max()) > 0


def test_map_frame_hands_the_fused_adam_the_live_rows(monkeypatch):
    """Mapper.map_frame with fused_adam: update_rows gets exactly the
    cloud's n_points rows each iteration (the host count the mapper already
    fetched), and the packed rows past them stay as they were."""
    _, tcfg = tiny_cfgs(4)
    tcfg["cuda"].update({"knn_packed_coords": "fused", "fused_adam": True})
    tcfg["mapping"]["iters_first"] = 3
    from point_slam_tpu_torch.datasets import get_dataset
    _, color, depth, c2w = get_dataset(tcfg)[0]
    mapper = TM.Mapper(tcfg, TD.init_decoders(tcfg, 0), 4,
                       np.random.default_rng(3), "cpu")
    rows = []
    real = tadam.update_rows

    def spy(params, *a, **kw):
        rows.append(params.shape[0])
        return real(params, *a, **kw)

    monkeypatch.setattr(tadam, "update_rows", spy)
    packed0 = mapper.cloud.packed.clone()
    mapper.map_frame(0, color, depth, c2w, c2w)
    live = mapper.n_points_host
    assert 0 < live == int(mapper.cloud.n_points)
    assert rows == [live] * 3
    assert mapper.cloud.packed.shape == packed0.shape
    assert torch.equal(mapper.cloud.packed[live:], packed0[live:])
    assert not torch.equal(mapper.cloud.packed[:live], packed0[:live])


def test_colour_refinement_schedule_matches_jax(monkeypatch):
    """map_frame(color_refine=True): no densification, 5 windows of up to
    2*window-2 random keyframes + the latest (the same picks as JAX from
    the same numpy seed), 2*iters iterations with only iteration 0 in the
    geometry stage, colour rates [decoders, 0, color/10], the colour
    decoder frozen, the whole cloud optimisable (JAX mapper.py:840-872)."""
    jcfg, tcfg = tiny_cfgs(8)
    for cfg in (jcfg, tcfg):
        cfg["mapping"]["mapping_window_size"] = 3
    from point_slam_tpu.datasets import get_dataset
    ds = get_dataset(jcfg)
    _, color, depth, c2w = ds[0]
    jmap = JM.Mapper(jcfg, jax_decoders(jcfg), 8, np.random.default_rng(3))
    tmap = TM.Mapper(tcfg, TD.init_decoders(tcfg, 0), 8,
                     np.random.default_rng(3), "cpu")
    np.testing.assert_array_equal(tmap.exposure_feat, jmap.exposure_feat)
    for m in (jmap, tmap):
        for kf in range(6):
            if m is jmap:
                m.store.append(jnp.asarray(color), jnp.asarray(depth), c2w,
                               c2w, np.zeros(8, np.float32))
            else:
                m.store.append(t(color), t(depth), c2w)
            m.keyframe_list.append(kf)
    jcalls, tcalls = [], []

    def jfake(ms, rc, params, packed, n_points, index, wc, wd, wr, wc2w, we,
              n_frames, pix, cur_slot, frustum, lr_geo, lr_col, lr_exp,
              fix_color, geo_bound, n_iters, key, **kw):
        jcalls.append((int(n_frames), np.asarray(lr_col).tolist(),
                       float(fix_color), int(geo_bound), int(n_iters),
                       int(np.asarray(frustum).sum()), float(lr_exp)))
        return params, packed, we, jnp.zeros(3), None, key, None

    def tfake(ms, rc, dec, packed, index, win, n_frames, pix, frustum,
              lr_geo, lr_col, fix_color, geo_bound, n_iters, **kw):
        tcalls.append((n_frames, list(lr_col), fix_color, geo_bound, n_iters,
                       int(frustum.sum()), kw["lr_exposure"]))
        assert kw["exposure"] is None and kw["ba"] is None
        return packed, torch.zeros(3), kw["exposure"], None

    monkeypatch.setattr(JM, "map_optimize", jfake)
    monkeypatch.setattr(TM, "map_optimize", tfake)
    jcfg["tpu"]["max_iters_per_launch"] = 10 ** 6
    js = jmap.map_frame(7, color, depth, c2w, c2w, color_refine=True)
    ts = tmap.map_frame(7, color, depth, c2w, c2w, color_refine=True)
    assert len(tcalls) == len(jcalls) == 5 and ts["outer_loops"] == 5
    np.testing.assert_allclose(np.array([c[1] for c in tcalls]),
                               np.array([c[1] for c in jcalls]), rtol=1e-6)
    for tc, jc in zip(tcalls, jcalls):
        assert (tc[0], tc[2], tc[3], tc[4], tc[5]) == \
            (jc[0], jc[2], jc[3], jc[4], jc[5])
    n_iters, lr_col = tcalls[0][4], tcalls[0][1]
    assert n_iters == 2 * tcfg["mapping"]["iters"] and tcalls[0][3] == 0
    assert lr_col[1] == 0.0 and tcalls[0][2] == 0.0
    assert ts["n_added"] == js["n_added"] == 0
    # 2*window-2 = 4 random keyframes + the latest + the current frame
    assert tcalls[0][0] == 6
