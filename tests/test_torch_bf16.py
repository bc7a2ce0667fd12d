"""The render-path run keys against the JAX package, on the CPU: the bf16
render view (cuda.bf16_features), cuda.mlp_precision and
cuda.profile_dir (max_iters_per_launch is in test_torch_visualizer.py).

* ``encode_render``'s bits equal JAX's (tolerance 0) on seeded inputs
  with sentinel rows, negative and tiny coordinates (and subnormal lo
  lanes by value);
  ``neighbor_pos`` decodes to JAX's values; positions take no gradient,
  feature gradients arrive f32 and equal JAX's.
* ``render_rays`` from the bf16 view equals JAX's from its bf16 view at
  the renderer's tolerance (2e-4: the Fourier phases, see
  test_torch_decoders.py), both kNN paths.
* A short map + track with the view on meets the bounds of
  tests/test_bf16.py::test_map_track_bf16_close_to_f32 against the
  port's own f32 run and against the JAX package's bf16 run.
* ``make_render_config`` resolves mlp_precision as JAX does; on the CPU
  'default' and 'highest' give bit-equal decoder outputs and gradients.
* With profile_dir set, a run leaves a Chrome trace there, with the
  program's spans (``track_frame``, ``map.iter``) as ranges.
"""

import glob
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu import pointcloud as jpc
from point_slam_tpu import renderer as JR
from point_slam_tpu.common import camera as jcam
from point_slam_tpu_torch import pointcloud as tpc
from point_slam_tpu_torch import renderer as TR

from torch_parity import Scene, jax_fill, n, t, tiny_cfgs

TOL = dict(rtol=2e-4, atol=2e-4)


def _packed(seed=0, rows=400):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, tpc.PACK_W)) * 4).astype(np.float32)
    pos = x[:, tpc.POS_SL]
    pos[:8] = 1e6                                   # sentinel (empty) rows
    pos[8:40] = -np.abs(pos[8:40])
    pos[40:60] *= 1e-30                             # tiny
    pos[60:64] = [[0.0, -0.0, 1e-30], [-1e-30, 3e-34, 0.5],
                  [-1e6, 2.5, -2.5], [65504.0, -1e-3, 7.0]]
    x[:, tpc.POS_SL] = pos
    return x


def test_encode_render_bits_equal_jax():
    """Coordinates under ~2^-118 (3e-36) are compared by value only: their
    lo lane is subnormal, which XLA's CPU code flushes to zero and torch
    does not; the two decode to within 1.2e-38 of each other."""
    x = _packed()
    j = np.asarray(jpc.encode_render(jnp.asarray(x))).view(np.uint16)
    tv = tpc.encode_render(torch.from_numpy(x))
    assert tv.dtype == torch.bfloat16 and tv.shape == x.shape
    np.testing.assert_array_equal(n(tv.view(torch.int16)).view(np.uint16), j)
    np.testing.assert_array_equal(
        n(tpc.neighbor_pos(tv)),
        np.asarray(jpc.neighbor_pos(jpc.encode_render(jnp.asarray(x)))))
    # the hi+lo pair: ~2^-17 relative, sentinels exact (test_bf16.py)
    pos = n(tpc.neighbor_pos(tv))[64:]
    ref = x[64:, tpc.POS_SL]
    assert (np.abs(pos - ref) / (np.abs(ref) + 1e-12)).max() < 5e-5
    assert (n(tpc.neighbor_pos(tv))[:8] == 1e6).all()
    np.testing.assert_array_equal(n(tpc.neighbor_geo(tv)),
                                  np.asarray(jpc.neighbor_geo(
                                      jpc.encode_render(jnp.asarray(x)))))
    sub = np.array([[1e-45, -1e-40, 3e-39], [1.17549435e-38, -1e-37, 2e-36],
                    [0.0, 5e-37, -3e-39], [1e-38, 1e-38, 1e-38]], np.float32)
    xs = np.tile(x[:4], (1, 1))
    xs[:, tpc.POS_SL] = sub
    np.testing.assert_allclose(
        n(tpc.neighbor_pos(tpc.encode_render(torch.from_numpy(xs)))),
        np.asarray(jpc.neighbor_pos(jpc.encode_render(jnp.asarray(xs)))),
        rtol=0, atol=1.2e-38)
    # the f32 layout passes through
    f = torch.from_numpy(x)
    assert torch.equal(tpc.neighbor_pos(f), f[:, tpc.POS_SL])


def test_encode_render_gradients_match_jax():
    x = _packed(1, 256)
    idx = np.arange(0, 256, 2)

    def jloss(p32):
        rows = jpc.encode_render(p32)[idx]
        return (jnp.sum(jpc.neighbor_geo(rows) ** 2)
                + jnp.sum(jpc.neighbor_col(rows))
                + jnp.sum(jpc.neighbor_pos(rows)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    p = torch.from_numpy(x).requires_grad_(True)
    rows = tpc.encode_render(p)[torch.from_numpy(idx)]
    (torch.sum(tpc.neighbor_geo(rows) ** 2) + torch.sum(tpc.neighbor_col(rows))
     + torch.sum(tpc.neighbor_pos(rows))).backward()
    g = n(p.grad)
    assert p.grad.dtype == torch.float32
    assert (g[:, tpc.POS_SL.start:] == 0).all()     # positions: none
    assert (g[1::2] == 0).all()                     # ungathered rows
    np.testing.assert_array_equal(g, want)


@pytest.fixture(scope="module", params=[False, True],
                ids=["grid_knn", "ray_knn_packed"])
def scene(request):
    ray = request.param
    sc = Scene(packed_coords=ray)
    _, _, depth, c2w = sc.frames[1]
    rng = np.random.default_rng(0)
    i = rng.integers(0, 64, 160).astype(np.float32)
    j = rng.integers(0, 48, 160).astype(np.float32)
    o, d = jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j), jnp.asarray(c2w),
                             40.0, 40.0, 31.5, 23.5)
    dep = depth[j.astype(int), i.astype(int)].copy()
    rq = rng.uniform(0.1, 0.16, 160).astype(np.float32)
    rays = (np.asarray(o), np.asarray(d), dep, rq, np.ones(160, bool))
    return (sc, rays, JR.RenderConfig(ray_knn=ray, knn_probes=27),
            TR.RenderConfig(ray_knn=ray, knn_probes=27))


@pytest.mark.parametrize("is_tracker", [False, True])
def test_render_rays_from_the_bf16_view_matches_jax(scene, is_tracker):
    sc, rays, jrc, trc = scene
    key = jax.random.key(7)
    jout = JR.render_rays(sc.params, jpc.encode_render(sc.jcloud.packed),
                          sc.jcloud.n_points, sc.jindex,
                          *map(jnp.asarray, rays), key, jrc,
                          stage_color=True, is_tracker=is_tracker)
    tout = TR.render_rays(sc.tdec, tpc.encode_render(sc.tcloud.packed),
                          sc.tindex, *map(t, rays), trc, stage_color=True,
                          is_tracker=is_tracker, fill=jax_fill(key))
    for name, a, b in zip(("depth", "uncertainty", "color"), tout[:3],
                          jout[:3]):
        np.testing.assert_allclose(n(a), np.asarray(b), err_msg=name, **TOL)
    np.testing.assert_array_equal(n(tout[3]), np.asarray(jout[3]))
    assert n(tout[3]).mean() > 0.5


def _map_track(package, bf16):
    """tests/test_bf16.py's _run_map_track in either package: map frames
    0 and 2 of its 48x64 config, track frame 3. Returns (mapper, the map
    stats, the track result, frame 3's GT pose)."""
    jcfg, tcfg = tiny_cfgs(8)
    cfg = jcfg if package == "jax" else tcfg
    cfg["tracking"].update({"pixels": 256, "iters": 8})
    cfg["mapping"].update({"iters": 15, "iters_first": 25,
                           "geo_iter_first": 10})
    cfg["tpu" if package == "jax" else "cuda"]["bf16_features"] = bf16
    if package == "jax":
        from point_slam_tpu.datasets import get_dataset
        from point_slam_tpu.mapper import Mapper
        from point_slam_tpu.models import decoders as D
        from point_slam_tpu.tracker import Tracker
        ds = get_dataset(cfg)
        mapper = Mapper(cfg, D.init_decoders(
            jax.random.key(cfg["setup_seed"]), cfg), len(ds),
            np.random.default_rng(cfg["setup_seed"]))
        tracker = Tracker(cfg, len(ds))
        wrap = np.asarray
    else:
        from point_slam_tpu_torch.datasets import get_dataset
        from point_slam_tpu_torch.mapper import Mapper
        from point_slam_tpu_torch.models import decoders as D
        from point_slam_tpu_torch.tracker import Tracker
        ds = get_dataset(cfg)
        mapper = Mapper(cfg, D.init_decoders(cfg, cfg["setup_seed"]),
                        len(ds), np.random.default_rng(cfg["setup_seed"]),
                        "cpu")
        tracker = Tracker(cfg, "cpu")
        assert mapper.ms.bf16_features == tracker.ts.bf16_features == bf16
        wrap = torch.as_tensor
    est = np.zeros((len(ds), 4, 4), np.float32)
    for idx in range(3):
        est[idx] = np.asarray(ds[idx][3])
    stats = []
    for idx in (0, 2):
        _, color, depth, c2w = ds[idx]
        stats.append(mapper.map_frame(idx, color, depth, c2w, c2w))
    _, color, depth, c2w = ds[3]
    color, depth = wrap(color), wrap(depth)
    res = tracker.track_frame(3, color, depth, c2w, est, mapper,
                              mapper.radius_maps(color)[1])
    return mapper, stats, res, np.asarray(c2w, np.float32)


@pytest.fixture(scope="module")
def map_track_runs():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return {(pkg, bf16): _map_track(pkg, bf16)
                for pkg, bf16 in (("port", False), ("port", True),
                                  ("jax", True))}
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("reference", [("port", False), ("jax", True)],
                         ids=["port_f32", "jax_bf16"])
def test_map_track_bf16_meets_the_jax_bounds(map_track_runs, reference):
    """test_bf16.py's bounds, the port's bf16 run against ``reference``:
    the same point count where both densify on one stream (the port's f32
    twin), per-ray losses under 2x (or +0.05), the tracked position
    within max(6x the reference's error, 2 cm), the best loss <= 1.05x the
    first."""
    m_bf, s_bf, r_bf, gt = map_track_runs[("port", True)]
    m_ref, s_ref, r_ref, _ = map_track_runs[reference]
    if reference[0] == "port":
        assert int(m_bf.cloud.n_points) == int(m_ref.cloud.n_points)
    for a, b in zip(s_ref, s_bf):
        pa = a["geo_loss"] / max(a["n_mask"], 1)
        pb = b["geo_loss"] / max(b["n_mask"], 1)
        assert np.isfinite(pb)
        assert pb < max(2.0 * pa, pa + 0.05), (pa, pb)
    assert r_bf["tracked"] and r_ref["tracked"]
    e_ref = np.linalg.norm(r_ref["c2w"][:3, 3] - gt[:3, 3])
    e_bf = np.linalg.norm(r_bf["c2w"][:3, 3] - gt[:3, 3])
    assert e_bf < max(6.0 * e_ref, 0.02), (e_ref, e_bf)
    assert np.isfinite(r_bf["best_loss"])
    assert r_bf["best_loss"] <= r_bf["first_loss"] * 1.05


@pytest.mark.parametrize("value", [None, "", "global", "highest", "default",
                                   "float32"])
def test_make_render_config_resolves_mlp_precision_as_jax(value):
    jcfg, tcfg = tiny_cfgs(4)
    jcfg["tpu"]["mlp_precision"] = value
    tcfg["cuda"]["mlp_precision"] = value
    got = TR.make_render_config(tcfg, 0.1, "cpu").mlp_precision
    assert got == JR.make_render_config(jcfg, 0.1).mlp_precision
    assert got == (None if value in (None, "", "global", "highest")
                   else value)


def test_mlp_precision_changes_nothing_on_the_cpu():
    from point_slam_tpu_torch.models import decoders as TD
    _, cfg = tiny_cfgs(4)
    dec = TD.init_decoders(cfg, 3)
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.uniform(-2, 2, (300, 3)).astype(np.float32))
    c = torch.from_numpy(rng.normal(0, 0.1, (300, 32)).astype(np.float32))
    nb = torch.from_numpy(rng.normal(0, 0.1, (300, 8, 32)).astype(
        np.float32))
    nbp = p[:, None, :] + torch.from_numpy(
        rng.normal(0, 0.05, (300, 8, 3)).astype(np.float32))
    out = {}
    for prec in (None, "highest", "default"):
        dec.zero_grad()
        x = c.clone().requires_grad_(True)
        occ = dec.geo(p, x, precision=prec)
        rgb = dec.col(p, x, precision=prec)
        f = dec.col.encode_neighbor_feats(nbp, p, nb, precision=prec)
        (occ.sum() + rgb.sum() + f.sum()).backward()
        out[prec] = [occ, rgb, f, x.grad] + [q.grad.clone() for q in
                                             dec.parameters()]
    assert torch.backends.cuda.matmul.allow_tf32 is False
    for prec in ("highest", "default"):
        for a, b in zip(out[None], out[prec]):
            assert torch.equal(a, b)


def test_profile_dir_leaves_a_trace(tmp_path):
    from point_slam_tpu_torch.slam import PointSLAM
    _, cfg = tiny_cfgs(3)
    cfg["tracking"]["iters"] = 2
    cfg["mapping"].update({"iters": 2, "iters_first": 2})
    cfg["cuda"].update({"profile_dir": str(tmp_path / "trace"),
                        "prefetch_depth": 1})
    cfg["data"]["output"] = str(tmp_path / "out")
    PointSLAM(cfg, device="cpu").run()
    traces = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    # the program's spans appear as ranges of their names
    names = {e.get("name", "") for e in events}
    assert "track_frame" in names and "map.iter" in names
