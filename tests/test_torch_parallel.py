"""Data parallelism of the port (point_slam_tpu_torch/parallel/dist.py) on
the CPU: gloo groups of spawned processes (tests/torch_dist.py), each with
a finite timeout and joined with a time limit.

tests/test_parallel.py's checks on the port: world size 2 against world
size 1 at the same total budget (512 rays) on its tiny config (32x40, CAP
2^11), mapping over its three frames (plain, exposure, the fused table
with K4's plain version; BA over six, see STEP_FLIPS) and tracking, at its
tolerances: positions and point counts equal, features within rtol/atol
2e-3, poses within rtol 2e-3 / atol 2e-4, the best tracking loss within
rtol 5e-3. Against JAX dp=2 (a 2-device mesh of the conftest's 8 virtual
devices), with JAX's draws replayed: a 6-iteration tracking run at the
same pose and loss tolerances, one mapping batch's loss (1e-4 relative)
and packed gradient (2e-3 of its largest entry; test_torch_mapper.py's
tolerances), and one map_optimize iteration of each stage (features
within 2e-3 where the gradient's sign is above that tolerance). Mapping
runs are not held to JAX's over several steps: the packages' gradients
differ by up to 2e-3 of the largest entry at one device already (decoder
Fourier phases), and Adam's first steps turn a near-zero gradient of
either sign into a full learning-rate step, so features of a 6-iteration
single-device run already differ by up to 0.1. Exact: a world-size-1
group against no group, and the two ranks' replicas against each other.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu import mapper as JM
from point_slam_tpu import renderer as JR
from point_slam_tpu import tracker as JT
from point_slam_tpu.common import camera as jcam
from point_slam_tpu.common import image as jimg
from point_slam_tpu.common import sampling as jsamp
from point_slam_tpu.parallel import mesh as pmesh
from point_slam_tpu_torch import renderer as TR
from point_slam_tpu_torch import tracker as TT
from point_slam_tpu_torch.parallel import dist as pdist

import torch_dist as TD
from torch_parity import CONFIGS, HERE, Scene, jax_fill, n, t

FEAT = dict(rtol=2e-3, atol=2e-3)
POSE = dict(rtol=2e-3, atol=2e-4)
MAP_STATIC = dict(h=48, w=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5, r_max=400,
                  f_max=10, w_color_loss=0.1, frustum_edge=-4.0,
                  fix_geo_decoder=True, n_add=3, near_end_surface_pc=0.98,
                  far_end_surface_pc=1.02, add_max=600, grad_max=50,
                  grad_top=250)
TRACK_STATIC = dict(h=48, w=64, fx=40.0, fy=40.0, cx=31.5, cy=23.5,
                    pixels=300, ignore_edge_w=5, ignore_edge_h=5,
                    handle_dynamic=True, depth_limit=False, use_color=True,
                    w_color_loss=0.5, separate_lr=True)
TRACK_ITERS = 6
# map_optimize's learning-rate triples [decoders, geometry features,
# colour features] of the geometry and the colour stage
STEP_LRS = ([0.001, 0.03, 0.0], [0.005, 0.005, 0.005])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The mapping variants and the tracking run: without a group, in a
    world-size-1 group and on the two ranks of a world-size-2 group."""
    tmp = tmp_path_factory.mktemp("dp_runs")
    payload = {"variants": TD.VARIANT_FRAMES,
               "jobs": ["map_frames", "track_frame"]}
    none = TD.spawn(TD.suite, 1, tmp / "none", payload, group=False)[0]
    w1 = TD.spawn(TD.suite, 1, tmp / "w1", payload)[0]
    w2 = TD.spawn(TD.suite, 2, tmp / "w2", payload)
    return none, w1, w2


# BA starts only past four keyframes, so its run maps six frames where
# test_parallel.py's comparison maps three (it holds BA at dp=8 only to
# finite values). Over those six frames the JAX package's own dp=2 run
# misses 2e-3 in 0.53% of the feature entries (python
# tests/dp_deviation.py): Adam turns a reduction-order difference in a
# near-zero gradient into a step of the learning rate. The port's misses
# it in one entry of 73,152; it is held to 2e-3 in all but 1e-4 of them.
STEP_FLIPS = {"ba": 1e-4}


@pytest.mark.parametrize("variant", list(TD.VARIANTS))
def test_w2_mapping_tracks_w1(runs, variant):
    """World size 2 against one process without a group at the same total
    budget, over TD.VARIANT_FRAMES's frames: point counts and positions
    equal, features within 2e-3 (BA: see STEP_FLIPS), the logged
    statistics the whole batch's, BA poses and exposure latents within
    test_parallel.py's tolerances."""
    none, _, w2 = runs
    a, b = none["map_frames"][variant], w2[0]["map_frames"][variant]
    assert len(a["stats"]) == TD.VARIANT_FRAMES[variant]
    assert a["n_points"] == b["n_points"] > 0
    assert [s["n_points"] for s in a["stats"]] == \
        [s["n_points"] for s in b["stats"]]
    np.testing.assert_array_equal(a["packed"][:, 64:67], b["packed"][:, 64:67])
    if variant in STEP_FLIPS:
        off = ~np.isclose(b["packed"][:, :64], a["packed"][:, :64], **FEAT)
        assert off.mean() <= STEP_FLIPS[variant], off.sum()
    else:
        np.testing.assert_allclose(b["packed"][:, :64], a["packed"][:, :64],
                                   **FEAT)
    assert np.isfinite(b["packed"]).all()
    # the logged statistics are the whole batch's
    for sa, sb in zip(a["stats"], b["stats"]):
        assert sa["n_mask"] == sb["n_mask"]
        np.testing.assert_allclose(sb["geo_loss"], sa["geo_loss"], rtol=1e-4)
    if variant == "ba":
        assert b["stats"][-1]["ba"]
        np.testing.assert_allclose(b["kf_c2w"], a["kf_c2w"], **POSE)
    if variant == "exposure":
        np.testing.assert_allclose(b["exposure"], a["exposure"], **FEAT)


def test_w2_tracking_tracks_w1(runs):
    none, _, w2 = runs
    a, b = none["track_frame"], w2[0]["track_frame"]
    assert a["tracked"] and b["tracked"]
    np.testing.assert_allclose(b["best_loss"], a["best_loss"], rtol=5e-3)
    np.testing.assert_allclose(b["c2w"], a["c2w"], **POSE)


def _flat(tree):
    if isinstance(tree, dict):
        return {f"{k}/{kk}": vv for k, v in tree.items()
                for kk, vv in _flat(v).items()}
    if isinstance(tree, list):
        return _flat(dict(enumerate(tree)))
    return {"": tree}


def _assert_bit_equal(x, y):
    fx, fy = _flat(x), _flat(y)
    assert fx.keys() == fy.keys()
    for k in fx:
        np.testing.assert_array_equal(np.asarray(fx[k]), np.asarray(fy[k]),
                                      err_msg=k)


def test_w2_replicas_are_bit_equal(runs):
    """Every rank steps the same reduced gradient: the clouds, decoders,
    exposure latents, BA poses and tracked poses of the two ranks are
    equal bit for bit."""
    _, _, (r0, r1) = runs
    _assert_bit_equal(r0, r1)


def test_w1_group_is_bit_equal_to_no_group(runs):
    none, w1, _ = runs
    _assert_bit_equal(w1, none)


def _render_error(scene, depth, rq, cam, i, j):
    """|sensor depth - rendered depth| of the pixels (i, j) at camera
    ``cam`` (valid-depth pixels; +inf elsewhere)."""
    from point_slam_tpu_torch.common import camera, sampling
    i, j = t(i), t(j)
    dep = sampling.gather_pixels(t(depth), i, j)
    o, d = camera.rays_from_uv(i, j, camera.pose_matrix_from_tensor(t(cam)),
                               40.0, 40.0, 31.5, 23.5)
    with torch.no_grad():
        rendered = TR.render_rays(
            scene.tdec, scene.tcloud.packed, scene.tindex, o, d, dep,
            sampling.gather_pixels(t(rq), i, j), dep > 0, TR.RenderConfig(),
            stage_color=True, is_tracker=True, fill=torch.zeros(2, 32))[0]
    return np.where(n(dep) > 0, np.abs(n(dep - rendered)), np.inf)


@pytest.fixture(scope="module")
def replayed(tmp_path_factory):
    """JAX dp=2 on a 2-device mesh and the port (no group; world size 2)
    on the parity scene with the same draws."""
    tmp = tmp_path_factory.mktemp("dp_replay")
    scene = Scene(packed_coords=False)
    f = MAP_STATIC["f_max"]
    color = np.zeros((f, 48, 64, 3), np.float32)
    depth = np.zeros((f, 48, 64), np.float32)
    rq = np.full((f, 48, 64), 1e6, np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (f, 1, 1))
    for slot, idx in enumerate((0, 2)):
        _, color[slot], depth[slot], c2w[slot] = scene.frames[idx]
        rq[slot] = np.asarray(jimg.dynamic_radius_maps(
            jnp.asarray(color[slot]), 0.08, 0.02, 2, 0.15)[1])
    # test_torch_mapper.py's draws: rays from key 2, the render from key 3
    k_rays, k_render = jax.random.key(2), jax.random.key(3)
    ki, kj = jax.random.split(k_rays)
    map_ij = (jax.random.randint(ki, (400,), 0, 64),
              jax.random.randint(kj, (400,), 0, 48))
    _, fcolor, fdepth, fc2w = scene.frames[2]
    frq = np.asarray(jimg.dynamic_radius_maps(jnp.asarray(fcolor), 0.08,
                                              0.02, 2, 0.15)[1])
    cam = jcam.tensor_from_pose_matrix(fc2w) + np.array(
        [0, 0.002, -0.001, 0.001, 0.01, -0.008, 0.006], np.float32)
    key = jax.random.key(4)
    draws, k = [], key
    for _ in range(TRACK_ITERS):
        k, k_it = jax.random.split(k)
        k_pix, k_fill = jax.random.split(k_it)
        i, j = jsamp.sample_pixels_uniform(k_pix, 5, 43, 5, 59, 300)
        draws.append((t(i), t(j), jax_fill(k_fill)))
    # 300 pixels for the robust median: 200 whose render error (at the
    # perturbed camera) is below 1 mm and 100 above, in the order 150 low
    # (rank 0's half), 50 low + 100 high (rank 1's): the batch's median is
    # a low error, rank 1's half's a high one
    rng = np.random.default_rng(0)
    ii = rng.integers(5, 59, 4000).astype(np.float32)
    jj = rng.integers(5, 43, 4000).astype(np.float32)
    err = _render_error(scene, fdepth, frq, cam, ii, jj)
    low, high = np.nonzero(err < 1e-3)[0], np.nonzero(err >= 1e-3)[0]
    assert len(low) >= 200 and len(high) >= 100
    pick = np.concatenate([low[:200], high[:100]])
    median_ij = (t(ii[pick]), t(jj[pick]))

    jax_out, step_draws = {}, {}
    pmesh.set_mesh(pmesh.make_mesh(2))
    try:
        jms = JM.MapperStatic(**MAP_STATIC, encode_exposure=False,
                              max_iters=200, dp=2)
        window = dict(color=jnp.asarray(color), depth=jnp.asarray(depth),
                      r_query=jnp.asarray(rq))
        jrc = JR.RenderConfig(sample_near_pcl=False)
        for stage_color in (False, True):
            def jloss(pk, stage_color=stage_color):
                rays = JM._sample_window_rays(jms, k_rays, window,
                                              jnp.asarray(2),
                                              jnp.asarray(200))
                return JM._losses(jms, jrc, scene.params, pk,
                                  jnp.zeros((f, 8)), scene.jcloud.n_points,
                                  scene.jindex, rays, jnp.asarray(c2w),
                                  k_render, stage_color)[0]
            jl, jg = jax.jit(jax.value_and_grad(jloss))(scene.jcloud.packed)
            jax_out[f"map_{stage_color}"] = (np.asarray(jl), np.asarray(jg))
        # one map_optimize iteration of each stage (geometry: geo_iter_bound
        # 0; colour: -1) from its own key, its draws replayed into the port
        n_pts = int(scene.jcloud.n_points)
        frustum = np.arange(scene.jcloud.packed.shape[0]) < n_pts
        for stage_color, seed in ((False, 5), (True, 6)):
            k = jax.random.key(seed)
            _, k_rays, k_render = jax.random.split(k, 3)
            ki, kj = jax.random.split(k_rays)
            step_draws[stage_color] = (
                t(jax.random.randint(ki, (400,), 0, 64)),
                t(jax.random.randint(kj, (400,), 0, 48)), jax_fill(k_render))
            res = JM.map_optimize(
                jms, jrc, scene.params, jnp.array(scene.jcloud.packed),
                scene.jcloud.n_points, scene.jindex, jnp.asarray(color),
                jnp.asarray(depth), jnp.asarray(rq), jnp.asarray(c2w),
                jnp.zeros((f, 8)), jnp.asarray(2), jnp.asarray(200),
                jnp.asarray(0), jnp.asarray(frustum),
                jnp.asarray(STEP_LRS[0]), jnp.asarray(STEP_LRS[1]),
                jnp.asarray(0.001), jnp.asarray(1.0),
                jnp.asarray(-1 if stage_color else 0), jnp.asarray(1), k)
            jax_out[f"step_{stage_color}"] = (
                np.asarray(res[1]), np.asarray(res[4]["m"]["packed"]),
                np.asarray(res[3]))
        jts = JT.TrackerStatic(**TRACK_STATIC, sample_with_color_grad=False,
                               grad_top=4500, max_iters=160, dp=2)
        best, _, _, best_loss, _ = JT.track_optimize(
            jts, JR.RenderConfig(sample_near_pcl=False, sigmoid_coef=0.1),
            scene.params, scene.jcloud.packed, scene.jcloud.n_points,
            scene.jindex, jnp.asarray(fcolor), jnp.asarray(fdepth),
            jnp.asarray(frq), jnp.asarray(cam), jnp.zeros(1, jnp.int32),
            jnp.zeros(1, bool), jnp.asarray(0.002, jnp.float32),
            jnp.asarray(TRACK_ITERS), key)
        jax_out["track"] = (np.asarray(best), float(best_loss))
    finally:
        pmesh.set_mesh(None)

    state = {"dec": scene.tdec, "cloud": scene.tcloud, "index": scene.tindex,
             "map_static": MAP_STATIC,
             "window": (t(color), t(depth), t(rq), t(c2w)),
             "map_ij": (t(map_ij[0]), t(map_ij[1])),
             "map_fill": jax_fill(k_render), "track_static": TRACK_STATIC,
             "frame": (t(fcolor), t(fdepth), t(frq), t(cam)),
             "track_draws": draws, "median_ij": median_ij,
             "step_draws": step_draws, "step_lrs": STEP_LRS,
             "frustum": torch.from_numpy(frustum)}
    path = str(tmp / "state.pt")
    torch.save(state, path)
    payload = {"state": path}
    none = TD.spawn(TD.replay, 1, tmp / "none", payload, group=False)[0]
    w2 = TD.spawn(TD.replay, 2, tmp / "w2", payload)
    return jax_out, none, w2, state


@pytest.mark.parametrize("stage_color", [False, True])
def test_w2_mapping_batch_matches_jax_dp2(replayed, stage_color):
    jax_out, none, w2, _ = replayed
    jl, jg = jax_out[f"map_{stage_color}"]
    for loss, grad in (w2[0][f"map_{stage_color}"],
                       w2[1][f"map_{stage_color}"]):
        np.testing.assert_allclose(n(loss), jl, rtol=1e-4)
        assert np.abs(jg).max() > 0
        np.testing.assert_allclose(n(grad), jg, rtol=2e-3,
                                   atol=2e-3 * np.abs(jg).max())
    # and the port's own world size 1, as test_torch_mapper.py holds it
    loss1, grad1 = none[f"map_{stage_color}"]
    np.testing.assert_allclose(n(w2[0][f"map_{stage_color}"][0]), n(loss1),
                               rtol=1e-5)
    np.testing.assert_allclose(n(w2[0][f"map_{stage_color}"][1]), n(grad1),
                               rtol=1e-4, atol=1e-5 * np.abs(n(grad1)).max())


@pytest.mark.parametrize("stage_color", [False, True])
def test_w2_mapping_step_matches_jax_dp2(replayed, stage_color):
    """One map_optimize iteration (the reduced gradient, its masks and the
    Adam step) at world size 2 against JAX dp=2 on the same draws. Adam's
    first step is about lr x sign(gradient): where JAX's gradient stands
    above the packages' gradient tolerance (2e-3 of its largest entry) the
    features agree within 2e-3; below it the sign may be rounding, and
    each step is held to the learning rate and all but 1e-4 of them to the
    2e-3; where it is zero, nothing moves. The logged statistics agree
    within 1e-4; the ranks are bit-equal."""
    jax_out, _, w2, st = replayed
    jpacked, jm, jstats = jax_out[f"step_{stage_color}"]
    p0 = n(st["cloud"].packed)
    g = np.abs(jm)                       # Adam's m after one step: 0.1 g
    assert g.max() > 0
    sure = g > 2e-3 * g.max()
    zero = g == 0
    lr = max(STEP_LRS[stage_color])
    for rank in w2:
        packed, stats = (n(x) for x in rank[f"step_{stage_color}"])
        np.testing.assert_allclose(packed[sure], jpacked[sure], **FEAT)
        assert np.abs(packed - p0).max() <= lr * (1 + 1e-5)
        np.testing.assert_array_equal(packed[zero], p0[zero])
        np.testing.assert_allclose(stats[:2], jstats[:2], rtol=1e-4)
        assert stats[2] == jstats[2] > 0
    # and below the gradient tolerance all but 1e-4 of the moved entries
    # (measured: all of the geometry stage's, all but 3 of 109,760 of
    # the colour stage's)
    moved = ~zero
    packed = n(w2[0][f"step_{stage_color}"][0])
    off = ~np.isclose(packed[moved], jpacked[moved], **FEAT)
    assert off.mean() <= 1e-4, off.sum()
    _assert_bit_equal([n(x) for x in w2[0][f"step_{stage_color}"]],
                      [n(x) for x in w2[1][f"step_{stage_color}"]])


def test_w2_tracking_matches_jax_dp2(replayed):
    jax_out, _, w2, _ = replayed
    jbest, jloss = jax_out["track"]
    for rank in w2:
        best, _, _, best_loss = rank["track"]
        np.testing.assert_allclose(n(best_loss), jloss, rtol=5e-3)
        np.testing.assert_allclose(n(best), jbest, **POSE)
    _assert_bit_equal([n(x) for x in w2[0]["track"]],
                      [n(x) for x in w2[1]["track"]])


def test_tracker_robust_median_is_global(replayed):
    """The tracker's robust median over the ranks: on pixels whose halves'
    error medians differ from the batch's (rank 1's half is mostly high
    errors), world size 2 gives world size 1's loss, and the halves' losses
    under their own statistics sum to another."""
    _, none, w2, st = replayed
    whole = float(n(none["median_loss"]))
    assert float(n(w2[0]["median_loss"])) == pytest.approx(whole, rel=1e-5)
    assert n(w2[0]["median_loss"]) == n(w2[1]["median_loss"])
    ts = TT.TrackerStatic(**{**TRACK_STATIC, "pixels": 150,
                             "handle_dynamic": False})
    i, j = st["median_ij"]
    color, depth, rq, cam = st["frame"]
    halves = sum(float(TT.tracking_loss(
        ts, TR.RenderConfig(), st["dec"], st["cloud"].packed, st["index"],
        color, depth, rq, cam, i[sl], j[sl], st["map_fill"])[0].detach())
        for sl in (slice(0, 150), slice(150, 300)))
    assert halves > 2 * whole


def test_only_rank_0_writes_and_the_group_size_is_checked(tmp_path):
    out = tmp_path / "out"
    r0, r1 = TD.spawn(TD.run_slam, 2, tmp_path / "w2", {"out": str(out)})
    _assert_bit_equal({k: r0[k] for k in ("est", "packed", "decoders")},
                      {k: r1[k] for k in ("est", "packed", "decoders")})
    assert not (out / "rank1").exists()
    files = {os.path.relpath(os.path.join(d, f), out / "rank0")
             for d, _, fs in os.walk(out / "rank0") for f in fs}
    for name in ("ckpts/00002.npz", "metrics.jsonl", "npc_cloud.npy",
                 "final_point_cloud.npy", "final_point_cloud.ply",
                 "rendered_image/frame_00002.png"):
        assert name in files, (name, sorted(files))
    for d in ("mapping_vis", "tracking_vis"):
        assert [f for f in files if f.startswith(d + "/")], (d, files)
    for r in (r0, r1):
        assert "cuda.data_parallel is 3" in r["error"]
        assert "has 2 ranks" in r["error"]
    assert not (out / "bad").exists()


def test_data_parallel_without_a_group_raises(tmp_path):
    from point_slam_tpu_torch.slam import PointSLAM
    cfg = TD.tiny_cfg(2)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        PointSLAM(cfg, output=str(tmp_path / "out"), device="cpu")
    assert not (tmp_path / "out").exists()


def test_dist_helpers_without_a_group():
    assert not pdist.active()
    assert (pdist.world(), pdist.rank(), pdist.is_writer()) == (1, 0, True)
    x = torch.arange(6.0)
    assert pdist.shard(x) is x
    assert [pdist.padded(n, 4) for n in (1, 4, 5, 1500)] == [4, 4, 8, 1500]
    pdist.barrier()                          # no group: nothing to wait for
    assert pdist.data_parallel({"cuda": {"data_parallel": None}}) == 1


def test_cli_under_torchrun_writes_one_tree(tmp_path):
    """``torchrun --nproc_per_node 2 -m point_slam_tpu_torch.run ...
    --device cpu``: both ranks run, rank 0 alone writes (each metrics
    record once)."""
    yaml = tmp_path / "dp.yaml"
    yaml.write_text(
        f"inherit_from: {os.path.join(CONFIGS, 'Synthetic', 'room.yaml')}\n"
        "synthetic: {n_frames: 4, angular_step: 0.02}\n"
        "cam: {H: 32, W: 40, fx: 30.0, fy: 30.0, cx: 19.5, cy: 15.5}\n"
        "tracking: {pixels: 128, iters: 3, ignore_edge_W: 5, "
        "ignore_edge_H: 5}\n"
        "mapping: {pixels: 128, pixels_adding: 64, "
        "pixels_based_on_color_grad: 16, iters: 3, iters_first: 3, "
        "geo_iter_first: 1}\n"
        "cuda: {point_capacity_init: 2048, grid_table_size: 4096, "
        "grid_max_per_cell: 32, data_parallel: 2}\n"
        "verbose: false\n")
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "point_slam_tpu_torch.run",
         str(yaml), "--device", "cpu", "--stop", "2", "--no_eval",
         "--output", str(out)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("finished 3 frames on cpu") == 2, res.stdout
    assert res.stdout.count("checkpoint saved to") == 1
    assert sorted(os.listdir(out)) == ["ckpts", "final_point_cloud.npy",
                                       "final_point_cloud.ply", "mapping_vis",
                                       "mesh", "metrics.jsonl",
                                       "npc_cloud.npy", "rendered_image",
                                       "tracking_vis"]
    recs = [ln for ln in (out / "metrics.jsonl").read_text().splitlines()]
    assert sum('"idx_map": 2' in r for r in recs) == 1
    assert sum('"final_n_points"' in r for r in recs) == 1
    assert os.listdir(out / "ckpts") == ["00002.npz"]
