"""Port parity, utils/logger.py: checkpoints and mid-run resume.

* A run checkpoints itself every ``mapping.ckpt_freq`` mapped frames; a
  fresh PointSLAM resumed from the frame-6 checkpoint runs frames 7-11 and
  ends with the continuous run's poses and packed cloud, bit for bit
  (torch.use_deterministic_algorithms; the port's counterpart of
  tests/test_slam_e2e.py::test_midrun_resume), over the packed cell table
  and over the fused one with exposure latents (colour-decoder snapshots).
* Save, load and restore give the same cloud, cell table, decoders,
  keyframes, latents and random-stream states.
* A checkpoint written by the JAX package's save_checkpoint after a tiny
  JAX run restores into the port, whose renders of it (render_rays and
  render_img, with JAX's random-fill draws injected) equal JAX's to the
  tolerance of tests/test_torch_renderer.py (2e-4).
* The re-render of the evaluation takes each mapped frame's colour
  decoder snapshot and exposure latent.
* The CLI's --resume finds checkpoints nested under a timestamped run
  directory.

The iterations are cut (mapping 8, tracking 8) to keep the file short:
bit-equality does not need a good map."""

import glob
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from point_slam_tpu_torch.slam import PointSLAM
from point_slam_tpu_torch.utils import logger as tlogger

from torch_parity import jax_fill, n, t, tiny_cfgs

RENDER_TOL = dict(rtol=2e-4, atol=2e-4)
LAYOUTS = {"packed": dict(knn_packed_coords=True),
           "fused_exposure": dict(knn_packed_coords="fused")}


def _cfg(out, layout):
    _, cfg = tiny_cfgs(12)
    cfg["tracking"]["iters"] = 8
    cfg["mapping"].update({"iters": 8, "iters_first": 15, "ckpt_freq": 6})
    cfg["cuda"].update(LAYOUTS[layout])
    cfg["model"]["encode_exposure"] = layout == "fused_exposure"
    cfg["data"]["output"] = str(out)
    return cfg


@pytest.fixture(scope="module", params=list(LAYOUTS))
def runs(request, tmp_path_factory):
    layout = request.param
    tmp = tmp_path_factory.mktemp(layout)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        cont = PointSLAM(_cfg(tmp / "cont", layout), device="cpu")
        csum = cont.run()
        final = str(tmp / "final.npz")
        tlogger.save_checkpoint(final, cont, idx=11)
        res = PointSLAM(_cfg(tmp / "resumed", layout), device="cpu")
        rsum = res.run(resume_from=str(tmp / "cont" / "ckpts" /
                                       "00006.npz"))
    finally:
        torch.use_deterministic_algorithms(was)
    restored = PointSLAM(_cfg(tmp / "restored", layout), device="cpu")
    nxt = tlogger.restore_slam(restored, tlogger.load_checkpoint(final))
    return layout, cont, csum, res, rsum, restored, nxt


def test_the_run_checkpoints_itself(runs):
    layout, cont, *_ = runs
    ckpts = sorted(os.listdir(os.path.join(cont.output, "ckpts")))
    assert ckpts == ["00006.npz"]          # every 6 frames, not the last
    ck = tlogger.load_checkpoint(os.path.join(cont.output, "ckpts",
                                              ckpts[0]))
    assert int(ck["idx"]) == 6
    assert ("colsnap_n" in ck) == (layout == "fused_exposure")


def test_resumed_run_equals_continuous_bit_for_bit(runs):
    layout, cont, csum, res, rsum, *_ = runs
    assert rsum["n_frames"] == csum["n_frames"] == 12
    assert sorted(res.mapper.frame_stats) == [8, 10, 11]
    np.testing.assert_array_equal(rsum["estimate_c2w_list"],
                                  csum["estimate_c2w_list"])
    assert res.mapper.n_points_host == cont.mapper.n_points_host > 500
    np.testing.assert_array_equal(
        res.mapper.cloud.packed[:res.mapper.n_points_host].numpy(),
        cont.mapper.cloud.packed[:cont.mapper.n_points_host].numpy())
    assert rsum["keyframes"] == csum["keyframes"]
    kind = {"packed": "PackedGridIndex", "fused_exposure": "FusedGridIndex"}
    assert type(res.mapper.index).__name__ == kind[layout]


def test_save_load_restore_gives_the_same_state(runs):
    _, cont, _, _, _, restored, nxt = runs
    a, b = restored.mapper, cont.mapper
    assert nxt == 12
    assert a.n_points_host == b.n_points_host
    for x, y in zip(a.cloud, b.cloud):          # packed, counts, inputs
        assert torch.equal(x[:len(y)] if x.dim() else x, y)
    for x, y in zip(a.index, b.index):          # the cell table, bitwise
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    sa, sb = a.decoders.state_dict(), b.decoders.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.keyframe_list == b.keyframe_list
    np.testing.assert_array_equal(np.stack(a.store.est_c2w),
                                  np.stack(b.store.est_c2w))
    np.testing.assert_array_equal(np.stack(a.store.exposure),
                                  np.stack(b.store.exposure))
    k = len(a.keyframe_list)
    assert torch.equal(a.store.ring[:k], b.store.ring[:k])
    np.testing.assert_array_equal(a.exposure_feat, b.exposure_feat)
    assert len(a.exposure_feat_all) == len(b.exposure_feat_all)
    assert len(a.color_decoder_snapshots) == len(b.color_decoder_snapshots)
    for sa, sb in zip(a.color_decoder_snapshots, b.color_decoder_snapshots):
        for k in sb:
            assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(restored.tracker.generator.get_state(),
                       cont.tracker.generator.get_state())
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    np.testing.assert_array_equal(restored.estimate_c2w_list,
                                  cont.estimate_c2w_list)


def test_rerender_takes_each_frames_snapshot_and_latent(runs, tmp_path):
    """rerender_frames renders every mapped frame of the run; an exposure
    run renders each with the colour decoder and latent it was mapped
    with."""
    from point_slam_tpu_torch.tools.evaluate import rerender_frames
    layout, cont, *_ = runs
    m = cont.mapper
    out = rerender_frames(cont, str(tmp_path), eval_img=True)
    assert out["frame_cnt"] == 6
    assert np.isfinite(out["avg_psnr"]) and np.isfinite(out["avg_ms_ssim"])
    assert out["depth_l1_render"] < 0.05
    assert len(glob.glob(str(tmp_path / "rendered_every_frame" /
                             "color_*.npy"))) == 6
    if layout == "fused_exposure":
        assert len(m.color_decoder_snapshots) == len(m.exposure_feat_all) \
            == 7                                 # frames 0, 2, ..., 10, 11
        snaps, lat = m.color_decoder_snapshots, m.exposure_feat_all
        m.color_decoder_snapshots, m.exposure_feat_all = [], []
        try:
            plain = rerender_frames(cont, str(tmp_path / "final_only"),
                                    eval_img=True)
        finally:
            m.color_decoder_snapshots, m.exposure_feat_all = snaps, lat
        assert plain["avg_psnr"] != out["avg_psnr"]
    else:
        assert not m.color_decoder_snapshots


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A 3-frame JAX run and its checkpoint (JAX's save_checkpoint)."""
    from point_slam_tpu.slam import PointSLAM as JaxSLAM
    from point_slam_tpu.utils.logger import save_checkpoint
    tmp = tmp_path_factory.mktemp("jax_ckpt")
    jcfg, _ = tiny_cfgs(3)
    jcfg["tracking"]["iters"] = 5
    jcfg["mapping"].update({"iters": 5, "iters_first": 10})
    jcfg["data"]["output"] = str(tmp / "out")
    jslam = JaxSLAM(jcfg)
    jslam.run()
    path = str(tmp / "jax.npz")
    save_checkpoint(path, jslam, idx=2)
    return jslam, path


def test_checkpoint_keys_are_the_jax_packages(runs, jax_checkpoint):
    """The JAX checkpoint's keys (its PRNG keys aside) with the same
    shapes; beyond them only the port's generator states and, with
    exposure, the exposure MLP and the colour-decoder snapshots."""
    _, cont, *_ = runs
    jck = tlogger.load_checkpoint(jax_checkpoint[1])
    tck = tlogger.load_checkpoint(os.path.join(cont.output, "ckpts",
                                               "00006.npz"))
    shared = set(jck) - {"mapper_key", "tracker_key"}
    assert shared <= set(tck)
    extra = set(tck) - shared - set(tlogger.GEN_KEYS.values())
    if cont.mapper.ms.encode_exposure:
        assert extra and all(k.startswith(("param/col/mlp_exposure/",
                                           "colsnap")) for k in extra)
    else:
        assert not extra
    for k in shared:
        if k.startswith("param/") or k in ("pts_num", "idx"):
            assert tck[k].shape == jck[k].shape, k
        assert tck[k].dtype.kind == jck[k].dtype.kind, k


@pytest.mark.parametrize("what", ["render_rays", "render_img"])
def test_jax_checkpoint_restores_and_renders_what_jax_renders(
        jax_checkpoint, tmp_path, what):
    from point_slam_tpu import renderer as JR
    from point_slam_tpu.common import camera as jcam
    from point_slam_tpu_torch import renderer as TR
    jslam, path = jax_checkpoint
    _, tcfg = tiny_cfgs(3)
    tcfg["data"]["output"] = str(tmp_path / "port")
    tslam = PointSLAM(tcfg, device="cpu")
    tlogger.restore_cloud_and_params(tlogger.load_checkpoint(path),
                                     tslam.mapper)
    jm, tm = jslam.mapper, tslam.mapper
    assert tm.n_points_host == jm.n_points_host > 200
    assert tm.keyframe_list == list(jm.keyframe_list)
    _, color, depth, _ = jslam.dataset[2]
    c2w = jslam.estimate_c2w_list[2]
    r_query = np.asarray(jm.radius_maps(jnp.asarray(color))[1])
    key = jax.random.key(11)
    if what == "render_rays":
        rng = np.random.default_rng(0)
        i = rng.integers(0, 64, 160).astype(np.float32)
        j = rng.integers(0, 48, 160).astype(np.float32)
        o, d = jcam.rays_from_uv(jnp.asarray(i), jnp.asarray(j),
                                 jnp.asarray(c2w), 40.0, 40.0, 31.5, 23.5)
        ji, jj = i.astype(int), j.astype(int)
        rays = (np.asarray(o), np.asarray(d), depth[jj, ji], r_query[jj, ji],
                np.ones(160, bool))
        want = JR.render_rays(jm.params, jm.cloud.packed, jm.cloud.n_points,
                              jm.index, *map(jnp.asarray, rays), key, jm.rc,
                              stage_color=True)
        got = TR.render_rays(tm.decoders, tm.cloud.packed, tm.index,
                             *map(t, rays), tm.rc, stage_color=True,
                             fill=jax_fill(key))
        np.testing.assert_array_equal(n(got[3]), np.asarray(want[3]))
    else:
        want = JR.render_img(jm.params, jm.cloud, jm.index, jnp.asarray(c2w),
                             (40.0, 40.0, 31.5, 23.5), (48, 64), jm.rc, key,
                             jnp.asarray(depth), jnp.asarray(r_query))
        chunks = range(0, 48 * 64, tm.rc.ray_batch)
        fill = torch.stack([jax_fill(jax.random.fold_in(key, c))
                            for c in chunks])
        got = TR.render_img(tm.decoders, tm.cloud, tm.index, t(c2w),
                            (40.0, 40.0, 31.5, 23.5), (48, 64), tm.rc,
                            t(depth), t(r_query), fill=fill)
        assert len(chunks) == 2
    for name, a, b in zip(("depth", "uncertainty", "color"), got, want):
        np.testing.assert_allclose(n(a), np.asarray(b), err_msg=name,
                                   **RENDER_TOL)
    assert (n(got[0]) > 0).mean() > 0.5


def test_cli_resume_finds_nested_checkpoints(tmp_path):
    from point_slam_tpu_torch import run
    for stamp, idx in (("20260101_000000", 3), ("20260102_000000", 5),
                       ("20260102_000000", 10)):
        d = tmp_path / stamp / "ckpts"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{idx:05d}.npz").write_bytes(b"")
    path, out = run.find_resume_checkpoint(str(tmp_path))
    assert out == str(tmp_path / "20260102_000000")
    assert path == str(tmp_path / "20260102_000000" / "ckpts" / "00010.npz")
    flat = tmp_path / "20260101_000000"
    assert run.find_resume_checkpoint(str(flat)) == (
        str(flat / "ckpts" / "00003.npz"), str(flat))
    with pytest.raises(SystemExit, match="no checkpoint"):
        run.find_resume_checkpoint(str(tmp_path / "empty"))
