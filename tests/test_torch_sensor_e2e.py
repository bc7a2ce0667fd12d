"""The sensor-shaped slice as a whole: tests/test_slam_e2e.py's tiny
synthetic config (48x64, 12 frames) with what configs/Synthetic/
room_sensor.yaml turns on (sensor depth holes with sample_near_pcl,
exposure latents, bundle adjustment, colour-gradient tracking pixels,
colour refinement at the last frame) over the fused cell table, through
both PointSLAMs on the CPU. The port also takes the fused row-Adam (K4's
plain version); the JAX side keeps the unfused Adam, which
tests/test_mapper.py holds equal to the fused one. Both take per-sample
grid_knn, the CPU default ('auto'); the ray-shared kNN over the fused table
(K3's plain version) is held against JAX in test_torch_fused.py. The
iterations are cut (mapping 10, tracking 12; the refinement runs 5 x 20)
to keep the file near two minutes.

The port runs under torch.use_deterministic_algorithms: the CPU's
parallel scatter-add of the packed gradient otherwise sums in a varying
order, and this short, hole-ridden run's trajectory spreads over a few cm
from run to run. The two packages draw different random streams, so the
outcomes are compared, not the numbers: the same keyframes; both trajectories within
20 cm (ATE without alignment, JAX's own bound in test_slam_e2e.py for the
sensor path); the port's ATE within 2x the JAX package's plus 1 cm; point
counts within 15%; the same counts of exposure latents and colour-decoder
snapshots."""

import numpy as np
import pytest
import torch

from point_slam_tpu.slam import PointSLAM as JaxSLAM
from point_slam_tpu.tools.eval_ate import evaluate_ate
from point_slam_tpu_torch.ops import adam as tadam
from point_slam_tpu_torch.ops import knn as tk
from point_slam_tpu_torch.slam import PointSLAM as TorchSLAM

from torch_parity import tiny_cfgs


def sensor_cfgs():
    jcfg, tcfg = tiny_cfgs(12)
    for cfg, sec in ((jcfg, "tpu"), (tcfg, "cuda")):
        cfg["synthetic"]["depth_dropout"] = 0.15
        cfg["rendering"]["sample_near_pcl"] = True
        cfg["model"]["encode_exposure"] = True
        cfg["tracking"]["sample_with_color_grad"] = True
        cfg["mapping"].update({"BA": True, "keyframe_every": 2,
                               "color_refine": True, "iters": 10})
        cfg["tracking"]["iters"] = 12
        cfg[sec]["knn_packed_coords"] = "fused"
    tcfg["cuda"]["fused_adam"] = True
    return jcfg, tcfg


def _ate(summary):
    return evaluate_ate(summary["gt_c2w_list"], summary["estimate_c2w_list"],
                        align=False)["absolute_translational_error.rmse"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(2)
    jcfg, tcfg = sensor_cfgs()
    jcfg["data"]["output"] = str(tmp_path_factory.mktemp("jax"))
    tcfg["data"]["output"] = str(tmp_path_factory.mktemp("port"))
    jslam = JaxSLAM(jcfg)
    jsum = jslam.run()
    tslam = TorchSLAM(tcfg, device="cpu")
    # the store's keyframe poses after frame 9 (before BA can move them)
    kf_before = {}
    map_frame = tslam.mapper.map_frame

    def recording(idx, *a, **kw):
        if idx == 10:
            kf_before.update(enumerate(
                [p.copy() for p in tslam.mapper.store.est_c2w]))
        return map_frame(idx, *a, **kw)

    tslam.mapper.map_frame = recording
    launches = dict(tk.LAUNCHES), dict(tadam.LAUNCHES)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        tsum = tslam.run()
    finally:
        torch.use_deterministic_algorithms(was)
    assert (dict(tk.LAUNCHES), dict(tadam.LAUNCHES)) == launches
    return jslam, jsum, tslam, tsum, kf_before


def test_the_sensor_path_is_on(runs):
    _, _, tslam, _, _ = runs
    m = tslam.mapper
    assert isinstance(m.index, tk.FusedGridIndex)
    assert m.ms.fused_adam and m.ms.encode_exposure
    assert m.rc.sample_near_pcl and not m.rc.ray_knn
    assert tslam.tracker.ts.sample_with_color_grad
    # sensor holes: depth-free pixels in the frames
    _, _, depth, _ = tslam.dataset[3]
    assert (depth == 0).mean() > 0.05


def test_same_schedule_and_keyframes(runs):
    jslam, jsum, tslam, tsum, _ = runs
    assert tsum["n_frames"] == jsum["n_frames"] == 12
    assert tsum["keyframes"] == jsum["keyframes"] == [0, 2, 4, 6, 8, 10]
    assert sorted(tslam.mapper.frame_stats) == [0, 2, 4, 6, 8, 10, 11]


def test_both_trajectories_stay_on_track(runs):
    _, jsum, _, tsum, _ = runs
    j_ate, t_ate = _ate(jsum), _ate(tsum)
    assert j_ate < 0.20 and t_ate < 0.20, (j_ate, t_ate)
    assert t_ate <= 2 * j_ate + 0.01, (j_ate, t_ate)


def test_point_counts_agree(runs):
    _, jsum, _, tsum, _ = runs
    assert tsum["n_points"] > 200
    assert abs(tsum["n_points"] - jsum["n_points"]) <= 0.15 * jsum["n_points"]


def test_exposure_latents_and_decoder_snapshots(runs):
    jslam, _, tslam, _, _ = runs
    tm, jm = tslam.mapper, jslam.mapper
    assert len(tm.exposure_feat_all) == len(jm.exposure_feat_all) == 7
    assert len(tm.color_decoder_snapshots) == \
        len(jm.color_decoder_snapshots) == 7
    # the current frame's latent moves during mapping
    assert not np.array_equal(tm.exposure_feat_all[0],
                              tm.exposure_feat_all[-1])
    assert "mlp_exposure.l1.weight" in tm.color_decoder_snapshots[0]


def test_ba_moved_a_stored_keyframe_pose_and_refinement_ran(runs):
    _, _, tslam, tsum, kf_before = runs
    m = tslam.mapper
    st = m.frame_stats
    assert st[10]["ba"] and st[11]["ba"] and not st[8]["ba"]
    assert st[11]["outer_loops"] == 5 and st[10]["outer_loops"] == 1
    assert st[11]["n_added"] == 0
    assert st[11]["n_iters"] == 2 * tslam.cfg["mapping"]["iters"]
    # every window pose is written back through a quaternion round trip
    # (~1e-7); BA moves the others by far more, never the oldest keyframe
    shift = {k: np.abs(p - m.store.est_c2w[k]).max()
             for k, p in kf_before.items()}
    assert max(shift.values()) > 1e-5 and shift[0] < 1e-5, shift
    # the mapped (BA-refined) pose of the last frame is the estimate
    np.testing.assert_array_equal(tsum["estimate_c2w_list"][11],
                                  st[11]["cur_c2w"])


def test_poses_and_cloud_are_finite(runs):
    _, _, tslam, tsum, _ = runs
    est = tsum["estimate_c2w_list"]
    assert np.isfinite(est).all()
    for p in est:
        np.testing.assert_allclose(p[:3, :3] @ p[:3, :3].T, np.eye(3),
                                   atol=1e-3)
    m = tslam.mapper
    assert np.isfinite(m.cloud.packed[:m.n_points_host].numpy()).all()
