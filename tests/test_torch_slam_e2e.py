"""The slice as a whole: tests/test_slam_e2e.py's tiny synthetic config
(48x64, 12 frames) through both PointSLAMs, on the CPU.

The two packages draw different random streams, so the outcomes are
compared, not the numbers: the same keyframes; both trajectories within
10 cm (ATE without alignment); the port's ATE within 2x the JAX package's
plus 1 cm; point counts within 15%. The port runs under
torch.use_deterministic_algorithms: the CPU's parallel scatter-add of the
packed gradient otherwise sums in a varying order, which moved this short
run's trajectory by centimetres from run to run."""

import json
import os

import numpy as np
import pytest
import torch

from point_slam_tpu.slam import PointSLAM as JaxSLAM
from point_slam_tpu.tools.eval_ate import evaluate_ate
from point_slam_tpu_torch.slam import PointSLAM as TorchSLAM
from point_slam_tpu_torch.tools.eval_ate import evaluate_ate as t_evaluate_ate

from torch_parity import CONFIGS, tiny_cfgs


def _ate(summary, fn=evaluate_ate):
    return fn(summary["gt_c2w_list"], summary["estimate_c2w_list"],
              align=False)["absolute_translational_error.rmse"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(2)     # deterministic sums; share the host's cores
    jcfg, tcfg = tiny_cfgs(12)
    jcfg["data"]["output"] = str(tmp_path_factory.mktemp("jax"))
    tcfg["data"]["output"] = str(tmp_path_factory.mktemp("port"))
    jslam = JaxSLAM(jcfg)
    jsum = jslam.run()
    tslam = TorchSLAM(tcfg, device="cpu")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        tsum = tslam.run()
    finally:
        torch.use_deterministic_algorithms(was)
    return jslam, jsum, tslam, tsum


def test_same_schedule_and_keyframes(runs):
    jslam, jsum, tslam, tsum = runs
    assert tsum["n_frames"] == jsum["n_frames"] == 12
    assert tsum["keyframes"] == jsum["keyframes"] == [0, 4, 8, 10]
    # frames mapped: 0, every 2nd frame, and the last
    assert sorted(tslam.mapper.frame_stats) == [0, 2, 4, 6, 8, 10, 11]


def test_both_trajectories_stay_on_track(runs):
    _, jsum, _, tsum = runs
    j_ate, t_ate = _ate(jsum), _ate(tsum, t_evaluate_ate)
    print(f"ATE no-align: JAX {j_ate:.6f} m, port {t_ate:.6f} m")
    assert j_ate < 0.10 and t_ate < 0.10, (j_ate, t_ate)
    assert t_ate <= 2 * j_ate + 0.01, (j_ate, t_ate)


def test_point_counts_agree(runs):
    _, jsum, _, tsum = runs
    assert tsum["n_points"] > 200
    assert abs(tsum["n_points"] - jsum["n_points"]) <= 0.15 * jsum["n_points"]


def test_poses_are_rigid_and_frames_0_1_take_gt(runs):
    _, _, _, tsum = runs
    est = tsum["estimate_c2w_list"]
    assert np.isfinite(est).all()
    for p in est:
        np.testing.assert_allclose(p[:3, :3] @ p[:3, :3].T, np.eye(3),
                                   atol=1e-3)
    np.testing.assert_array_equal(est[:2], tsum["gt_c2w_list"][:2])


def test_cloud_grows_with_dedup_and_stays_finite(runs):
    _, _, tslam, tsum = runs
    st = tslam.mapper.frame_stats
    counts = [st[i]["n_points"] for i in sorted(st)]
    assert counts == sorted(counts) and counts[0] > 0
    assert st[10]["n_added"] < st[0]["n_added"]
    m = tslam.mapper
    assert np.isfinite(m.cloud.packed[:m.n_points_host].numpy()).all()
    assert int(m.cloud.n_points) == m.n_points_host


def test_wall_clock_buckets_sum(runs):
    _, _, _, tsum = runs
    tm = tsum["timing"]
    parts = sum(tm[k] for k in ("track", "map", "io", "wait", "log",
                                "other"))
    assert tm["track"] > 0 and tm["map"] > 0
    assert parts <= tm["wall_active"] + 1e-6
    assert parts >= 0.95 * tm["wall_active"]


def test_cli_entry_point(tmp_path, capsys):
    """python -m point_slam_tpu_torch.run <cfg> --stop N --output DIR, then
    the same command with --resume: the run leaves its checkpoint, metrics
    sink, point clouds and mesh, and the resumed one continues from the
    newest checkpoint."""
    from point_slam_tpu_torch import run
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        f"inherit_from: {os.path.join(CONFIGS, 'Synthetic', 'room.yaml')}\n"
        "synthetic: {n_frames: 6, angular_step: 0.02}\n"
        "cam: {H: 48, W: 64, fx: 40.0, fy: 40.0, cx: 31.5, cy: 23.5}\n"
        "tracking: {pixels: 200, iters: 5, ignore_edge_W: 5,"
        " ignore_edge_H: 5}\n"
        "mapping: {pixels: 300, pixels_adding: 150,"
        " pixels_based_on_color_grad: 30, iters: 5, iters_first: 10,"
        " geo_iter_first: 5, mapping_window_size: 4, every_frame: 2}\n"
        "cuda: {point_capacity_init: 8192, grid_table_size: 16384}\n"
        "render_datasets: [synthetic]\n"
        "reconstruction_datasets: [synthetic]\n"
        "meshing: {eval_rec: true, voxel: 0.06}\n"
        "verbose: false\n")
    out = tmp_path / "out"
    summary = run.main([str(cfg), "--stop", "3", "--output", str(out),
                        "--device", "cpu"])
    assert summary["n_frames"] == 4
    printed = capsys.readouterr().out
    assert "finished 4 frames on cpu" in printed and "ATE (no-align)" in printed
    for name in ("ckpts/00003.npz", "metrics.jsonl", "final_point_cloud.npy",
                 "final_point_cloud.ply", "npc_cloud.npy",
                 "mesh/final_mesh.ply", "mesh/gt_culled.ply"):
        assert (out / name).exists(), name
    assert "recon_F_score" in summary["eval"]
    assert "failed" not in summary["eval"]

    resumed = run.main([str(cfg), "--resume", "--output", str(out),
                        "--device", "cpu", "--no_eval"])
    assert resumed["n_frames"] == 6 and resumed["output"] == str(out)
    assert (out / "ckpts" / "00005.npz").exists()
    np.testing.assert_array_equal(resumed["estimate_c2w_list"][:4],
                                  summary["estimate_c2w_list"])
    tracked = [json.loads(ln).get("idx_track")
               for ln in open(out / "metrics.jsonl")]
    assert [i for i in tracked if i is not None] == [2, 3, 4, 5]
