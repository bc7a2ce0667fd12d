"""The end-of-run evaluation as a whole: the 8-frame config of
tests/test_slam_e2e.py::test_end_of_run_reconstruction_eval (48x64, with
synthetic in render_datasets and reconstruction_datasets, eval_img on, a
0.06 m TSDF voxel, the 2D metric over 4 views, a mid mesh every 2 fused
frames) through both PointSLAMs and their run_end_of_run_eval, the port on
the CPU under torch.use_deterministic_algorithms.

The two packages draw different random streams, so the outcomes are
compared, not the numbers: the same result keys (the port adds only its
per-step seconds and mesh statistics); the port's reconstruction as good
as the JAX test asks of JAX's (precision > 5%, finite accuracy, a finite
2D depth-L1); its rendered depth L1 within 2x JAX's plus 1 cm and its PSNR
above half JAX's minus 1 dB. And the CLI with --no_eval writes no mesh,
which the mesh-from-checkpoint CLI then makes from the run's checkpoint."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from point_slam_tpu.slam import PointSLAM as JaxSLAM
from point_slam_tpu.tools.evaluate import run_end_of_run_eval as j_eval
from point_slam_tpu_torch.slam import PointSLAM as TorchSLAM
from point_slam_tpu_torch.tools.evaluate import run_end_of_run_eval as t_eval

from torch_parity import CONFIGS, tiny_cfgs


def eval_cfgs():
    out = tiny_cfgs(8)
    for cfg in out:
        cfg["mapping"].update({"iters": 15, "iters_first": 25})
        cfg["reconstruction_datasets"] = ["synthetic"]
        cfg["render_datasets"] = ["synthetic"]
        cfg["rendering"]["eval_img"] = True
        cfg["meshing"].update({"eval_rec": True, "voxel": 0.06,
                               "eval_2d": True, "eval_2d_n_imgs": 4,
                               "mesh_freq": 2})
    return out


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    jcfg, tcfg = eval_cfgs()
    jcfg["data"]["output"] = str(tmp_path_factory.mktemp("jax"))
    tcfg["data"]["output"] = str(tmp_path_factory.mktemp("port"))
    jslam = JaxSLAM(jcfg)
    jslam.run()
    jres = j_eval(jslam, jslam.output)
    tslam = TorchSLAM(tcfg, device="cpu")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        tslam.run()
        tres = t_eval(tslam, tslam.output)
    finally:
        torch.use_deterministic_algorithms(was)
    return jres, tslam, tres


def test_same_result_keys(evals):
    jres, _, tres = evals
    assert "failed" not in tres, tres
    own = {k for k in tres if k.startswith(("time_", "mesh_"))}
    assert set(tres) - own == set(jres)
    assert {"time_ate", "time_rerender", "time_mesh", "time_recon"} <= own


def test_port_reconstruction_is_scored(evals):
    _, tslam, tres = evals
    assert tres["recon_precision"] > 5.0
    assert np.isfinite(tres["recon_accuracy"])
    assert np.isfinite(tres["recon_F_score"])
    assert "recon_depth_l1_2d" in tres
    assert np.isfinite(tres["recon_depth_l1_2d"])
    mesh = os.path.join(tslam.output, "mesh")
    assert os.path.exists(os.path.join(mesh, "gt_culled.ply"))
    assert os.path.exists(tres["mesh"])
    assert glob.glob(os.path.join(mesh, "mid_mesh", "frame_*_mesh.ply"))
    # the scratch renders are gone, the checkpoints dir stays
    assert not os.path.exists(os.path.join(tslam.output,
                                           "rendered_every_frame"))
    assert os.path.isdir(os.path.join(tslam.output, "ckpts"))


def test_image_metrics_against_jax(evals):
    jres, _, tres = evals
    assert tres["frame_cnt"] == jres["frame_cnt"] == 4
    for k in ("depth_l1_render", "avg_psnr", "avg_ms_ssim"):
        assert np.isfinite(tres[k]), k
    assert tres["depth_l1_render"] <= 2 * jres["depth_l1_render"] + 0.01
    assert tres["avg_psnr"] >= jres["avg_psnr"] / 2 - 1.0
    assert 0 < tres["avg_ms_ssim"] <= 1.0
    # no weights here: each package gives its reason, the port's naming
    # its own converter
    from point_slam_tpu.utils.metrics import LPIPS_UNAVAILABLE as j_reason
    from point_slam_tpu_torch.utils.metrics import LPIPS_UNAVAILABLE
    assert jres["avg_lpips"] == j_reason
    assert tres["avg_lpips"] == LPIPS_UNAVAILABLE
    assert tres["ate_rmse_no_align"] < 0.10


def test_cli_no_eval_writes_no_mesh_and_the_mesher_cli_does(tmp_path):
    from point_slam_tpu_torch import run
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        f"inherit_from: {os.path.join(CONFIGS, 'Synthetic', 'room.yaml')}\n"
        "synthetic: {n_frames: 4, angular_step: 0.02}\n"
        "cam: {H: 48, W: 64, fx: 40.0, fy: 40.0, cx: 31.5, cy: 23.5}\n"
        "tracking: {pixels: 200, iters: 5, ignore_edge_W: 5,"
        " ignore_edge_H: 5}\n"
        "mapping: {pixels: 300, pixels_adding: 150,"
        " pixels_based_on_color_grad: 30, iters: 5, iters_first: 10,"
        " geo_iter_first: 5, mapping_window_size: 4, every_frame: 2}\n"
        "cuda: {point_capacity_init: 8192, grid_table_size: 16384}\n"
        "render_datasets: [synthetic]\nreconstruction_datasets: [synthetic]\n"
        "meshing: {eval_rec: true, voxel: 0.06}\nverbose: false\n")
    out = tmp_path / "out"
    summary = run.main([str(cfg), "--stop", "2", "--output", str(out),
                        "--device", "cpu", "--no_eval"])
    assert summary["eval"] == {}
    assert (out / "ckpts" / "00002.npz").exists()
    assert (out / "final_point_cloud.ply").exists()
    assert not glob.glob(str(out / "mesh" / "*.ply"))
    assert not (out / "trajectory.png").exists()

    # the mesh-from-checkpoint CLI on the run's newest checkpoint
    from point_slam_tpu_torch.tools import mesher
    mesh = mesher.main([str(cfg), "--output", str(out), "--device", "cpu",
                        "--voxel", "0.06"])
    assert mesh == str(out / "mesh" / "synth_room_pred_mesh.ply")
    assert os.path.exists(mesh)
    rec = json.load(open(out / "mesh" / "recon_eval.json"))
    assert rec["recon_precision"] > 5.0 and np.isfinite(rec["recon_F_score"])
