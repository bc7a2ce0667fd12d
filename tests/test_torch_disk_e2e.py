"""The disk path as a whole: a micro-SLAM (48x64, 6 frames) straight from a
Replica-layout directory through both PointSLAMs, as
test_dataset_formats.py::test_slam_from_replica_format_on_disk does for
the JAX package, and the port's CLI with --input_folder on the CPU.

The two packages draw different random streams, so the outcomes are
compared (as in test_torch_slam_e2e.py): the same schedule and keyframes,
both trajectories within 10 cm (ATE without alignment) and the port's
within 2x the JAX package's plus 1 cm. The port runs under
torch.use_deterministic_algorithms (the CPU's scatter-add otherwise sums
in a varying order)."""

import json
import os

import numpy as np
import pytest
import torch

from point_slam_tpu.slam import PointSLAM as JaxSLAM
from point_slam_tpu.tools.eval_ate import evaluate_ate
from point_slam_tpu_torch.slam import PointSLAM as TorchSLAM

from torch_parity import room_frames, tiny_cfgs, write_replica

N_FRAMES = 6


def _cfgs(out):
    jcfg, tcfg = tiny_cfgs(N_FRAMES)
    for cfg, name in ((jcfg, "jax"), (tcfg, "port")):
        cfg["dataset"] = "replica"
        cfg["cam"].update({"png_depth_scale": 5000.0, "crop_edge": 0})
        cfg["mapping"].update({"keyframe_every": 2, "every_frame": 2})
        cfg["data"]["output"] = str(out / name)
    return jcfg, tcfg


def _ate(summary):
    return evaluate_ate(summary["gt_c2w_list"], summary["estimate_c2w_list"],
                        align=False)["absolute_translational_error.rmse"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("disk") / "room0"
    write_replica(str(root), room_frames(N_FRAMES))
    return root


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    jcfg, tcfg = _cfgs(tmp_path_factory.mktemp("out"))
    jslam = JaxSLAM(jcfg, input_folder=str(data))
    jsum = jslam.run()
    tslam = TorchSLAM(tcfg, input_folder=str(data), device="cpu")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        tsum = tslam.run()
    finally:
        torch.use_deterministic_algorithms(was)
    return jslam, jsum, tslam, tsum


def test_same_frames_schedule_and_keyframes(runs):
    jslam, jsum, tslam, tsum = runs
    assert tsum["n_frames"] == jsum["n_frames"] == N_FRAMES
    assert tsum["keyframes"] == jsum["keyframes"] == [0, 2, 4]
    assert sorted(tslam.mapper.frame_stats) == [0, 2, 4, 5]
    np.testing.assert_allclose(tsum["gt_c2w_list"], jsum["gt_c2w_list"],
                               rtol=0, atol=1e-6)


def test_both_trajectories_stay_on_track(runs):
    _, jsum, _, tsum = runs
    j_ate, t_ate = _ate(jsum), _ate(tsum)
    print(f"ATE no-align from disk: JAX {j_ate:.6f} m, port {t_ate:.6f} m")
    assert np.isfinite(tsum["estimate_c2w_list"]).all()
    assert j_ate < 0.10 and t_ate < 0.10, (j_ate, t_ate)
    assert t_ate <= 2 * j_ate + 0.01, (j_ate, t_ate)
    assert tsum["n_points"] > 100


def test_cli_reads_the_input_folder_on_the_cpu(data, tmp_path):
    """``python -m point_slam_tpu_torch.run <yaml> --input_folder DIR
    --device cpu``: frames from disk, a checkpoint, and the end-of-run
    evaluation, whose reconstruction step is listed as failed without a
    ground-truth mesh (a Replica run needs meshing.gt_mesh)."""
    from point_slam_tpu_torch import run
    yaml = tmp_path / "replica_tiny.yaml"
    yaml.write_text(
        "inherit_from: configs/Replica/room0.yaml\n"
        "cam: {H: 48, W: 64, fx: 40.0, fy: 40.0, cx: 31.5, cy: 23.5,"
        " png_depth_scale: 5000.0, crop_edge: 0}\n"
        "tracking: {pixels: 200, iters: 5, ignore_edge_W: 5,"
        " ignore_edge_H: 5}\n"
        "mapping: {pixels: 300, pixels_adding: 150,"
        " pixels_based_on_color_grad: 30, iters: 5, iters_first: 10,"
        " geo_iter_first: 5, mapping_window_size: 3, keyframe_every: 2,"
        " every_frame: 2, lazy_start: 0, color_refine: false}\n"
        "rendering: {eval_img: false}\n"
        "meshing: {eval_rec: true, voxel: 0.08}\n"
        "cuda: {point_capacity_init: 4096, grid_table_size: 4096}\n"
        "verbose: false\n")
    out = tmp_path / "out"
    res = run.main([str(yaml), "--input_folder", str(data), "--output",
                    str(out), "--device", "cpu"])
    assert res["n_frames"] == N_FRAMES
    assert os.path.exists(out / "ckpts" / f"{N_FRAMES - 1:05d}.npz")
    ev = res["eval"]
    assert ev["ate_rmse_no_align"] < 0.10
    assert os.path.exists(ev["mesh"])
    assert ev["failed"] == ["recon"]          # no meshing.gt_mesh given
    lines = [json.loads(ln) for ln in open(out / "metrics.jsonl")]
    assert [ln["idx_map"] for ln in lines if "idx_map" in ln] == [2, 4, 5]
