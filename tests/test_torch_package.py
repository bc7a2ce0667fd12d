"""The port as a package: it runs without JAX, reads the same config tree
as point_slam_tpu, raises on the paths it does not carry yet, and runs on
CUDA unless asked for the CPU."""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from point_slam_tpu.config import load_config as jload
from point_slam_tpu_torch import config as tconfig
from point_slam_tpu_torch import renderer as TR

from torch_parity import CONFIGS, HERE, tiny_cfgs

PORT = os.path.join(HERE, "point_slam_tpu_torch")

NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None               # any import of jax now fails
sys.modules["point_slam_tpu"] = None
import torch
import point_slam_tpu_torch
for m in pkgutil.walk_packages(point_slam_tpu_torch.__path__,
                               "point_slam_tpu_torch."):
    importlib.import_module(m.name)
from point_slam_tpu_torch import pointcloud as pc, renderer as R
from point_slam_tpu_torch.models import decoders as D
cfg = {"model": {"c_dim": 32}}
dec = D.Decoders(cfg)
cloud = pc.init_cloud(1024, 32, 3)
g = torch.Generator().manual_seed(0)
o = torch.zeros(64, 3)
d = torch.nn.functional.pad(torch.rand(64, 2, generator=g) * 0.2 - 0.1,
                            (0, 1), value=-1.0)
dep = torch.full((64,), 2.0)
index = pc.build_index(cloud, 0.16, 1 << 10, 64)
cloud, _ = pc.add_points(cloud, index, o, d, dep, torch.rand(64, 3),
                         torch.ones(64, dtype=bool), torch.full((64,), 0.04),
                         0.98, 1.02, generator=g)
index = pc.build_index(cloud, 0.16, 1 << 10, 64, packed_coords=True)
depth, unc, col, valid = R.render_rays(
    dec, cloud.packed, index, o, d, dep, torch.full((64,), 0.16),
    torch.ones(64, dtype=bool), R.RenderConfig(ray_knn=True, knn_probes=27),
    stage_color=True, generator=g)
assert torch.isfinite(depth).all() and valid.any()
from point_slam_tpu_torch.ops import block_topk as bt
from point_slam_tpu_torch.profiling import (knn_layout_micro, knn_pallas,
    knn_pallas2, knn_pallas3, knn_pallas4, knn_quad_micro, knn_study, scene)
views = bt.layout_views(torch.rand(4, 3 * 2 * 8), "row", 4, 2, 8, 3)
keys, ids = bt.block_topk(views, torch.rand(4, 5, 3), 8, 15)
assert keys.shape == (4, 40) and ids is None
assert not [k for k, v in sys.modules.items()
            if v is not None and (k == "jax" or k.startswith("jax."))]
print("rendered without jax")
"""


def test_port_imports_and_renders_without_jax():
    env = dict(os.environ, PYTHONPATH=HERE)
    res = subprocess.run([sys.executable, "-c", NO_JAX], cwd=HERE, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "rendered without jax" in res.stdout


def test_no_source_file_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|point_slam_tpu)(\.|\s|$)")
    files = glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
    assert len(files) > 30
    assert os.path.join(PORT, "profiling", "knn_study.py") in files
    for f in files:
        with open(f) as fh:
            bad = [ln for ln in fh if pat.match(ln)]
        assert not bad, (f, bad)


YAMLS = sorted(os.path.relpath(p, CONFIGS) for p in
               glob.glob(os.path.join(CONFIGS, "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("name", YAMLS)
def test_config_tree_matches_jax(name):
    """Same YAML tree, same inherit_from resolution; the port reads its
    'cuda' section (defaults equal to TPU_DEFAULTS for the knobs it keeps)
    and leaves a scene's 'tpu' section to the JAX package."""
    from point_slam_tpu.config import TPU_DEFAULTS
    default = os.path.join(CONFIGS, "point_slam.yaml")
    jcfg = jload(os.path.join(CONFIGS, name), default)
    tcfg = tconfig.load_config(os.path.join(CONFIGS, name), default)
    jcfg.pop("tpu")
    tcfg.pop("tpu", None)
    tcuda = tcfg.pop("cuda")
    assert tcfg == jcfg
    for k, v in tcuda.items():
        assert v == TPU_DEFAULTS["tpu"][k], k


def test_cuda_defaults_hold_only_the_slice_knobs():
    assert set(tconfig.CUDA_DEFAULTS["cuda"]) == {
        "point_capacity_init", "point_capacity_max", "grid_table_size",
        "grid_max_per_cell", "knn_probes", "ray_knn", "knn_packed_coords",
        "keyframe_device_budget", "fused_adam"}


OUT_OF_SLICE = [
    ({"mapping": {"vis_inside": True}}, "vis_inside"),
    ({"tracking": {"vis_inside": True}}, "vis_inside"),
    ({"wandb": True}, "metrics sink"),
    ({"cuda": {"keyframe_host_ring": True}}, "keyframe ring"),
    ({"cuda": {"data_parallel": 2}}, "data parallelism"),
]


@pytest.mark.parametrize("override,what", OUT_OF_SLICE,
                         ids=[w for _, w in OUT_OF_SLICE])
def test_out_of_slice_paths_raise(override, what):
    _, cfg = tiny_cfgs(4)
    tconfig.update_recursive(cfg, override)
    with pytest.raises(NotImplementedError, match=what):
        tconfig.check_supported(cfg)


SENSOR_SLICE = [
    ({"mapping": {"BA": True}}, "bundle adjustment"),
    ({"model": {"encode_exposure": True}}, "exposure"),
    ({"mapping": {"color_refine": True}}, "colour refinement"),
    ({"rendering": {"sample_near_pcl": True}}, "sample_near_pcl"),
    ({"cuda": {"knn_packed_coords": "fused"}}, "fused"),
    ({"cuda": {"fused_adam": True}}, "row-Adam"),
]


@pytest.mark.parametrize("override,what", SENSOR_SLICE,
                         ids=[w for _, w in SENSOR_SLICE])
def test_sensor_slice_paths_pass_the_check(override, what):
    """The paths the sensor-shaped slice carries are no longer refused."""
    _, cfg = tiny_cfgs(4)
    tconfig.update_recursive(cfg, override)
    tconfig.check_supported(cfg)


def test_the_slice_config_passes_the_check():
    _, cfg = tiny_cfgs(4)
    tconfig.check_supported(cfg)
    # room_sensor.yaml's path with the two kernels on
    cfg = tconfig.load_config(
        os.path.join(CONFIGS, "Synthetic", "room_sensor.yaml"),
        os.path.join(CONFIGS, "point_slam.yaml"))
    cfg["cuda"].update({"knn_packed_coords": "fused", "fused_adam": True})
    tconfig.check_supported(cfg)


def test_entry_points_run_on_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                            tmp_path):
    """Without CUDA, PointSLAM(cfg) and the CLI without --device raise
    (no silent fall-back to the host); device="cpu" is the way to ask."""
    from point_slam_tpu_torch import run
    from point_slam_tpu_torch.slam import PointSLAM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = tiny_cfgs(4)
    cfg["data"]["output"] = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PointSLAM(cfg)
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(
        f"inherit_from: {os.path.join(CONFIGS, 'Synthetic', 'room.yaml')}\n"
        "synthetic: {n_frames: 4}\ncam: {H: 48, W: 64, fx: 40.0, fy: 40.0,"
        " cx: 31.5, cy: 23.5}\nverbose: false\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main([str(yaml), "--stop", "2", "--output",
                  str(tmp_path / "cli")])
    assert PointSLAM(cfg, device="cpu").device.type == "cpu"


def test_auto_knobs_resolve_by_device():
    assert TR.resolve_auto("auto", "cuda") is True
    assert TR.resolve_auto("auto", "cpu") is False
    assert TR.resolve_auto(True, "cpu") is True
    assert TR.resolve_auto(False, torch.device("cuda")) is False


def test_tf32_is_off():
    import point_slam_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("scene", ["room.yaml", "room_furnished.yaml",
                                   "room_sensor.yaml"])
def test_synthetic_frames_are_the_jax_packages(scene):
    """The port's copy of the Synthetic reader and wire format gives the
    same bytes and the same poses."""
    from point_slam_tpu.datasets import get_dataset as jget
    from point_slam_tpu_torch.datasets import get_dataset as tget
    default = os.path.join(CONFIGS, "point_slam.yaml")
    path = os.path.join(CONFIGS, "Synthetic", scene)
    jcfg = jload(path, default)
    tcfg = tconfig.load_config(path, default)
    for cfg in (jcfg, tcfg):
        cfg["cam"].update({"H": 24, "W": 32, "fx": 20.0, "fy": 20.0,
                           "cx": 15.5, "cy": 11.5, "crop_edge": 0})
        cfg["synthetic"]["n_frames"] = 40
    jds, tds = jget(jcfg), tget(tcfg)
    assert len(jds) == len(tds) == 40
    for i in (0, 17, 39):
        for a, b in zip(tds.wire(i)[1:], jds.wire(i)[1:]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tds[i][1:], jds[i][1:]):
            np.testing.assert_array_equal(a, b)


def test_eval_ate_is_the_jax_packages():
    from point_slam_tpu.tools.eval_ate import evaluate_ate as jate
    from point_slam_tpu_torch.tools.eval_ate import evaluate_ate as tate
    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = rng.normal(size=(20, 3))
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (20, 3))
    est[3, 0, 0] = np.nan                       # skipped pair
    for align in (True, False):
        assert tate(gt, est, align) == jate(gt, est, align)


def test_prefetcher_yields_frames_in_order_and_raises_errors():
    from point_slam_tpu_torch.utils.prefetch import FramePrefetcher

    class Frames:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise ValueError("bad frame")
            return i

    got = []
    with pytest.raises(ValueError, match="bad frame"):
        for item in FramePrefetcher(Frames(), depth=2, start=1,
                                    stage=lambda x: x * 10):
            got.append(item)
    assert got == [10, 20, 30]
