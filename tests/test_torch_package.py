"""The port as a package: it runs without JAX, reads the same config tree
as point_slam_tpu, refuses none of its paths, and runs on CUDA unless
asked for the CPU."""

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
names = {m.name for m in pkgutil.walk_packages(point_slam_tpu_torch.__path__,
                                               "point_slam_tpu_torch.")}
assert {"point_slam_tpu_torch.parallel.dist",
        "point_slam_tpu_torch.tools.determinism",
        "point_slam_tpu_torch.tools.convert_pretrained",
        "point_slam_tpu_torch.tools.convert_lpips",
        "point_slam_tpu_torch.tools.pretrain_geo"} <= names
for name in sorted(names):
    importlib.import_module(name)
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


def _code_strings(path):
    """The string literals of a Python file outside its docstrings."""
    import ast
    tree = ast.parse(open(path).read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_source_file_imports_jax_or_the_jax_package():
    """No import of jax, point_slam_tpu or an image library (cv2, PIL,
    torchvision); no run-time path into the JAX
    package or the root native/ sources (docstrings and comments may cite
    them); the host C++ sources are the port's own copies, built from its
    native/ into its ops/build/, and its C++/CUDA sources include nothing
    from outside their own directory."""
    from point_slam_tpu_torch.utils import native
    pat = re.compile(r"^\s*(import|from)\s+(jax|point_slam_tpu|cv2|PIL|"
                     r"torchvision)(\.|\s|$)")
    files = glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
    assert len(files) > 30
    assert os.path.join(PORT, "profiling", "knn_study.py") in files
    for f in files:
        with open(f) as fh:
            bad = [ln for ln in fh if pat.match(ln)]
        assert not bad, (f, bad)
        bad = [s for s in _code_strings(f)
               if re.search(r"point_slam_tpu(/|\.)|\.\./|(^|/)native/", s)]
        assert not bad, (f, bad)
    assert native._SRC_DIR == os.path.join(PORT, "native")
    assert native.BUILD_DIR == os.path.join(PORT, "ops", "build")
    sources = sorted(glob.glob(os.path.join(PORT, "native", "*.cpp")))
    assert [os.path.basename(s) for s in sources] == [
        "imgcodec.cpp", "marching.cpp", "raster.cpp"]
    for name in ("imgcodec", "marching", "raster"):
        assert os.path.dirname(native.library_path(name)) == \
            native.BUILD_DIR
    cxx = sources + glob.glob(os.path.join(PORT, "ops", "csrc", "*.cu"))
    for f in cxx:
        for ln in open(f):
            code = ln.split("//")[0]
            assert "point_slam_tpu/" not in code, (f, ln)
            inc = re.match(r'\s*#\s*include\s+"([^"]+)"', code)
            if inc:
                assert os.path.exists(os.path.join(os.path.dirname(f),
                                                   inc.group(1))), (f, ln)
                assert "/" not in inc.group(1), (f, ln)


def test_chip_smoke_imports_no_jax_and_no_image_library():
    """chip_smoke.py runs on the card's machine, which has neither JAX nor
    an image library: it imports none of them, nor the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|point_slam_tpu|cv2|PIL|"
                     r"torchvision)(\.|\s|$)")
    with open(os.path.join(HERE, "chip_smoke.py")) as fh:
        lines = fh.readlines()
    assert any(re.match(r"\s*from point_slam_tpu_torch", ln) for ln in lines)
    assert not [ln for ln in lines if pat.match(ln)]


YAMLS = sorted(os.path.relpath(p, CONFIGS) for p in
               glob.glob(os.path.join(CONFIGS, "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("name", YAMLS)
def test_config_tree_matches_jax(name):
    """Same YAML tree, same inherit_from resolution; the port reads its
    'cuda' section, whose knobs resolve to the JAX package's 'tpu' values
    (its defaults, and a scene's shared 'tpu' keys such as
    room_scannet_scale.yaml's capacity and host ring)."""
    default = os.path.join(CONFIGS, "point_slam.yaml")
    jcfg = jload(os.path.join(CONFIGS, name), default)
    tcfg = tconfig.load_config(os.path.join(CONFIGS, name), default)
    jtpu = jcfg.pop("tpu")
    tcfg.pop("tpu", None)
    tcuda = tcfg.pop("cuda")
    assert tcfg == jcfg
    # the run keys of this slice and the visualiser's, explicitly
    for k in ("prefetch_depth", "max_iters_per_launch", "bf16_features",
              "profile_dir"):
        assert tcuda[k] == jtpu[k], k
    for sec, k in [(s, k) for s in ("tracking", "mapping")
                   for k in ("vis_freq", "vis_inside", "vis_inside_freq")]:
        assert tcfg[sec][k] == jcfg[sec][k], (sec, k)
    assert tcfg["mapping"]["save_rendered_image"] == \
        jcfg["mapping"]["save_rendered_image"]
    # mlp_precision is the port's own: 'default' is TF32 here, a bf16 MXU
    # pass on the TPU; the port keeps IEEE f32 by default
    assert tcuda.pop("mlp_precision") == "highest"
    for k, v in tcuda.items():
        assert v == jtpu[k], k


def test_cuda_defaults_hold_only_the_slice_knobs():
    assert set(tconfig.CUDA_DEFAULTS["cuda"]) == {
        "point_capacity_init", "point_capacity_max", "grid_table_size",
        "grid_max_per_cell", "knn_probes", "ray_knn", "knn_packed_coords",
        "keyframe_device_budget", "keyframe_host_ring", "data_parallel",
        "fused_adam", "bf16_features", "mlp_precision",
        "max_iters_per_launch", "prefetch_depth", "profile_dir"}


SENSOR_SLICE = [
    ({"mapping": {"BA": True}}, "bundle adjustment"),
    ({"model": {"encode_exposure": True}}, "exposure"),
    ({"mapping": {"color_refine": True}}, "colour refinement"),
    ({"rendering": {"sample_near_pcl": True}}, "sample_near_pcl"),
    ({"cuda": {"knn_packed_coords": "fused"}}, "fused"),
    ({"cuda": {"fused_adam": True}}, "row-Adam"),
    ({"wandb": True}, "metrics sink"),
    ({"cuda": {"keyframe_host_ring": True}}, "keyframe ring"),
    ({"mapping": {"vis_inside": True}}, "mapping vis_inside"),
    ({"tracking": {"vis_inside": True}}, "tracking vis_inside"),
    ({"cuda": {"bf16_features": True}}, "bf16 view"),
    ({"cuda": {"mlp_precision": "default"}}, "TF32 MLP blocks"),
]


def _build(cfg, tmp_path):
    from point_slam_tpu_torch.slam import PointSLAM
    slam = PointSLAM(cfg, output=str(tmp_path / "out"), device="cpu")
    slam.mlog.close()
    return slam


@pytest.mark.parametrize("override,what", SENSOR_SLICE,
                         ids=[w for _, w in SENSOR_SLICE])
def test_sensor_slice_paths_build(override, what, tmp_path):
    """The paths the port carries (those of the sensor-shaped slice, the
    metrics sink's wandb mirror, the host keyframe ring, the in-loop
    visualisation and the render-path keys): PointSLAM builds on the CPU
    with each key set, and keeps it as given."""
    _, cfg = tiny_cfgs(4)
    tconfig.update_recursive(cfg, override)
    slam = _build(cfg, tmp_path)
    for sec, v in override.items():
        if isinstance(v, dict):
            for k, x in v.items():
                assert slam.cfg[sec][k] == x, (sec, k)
        else:
            assert slam.cfg[sec] == v, sec


def test_the_slice_config_builds(tmp_path):
    # room_sensor.yaml's path with the two kernels on
    cfg = tconfig.load_config(
        os.path.join(CONFIGS, "Synthetic", "room_sensor.yaml"),
        os.path.join(CONFIGS, "point_slam.yaml"))
    cfg["cuda"].update({"knn_packed_coords": "fused", "fused_adam": True})
    cfg["synthetic"]["n_frames"] = 2
    cfg["verbose"] = False
    slam = _build(cfg, tmp_path)
    assert slam.mapper.ms.fused_adam and slam.mapper.ms.encode_exposure


def test_tpu_data_parallel_reaches_cuda(tmp_path):
    """A yaml's ``tpu: {data_parallel: 2}`` is the port's
    ``cuda.data_parallel``, which then needs a process group of 2."""
    from point_slam_tpu_torch.parallel import dist as pdist
    yaml = tmp_path / "dp.yaml"
    yaml.write_text(
        f"inherit_from: {os.path.join(CONFIGS, 'Synthetic', 'room.yaml')}\n"
        "tpu: {data_parallel: 2}\n")
    cfg = tconfig.load_config(str(yaml), os.path.join(CONFIGS,
                                                      "point_slam.yaml"))
    assert cfg["cuda"]["data_parallel"] == 2
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        pdist.check_group(cfg)


@pytest.mark.parametrize("dp", [None, 1, 2, 3])
def test_check_group_without_a_group(dp):
    """Without a process group ``cuda.data_parallel`` may only be 1 (or
    unset); a larger value is refused with the torchrun command."""
    from point_slam_tpu_torch.parallel import dist as pdist
    cfg = {"cuda": {"data_parallel": dp}}
    if (dp or 1) == 1:
        pdist.check_group(cfg)
    else:
        with pytest.raises(RuntimeError,
                           match=f"torchrun --nproc_per_node {dp}"):
            pdist.check_group(cfg)


def test_entry_points_run_on_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                            tmp_path):
    """Without CUDA, PointSLAM(cfg), the CLI without --device, the
    mesh-from-checkpoint CLI without --device, the determinism harness and
    pretrain_geo without --device, the end-of-run meshing (fuse_renders),
    TSDFVolume and every profiling tool without --device raise (no silent
    fall-back to the host); device="cpu" is the way to ask."""
    from point_slam_tpu_torch import run
    from point_slam_tpu_torch.slam import PointSLAM
    from point_slam_tpu_torch.tools import determinism, mesher, pretrain_geo
    from point_slam_tpu_torch.tools.tsdf import TSDFVolume
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesher.main([str(yaml), "--output", str(tmp_path / "cli")])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        determinism.main(["--self_check"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pretrain_geo.main(["--out", str(tmp_path / "geo.npz"), "--workdir",
                           str(tmp_path / "work")])
    assert not (tmp_path / "geo.npz").exists()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TSDFVolume((0, 0, 0), (4, 4, 4))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TSDFVolume.from_bounds(np.zeros(3), np.ones(3), voxel=0.5)
    renders = tmp_path / "renders"
    renders.mkdir()
    np.save(renders / "depth_00000.npy", np.ones((4, 4), np.float32))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mesher.fuse_renders(str(renders), None, np.eye(4)[None], 1,
                            (4.0, 4.0, 1.5, 1.5), voxel=0.5)
    assert PointSLAM(cfg, device="cpu").device.type == "cpu"
    assert TSDFVolume((0, 0, 0), (4, 4, 4), device="cpu").tsdf.device.type \
        == "cpu"
    # the layer-measurement tools: cuda by default, raising without it
    import importlib
    for name in PROFILING_TOOLS:
        module = importlib.import_module(
            f"point_slam_tpu_torch.profiling.{name}")
        argv = {"trace_ops": ["capture", str(tmp_path / "tr")],
                "recon_validate": [str(yaml), str(tmp_path / "cli")],
                "soak_eval": [str(tmp_path / "cli")],
                "soak_summary": [str(tmp_path / "cli")],
                "soak_runner": ["--output", str(tmp_path / "soak"),
                                "--log-dir", str(tmp_path / "soak")],
                }.get(name, [])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            module.main(argv)
    assert not (tmp_path / "tr").exists()
    assert not (tmp_path / "soak").exists()


PROFILING_TOOLS = (
    "roofline", "hw_calibration", "gather_scatter_micro", "scatter_micro",
    "latency_floor", "trace_ops", "trace_map_iter", "iter_breakdown",
    "render_breakdown", "sample_stages", "step_cost", "iter_cost",
    "tracker_cost", "map_frame_overhead", "track_frame_overhead",
    "frame_overhead", "feat_adam_micro", "upload_micro", "knn8_micro",
    "knn_ray", "knn_study", "quality_gate", "track_quality",
    "recon_validate", "soak_eval", "soak_summary", "soak_runner", "bf16_ab",
    "geo_decoder_ab", "mlp_precision_ab", "probes_ab", "geo_fwd_split",
    "interp_inspect")


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
