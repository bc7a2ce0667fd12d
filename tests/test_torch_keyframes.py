"""The host keyframe ring, the ``tpu:`` keys the port now reads, and the
checkpoint of the view-direction embedding.

* A micro run from a Replica-layout directory with
  ``cuda.keyframe_host_ring: true`` equals the same run on the device ring
  bit for bit (poses, packed cloud, keyframes), both under
  torch.use_deterministic_algorithms on the CPU; a host-ring run resumed
  from its checkpoint re-reads its keyframes from disk (the same wire
  bytes) and ends with the continuous run's poses.
* A gathered window is bit-equal between the two rings, padding included.
* 'auto' picks the host ring exactly when the JAX package's store does.
* configs/Synthetic/room_scannet_scale.yaml resolves to CAP 2^18 and the
  host ring in both packages.
* A checkpoint carries ``param/col/embedder_view_B``.
"""

import os

import numpy as np
import pytest
import torch

from point_slam_tpu.config import load_config as jload
from point_slam_tpu.mapper import KeyframeStore as JStore
from point_slam_tpu_torch.config import load_config as tload
from point_slam_tpu_torch.mapper import KeyframeStore
from point_slam_tpu_torch.slam import PointSLAM
from point_slam_tpu_torch.utils import logger as tlogger

from torch_parity import CONFIGS, room_frames, tiny_cfgs, write_replica

N_FRAMES = 8


def _cfg(out, host_ring):
    _, cfg = tiny_cfgs(N_FRAMES)
    cfg["dataset"] = "replica"
    cfg["cam"].update({"png_depth_scale": 5000.0, "crop_edge": 2,
                       "cx": 31.5, "cy": 23.5})
    cfg["tracking"]["iters"] = 8
    cfg["mapping"].update({"iters": 8, "iters_first": 15, "ckpt_freq": 4,
                           "keyframe_every": 2})
    cfg["cuda"]["keyframe_host_ring"] = host_ring
    cfg["data"]["output"] = str(out)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rings")
    data = str(tmp / "room0")
    write_replica(data, room_frames(N_FRAMES))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out = {}
        for name, host in (("device", False), ("host", True)):
            slam = PointSLAM(_cfg(tmp / name, host), input_folder=data,
                             device="cpu")
            out[name] = (slam, slam.run())
        resumed = PointSLAM(_cfg(tmp / "resumed", True), input_folder=data,
                            device="cpu")
        out["resumed"] = (resumed, resumed.run(resume_from=str(
            tmp / "host" / "ckpts" / "00004.npz")))
    finally:
        torch.use_deterministic_algorithms(was)
    return out


def test_host_ring_run_equals_the_device_ring_run(runs):
    (dslam, dsum), (hslam, hsum) = runs["device"], runs["host"]
    assert not dslam.mapper.store.host_mode and hslam.mapper.store.host_mode
    assert hsum["keyframes"] == dsum["keyframes"] and len(hsum["keyframes"]) > 2
    assert np.isfinite(hsum["estimate_c2w_list"]).all()
    np.testing.assert_array_equal(hsum["estimate_c2w_list"],
                                  dsum["estimate_c2w_list"])
    n = dslam.mapper.n_points_host
    assert hslam.mapper.n_points_host == n
    assert torch.equal(hslam.mapper.cloud.packed[:n],
                       dslam.mapper.cloud.packed[:n])
    # the host ring holds exactly the device ring's wire frames
    ring = dslam.mapper.store.ring
    for slot, frame in enumerate(hslam.mapper.store.frames):
        np.testing.assert_array_equal(frame, ring[slot].numpy())


def test_resumed_host_ring_rereads_its_keyframes_from_disk(runs):
    (hslam, hsum), (rslam, rsum) = runs["host"], runs["resumed"]
    store = rslam.mapper.store
    assert store.host_mode and store.frames
    for slot, frame in enumerate(store.frames):
        np.testing.assert_array_equal(frame, hslam.mapper.store.frames[slot])
    np.testing.assert_array_equal(rsum["estimate_c2w_list"],
                                  hsum["estimate_c2w_list"])


def _store(cfg, host, n_img=40, every=2):
    cfg["cuda"]["keyframe_host_ring"] = host
    return KeyframeStore(cfg, 12, 16, n_img, every, "cpu")


def test_window_is_bit_equal_between_the_rings():
    _, cfg = tiny_cfgs(4)
    cfg["use_dynamic_radius"] = True
    dev, host = _store(cfg, False), _store(cfg, True)
    rng = np.random.default_rng(0)
    for _ in range(2):                 # an empty store's window first
        for a, b in zip(dev.gather_window([], 5), host.gather_window([], 5)):
            assert torch.equal(a, b)
        for k in range(6):
            color = torch.from_numpy(rng.random((12, 16, 3), np.float32))
            depth = torch.from_numpy(rng.uniform(0, 5, (12, 16)).astype(
                np.float32))
            pose = np.eye(4) + k
            for s in (dev, host):
                s.append(color, depth, pose,
                         np.full(s.exposure_dim, k, np.float32))
    for sel in ([0], [3, 1, 5], [5, 4, 3, 2, 1], [11, 7, 9, 0]):
        for a, b in zip(dev.gather_window(sel, 5),
                        host.gather_window(sel, 5)):
            assert a.dtype == b.dtype and torch.equal(a, b)


AUTO = [(40, 2, 1024), (4000, 2, 1024), (4000, 4, 1000), (4000, 4, 1004),
        (4000, 4, 1003), (10, 1, 4)]


@pytest.mark.parametrize("n_img,every,budget", AUTO)
def test_auto_resolves_as_the_jax_packages(n_img, every, budget):
    jcfg, tcfg = tiny_cfgs(4)
    jcfg["tpu"].update({"keyframe_device_budget": budget,
                        "keyframe_host_ring": "auto"})
    tcfg["cuda"]["keyframe_device_budget"] = budget
    jhost = JStore(jcfg, 2, 2, n_img, 8, every).host_mode
    thost = _store(tcfg, "auto", n_img, every).host_mode
    assert thost == jhost == (n_img // every + 4 > budget)


def test_overflowing_the_device_ring_names_the_knob():
    _, cfg = tiny_cfgs(4)
    cfg["cuda"]["keyframe_device_budget"] = 4
    store = _store(cfg, False, n_img=40, every=2)
    for _ in range(4):
        store.append(torch.zeros(12, 16, 3), torch.ones(12, 16), np.eye(4))
    with pytest.raises(RuntimeError, match="cuda.keyframe_host_ring: true"):
        store.append(torch.zeros(12, 16, 3), torch.ones(12, 16), np.eye(4))


def test_scannet_scale_config_resolves_alike_in_both_packages():
    path = os.path.join(CONFIGS, "Synthetic", "room_scannet_scale.yaml")
    default = os.path.join(CONFIGS, "point_slam.yaml")
    jcfg, tcfg = jload(path, default), tload(path, default)
    assert tcfg["cuda"]["point_capacity_init"] == \
        jcfg["tpu"]["point_capacity_init"] == 1 << 18
    n_img, every = jcfg["synthetic"]["n_frames"], \
        jcfg["mapping"]["keyframe_every"]
    assert JStore(jcfg, 2, 2, n_img, 8, every).host_mode
    assert KeyframeStore(tcfg, 2, 2, n_img, every, "cpu").host_mode
    # an explicit cuda: key of the same yaml wins over its tpu: key
    from point_slam_tpu_torch.config import _take_tpu_keys
    raw = {"tpu": {"point_capacity_init": 7, "knn_probes": 9},
           "cuda": {"point_capacity_init": 5}}
    assert _take_tpu_keys(raw)["cuda"] == {"point_capacity_init": 5}
    assert _take_tpu_keys({"tpu": {"point_capacity_init": 7}})["cuda"] == \
        {"point_capacity_init": 7}


@pytest.mark.parametrize("encode_viewd", [True, False],
                         ids=["encode_viewd", "raw_viewd"])
def test_checkpoint_carries_the_view_embedding(tmp_path, encode_viewd):
    _, cfg = tiny_cfgs(4)
    cfg["model"].update({"use_view_direction": True,
                         "encode_viewd": encode_viewd})
    cfg["data"]["output"] = str(tmp_path / "a")
    slam = PointSLAM(cfg, device="cpu")
    path = str(tmp_path / "a.npz")
    tlogger.save_checkpoint(path, slam, idx=0)
    ckpt = tlogger.load_checkpoint(path)
    assert ("param/col/embedder_view_B" in ckpt) == encode_viewd
    _, cfg2 = tiny_cfgs(4)
    cfg2["model"].update({"use_view_direction": True,
                          "encode_viewd": encode_viewd})
    cfg2["setup_seed"] = 7
    cfg2["data"]["output"] = str(tmp_path / "b")
    other = PointSLAM(cfg2, device="cpu")
    tlogger.restore_cloud_and_params(ckpt, other.mapper)
    for (k, a), (k2, b) in zip(slam.mapper.decoders.state_dict().items(),
                               other.mapper.decoders.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    if encode_viewd:
        assert "col.embedder_view_B" in slam.mapper.decoders.state_dict()
