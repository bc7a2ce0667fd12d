"""Port parity, datasets.py: the Replica, ScanNet and TUM-RGBD readers of
both packages on the same directories, written here with OpenCV in each
dataset's layout from the synthetic room (as test_dataset_formats.py does).
The wire frames ((H,W,5) u8: colour and u16 depth) are compared byte for
byte and the poses to 1e-6.

The JAX readers call OpenCV; the port calls its own decoders and
resampling, which follow OpenCV's own code. This build of OpenCV also has
Intel IPP, whose cv2.resize of a float64 image rounds differently from
OpenCV's code (in the last bits of the f64 colour, which now and then
moves the u8 wire value). So every variant is compared twice:

- with OpenCV's IPP path off: equal bytes, on every variant;
- with OpenCV as built: depth bytes and poses equal, colour bytes equal
  except for at most 1 LSB on at most 0.1% of the colour pixels (the
  resize rounding just described), and on at most 2% of them for
  ``replica_crop_size``: there IPP's 48x64 -> 40x56 resize of the f64
  colour rounds 1.4-1.6% of the frames' pixels to the other u8 neighbour
  (measured on these files), where OpenCV's own code and the port agree.
  The variants without a colour resize (Replica, TUM) are equal here too.
"""

import os

import cv2
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from point_slam_tpu.config import load_config as jload
from point_slam_tpu.datasets import get_dataset as jget
from point_slam_tpu_torch import datasets as TDS
from point_slam_tpu_torch.config import load_config as tload

from torch_parity import (CONFIGS, room_frames, write_images as write,
                          write_replica)

H, W = 48, 64
F = 40.0
DEPTH_SCALE = 5000.0
FR1_DISTORTION = [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]


def cfgs(dataset, **cam):
    out = []
    for load in (jload, tload):
        cfg = load(os.path.join(CONFIGS, "Synthetic", "room.yaml"),
                   os.path.join(CONFIGS, "point_slam.yaml"))
        cfg["dataset"] = dataset
        cfg["cam"].update({"H": H, "W": W, "fx": F, "fy": F, "cx": 31.5,
                           "cy": 23.5, "png_depth_scale": DEPTH_SCALE,
                           "crop_edge": 4, **cam})
        out.append(cfg)
    return out


def room(n, h=H, w=W):
    return room_frames(n, h, w, DEPTH_SCALE)


def replica(root, n=5):
    write_replica(str(root), room(n))


def scannet(root, n=12):
    for sub in ("color", "depth", "pose"):
        os.makedirs(root / "frames" / sub)
    big = room(n, 60, 80)        # colour larger than depth: the resize path
    for i, ((bgr, _, pose), (_, d16, _)) in enumerate(zip(big, room(n))):
        write(bgr, d16, str(root / "frames" / "color" / f"{i}.jpg"),
              str(root / "frames" / "depth" / f"{i}.png"))
        np.savetxt(str(root / "frames" / "pose" / f"{i}.txt"), pose)


def tum(root, n=7, pose_name="groundtruth.txt"):
    """TUM layout: rgb 1/30 s apart with +-1 ms jitter, depth 5-15 ms and
    poses 3-8 ms off, and one extra rgb/depth/pose entry 10 ms after frame
    3, which the 32 fps pick drops."""
    rng = np.random.default_rng(3)
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    head = ["# color images", "# file: 'x.bag'", "# timestamp filename"]
    rgb, dep = list(head), list(head)
    gt = ["# ground truth trajectory", "# file: 'x.bag'",
          "# timestamp tx ty tz qx qy qz qw"]
    frames = room(n + 1)
    stamps = [1305031102.0 + i / 30 + rng.uniform(-1e-3, 1e-3)
              for i in range(n)]
    stamps.insert(4, stamps[3] + 0.010)
    for t, (bgr, d16, pose) in zip(stamps, frames):
        td = t + rng.uniform(0.005, 0.015)
        tp = t + rng.uniform(0.003, 0.008)
        write(bgr, d16, str(root / "rgb" / f"{t:.6f}.png"),
              str(root / "depth" / f"{td:.6f}.png"))
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{td:.6f} depth/{td:.6f}.png")
        q = Rotation.from_matrix(pose[:3, :3]).as_quat()
        gt.append(f"{tp:.6f} " + " ".join(f"{v:.9f}"
                                          for v in [*pose[:3, 3], *q]))
    (root / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("\n".join(dep) + "\n")
    (root / pose_name).write_text("\n".join(gt) + "\n")


# variant -> (layout writer, dataset, cam overrides, frames expected)
VARIANTS = {
    "replica": (replica, "replica", {}, 5),
    "replica_crop_size": (replica, "replica", {"crop_size": [40, 56],
                                               "crop_edge": 2}, 5),
    "scannet_resize": (scannet, "scannet", {}, 12),
    "scannet_crop_size": (scannet, "scannet", {"crop_size": [36, 52]}, 12),
    "tum": (tum, "tumrgbd", {}, 7),
    "tum_pose_txt": (lambda r: tum(r, pose_name="pose.txt"), "tumrgbd",
                     {}, 7),
    "tum_fr1_distortion": (tum, "tumrgbd", {
        "distortion": FR1_DISTORTION, "fx": 51.73, "fy": 51.65,
        "cx": 31.86, "cy": 25.53}, 7),
}


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("layouts")
    made = {}
    for name, (writer, *_) in VARIANTS.items():
        writer(root / name)
        made[name] = root / name
    return made


def read_both(path, dataset, cam):
    jcfg, tcfg = cfgs(dataset, **cam)
    jds, tds = jget(jcfg, str(path)), TDS.get_dataset(tcfg, str(path))
    return jds, tds


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_wire_bytes_and_poses_equal_to_the_jax_readers(layouts, variant):
    _, dataset, cam, n = VARIANTS[variant]
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        jds, tds = read_both(layouts[variant], dataset, cam)
        assert len(tds) == len(jds) == n
        assert [os.path.basename(p) for p in tds.color_paths] == \
            [os.path.basename(p) for p in jds.color_paths]
        for i in range(n):
            ti, tw, tp = tds.wire(i)
            ji, jw, jp = jds.wire(i)
            assert ti == ji and tw.dtype == jw.dtype == np.uint8
            np.testing.assert_array_equal(tw, jw)
            np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    finally:
        cv2.ipp.setUseIPP(ipp)
    e = jds.crop_edge
    h, w = cam.get("crop_size", (H, W))
    assert tw.shape == (h - 2 * e, w - 2 * e, 5)


# share of colour pixels allowed 1 LSB off under IPP (module docstring)
IPP_SHARE = {"replica_crop_size": 0.02}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_wire_bytes_within_the_stated_tolerance_of_opencv_as_built(
        layouts, variant):
    _, dataset, cam, n = VARIANTS[variant]
    jds, tds = read_both(layouts[variant], dataset, cam)
    for i in range(n):
        _, tw, tp = tds.wire(i)
        _, jw, jp = jds.wire(i)
        np.testing.assert_array_equal(tw[..., 3:], jw[..., 3:])   # depth
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
        diff = np.abs(tw[..., :3].astype(int) - jw[..., :3])
        assert diff.max() <= 1
        assert (diff.max(-1) > 0).mean() <= IPP_SHARE.get(variant, 1e-3)


def test_scannet_sorts_frames_numerically(layouts):
    _, tds = read_both(layouts["scannet_resize"], "scannet", {})
    assert [os.path.basename(p) for p in tds.color_paths] == \
        [f"{i}.jpg" for i in range(12)]


def test_tum_association_drops_the_frame_inside_one_32nd_of_a_second(
        layouts):
    """7 of the 8 rgb entries survive: the one 10 ms after frame 3 is too
    close to it for the 32 fps pick; the first pose is the identity (then
    flipped)."""
    _, tds = read_both(layouts["tum"], "tumrgbd", {})
    rgb = (layouts["tum"] / "rgb.txt").read_text().split("\n")[3:-1]
    listed = [ln.split()[1] for ln in rgb]
    assert len(listed) == 8
    kept = [os.path.relpath(p, layouts["tum"]) for p in tds.color_paths]
    assert kept == listed[:4] + listed[5:]
    np.testing.assert_allclose(tds.poses[0], TDS._flip_yz(np.eye(4)),
                               atol=1e-12)


def test_quaternion_matches_scipy():
    rng = np.random.default_rng(0)
    for q in rng.normal(size=(20, 4)):
        np.testing.assert_allclose(TDS.quat_to_matrix(q),
                                   Rotation.from_quat(q).as_matrix(),
                                   rtol=0, atol=1e-12)
