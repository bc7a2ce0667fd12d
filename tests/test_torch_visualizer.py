"""The in-run visualiser (utils/visualizer.py) against the JAX package's,
on the CPU.

* The firing schedule: the port's Visualizer at the port's hook call sites
  (the real tracking and mapping loops) gives the (idx, it) pairs that the
  JAX package's Visualizer gives at its call sites (its host loops,
  tracker.py:275-287 and mapper.py:921-955, replayed here), over a grid of
  (vis_freq, vis_inside_freq, iters, max_iters_per_launch, vis_inside).
* Whole runs: the tiny room through both PointSLAMs writes panels and
  rendered images under the same names, with vis_inside in both loops and
  without it; a port run with panels ends bit-equal to one without them.
* The panel: its depth tiles equal matplotlib's ``plasma`` at the same
  vmin/vmax in u8, its colour tiles matplotlib's float-to-u8 conversion;
  the PNG writer round-trips through the port's decoder byte for byte.
Tolerance 0 throughout.
"""

import glob
import os

import numpy as np
import pytest
import torch

from point_slam_tpu.slam import PointSLAM as JaxSLAM
from point_slam_tpu.utils.visualizer import Visualizer as JVis
from point_slam_tpu_torch import mapper as TM
from point_slam_tpu_torch import tracker as TT
from point_slam_tpu_torch.models import decoders as TD
from point_slam_tpu_torch.slam import PointSLAM as TorchSLAM
from point_slam_tpu_torch.utils import png, visualizer as TV

from torch_parity import tiny_cfgs


def _recording(cls, tmp_path, freq, inside, vis_inside, fired):
    """A Visualizer of ``cls`` whose vis() records (idx, it) where it
    fires instead of rendering."""
    vis = cls(freq, inside, str(tmp_path / cls.__module__),
              vis_inside=vis_inside)

    def record(idx, it, total, mapper, c2w, depth, color,
               freq_override=False, **_):
        if vis.should_fire(idx, it, total, freq_override):
            fired.append((idx, it))
    vis.vis = record
    return vis


def _jax_schedule(tmp_path, idx, freq, inside, iters, chunk, vis_inside):
    """The JAX package's pairs: the tracker's chunked launches and the
    mapper's launches of ``chunk`` iterations, each firing its hook, and
    the end-of-frame calls."""
    track, mapping = [], []
    tv = _recording(JVis, tmp_path, freq, inside, vis_inside, track)
    mv = _recording(JVis, tmp_path, freq, inside, vis_inside, mapping)
    if vis_inside:
        it = 0                                   # tracker.py:275-287
        while it < iters:
            it = min(it + inside, iters)
            if it < iters and idx % tv.freq == 0:    # slam.py:135-144
                tv.vis(idx, it, iters, None, None, None, None,
                       freq_override=True)
        it = 0                                   # mapper.py:921-955
        while it < iters:
            it_prev, it = it, min(it + chunk, iters)
            if it < iters:
                mv.vis_chunk(idx, it_prev, it, iters, None, None, None, None)
    return (track, mapping) + _end_of_frame(JVis, tmp_path, idx, freq,
                                            inside, iters, vis_inside)


def _end_of_frame(cls, tmp_path, idx, freq, inside, iters, vis_inside):
    """The end-of-frame calls' pairs (slam.py's vis(idx, iters - 1,
    iters)) of a tracking and a mapping visualizer of ``cls``."""
    out = []
    for _ in range(2):
        fired = []
        _recording(cls, tmp_path, freq, inside, vis_inside, fired).vis(
            idx, iters - 1, iters, None, None, None, None)
        out.append(fired)
    return tuple(out)


@pytest.fixture(scope="module")
def tiny_mapper():
    """A port Mapper with frame 0 mapped (few rays) and frame 2's data.
    Every later mapped frame runs exactly mapping.iters iterations: at
    most 150 accepted locations keep int(iters * n / 300) below the
    floor, min_iter_ratio 1.0."""
    from point_slam_tpu_torch.datasets import get_dataset
    _, cfg = tiny_cfgs(4)
    cfg["mapping"].update({"pixels": 64, "pixels_adding": 100,
                           "pixels_based_on_color_grad": 50,
                           "iters_first": 2, "min_iter_ratio": 1.0})
    cfg["tracking"]["pixels"] = 32
    ds = get_dataset(cfg)
    mapper = TM.Mapper(cfg, TD.init_decoders(cfg, 0), len(ds),
                       np.random.default_rng(0), "cpu")
    _, color, depth, c2w = ds[0]
    mapper.map_frame(0, color, depth, c2w, c2w)
    _, color, depth, c2w = ds[2]
    return cfg, mapper, (torch.as_tensor(color), torch.as_tensor(depth), c2w)


GRID = [  # (idx, vis_freq, vis_inside_freq, iters, max_iters_per_launch,
          #  vis_inside)
    (2, 1, 8, 16, 8, True),        # tests/test_slam_e2e.py's setting
    (4, 2, 5, 20, 7, True),        # chunks across the inside multiples
    (3, 1, 3, 10, 4, True),
    (6, 3, 10, 20, 200, True),     # one launch: no chunk boundary
    (5, 5, 4, 12, 5, True),
    (4, 3, 4, 12, 5, True),        # idx % vis_freq != 0: nothing
    (2, 1, 5, 20, 7, False),       # end-of-frame panels only
]


@pytest.mark.parametrize("case", GRID, ids=[str(c) for c in GRID])
def test_firing_schedule_matches_jax(tiny_mapper, tmp_path, case):
    idx, freq, inside, iters, chunk, vis_inside = case
    cfg, mapper, (color, depth, c2w) = tiny_mapper
    want = _jax_schedule(tmp_path, idx, freq, inside, iters, chunk,
                         vis_inside)

    track, mapping = [], []
    tv = _recording(TV.Visualizer, tmp_path, freq, inside, vis_inside,
                    track)
    mv = _recording(TV.Visualizer, tmp_path, freq, inside, vis_inside,
                    mapping)
    tracker = TT.Tracker(cfg, "cpu")
    tracker.iters, tracker.inside_freq = iters, inside
    if vis_inside:           # the hooks PointSLAM installs (slam.py)
        def track_hook(i, it, total, cam):
            if i % tv.freq == 0:
                tv.vis(i, it, total, mapper, None, depth, color,
                       freq_override=True)
        tracker.vis_hook = track_hook
        mapper.vis_hook = lambda i, a, b, n, c: mv.vis_chunk(
            i, a, b, n, mapper, c, depth, color)
    est = np.stack([c2w] * (idx + 1))
    tracker.track_frame(idx, color, depth, c2w, est, mapper,
                        mapper.radius_maps(color)[1])
    mapper.chunk = chunk
    mapper.cfg["mapping"]["iters"] = iters
    try:
        st = mapper.map_frame(idx, color, depth, c2w, c2w)
    finally:
        mapper.vis_hook = None
    assert st["n_iters"] == iters
    got = (track, mapping) + _end_of_frame(TV.Visualizer, tmp_path, idx,
                                           freq, inside, iters, vis_inside)
    assert got == want, (got, want)
    if vis_inside and idx % freq == 0:
        assert track or mapping


def _stems(root):
    return {d: sorted(os.path.splitext(os.path.basename(p))[0]
                      for p in glob.glob(os.path.join(root, d, "*")))
            for d in ("tracking_vis", "mapping_vis", "rendered_image")}


def _vis_cfgs(tmp_path, name, inside):
    """The tiny room over 5 frames (map 0, 2, 4; track 2, 3, 4) with
    panels: vis_inside in both loops (``inside``) or end-of-frame panels
    at vis_freq 1, and save_rendered_image."""
    jcfg, tcfg = tiny_cfgs(5)
    for cfg, sec in ((jcfg, "tpu"), (tcfg, "cuda")):
        cfg["tracking"].update({"iters": 10, "vis_freq": 1,
                                "vis_inside": inside, "vis_inside_freq": 4})
        cfg["mapping"].update({"iters": 8, "iters_first": 12, "vis_freq": 1,
                               "vis_inside": inside, "vis_inside_freq": 3,
                               "save_rendered_image": True})
        cfg[sec]["max_iters_per_launch"] = 5
        cfg["data"]["output"] = str(tmp_path / f"{name}_{sec}")
    return jcfg, tcfg


def _port_run(cfg):
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        slam = TorchSLAM(cfg, device="cpu")
        return slam, slam.run()
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.fixture(scope="module")
def port_off(tmp_path_factory):
    _, cfg = _vis_cfgs(tmp_path_factory.mktemp("off"), "off", False)
    cfg["tracking"]["vis_freq"] = cfg["mapping"]["vis_freq"] = 1000
    return _port_run(cfg)


@pytest.mark.parametrize("inside", [True, False],
                         ids=["vis_inside", "end_of_frame"])
def test_runs_write_the_jax_packages_panels(tmp_path, port_off, inside):
    jcfg, tcfg = _vis_cfgs(tmp_path, "vis", inside)
    JaxSLAM(jcfg).run()
    slam, summary = _port_run(tcfg)
    want = _stems(jcfg["data"]["output"])
    got = _stems(tcfg["data"]["output"])
    assert got == want
    if inside:
        assert want["tracking_vis"] and want["mapping_vis"]
        assert not want["rendered_image"]   # vis_inside: no end panels
    else:
        assert want["tracking_vis"] == ["00003_0009"]
        assert want["rendered_image"] == ["frame_00002", "frame_00004"]
    assert all(p.endswith(".png") for p in glob.glob(
        os.path.join(tcfg["data"]["output"], "*_vis", "*")))
    # panels change nothing in the run
    off_slam, off = port_off
    np.testing.assert_array_equal(summary["estimate_c2w_list"],
                                  off["estimate_c2w_list"])
    assert torch.equal(slam.mapper.cloud.packed, off_slam.mapper.cloud.packed)
    assert slam.timing["log"] > 0


def test_panel_tiles_match_matplotlib():
    mpl = pytest.importorskip("matplotlib")
    from matplotlib.colors import Normalize
    rng = np.random.default_rng(0)
    h, w = 37, 53
    gt = rng.uniform(0.0, 4.0, (h, w)).astype(np.float32)
    gt[rng.uniform(size=(h, w)) < 0.1] = 0
    gt[0, :4] = [gt.max(), 0.0, np.nextafter(gt.max(), 0), 1e-7]
    dep = (gt + rng.normal(0, 0.3, (h, w))).astype(np.float32)
    dep[1, :3] = [-0.5, 1e3, gt.max()]
    gcol = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    col = rng.uniform(-0.2, 1.2, (h, w, 3)).astype(np.float32)
    out = TV.panel(gt, gcol, dep, col)
    assert out.shape == (2 * h, 3 * w, 3) and out.dtype == np.uint8

    vmax = max(float(gt.max()), 1e-3)
    cmap = mpl.colormaps["plasma"]
    depth_res = np.abs(gt - dep)
    depth_res[gt == 0] = 0
    color_res = np.abs(gcol - np.clip(col, 0, 1))
    color_res[gt == 0] = 0
    tiles = [cmap(Normalize(vmin=0, vmax=vmax)(x), bytes=True)[..., :3]
             for x in (gt, dep, depth_res)]
    # imshow's float RGB -> u8 (ScalarMappable.to_rgba(bytes=True))
    tiles += [(np.clip(x, 0, 1) * 255).astype(np.uint8)
              for x in (gcol, col, color_res)]
    for k, tile in enumerate(tiles):
        r, c = divmod(k, 3)
        np.testing.assert_array_equal(
            out[r * h:(r + 1) * h, c * w:(c + 1) * w], tile, err_msg=str(k))
    # the lookup's edges: x == vmax is the last colour, below 0 the first
    edge = TV.plasma_u8(np.array([[0.0, vmax, 2 * vmax, -1.0]], np.float32),
                        vmax)
    np.testing.assert_array_equal(
        edge, cmap(Normalize(0, vmax)(np.array([[0.0, vmax, 2 * vmax, -1.0]],
                                               np.float32)),
                   bytes=True)[..., :3])


@pytest.mark.parametrize("shape,dtype", [((37, 53, 3), np.uint8),
                                         ((48, 64), np.uint16)])
def test_png_writer_round_trips_through_the_ports_decoder(tmp_path, shape,
                                                          dtype):
    from point_slam_tpu_torch.utils import imgcodec
    rng = np.random.default_rng(1)
    img = rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype,
                       endpoint=True)
    for level in (1, 6):
        path = str(tmp_path / f"x{level}.png")
        png.write_png(path, img, level)
        back = imgcodec.imread(path, unchanged=True)
        if img.ndim == 3:
            back = back[..., ::-1]             # the decoder gives BGR
        assert back.dtype == img.dtype
        assert back.tobytes() == img.tobytes()
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.float32))
