"""The images the benchmark writes against the program's reader."""

import numpy as np
import pytest
import torch

from core import codecs
from point_slam_tpu_torch.utils.imgcodec import imread
from point_slam_tpu_torch.utils.png import encode_png


def test_png_depth_and_colour_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    dep = rng.integers(0, 65536, (37, 53)).astype(np.uint16)
    rgb = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    (tmp_path / "d.png").write_bytes(encode_png(dep, level=1))
    (tmp_path / "c.png").write_bytes(encode_png(rgb, level=1))
    assert (imread(str(tmp_path / "d.png"), unchanged=True) == dep).all()
    assert (imread(str(tmp_path / "c.png"))[..., ::-1] == rgb).all()


@pytest.mark.parametrize("h,w", [(48, 64), (50, 70), (680, 1200)])
def test_jpeg_decodes_close_to_its_source(tmp_path, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([128 + 90 * np.sin(xx / 17.0),
                    128 + 70 * np.cos(yy / 13.0 + xx / 29.0),
                    128 + 60 * np.sin((xx + yy) / 41.0)], -1).astype(np.uint8)
    blob = codecs.encode_jpeg(torch.from_numpy(rgb), 95)
    assert blob[:2] == b"\xff\xd8" and blob[-2:] == b"\xff\xd9"
    (tmp_path / "a.jpg").write_bytes(blob)
    got = imread(str(tmp_path / "a.jpg"))[..., ::-1].astype(int)
    assert got.shape == rgb.shape
    assert np.abs(got - rgb).mean() < 1.5
    assert np.abs(got - rgb).max() <= 12
