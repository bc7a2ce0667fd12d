"""The port's image decoding (utils/imgcodec.py, native/imgcodec.cpp)
against OpenCV: byte-equal to cv2.imread on the committed fixtures (their
recorded digests, and cv2 itself) and on freshly written random images at
sizes that are not multiples of 8 or 16; formats outside the supported set
raise with the file's name. Tolerance 0 everywhere."""

import hashlib
import importlib.util
import json
import os

import cv2
import numpy as np
import pytest

from point_slam_tpu_torch.utils import imgcodec

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch")
with open(os.path.join(DATA, "digests.json")) as _f:
    DIGESTS = json.load(_f)["files"]

_spec = importlib.util.spec_from_file_location(
    "make_fixtures", os.path.join(DATA, "make_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)


def _cv2_read(path, unchanged):
    return cv2.imread(path, cv2.IMREAD_UNCHANGED if unchanged
                      else cv2.IMREAD_COLOR)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_decodes_to_cv2_bytes(name):
    rec = DIGESTS[name]
    path = os.path.join(DATA, name)
    got = imgcodec.imread(path, unchanged=rec["unchanged"])
    assert list(got.shape) == rec["shape"] and str(got.dtype) == rec["dtype"]
    assert hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest() \
        == rec["sha256"]
    _same(got, _cv2_read(path, rec["unchanged"]))


def _noisy(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0)
                    for c in range(3)], -1) + rng.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


SIZES = [(37, 51), (17, 9), (100, 131), (3, 5), (1, 1), (8, 16)]
JPEG_CASES = [(s, q, rst) for s in ("420", "422", "444")
              for q in (50, 98) for rst in (0, 3)]


@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("sampling,quality,restart", JPEG_CASES,
                         ids=[f"{s}_q{q}_rst{r}" for s, q, r in JPEG_CASES])
def test_random_jpeg_matches_cv2(tmp_path, h, w, sampling, quality, restart):
    path = str(tmp_path / "a.jpg")
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, fixtures.SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    cv2.imwrite(path, _noisy(h, w, h * w + quality), params)
    _same(imgcodec.imread(path), cv2.imread(path))


@pytest.mark.parametrize("h,w", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_random_grey_jpeg_matches_cv2(tmp_path, h, w):
    path = str(tmp_path / "g.jpg")
    cv2.imwrite(path, _noisy(h, w, 1)[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 90])
    _same(imgcodec.imread(path), cv2.imread(path))
    _same(imgcodec.imread(path, unchanged=True),
          cv2.imread(path, cv2.IMREAD_UNCHANGED))


PNG_KINDS = ["grey8", "rgb", "rgba", "depth16"]


@pytest.mark.parametrize("kind", PNG_KINDS)
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
def test_random_png_matches_cv2(tmp_path, kind, filters):
    rng = np.random.default_rng(len(kind) + sum(filters))
    h, w = 23, 37
    img = {"grey8": lambda: rng.integers(0, 256, (h, w), dtype=np.uint8),
           "rgb": lambda: _noisy(h, w, 2),
           "rgba": lambda: np.dstack([_noisy(h, w, 3), rng.integers(
               0, 256, (h, w), dtype=np.uint8)]),
           "depth16": lambda: rng.integers(0, 65536, (h, w),
                                           dtype=np.uint16)}[kind]()
    path = str(tmp_path / "a.png")
    fixtures.write_png(path, img[..., ::-1] if kind == "rgb" else
                       img[..., [2, 1, 0, 3]] if kind == "rgba" else img,
                       filters=filters, depth=16 if kind == "depth16" else 8)
    for unchanged in (True, False):
        if kind == "depth16" and not unchanged:
            continue
        _same(imgcodec.imread(path, unchanged=unchanged),
              _cv2_read(path, unchanged))


def test_encoder_written_pngs_match_cv2(tmp_path):
    """PNGs written by OpenCV's own encoder (its filter choice)."""
    for i, img in enumerate([_noisy(45, 61, 4),
                             _noisy(45, 61, 5)[..., 0],
                             np.arange(45 * 61, dtype=np.uint16)
                             .reshape(45, 61) * 7]):
        path = str(tmp_path / f"{i}.png")
        cv2.imwrite(path, img)
        for unchanged in (True, False):
            if img.dtype == np.uint16 and not unchanged:
                continue
            _same(imgcodec.imread(path, unchanged=unchanged),
                  _cv2_read(path, unchanged))


def _progressive(path):
    cv2.imwrite(path, _noisy(24, 40, 6), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])


def _adam7(path):
    fixtures.write_png(path, _noisy(16, 16, 7), interlace=1)


def _palette(path):
    fixtures.write_png(path, np.zeros((8, 8), np.uint8), ctype=3,
                       palette=[0, 0, 0, 255, 255, 255])


def _grey_alpha(path):
    fixtures.write_png(path, np.zeros((8, 8, 2), np.uint8), ctype=4)


def _sixteen_bit_colour_read(path):
    fixtures.write_png(path, np.zeros((8, 8), np.uint16), depth=16)
    return False                                # read as IMREAD_COLOR


def _bad_filter(path):
    fixtures.write_png(path, np.zeros((4, 4, 3), np.uint8))
    data = bytearray(open(path, "rb").read())
    import struct
    import zlib
    start = data.index(b"IDAT") + 4
    n = struct.unpack(">I", data[start - 8:start - 4])[0]
    raw = bytearray(zlib.decompress(bytes(data[start:start + n])))
    raw[0] = 9
    body = zlib.compress(bytes(raw))
    data = (data[:start - 8] + struct.pack(">I", len(body)) + b"IDAT" + body
            + struct.pack(">I", zlib.crc32(b"IDAT" + body))
            + data[start + n + 4:])
    open(path, "wb").write(bytes(data))


def _not_an_image(path):
    open(path, "w").write("P3 1 1 255 0 0 0")


REFUSED = {"progressive.jpg": (_progressive, "progressive"),
           "adam7.png": (_adam7, "Adam7"),
           "palette.png": (_palette, "palette"),
           "grey_alpha.png": (_grey_alpha, "colour type 4"),
           "colour16.png": (_sixteen_bit_colour_read, "16-bit"),
           "bad_filter.png": (_bad_filter, "filter type"),
           "image.ppm": (_not_an_image, "neither a PNG nor a JPEG")}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unsupported_formats_raise_with_the_file_name(tmp_path, name):
    make, what = REFUSED[name]
    path = str(tmp_path / name)
    unchanged = make(path) is not False
    with pytest.raises(ValueError, match=what) as err:
        imgcodec.imread(path, unchanged=unchanged)
    assert path in str(err.value)
