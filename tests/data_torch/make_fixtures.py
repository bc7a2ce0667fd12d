"""Write the image-decoder fixtures of tests/test_torch_imgcodec.py and
chip_smoke.py phase F1, and record what cv2.imread returns for each.

    python tests/data_torch/make_fixtures.py      # needs OpenCV (cv2)

Run once where OpenCV is installed; the files and ``digests.json`` (the
SHA-256, shape and dtype of cv2.imread's output, IMREAD_UNCHANGED for the
16-bit PNG and IMREAD_COLOR otherwise) are committed, so the port's
decoders can be held to OpenCV's bytes on a machine without it.

- JPEGs at 48x64 and 37x51 (sizes not multiples of 8 or 16): 4:2:0, 4:2:2
  and 4:4:4 at qualities 50, 90 and 98, grey, and a restart interval;
- one 680x1200 frame of the synthetic room at quality 95 (a Replica
  frame's size);
- 8-bit RGB and RGBA PNGs, and a 16-bit depth PNG whose rows use each of
  the five filter types in turn (written by ``write_png`` below, since
  encoders pick the filters themselves).
"""

import hashlib
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def filter_row(ft, row, prev, bpp):
    """One scanline filtered with PNG filter type ``ft`` (0-4)."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i] if prev is not None else 0
        c = prev[i - bpp] if prev is not None and i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ft]
        out[i] = (x - pred) & 0xFF
    return bytes([ft]) + bytes(out)


def write_png(path, img, filters=(0, 1, 2, 3, 4), ctype=None, depth=8,
              interlace=0, palette=None):
    """A PNG of ``img`` (rows of bytes per ``ctype``) with row r filtered
    by ``filters[r % len(filters)]``; ``interlace`` and ``palette`` only
    set the header fields and the PLTE chunk (for refusal tests)."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ctype is None:
        ctype = {1: 0, 3: 2, 4: 6}[ch]
    if depth == 16:
        img = img.astype(">u2")
    rows = img.reshape(h, -1).view(np.uint8).reshape(h, -1)
    bpp = max(ch * depth // 8, 1)
    raw, prev = b"", None
    for r in range(h):
        row = bytes(rows[r])
        raw += filter_row(filters[r % len(filters)], row, prev, bpp)
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", bytes(palette))
    data += chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def synthetic_frame(h, w, f):
    """The synthetic room's frame 0 at h x w (focal f): (RGB u8, depth m)."""
    sys.path.insert(0, ROOT)
    from point_slam_tpu_torch.config import load_config
    from point_slam_tpu_torch.datasets import Synthetic
    cfg = load_config(os.path.join(ROOT, "configs", "Synthetic",
                                   "room_furnished.yaml"),
                      os.path.join(ROOT, "configs", "point_slam.yaml"))
    cfg["cam"].update({"H": h, "W": w, "fx": f, "fy": f,
                       "cx": (w - 1) / 2, "cy": (h - 1) / 2, "crop_edge": 0})
    _, color, depth, _ = Synthetic(cfg)[0]
    return np.rint(color * 255).astype(np.uint8), depth


def main():
    rng = np.random.default_rng(7)
    files = {}

    def jpeg(name, img, quality, sampling="420", restart=0):
        params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        if img.ndim == 3:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        if restart:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        cv2.imwrite(os.path.join(HERE, name), img, params)
        files[name] = False

    for h, w in ((48, 64), (37, 51)):
        rgb, _ = synthetic_frame(h, w, 0.6 * w)
        noisy = np.clip(rgb + rng.normal(0, 12, rgb.shape), 0, 255) \
            .astype(np.uint8)
        bgr = noisy[..., ::-1]
        for s in SAMPLING:
            for q in (50, 90, 98):
                jpeg(f"jpeg_{h}x{w}_{s}_q{q}.jpg", bgr, q, s)
        jpeg(f"jpeg_{h}x{w}_grey_q90.jpg", bgr[..., 1], 90)
        jpeg(f"jpeg_{h}x{w}_420_q90_rst2.jpg", bgr, 90, "420", restart=2)
    rgb, _ = synthetic_frame(680, 1200, 600.0)
    jpeg("room_680x1200_q95.jpg", rgb[..., ::-1], 95)

    rgb, depth = synthetic_frame(48, 64, 40.0)
    write_png(os.path.join(HERE, "png_48x64_rgb.png"), rgb)
    files["png_48x64_rgb.png"] = False
    alpha = rng.integers(0, 256, rgb.shape[:2], dtype=np.uint8)
    write_png(os.path.join(HERE, "png_48x64_rgba.png"),
              np.dstack([rgb, alpha]))
    files["png_48x64_rgba.png"] = False
    d16 = np.clip(np.rint(depth * 5000.0), 0, 65535).astype(np.uint16)
    d16[rng.uniform(size=d16.shape) < 0.05] = 0
    write_png(os.path.join(HERE, "png_48x64_depth16.png"), d16, depth=16)
    files["png_48x64_depth16.png"] = True

    digests = {}
    for name, unchanged in sorted(files.items()):
        img = cv2.imread(os.path.join(HERE, name),
                         cv2.IMREAD_UNCHANGED if unchanged
                         else cv2.IMREAD_COLOR)
        digests[name] = {
            "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
            .hexdigest(),
            "shape": list(img.shape), "dtype": str(img.dtype),
            "unchanged": unchanged}
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump({"opencv": cv2.__version__, "files": digests}, f,
                  indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(digests)} fixtures, "
          f"{sum(os.path.getsize(os.path.join(HERE, n)) for n in digests)}"
          " bytes")


if __name__ == "__main__":
    main()
