"""Read the disk datasets' images as ``cv2.imread`` does, without OpenCV.

``imread(path)`` returns what ``cv2.imread(path)`` (``IMREAD_COLOR``)
returns: (H,W,3) u8 BGR, grey replicated, alpha dropped.
``imread(path, unchanged=True)`` returns what ``IMREAD_UNCHANGED`` returns:
(H,W) u16 for a 16-bit grey PNG, (H,W) u8 for 8-bit grey, BGR or BGRA for
colour. The formats are those the Replica, ScanNet and TUM-RGBD layouts
hold:

- PNG: 8-bit grey, RGB and RGBA, 16-bit grey; non-interlaced. The stream
  is inflated with ``zlib``; the scanline filters are undone by
  ``native/imgcodec.cpp`` (Paeth is serial along a row).
- JPEG: baseline sequential Huffman (SOF0/SOF1), 8-bit, grey or YCbCr at
  4:4:4, 4:2:2 or 4:2:0, with or without restart markers, decoded by
  ``native/imgcodec.cpp`` to libjpeg-turbo's bytes (ISLOW IDCT, fancy
  upsampling). EXIF orientation is not applied.

Anything else (progressive, arithmetic or 12-bit JPEG, interlaced, palette
or other PNG types) raises ``ValueError`` naming the file.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from point_slam_tpu_torch.utils import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG (colour type, bit depth) -> channels
_PNG_TYPES = {(0, 8): 1, (2, 8): 3, (6, 8): 4, (0, 16): 1}


def _lib() -> ctypes.CDLL:
    lib = native.load("imgcodec")
    if not getattr(lib, "_typed", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.png_unfilter.argtypes = [u8p, ctypes.c_long, ctypes.c_long,
                                     ctypes.c_int]
        lib.png_unfilter.restype = ctypes.c_long
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, u8p,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_char_p]
        lib.jpeg_decode.restype = ctypes.c_int
        lib._typed = True
    return lib


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_png(data: bytes, unchanged: bool = False) -> np.ndarray:
    """A PNG's pixels, as ``cv2.imdecode`` gives them (see the module)."""
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype == 3:
        raise ValueError("palette PNG is not supported")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    ch = _PNG_TYPES.get((ctype, depth))
    if ch is None:
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not "
                         "supported")
    if depth == 16 and not unchanged:
        raise ValueError("a 16-bit PNG is read only unchanged")
    row = w * ch * depth // 8
    raw = np.frombuffer(bytearray(zlib.decompress(b"".join(idat))), np.uint8)
    if raw.size < h * (row + 1):
        raise ValueError("PNG image data is shorter than its size")
    raw = raw[:h * (row + 1)].copy()
    bad = _lib().png_unfilter(_u8p(raw), h, row, max(ch * depth // 8, 1))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    px = raw[:h * row]
    if depth == 16:
        return px.view(">u2").astype(np.uint16).reshape(h, w)
    img = px.reshape(h, w, ch)
    if ch == 1:
        return img[..., 0].copy() if unchanged else np.repeat(img, 3, axis=2)
    if ch == 4 and unchanged:
        return np.ascontiguousarray(img[..., [2, 1, 0, 3]])
    return np.ascontiguousarray(img[..., 2::-1])


def decode_jpeg(data: bytes, unchanged: bool = False) -> np.ndarray:
    """A baseline JPEG's pixels as (H,W,3) BGR u8 ((H,W) for a grey one
    read ``unchanged``), byte-equal to libjpeg-turbo's defaults."""
    lib = _lib()
    hw = (ctypes.c_int * 3)()
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_decode(data, len(data), None, hw, err):
        raise ValueError(err.value.decode())
    out = np.empty((hw[0], hw[1], 3), np.uint8)
    if lib.jpeg_decode(data, len(data), _u8p(out), hw, err):
        raise ValueError(err.value.decode())
    return out[..., 0].copy() if unchanged and hw[2] == 1 else out


def imread(path: str, unchanged: bool = False) -> np.ndarray:
    """``cv2.imread(path)`` (or with ``IMREAD_UNCHANGED``) for the PNG and
    JPEG files of the disk layouts; raises ``ValueError`` naming the file
    for anything else, and ``OSError`` when it cannot be read."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(PNG_SIGNATURE):
            return decode_png(data, unchanged)
        if data.startswith(b"\xff\xd8"):
            return decode_jpeg(data, unchanged)
        raise ValueError("neither a PNG nor a JPEG file")
    except (ValueError, zlib.error, struct.error) as e:
        raise ValueError(f"{path}: {e}") from None
