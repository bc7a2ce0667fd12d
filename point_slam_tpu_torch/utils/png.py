"""A minimal PNG writer: 8-bit RGB (H,W,3) or 16-bit grey (H,W) u16, every
row with filter 0 (none), one zlib stream. ``utils/imgcodec.py`` reads
what it writes."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """The PNG file of ``img``: (H,W,3) u8 as RGB, (H,W) u16 as 16-bit
    grey; ``level`` is zlib's."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    if img.dtype == np.uint16 and img.ndim == 2:
        ctype, bits = 0, 16
        rows = img.astype(">u2").view(np.uint8).reshape(h, -1)
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, bits = 2, 8
        rows = img.reshape(h, -1)
    else:
        raise ValueError(f"encode_png: {img.dtype} {img.shape} is neither "
                         f"(H,W,3) u8 nor (H,W) u16")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, level))
