"""The baseline JPEG writer (YCbCr 4:2:0, per-image Huffman tables) of
the benchmark's on-disk sequences, as Replica's renders store their
colour frames; PNGs are written with the program's own
``utils/png.py``.

It runs in plain numpy, with the DCT in torch on the device that holds
the frame, so the benchmark needs no image library. The program's own
reader decodes what it writes.
"""

from __future__ import annotations

import heapq
import struct

import numpy as np
import torch

# --------------------------------------------------------------- JPEG

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])

# ITU T.81 Annex K, tables K.1 and K.2 (natural order)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """The IJG quality scaling of a base table, clamped to 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _dct_matrix(device) -> torch.Tensor:
    k = torch.arange(8, dtype=torch.float64, device=device)
    m = torch.cos((2 * k[None, :] + 1) * k[:, None] * torch.pi / 16)
    c = torch.full((8,), 0.5, dtype=torch.float64, device=device)
    c[0] = 0.5 / np.sqrt(2.0)
    return c[:, None] * m                     # orthonormal DCT-II rows


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """(H,W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3)


def _huffman_lengths(freq: np.ndarray) -> np.ndarray:
    """Code lengths (<= 16, none all ones) of the symbols with freq > 0:
    a Huffman code with one reserved symbol, limited by T.81 Annex K.2's
    adjustment."""
    syms = [int(s) for s in np.nonzero(freq)[0]]
    items = [(int(freq[s]), i, [s]) for i, s in enumerate(syms)]
    items.append((0, len(syms), [256]))                   # the reserved code
    depth = {s: 0 for s in syms + [256]}
    heapq.heapify(items)
    tie = len(items)
    while len(items) > 1:
        f1, _, a = heapq.heappop(items)
        f2, _, b = heapq.heappop(items)
        for s in a + b:
            depth[s] += 1
        heapq.heappush(items, (f1 + f2, tie, a + b))
        tie += 1
    bits = np.zeros(64, np.int64)
    for s, d in depth.items():
        bits[max(d, 1)] += 1
    for i in range(63, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1                                          # drop the reserved
    # the longest codes go to the rarest symbols
    order = sorted(syms, key=lambda s: (-int(freq[s]), s))
    lengths = np.zeros(256, np.int64)
    at = 0
    for n in range(1, 17):
        for s in order[at:at + bits[n]]:
            lengths[s] = n
        at += bits[n]
    return lengths


def _canonical(lengths: np.ndarray):
    """(codes (256,), bits[16], huffval list) of canonical codes."""
    codes = np.zeros(256, np.int64)
    bits, vals = [], []
    code = 0
    for n in range(1, 17):
        syms = [s for s in range(256) if lengths[s] == n]
        syms.sort()
        for s in syms:
            codes[s] = code
            code += 1
            vals.append(s)
        bits.append(len(syms))
        code <<= 1
    return codes, bits, vals


def _size(v: np.ndarray) -> np.ndarray:
    """The JPEG magnitude category (bit length of |v|)."""
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _extra(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v + (1 << size) - 1)


def _elements(zz: np.ndarray, comp: np.ndarray):
    """Entropy-coding elements of blocks in scan order: (block, key,
    table class (0 DC, 1 AC), component, symbol, extra bits, extra len).
    ``zz`` (B, 64) zigzagged quantised coefficients; ``comp`` (B,)."""
    nb = zz.shape[0]
    blk = np.arange(nb)
    # DC differences per component, in scan order
    dc = zz[:, 0]
    diff = np.zeros(nb, np.int64)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        d = dc[sel]
        diff[sel] = d - np.concatenate([[0], d[:-1]])
    dsz = _size(diff)
    el = [(blk, np.zeros(nb, np.int64), np.zeros(nb, np.int64), comp, dsz,
           _extra(diff, dsz), dsz)]
    ac = zz[:, 1:]
    b_i, k_i = np.nonzero(ac)
    k_i = k_i + 1
    v = ac[b_i, k_i - 1]
    prev = np.concatenate([[0], k_i[:-1]])
    first = np.concatenate([[True], b_i[1:] != b_i[:-1]])
    prev = np.where(first, 0, prev)
    run = k_i - prev - 1
    n_zrl = run // 16
    run = run % 16
    asz = _size(v)
    el.append((b_i, k_i * 4 + 3, np.ones_like(b_i), comp[b_i], run * 16 + asz,
               _extra(v, asz), asz))
    # ZRL (0xF0) runs before their coefficient
    zb = np.repeat(b_i, n_zrl)
    zk = np.repeat(k_i, n_zrl)
    zj = np.arange(zb.size) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
    el.append((zb, zk * 4 + zj, np.ones_like(zb), comp[zb],
               np.full(zb.size, 0xF0), np.zeros(zb.size, np.int64),
               np.zeros(zb.size, np.int64)))
    # EOB where the last coefficient is zero
    last = np.zeros(nb, np.int64)
    if b_i.size:
        np.maximum.at(last, b_i, k_i)
    eb = np.nonzero(last < 63)[0]
    el.append((eb, np.full(eb.size, 64 * 4), np.ones_like(eb), comp[eb],
               np.zeros(eb.size, np.int64), np.zeros(eb.size, np.int64),
               np.zeros(eb.size, np.int64)))
    cols = [np.concatenate([e[i] for e in el]) for i in range(7)]
    order = np.lexsort((cols[1], cols[0]))
    return [c[order] for c in cols]


def encode_jpeg(rgb: torch.Tensor, quality: int = 95) -> bytes:
    """Baseline JPEG (SOF0, YCbCr 4:2:0, optimised Huffman tables) of an
    (H,W,3) u8 RGB tensor."""
    dev = rgb.device
    h, w = rgb.shape[:2]
    x = rgb.to(torch.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16

    def pad(p):
        return torch.nn.functional.pad(p[None, None], (0, wp - w, 0, hp - h),
                                       mode="replicate")[0, 0]

    y, cb, cr = pad(y), pad(cb), pad(cr)
    cb = cb.reshape(hp // 2, 2, wp // 2, 2).mean((1, 3))
    cr = cr.reshape(hp // 2, 2, wp // 2, 2).mean((1, 3))
    m = _dct_matrix(dev)
    qs = [quant_table(_Q_LUMA, quality), quant_table(_Q_CHROMA, quality)]
    zz_t = torch.as_tensor(_ZIGZAG, device=dev)

    def coefs(plane, q):
        blk = _blocks(plane - 128.0)
        f = m @ blk @ m.T
        qt = torch.as_tensor(q, dtype=torch.float64, device=dev).reshape(8, 8)
        out = torch.round(f / qt).to(torch.int64)
        return out.reshape(*out.shape[:2], 64)[..., zz_t]

    cy, ccb, ccr = coefs(y, qs[0]), coefs(cb, qs[1]), coefs(cr, qs[1])
    my, mx = hp // 16, wp // 16
    # scan order: per MCU four Y blocks (2x2), then Cb, then Cr
    ymcu = cy.reshape(my, 2, mx, 2, 64).permute(0, 2, 1, 3, 4).reshape(
        my, mx, 4, 64)
    mcu = torch.cat([ymcu, ccb[:, :, None], ccr[:, :, None]], dim=2)
    zz = mcu.reshape(-1, 64).cpu().numpy()
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    blk, _, cls, cmp_, sym, extra, elen = _elements(zz, comp)
    tbl = np.minimum(cmp_, 1)                      # 0 luma, 1 chroma
    huff = {}
    for t in (0, 1):
        for c in (0, 1):
            sel = (tbl == t) & (cls == c)
            freq = np.bincount(sym[sel], minlength=256)
            codes, bits, vals = _canonical(_huffman_lengths(freq))
            huff[(c, t)] = (codes, _huffman_lengths(freq), bits, vals)
    code = np.zeros(sym.size, np.int64)
    clen = np.zeros(sym.size, np.int64)
    for (c, t), (codes, lengths, _, _) in huff.items():
        sel = (tbl == t) & (cls == c)
        code[sel] = codes[sym[sel]]
        clen[sel] = lengths[sym[sel]]
    val = (code << elen) | extra
    n = clen + elen
    v32 = (val << (32 - n)).astype(">u4")
    bitm = np.unpackbits(v32.view(np.uint8).reshape(-1, 4), axis=1)
    stream = bitm[np.arange(32)[None, :] < n[:, None]]
    pad_bits = (-stream.size) % 8
    stream = np.concatenate([stream, np.ones(pad_bits, np.uint8)])
    data = np.packbits(stream)
    ff = np.nonzero(data == 0xFF)[0]
    data = np.insert(data, ff + 1, 0)

    out = [b"\xff\xd8",
           b"\xff\xe0" + struct.pack(">H5sBBBHHBB", 16, b"JFIF\0", 1, 1, 0,
                                     1, 1, 0, 0)]
    for tid, q in enumerate(qs):
        out.append(b"\xff\xdb" + struct.pack(">HB", 67, tid)
                   + bytes(q[_ZIGZAG].astype(np.uint8)))
    out.append(b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, h, w, 3)
               + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for (c, t), (_, _, bits, vals) in sorted(huff.items()):
        body = bytes([c << 4 | t]) + bytes(bits) + bytes(vals)
        out.append(b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body)
    out.append(b"\xff\xda" + struct.pack(">HB", 12, 3)
               + bytes([1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    out.append(data.tobytes())
    out.append(b"\xff\xd9")
    return b"".join(out)
