// Image decoding for the disk readers: the PNG scanline filters and a
// baseline JPEG decoder, so the port needs no image library on the card's
// host. The JPEG output is byte-equal to libjpeg-turbo's with its default
// settings (what cv2.imread returns): the ISLOW integer IDCT (jidctint.c),
// fancy (triangular) chroma upsampling (jdsample.c h2v1/h2v2, with their
// alternating rounding bias and edge rows/columns replicated as the main
// controller's context rows are), and the fixed-point YCbCr->RGB tables of
// jdcolor.c. Supported: SOF0/SOF1, 8-bit samples, Huffman coding, restart
// markers, grey and YCbCr at 4:4:4, 4:2:2 and 4:2:0, interleaved or
// single-component scans. Anything else is refused with a message, never
// decoded approximately.
//
// Build: g++ -O3 -shared -fPIC imgcodec.cpp (utils/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------ PNG

inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

// ------------------------------------------------------------------ JPEG

// zig-zag index -> natural index, with libjpeg's 16 spare entries so that a
// corrupt run past 63 lands on coefficient 63 instead of outside the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
    bool defined = false;
    uint8_t vals[256];
    int32_t maxcode[18];
    int32_t valoff[17];
    uint16_t lut[1 << 9];   // (length << 8) | value for codes of <= 9 bits
};

struct Comp {
    int id, h, v, tq;
    int td = 0, ta = 0;     // Huffman tables of the current scan
    int bw, bh;             // blocks across / down, padded to whole MCUs
    int dw, dh;             // downsampled width / height in samples
    std::vector<int16_t> coef;
    int pred = 0;
};

struct Decoder {
    const uint8_t* buf;
    size_t n, pos = 0;
    char* err;
    uint16_t qt[4][64];     // natural order
    bool qt_defined[4] = {false, false, false, false};
    Huff dc[4], ac[4];
    std::vector<Comp> comps;
    int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int restart = 0;
    bool frame = false, adobe = false, jfif = false;
    bool header_only = false;   // stop after the frame header
    int adobe_transform = -1;
    // entropy-coded segment reader
    uint64_t acc = 0;
    int nbits = 0;
    bool marker_hit = false;

    bool fail(const char* what) {
        std::snprintf(err, 256, "%s", what);
        return false;
    }

    int byte() { return pos < n ? buf[pos++] : -1; }

    int u16() {
        int a = byte(), b = byte();
        return (a < 0 || b < 0) ? -1 : (a << 8) | b;
    }

    // -------------------------------------------------------- bit reader
    void fill() {
        while (nbits <= 56) {
            int b = 0;
            if (!marker_hit) {
                if (pos >= n) {
                    marker_hit = true;
                } else if (buf[pos] == 0xFF) {
                    if (pos + 1 < n && buf[pos + 1] == 0x00) {
                        b = 0xFF;
                        pos += 2;
                    } else {
                        marker_hit = true;   // stays at the 0xFF
                    }
                } else {
                    b = buf[pos++];
                }
            }
            // past a marker libjpeg feeds zeros
            acc = (acc << 8) | (uint64_t)b;
            nbits += 8;
        }
    }

    inline int bits(int k) {
        if (k == 0) return 0;
        if (nbits < k) fill();
        int v = (int)((acc >> (nbits - k)) & ((1ull << k) - 1));
        nbits -= k;
        return v;
    }

    inline int extend(int v, int s) {
        return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
    }

    bool decode(const Huff& h, int* out) {
        if (nbits < 16) fill();
        int look = (int)((acc >> (nbits - 9)) & 511);
        uint16_t e = h.lut[look];
        if (e) {
            nbits -= e >> 8;
            *out = e & 255;
            return true;
        }
        for (int l = 1; l <= 16; ++l) {
            int code = (int)((acc >> (nbits - l)) & ((1u << l) - 1));
            if (code <= h.maxcode[l]) {
                nbits -= l;
                *out = h.vals[h.valoff[l] + code];
                return true;
            }
        }
        return fail("corrupt Huffman code in the entropy-coded data");
    }

    void reset_reader() {
        acc = 0;
        nbits = 0;
        marker_hit = false;
    }

    // --------------------------------------------------------- segments
    bool read_dqt(int len) {
        size_t end = pos + len - 2;
        while (pos < end) {
            int pq_tq = byte();
            int pq = pq_tq >> 4, tq = pq_tq & 15;
            if (tq > 3 || pq > 1) return fail("bad DQT segment");
            for (int k = 0; k < 64; ++k) {
                int v = pq ? u16() : byte();
                if (v < 0) return fail("truncated DQT segment");
                qt[tq][kNatural[k]] = (uint16_t)v;
            }
            qt_defined[tq] = true;
        }
        return pos == end || fail("bad DQT segment length");
    }

    bool read_dht(int len) {
        size_t end = pos + len - 2;
        while (pos < end) {
            int tc_th = byte();
            int tc = tc_th >> 4, th = tc_th & 15;
            if (tc > 1 || th > 3) return fail("bad DHT segment");
            Huff& h = tc ? ac[th] : dc[th];
            int counts[17] = {0};
            int total = 0;
            for (int l = 1; l <= 16; ++l) {
                counts[l] = byte();
                total += counts[l];
            }
            if (total > 256) return fail("bad DHT segment");
            for (int i = 0; i < total; ++i) h.vals[i] = (uint8_t)byte();
            std::memset(h.lut, 0, sizeof(h.lut));
            int code = 0, k = 0;
            for (int l = 1; l <= 16; ++l) {
                h.valoff[l] = k - code;
                for (int i = 0; i < counts[l]; ++i, ++k, ++code) {
                    if (l <= 9) {
                        int shift = 9 - l;
                        for (int f = 0; f < (1 << shift); ++f)
                            h.lut[(code << shift) | f] =
                                (uint16_t)((l << 8) | h.vals[k]);
                    }
                }
                h.maxcode[l] = counts[l] ? code - 1 : -1;
                if (code > (1 << l)) return fail("bad Huffman table");
                code <<= 1;
            }
            h.maxcode[17] = 0x7FFFFFFF;
            h.defined = true;
        }
        return pos == end || fail("bad DHT segment length");
    }

    bool read_sof(int len) {
        if (frame) return fail("more than one frame");
        int precision = byte();
        if (precision != 8)
            return fail("not an 8-bit JPEG (12-bit and 16-bit samples are "
                        "not supported)");
        height = u16();
        width = u16();
        int nf = byte();
        if (height <= 0)
            return fail("image height 0 (DNL) is not supported");
        if (width <= 0 || (nf != 1 && nf != 3) || len != 8 + 3 * nf)
            return fail("not a grey or three-component JPEG");
        comps.resize(nf);
        for (int i = 0; i < nf; ++i) {
            Comp& c = comps[i];
            c.id = byte();
            int hv = byte();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = byte();
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                return fail("bad SOF component");
            hmax = c.h > hmax ? c.h : hmax;
            vmax = c.v > vmax ? c.v : vmax;
        }
        for (Comp& c : comps) {
            int hr = hmax / c.h, vr = vmax / c.v;
            bool ok = hmax % c.h == 0 && vmax % c.v == 0 &&
                      ((hr == 1 && vr == 1) || (hr == 2 && vr == 1) ||
                       (hr == 2 && vr == 2));
            if (!ok)
                return fail("chroma subsampling other than 4:4:4, 4:2:2 and "
                            "4:2:0 is not supported");
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (Comp& c : comps) {
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
            c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
        }
        frame = true;
        return true;
    }

    bool decode_block(Comp& c, int16_t* blk) {
        int s;
        if (!decode(dc[c.td], &s)) return false;
        if (s > 11) return fail("corrupt DC coefficient");
        int diff = s ? extend(bits(s), s) : 0;
        c.pred += diff;
        blk[0] = (int16_t)c.pred;
        for (int k = 1; k < 64; ++k) {
            int rs;
            if (!decode(ac[c.ta], &rs)) return false;
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend(bits(s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
        return true;
    }

    // skip the RSTn marker that ends a restart interval
    bool next_restart(int expect) {
        reset_reader();
        while (pos + 1 < n && !(buf[pos] == 0xFF && buf[pos + 1] != 0xFF &&
                                buf[pos + 1] != 0x00))
            ++pos;
        if (pos + 1 >= n || buf[pos + 1] != 0xD0 + expect)
            return fail("missing or out-of-order restart marker");
        pos += 2;
        for (Comp& c : comps) c.pred = 0;
        return true;
    }

    bool read_sos(int len) {
        if (!frame) return fail("scan before the frame header");
        int ns = byte();
        if (ns < 1 || ns > 4 || len != 6 + 2 * ns)
            return fail("bad SOS segment");
        std::vector<Comp*> sc;
        for (int i = 0; i < ns; ++i) {
            int cid = byte(), t = byte();
            Comp* found = nullptr;
            for (Comp& c : comps)
                if (c.id == cid) found = &c;
            if (!found) return fail("scan names an unknown component");
            found->td = t >> 4;
            found->ta = t & 15;
            if (found->td > 3 || found->ta > 3 || !dc[found->td].defined ||
                !ac[found->ta].defined)
                return fail("scan uses an undefined Huffman table");
            sc.push_back(found);
        }
        int ss = byte(), se = byte(), ahal = byte();
        if (ss != 0 || se != 63 || ahal != 0)
            return fail("not a sequential scan");
        for (Comp* c : sc) c->pred = 0;
        reset_reader();
        int next_rst = 0, todo = restart;
        if (ns == 1) {
            Comp& c = *sc[0];
            int bx = (c.dw + 7) / 8, by = (c.dh + 7) / 8;
            for (int y = 0; y < by; ++y)
                for (int x = 0; x < bx; ++x) {
                    if (restart && todo == 0) {
                        if (!next_restart(next_rst)) return false;
                        next_rst = (next_rst + 1) & 7;
                        todo = restart;
                    }
                    int16_t* blk = &c.coef[((size_t)y * c.bw + x) * 64];
                    if (!decode_block(c, blk)) return false;
                    --todo;
                }
        } else {
            for (int my = 0; my < mcuy; ++my)
                for (int mx = 0; mx < mcux; ++mx) {
                    if (restart && todo == 0) {
                        if (!next_restart(next_rst)) return false;
                        next_rst = (next_rst + 1) & 7;
                        todo = restart;
                    }
                    for (Comp* cp : sc) {
                        Comp& c = *cp;
                        for (int v = 0; v < c.v; ++v)
                            for (int h = 0; h < c.h; ++h) {
                                size_t bi = (size_t)(my * c.v + v) * c.bw +
                                            mx * c.h + h;
                                if (!decode_block(c, &c.coef[bi * 64]))
                                    return false;
                            }
                    }
                    --todo;
                }
        }
        // step to the marker that follows the scan
        reset_reader();
        while (pos + 1 < n && !(buf[pos] == 0xFF && buf[pos + 1] != 0x00 &&
                                buf[pos + 1] != 0xFF &&
                                !(buf[pos + 1] >= 0xD0 && buf[pos + 1] <= 0xD7)))
            ++pos;
        return true;
    }

    // ------------------------------------------------------ sample stage
    static inline uint8_t idct_limit(long v) {
        int i = (int)(v & 1023);
        if (i < 128) return (uint8_t)(i + 128);
        if (i < 512) return 255;
        if (i < 896) return 0;
        return (uint8_t)(i - 896);
    }

    // jidctint.c jpeg_idct_islow
    static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                           int stride) {
        const long F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                   F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                   F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
        const int CB = 13, P1 = 2;
        int ws[64];
        for (int c = 0; c < 8; ++c) {
            const int16_t* ip = in + c;
            const uint16_t* qp = q + c;
            int* wp = ws + c;
            if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] &&
                !ip[48] && !ip[56]) {
                int dc = (ip[0] * (int)qp[0]) * (1 << P1);
                for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
                continue;
            }
            long z2 = ip[16] * (long)qp[16], z3 = ip[48] * (long)qp[48];
            long z1 = (z2 + z3) * F0541;
            long tmp2 = z1 + z3 * (-F1847);
            long tmp3 = z1 + z2 * F0765;
            z2 = ip[0] * (long)qp[0];
            z3 = ip[32] * (long)qp[32];
            long tmp0 = (z2 + z3) * (1L << CB);
            long tmp1 = (z2 - z3) * (1L << CB);
            long t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
            long t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
            tmp0 = ip[56] * (long)qp[56];
            tmp1 = ip[40] * (long)qp[40];
            tmp2 = ip[24] * (long)qp[24];
            tmp3 = ip[8] * (long)qp[8];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            long z4 = tmp1 + tmp3;
            long z5 = (z3 + z4) * F1175;
            tmp0 *= F0298;
            tmp1 *= F2053;
            tmp2 *= F3072;
            tmp3 *= F1501;
            z1 *= -F0899;
            z2 *= -F2562;
            z3 *= -F1961;
            z4 *= -F0390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            const int sh = CB - P1;
            const long rnd = 1L << (sh - 1);
            wp[0] = (int)((t10 + tmp3 + rnd) >> sh);
            wp[56] = (int)((t10 - tmp3 + rnd) >> sh);
            wp[8] = (int)((t11 + tmp2 + rnd) >> sh);
            wp[48] = (int)((t11 - tmp2 + rnd) >> sh);
            wp[16] = (int)((t12 + tmp1 + rnd) >> sh);
            wp[40] = (int)((t12 - tmp1 + rnd) >> sh);
            wp[24] = (int)((t13 + tmp0 + rnd) >> sh);
            wp[32] = (int)((t13 - tmp0 + rnd) >> sh);
        }
        const int sh = CB + P1 + 3;
        const long rnd = 1L << (sh - 1);
        for (int r = 0; r < 8; ++r) {
            const int* wp = ws + 8 * r;
            uint8_t* op = out + (size_t)r * stride;
            if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
                !wp[7]) {
                uint8_t dc = idct_limit(((long)wp[0] + (1L << (P1 + 2))) >>
                                        (P1 + 3));
                for (int k = 0; k < 8; ++k) op[k] = dc;
                continue;
            }
            long z2 = wp[2], z3 = wp[6];
            long z1 = (z2 + z3) * F0541;
            long tmp2 = z1 + z3 * (-F1847);
            long tmp3 = z1 + z2 * F0765;
            long tmp0 = ((long)wp[0] + wp[4]) * (1L << CB);
            long tmp1 = ((long)wp[0] - wp[4]) * (1L << CB);
            long t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
            long t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
            tmp0 = wp[7];
            tmp1 = wp[5];
            tmp2 = wp[3];
            tmp3 = wp[1];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            long z4 = tmp1 + tmp3;
            long z5 = (z3 + z4) * F1175;
            tmp0 *= F0298;
            tmp1 *= F2053;
            tmp2 *= F3072;
            tmp3 *= F1501;
            z1 *= -F0899;
            z2 *= -F2562;
            z3 *= -F1961;
            z4 *= -F0390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            op[0] = idct_limit((t10 + tmp3 + rnd) >> sh);
            op[7] = idct_limit((t10 - tmp3 + rnd) >> sh);
            op[1] = idct_limit((t11 + tmp2 + rnd) >> sh);
            op[6] = idct_limit((t11 - tmp2 + rnd) >> sh);
            op[2] = idct_limit((t12 + tmp1 + rnd) >> sh);
            op[5] = idct_limit((t12 - tmp1 + rnd) >> sh);
            op[3] = idct_limit((t13 + tmp0 + rnd) >> sh);
            op[4] = idct_limit((t13 - tmp0 + rnd) >> sh);
        }
    }

    // one component's samples (bw*8 x bh*8) from its coefficients
    std::vector<uint8_t> samples(const Comp& c) {
        int stride = c.bw * 8;
        std::vector<uint8_t> out((size_t)stride * c.bh * 8);
        for (int by = 0; by < c.bh; ++by)
            for (int bx = 0; bx < c.bw; ++bx)
                idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], qt[c.tq],
                           &out[(size_t)by * 8 * stride + bx * 8], stride);
        return out;
    }

    // the component at full size (width x height), fancy upsampled
    std::vector<uint8_t> upsampled(const Comp& c) {
        std::vector<uint8_t> s = samples(c);
        int stride = c.bw * 8;
        int hr = hmax / c.h, vr = vmax / c.v;
        std::vector<uint8_t> out((size_t)width * height);
        std::vector<uint8_t> row((size_t)2 * c.dw + 2);
        for (int y = 0; y < height; ++y) {
            uint8_t* op = &out[(size_t)y * width];
            if (hr == 1) {
                std::memcpy(op, &s[(size_t)y * stride], width);
            } else if (c.dw <= 2) {
                // jdsample.c h2v1_upsample / h2v2_upsample (no fancy
                // upsampling this narrow)
                const uint8_t* ip = &s[(size_t)(y / vr) * stride];
                for (int x = 0; x < width; ++x) op[x] = ip[x >> 1];
            } else if (vr == 1) {
                // jdsample.c h2v1_fancy_upsample
                const uint8_t* ip = &s[(size_t)y * stride];
                int dw = c.dw;
                for (int x = 0; x < dw; ++x) {
                    int v3 = ip[x] * 3;
                    int l = ip[x > 0 ? x - 1 : 0];
                    int r = ip[x + 1 < dw ? x + 1 : dw - 1];
                    row[2 * x] = (uint8_t)((v3 + l + 1) >> 2);
                    row[2 * x + 1] = (uint8_t)((v3 + r + 2) >> 2);
                }
                std::memcpy(op, row.data(), width);
            } else {
                // jdsample.c h2v2_fancy_upsample; the rows above the first
                // and below the last repeat them (jdmainct.c context rows)
                int r0 = y >> 1, dh = c.dh, dw = c.dw;
                int r1 = (y & 1) ? (r0 + 1 < dh ? r0 + 1 : dh - 1)
                                 : (r0 > 0 ? r0 - 1 : 0);
                const uint8_t* p0 = &s[(size_t)r0 * stride];
                const uint8_t* p1 = &s[(size_t)r1 * stride];
                for (int x = 0; x < dw; ++x) {
                    int t = p0[x] * 3 + p1[x];
                    int xl = x > 0 ? x - 1 : 0, xr = x + 1 < dw ? x + 1 : dw - 1;
                    int l = p0[xl] * 3 + p1[xl];
                    int r = p0[xr] * 3 + p1[xr];
                    row[2 * x] = (uint8_t)((t * 3 + l + 8) >> 4);
                    row[2 * x + 1] = (uint8_t)((t * 3 + r + 7) >> 4);
                }
                std::memcpy(op, row.data(), width);
            }
        }
        return out;
    }

    bool parse() {
        if (u16() != 0xFFD8) return fail("not a JPEG file (no SOI marker)");
        for (;;) {
            int b = byte();
            while (b >= 0 && b != 0xFF) b = byte();
            while (b == 0xFF) b = byte();
            if (b < 0) return fail("truncated JPEG (no EOI marker)");
            int m = b;
            if (m == 0xD9) break;
            if (m >= 0xD0 && m <= 0xD7) continue;
            int len = u16();
            if (len < 2 || pos + len - 2 > n)
                return fail("truncated JPEG segment");
            size_t end = pos + len - 2;
            bool ok = true;
            if (m == 0xC0 || m == 0xC1) {
                ok = read_sof(len);
                if (ok && header_only) return true;
            } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
                return fail("progressive JPEG is not supported");
            } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
                return fail("lossless JPEG is not supported");
            } else if (m == 0xC5 || m == 0xC9 || m == 0xCD || m == 0xCC) {
                return fail("arithmetic-coded or hierarchical JPEG is not "
                            "supported");
            } else if (m == 0xC4) {
                ok = read_dht(len);
            } else if (m == 0xDB) {
                ok = read_dqt(len);
            } else if (m == 0xDD) {
                restart = u16();
            } else if (m == 0xDA) {
                if (!read_sos(len)) return false;
                continue;
            } else if (m == 0xDC) {
                return fail("DNL marker is not supported");
            } else if (m == 0xE0) {
                jfif = len >= 7 && !std::memcmp(buf + pos, "JFIF", 4);
            } else if (m == 0xEE) {
                if (len >= 14 && !std::memcmp(buf + pos, "Adobe", 5)) {
                    adobe = true;
                    adobe_transform = buf[pos + 11];
                }
            }
            if (!ok) return false;
            pos = end;
        }
        if (!frame) return fail("JPEG without a frame");
        for (Comp& c : comps)
            if (!qt_defined[c.tq])
                return fail("component uses an undefined quantisation table");
        if (comps.size() == 3) {
            // libjpeg's colour-space guess (jdapimin.c default_decompress_parms)
            bool rgb = false;
            if (jfif) rgb = false;
            else if (adobe) rgb = adobe_transform == 0;
            else rgb = comps[0].id == 'R' && comps[1].id == 'G' &&
                       comps[2].id == 'B';
            if (rgb) return fail("RGB-coded JPEG is not supported");
        }
        return true;
    }

    void to_bgr(uint8_t* out) {
        size_t np = (size_t)width * height;
        if (comps.size() == 1) {
            std::vector<uint8_t> g = upsampled(comps[0]);
            for (size_t i = 0; i < np; ++i)
                out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
            return;
        }
        std::vector<uint8_t> yy = upsampled(comps[0]);
        std::vector<uint8_t> cb = upsampled(comps[1]);
        std::vector<uint8_t> cr = upsampled(comps[2]);
        // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
        const long ONE_HALF = 1L << 15;
        auto fix = [](double x) { return (long)(x * 65536.0 + 0.5); };
        int cr_r[256], cb_b[256];
        long cr_g[256], cb_g[256];
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> 16);
            cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> 16);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
        auto clamp = [](int v) {
            return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
        };
        for (size_t i = 0; i < np; ++i) {
            int y = yy[i], b = cb[i], r = cr[i];
            out[3 * i + 2] = clamp(y + cr_r[r]);
            out[3 * i + 1] = clamp(y + (int)((cb_g[b] + cr_g[r]) >> 16));
            out[3 * i] = clamp(y + cb_b[b]);
        }
    }
};

}  // namespace

extern "C" {

// Undo the PNG scanline filters in place: ``data`` holds ``rows`` scanlines
// of (1 + ``row_bytes``) bytes each (filter type, then the filtered bytes),
// ``bpp`` the bytes of one pixel (at least 1). The unfiltered rows are
// written packed to the front of ``data``. Returns 0, or the 1-based row
// with an unknown filter type.
long png_unfilter(uint8_t* data, long rows, long row_bytes, int bpp) {
    uint8_t* prev = nullptr;
    for (long r = 0; r < rows; ++r) {
        const uint8_t* src = data + r * (row_bytes + 1);
        int ft = src[0];
        ++src;
        uint8_t* dst = data + r * row_bytes;   // behind src: safe in place
        switch (ft) {
        case 0:
            std::memmove(dst, src, row_bytes);
            break;
        case 1:
            for (long i = 0; i < row_bytes; ++i)
                dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
            break;
        case 2:
            for (long i = 0; i < row_bytes; ++i)
                dst[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
            break;
        case 3:
            for (long i = 0; i < row_bytes; ++i) {
                int a = i >= bpp ? dst[i - bpp] : 0, b = prev ? prev[i] : 0;
                dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (long i = 0; i < row_bytes; ++i) {
                int a = i >= bpp ? dst[i - bpp] : 0, b = prev ? prev[i] : 0;
                int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                dst[i] = (uint8_t)(src[i] + paeth(a, b, c));
            }
            break;
        default:
            return r + 1;
        }
        prev = dst;
    }
    return 0;
}

// Decode a baseline JPEG held in ``buf`` (``n`` bytes). ``hw`` receives the
// height, width and number of components. With ``out`` NULL only the
// headers up to the frame are read; otherwise ``out`` (height * width * 3
// bytes) receives the BGR pixels. Returns 0, or -1 with a message in
// ``err`` (256 bytes).
int jpeg_decode(const uint8_t* buf, long n, uint8_t* out, int* hw,
                char* err) {
    Decoder d;
    d.buf = buf;
    d.n = (size_t)n;
    d.err = err;
    d.header_only = out == nullptr;
    err[0] = 0;
    if (!d.parse()) return -1;
    hw[2] = (int)d.comps.size();
    hw[0] = d.height;
    hw[1] = d.width;
    if (out) d.to_bgr(out);
    return 0;
}

}  // extern "C"
