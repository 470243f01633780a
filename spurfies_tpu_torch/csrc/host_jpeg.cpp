// Sequential and progressive Huffman JPEG decoder, on the host: the port's
// reader of JPEG files (what the JAX package reads through imageio, i.e.
// libjpeg-turbo under Pillow at its defaults, and through cv2.imread).
//
// Scope: SOF0/SOF1 (baseline and extended sequential) and SOF2
// (progressive), 8-bit samples; DQT (8- and 16-bit tables), DHT, DRI and
// RST0-7, byte stuffing; interleaved and non-interleaved scans; 1
// component (grey) or 3 (YCbCr, or RGB under Adobe transform 0 or the
// component ids 'R', 'G', 'B') at any sampling factors whose ratios to the
// largest are integers (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...). A
// progressive scan is checked as jdphuff.c's start_pass_phuff_decoder
// checks it (an error there is an error here; a JWRN_BOGUS_PROGRESSION
// warning decodes as libjpeg decodes it). Anything else is an error with a
// message that names the feature: arithmetic coding (SOF9-11), lossless
// (SOF3), hierarchical (SOF5-7), 12-bit samples, 4 components
// (CMYK/YCCK), fractional sampling ratios, a progressive script that
// leaves one of the first nine AC coefficients unfinished (libjpeg would
// smooth the blocks, jdcoefct.c decompress_smooth_data) and truncated
// data.
//
// Damaged data decode as libjpeg decodes them: a read past a segment's
// data gives zero bits and leaves its later MCUs as they are
// (insufficient_data), a bad Huffman code reads as 0, a wrong restart
// marker resyncs as jpeg_resync_to_restart does, other Ss/Se/Ah/Al in a
// sequential scan are ignored (JWRN_NOT_SEQUENTIAL).
//
// Every stage is libjpeg's integer arithmetic, so the pixels are bit-equal
// to libjpeg-turbo's (whose SIMD paths are bit-exact with its C paths while
// the dequantized coefficients fit in 16 bits; past that, on damaged data
// only, this computes as its C code does):
//   * the four progressive scan decoders of jdphuff.c (DC first and
//     refine, AC first and refine with their EOB runs),
//   * the islow IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2, its
//     DESCALE rounding and the 1024-entry range-limit table) on the
//     quantization table each component latched at its first scan,
//   * the upsampling that jdsample.c's jinit_upsampler picks: fancy h2v1
//     (3/4, 1/4 with +1/+2 bias) and h2v2 (3/4, 1/4 in both directions,
//     +8/+7 bias before >> 4) when the component is more than 2 samples
//     wide, fancy h1v2 (3/4, 1/4 down the column, +1/+2 bias), and
//     replication (int_upsample) for every other integral ratio; edge rows
//     and columns replicated,
//   * the YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16, ONE_HALF, clamp).
// Built by the host compiler through ops/cuda_build.py at first use.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

// zigzag index -> natural (row-major) index; 16 extra entries absorb
// corrupt run lengths as libjpeg's table does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
    bool defined = false;
    uint8_t look_len[1 << kLookBits];
    uint8_t look_val[1 << kLookBits];
    int32_t maxcode[18];
    int32_t valoffset[17];
    uint8_t vals[256];
};

struct Component {
    int id, h, v, tq;
    int dc_table = 0, ac_table = 0;
    int bw = 0, bh = 0;          // blocks stored (the MCU grid's)
    int dw = 0, dh = 0;          // downsampled_width / _height
    std::vector<int16_t> coef;   // bw * bh * 64, natural order
    std::vector<uint8_t> plane;  // (bw * 8) x (bh * 8) samples
    int pred = 0;
    bool q_latched = false;      // jdinput.c latch_quant_tables
    uint16_t q[64];
    int coef_bits[64];           // progressive: Al of each zigzag
                                 // coefficient's last scan, -1 before any
};

// the kinds of scan (jdphuff.c's four decoders, and the sequential one)
enum Scan { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

struct Decoder {
    const uint8_t *d;
    size_t n;
    size_t pos = 0;
    int width = 0, height = 0;
    bool frame = false;
    std::vector<Component> comps;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    int restart_interval = 0;
    bool progressive = false;
    unsigned eobrun = 0;  // blocks left in the current EOB run
    bool jfif = false, adobe = false;
    int adobe_transform = -1;
    int orientation = 1;
    bool eoi = false;
    // entropy reader
    uint64_t buf = 0;
    int cnt = 0;                // bits in buf
    int real = 0;               // of them, bits of the scan's data; the
                                // rest are zeros after its marker
    bool marker_hit = false;
    bool insufficient = false;  // libjpeg's insufficient_data: a read went
                                // past the data (JWRN_HIT_MARKER)
    int next_rst = 0;           // the RSTn expected next
    size_t marker_at = 0;       // where the last marker read begins

    Decoder(const uint8_t *data, size_t size) : d(data), n(size) {}

    [[noreturn]] void truncated() {
        throw JpegError("truncated data (the file ends inside the image)");
    }
    int u8() {
        if (pos >= n) truncated();
        return d[pos++];
    }
    int u16() {
        int hi = u8();
        return (hi << 8) | u8();
    }

    // ---- markers --------------------------------------------------------
    int next_marker() {
        // skip to 0xFF, then over fill bytes; a stuffed 0xFF00 left in
        // the data is skipped too (jdmarker.c next_marker)
        for (;;) {
            int c = u8();
            while (c != 0xFF) c = u8();
            do {
                c = u8();
            } while (c == 0xFF);
            marker_at = pos - 2;
            if (c != 0) return c;
        }
    }

    void parse_headers(bool stop_at_frame_scan) {
        if (n < 2 || d[0] != 0xFF || d[1] != 0xD8)
            throw JpegError("not a JPEG file (no SOI marker)");
        pos = 2;
        for (;;) {
            int m = next_marker();
            if (m == 0xD9) {
                eoi = true;
                return;
            }
            if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn
            if (m == 0x01) continue;               // TEM
            switch (m) {
            case 0xC0:
            case 0xC1:
                read_sof(false);
                break;
            case 0xC2:
                read_sof(true);
                break;
            case 0xC3:
                throw JpegError("lossless JPEG (SOF3) is not supported");
            case 0xC5: case 0xC6: case 0xC7:
                throw JpegError("hierarchical JPEG (SOF5-7) is not "
                                "supported");
            case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE:
            case 0xCF: case 0xCC:
                throw JpegError("arithmetic-coded JPEG is not supported");
            case 0xC4:
                read_dht();
                break;
            case 0xDB:
                read_dqt();
                break;
            case 0xDD:
                if (u16() != 4) throw JpegError("corrupt data: bad DRI");
                restart_interval = u16();
                break;
            case 0xDA:
                if (!frame) throw JpegError("corrupt data: SOS before SOF");
                if (stop_at_frame_scan) return;
                read_sos_and_scan();
                break;
            default:
                read_app_or_skip(m);
            }
        }
    }

    size_t segment(int *len) {
        int L = u16();
        if (L < 2) throw JpegError("corrupt data: bad segment length");
        if (pos + (L - 2) > n) truncated();
        *len = L - 2;
        size_t at = pos;
        pos += L - 2;
        return at;
    }

    void read_app_or_skip(int m) {
        int len;
        size_t at = segment(&len);
        const uint8_t *p = d + at;
        if (m == 0xE0 && len >= 5 && !memcmp(p, "JFIF\0", 5)) jfif = true;
        if (m == 0xEE && len >= 12 && !memcmp(p, "Adobe", 5)) {
            adobe = true;
            adobe_transform = p[11];
        }
        if (m == 0xE1 && len >= 6 && !memcmp(p, "Exif\0\0", 6))
            read_exif(p + 6, len - 6);
    }

    // EXIF orientation (IFD0 tag 0x0112); reported, never applied here
    void read_exif(const uint8_t *t, int len) {
        if (len < 8) return;
        bool le = t[0] == 'I' && t[1] == 'I';
        if (!le && !(t[0] == 'M' && t[1] == 'M')) return;
        auto r16 = [&](int o) -> int {
            return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
        };
        auto r32 = [&](int o) -> uint32_t {
            return le ? (uint32_t)t[o] | ((uint32_t)t[o + 1] << 8) |
                            ((uint32_t)t[o + 2] << 16) |
                            ((uint32_t)t[o + 3] << 24)
                      : ((uint32_t)t[o] << 24) | ((uint32_t)t[o + 1] << 16) |
                            ((uint32_t)t[o + 2] << 8) | (uint32_t)t[o + 3];
        };
        uint32_t ifd = r32(4);
        if (ifd + 2 > (uint32_t)len) return;
        int count = r16(ifd);
        for (int i = 0; i < count; ++i) {
            uint32_t e = ifd + 2 + 12 * i;
            if (e + 12 > (uint32_t)len) return;
            if (r16(e) == 0x0112 && r16(e + 2) == 3) {
                int o = r16(e + 8);
                if (o >= 1 && o <= 8) orientation = o;
                return;
            }
        }
    }

    void read_sof(bool prog) {
        if (frame) throw JpegError("corrupt data: two SOF markers");
        progressive = prog;
        int len;
        size_t at = segment(&len);
        const uint8_t *p = d + at;
        if (len < 6) throw JpegError("corrupt data: short SOF");
        int precision = p[0];
        if (precision == 12)
            throw JpegError("12-bit samples are not supported");
        if (precision != 8)
            throw JpegError("corrupt data: sample precision " +
                            std::to_string(precision));
        height = (p[1] << 8) | p[2];
        width = (p[3] << 8) | p[4];
        int nc = p[5];
        if (height == 0)
            throw JpegError("a height defined by DNL is not supported");
        if (width == 0) throw JpegError("corrupt data: zero width");
        if (nc == 4)
            throw JpegError("CMYK/YCCK (4 components) is not supported");
        if (nc != 1 && nc != 3)
            throw JpegError(std::to_string(nc) +
                            " components are not supported");
        if (len < 6 + 3 * nc) throw JpegError("corrupt data: short SOF");
        comps.resize(nc);
        for (int i = 0; i < nc; ++i) {
            Component &c = comps[i];
            c.id = p[6 + 3 * i];
            c.h = p[7 + 3 * i] >> 4;
            c.v = p[7 + 3 * i] & 15;
            c.tq = p[8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                throw JpegError("corrupt data: bad component in SOF");
            std::fill(c.coef_bits, c.coef_bits + 64, -1);
        }
        if (nc == 1) comps[0].h = comps[0].v = 1;  // one block an MCU
        hmax = vmax = 1;
        for (auto &c : comps) {
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        // jdsample.c jinit_upsampler: every integral ratio upsamples
        for (auto &c : comps)
            if (hmax % c.h || vmax % c.v)
                throw JpegError(
                    "fractional sampling (a component at " +
                    std::to_string(c.h) + "x" + std::to_string(c.v) +
                    " of " + std::to_string(hmax) + "x" +
                    std::to_string(vmax) + ") is not supported");
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (auto &c : comps) {
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
            c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
        }
        frame = true;
    }

    void read_dqt() {
        int len;
        size_t at = segment(&len);
        const uint8_t *p = d + at, *end = p + len;
        while (p < end) {
            int pq = *p >> 4, tq = *p & 15;
            ++p;
            if (tq > 3 || pq > 1 || end - p < (pq ? 128 : 64))
                throw JpegError("corrupt data: bad DQT");
            for (int k = 0; k < 64; ++k) {
                int q = pq ? (p[2 * k] << 8) | p[2 * k + 1] : p[k];
                qt[tq][kNatural[k]] = (uint16_t)q;
            }
            p += pq ? 128 : 64;
            qt_defined[tq] = true;
        }
    }

    void read_dht() {
        int len;
        size_t at = segment(&len);
        const uint8_t *p = d + at, *end = p + len;
        while (p < end) {
            if (end - p < 17) throw JpegError("corrupt data: bad DHT");
            int tc = *p >> 4, th = *p & 15;
            ++p;
            if (tc > 1 || th > 3) throw JpegError("corrupt data: bad DHT");
            int bits[17] = {0};
            int total = 0;
            for (int l = 1; l <= 16; ++l) total += bits[l] = p[l - 1];
            p += 16;
            if (total > 256 || end - p < total)
                throw JpegError("corrupt data: bad DHT");
            // jdhuff.c's jpeg_make_d_derived_tbl: DC symbols are bit
            // counts, 0..15
            if (tc == 0)
                for (int i = 0; i < total; ++i)
                    if (p[i] > 15)
                        throw JpegError("corrupt data: bad Huffman table");
            Huffman &h = tc ? ac[th] : dc[th];
            memcpy(h.vals, p, total);
            p += total;
            build_huffman(h, bits);
        }
    }

    // Two passes, as jdhuff.c: the codes are checked against their lengths
    // before any lookahead entry is written, so every entry's index is
    // below 1 << kLookBits.
    static void build_huffman(Huffman &h, const int *bits) {
        h.defined = false;
        int code = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
            h.valoffset[l] = k - code;
            code += bits[l];
            k += bits[l];
            h.maxcode[l] = bits[l] ? code - 1 : -1;
            if (code >= (1 << l))
                throw JpegError("corrupt data: bad Huffman table");
            code <<= 1;
        }
        h.maxcode[17] = 0x7FFFFFFF;
        memset(h.look_len, 0, sizeof h.look_len);
        code = 0;
        k = 0;
        for (int l = 1; l <= kLookBits; ++l) {
            int shift = kLookBits - l;
            for (int i = 0; i < bits[l]; ++i, ++k, ++code)
                for (int j = 0; j < (1 << shift); ++j) {
                    h.look_len[(code << shift) | j] = (uint8_t)l;
                    h.look_val[(code << shift) | j] = h.vals[k];
                }
            code <<= 1;
        }
        h.defined = true;
    }

    // ---- entropy-coded data --------------------------------------------
    void fill() {
        while (cnt <= 56) {
            uint32_t byte = 0;
            if (!marker_hit) {
                if (pos >= n) truncated();
                byte = d[pos];
                if (byte == 0xFF) {
                    size_t q = pos + 1;
                    while (q < n && d[q] == 0xFF) ++q;
                    if (q >= n) truncated();
                    if (d[q] == 0x00) {
                        pos = q + 1;
                        real += 8;
                    } else {
                        marker_hit = true;  // zeros from here, as libjpeg
                        byte = 0;
                    }
                } else {
                    ++pos;
                    real += 8;
                }
            }
            buf |= (uint64_t)byte << (56 - cnt);
            cnt += 8;
        }
    }
    // drops k bits; a read past the scan's data sets insufficient, as
    // jdhuff.c jpeg_fill_bit_buffer does when it must stuff zeros
    inline void take(int k) {
        buf <<= k;
        cnt -= k;
        if (k > real) {
            insufficient = true;
            real = 0;
        } else {
            real -= k;
        }
    }
    inline int bits(int k) {
        if (k == 0) return 0;
        if (cnt < k) fill();
        int v = (int)(buf >> (64 - k));
        take(k);
        return v;
    }
    inline int decode(const Huffman &h) {
        if (cnt < 17) fill();
        int look = (int)(buf >> (64 - kLookBits));
        int l = h.look_len[look];
        if (l) {
            take(l);
            return h.look_val[look];
        }
        l = kLookBits + 1;
        int code = (int)(buf >> (64 - l));
        while (code > h.maxcode[l]) {  // maxcode[17] stops it
            ++l;
            code = (int)(buf >> (64 - l));
        }
        take(l);
        if (l > 16) return 0;  // jpeg_huff_decode: JWRN_HUFF_BAD_CODE
        return h.vals[(h.valoffset[l] + code) & 255];
    }
    static inline int extend(int v, int s) {
        return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
    }

    void decode_block(Component &c, int16_t *blk) {
        int s = decode(dc[c.dc_table]);
        int diff = s ? extend(bits(s), s) : 0;
        c.pred = (int)((unsigned)c.pred + (unsigned)diff);  // as jdhuff.c
        blk[0] = (int16_t)c.pred;
        const Huffman &h = ac[c.ac_table];
        for (int k = 1; k < 64; ++k) {
            int rs = decode(h);
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
    }

    // ---- the progressive scans: jdphuff.c's decode_mcu_* ---------------
    static inline int16_t shifted(int v, int al) {
        return (int16_t)(int)((unsigned)v << al);  // LEFT_SHIFT, then JCOEF
    }

    void decode_dc_first(Component &c, int16_t *blk, int al) {
        int s = decode(dc[c.dc_table]);
        int diff = s ? extend(bits(s), s) : 0;
        if ((c.pred >= 0 && diff > INT_MAX - c.pred) ||
            (c.pred < 0 && diff < INT_MIN - c.pred))
            throw JpegError("corrupt data: a DC coefficient out of range");
        c.pred += diff;
        blk[0] = shifted(c.pred, al);
    }

    void decode_ac_first(const Component &c, int16_t *blk, int ss, int se,
                         int al) {
        if (eobrun > 0) {  // a band of zeros
            --eobrun;
            return;
        }
        const Huffman &h = ac[c.ac_table];
        for (int k = ss; k <= se; ++k) {
            int rs = decode(h);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;  // at most 78: kNatural's extra entries
                blk[kNatural[k]] = shifted(extend(bits(s), s), al);
            } else if (r == 15) {
                k += 15;  // ZRL
            } else {      // EOBr: a run of 2^r + r more bits bands
                eobrun = 1u << r;
                if (r) eobrun += bits(r);
                --eobrun;  // this band
                break;
            }
        }
    }

    // decode_mcu_AC_refine: a correction bit for each coefficient already
    // nonzero that the band passes, new coefficients of +-1 << al
    void decode_ac_refine(const Component &c, int16_t *blk, int ss, int se,
                          int al) {
        const int p1 = 1 << al, m1 = -(1 << al);
        auto correct = [&](int16_t &coef) {
            if (bits(1) && (coef & p1) == 0)
                coef = (int16_t)(coef >= 0 ? coef + p1 : coef + m1);
        };
        const Huffman &h = ac[c.ac_table];
        int k = ss;
        if (eobrun == 0) {
            for (; k <= se; ++k) {
                int rs = decode(h);
                int r = rs >> 4, s = rs & 15;
                if (s) {  // a size other than 1 is libjpeg's warning only
                    s = bits(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1u << r;
                    if (r) eobrun += bits(r);
                    break;  // the rest of the block: the EOB run below
                }
                // pass the nonzero coefficients and r zeros, correcting
                do {
                    int16_t &coef = blk[kNatural[k]];
                    if (coef != 0)
                        correct(coef);
                    else if (--r < 0)
                        break;  // the zero that becomes s
                    ++k;
                } while (k <= se);
                if (s) blk[kNatural[k]] = (int16_t)s;  // k <= 64
            }
        }
        if (eobrun > 0) {
            for (; k <= se; ++k)
                if (blk[kNatural[k]] != 0) correct(blk[kNatural[k]]);
            --eobrun;
        }
    }

    // process_restart (jdhuff.c, jdphuff.c) with jdmarker.c's
    // read_restart_marker and jpeg_resync_to_restart: the expected RSTn, or
    // one 3 to 5 ahead of it, is read and the data go on after it; one or
    // two behind is skipped and the next marker looked at; one or two
    // ahead, or a marker that is no RSTn, stays unread and the segment
    // reads as empty
    void restart() {
        buf = 0;
        cnt = 0;
        real = 0;
        auto rst = [&](int ahead) { return 0xD0 + ((next_rst + ahead) & 7); };
        int m = next_marker();
        for (;;) {
            if (m == rst(0) || (m >= 0xD0 && m <= 0xD7 && m != rst(1) &&
                                m != rst(2) && m != rst(7) && m != rst(6))) {
                marker_hit = false;
                insufficient = false;
                break;
            }
            if (m >= 0xC0 && (m < 0xD0 || m > 0xD7 || m == rst(1) ||
                              m == rst(2))) {
                pos = marker_at;
                marker_hit = true;
                break;
            }
            m = next_marker();  // an invalid or an earlier marker
        }
        next_rst = (next_rst + 1) & 7;
        for (auto &c : comps) c.pred = 0;
        eobrun = 0;
    }

    // jdphuff.c start_pass_phuff_decoder's checks of a progressive scan
    // (JERR_BAD_PROGRESSION) and the kind of scan they leave
    Scan scan_kind(int ns, int ss, int se, int ah, int al) const {
        // jdhuff.c only warns about other parameters in a sequential
        // scan (JWRN_NOT_SEQUENTIAL: baseline files with them all zero)
        if (!progressive) return kSequential;
        std::string why;
        if (ss == 0 && se != 0)
            why = "a DC scan with Se != 0";
        else if (ss > se)
            why = "Ss > Se";
        else if (se > 63)
            why = "Se > 63";
        else if (ss != 0 && ns != 1)
            why = "an AC scan of more than one component";
        else if (ah != 0 && al != ah - 1)
            why = "a refinement scan with Al != Ah - 1";
        else if (al > 13)
            why = "Al > 13";
        if (!why.empty())
            throw JpegError(
                "corrupt data: bad progressive scan (Ss=" +
                std::to_string(ss) + " Se=" + std::to_string(se) +
                " Ah=" + std::to_string(ah) + " Al=" + std::to_string(al) +
                "): " + why);
        if (ss == 0) return ah ? kDcRefine : kDcFirst;
        return ah ? kAcRefine : kAcFirst;
    }

    // libjpeg-turbo smooths the blocks (jdcoefct.c smoothing_ok, 10 saved
    // coefficients) when every component's DC is known, its quantizers at
    // the first ten zigzag positions are nonzero, and some component's
    // coefficients 1..9 are unfinished
    bool would_smooth() const {
        bool useful = false;
        for (const auto &c : comps) {
            if (!c.q_latched) return false;
            for (int k = 0; k < 10; ++k)
                if (c.q[kNatural[k]] == 0) return false;
            if (c.coef_bits[0] < 0) return false;
            for (int k = 1; k < 10; ++k) useful |= c.coef_bits[k] != 0;
        }
        return useful;
    }

    void read_sos_and_scan() {
        int len;
        size_t at = segment(&len);
        const uint8_t *p = d + at;
        int ns = len > 0 ? p[0] : 0;
        if (ns < 1 || ns > 4 || len < 4 + 2 * ns)
            throw JpegError("corrupt data: bad SOS");
        int ss = p[1 + 2 * ns], se = p[2 + 2 * ns];
        int ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;
        Scan kind = scan_kind(ns, ss, se, ah, al);
        bool need_dc = kind == kSequential || kind == kDcFirst;
        bool need_ac = kind == kSequential || ss != 0;
        std::vector<Component *> sc;
        int blocks = 0;
        for (int i = 0; i < ns; ++i) {
            int id = p[1 + 2 * i], t = p[2 + 2 * i];
            Component *c = nullptr;
            for (auto &cc : comps)
                if (cc.id == id) c = &cc;
            if (!c) throw JpegError("corrupt data: SOS names no component");
            c->dc_table = t >> 4;
            c->ac_table = t & 15;
            if ((need_dc &&
                 (c->dc_table > 3 || !dc[c->dc_table].defined)) ||
                (need_ac && (c->ac_table > 3 || !ac[c->ac_table].defined)))
                throw JpegError("corrupt data: a Huffman table is missing");
            if (!c->q_latched) {
                if (!qt_defined[c->tq])
                    throw JpegError("corrupt data: a quantization table is "
                                    "missing");
                memcpy(c->q, qt[c->tq], sizeof c->q);
                c->q_latched = true;
            }
            blocks += c->h * c->v;
            sc.push_back(c);
        }
        // jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU
        if (ns > 1 && blocks > 10)
            throw JpegError("corrupt data: more than 10 blocks in an MCU");
        for (auto *c : sc) {
            if (c->coef.empty())
                c->coef.assign((size_t)c->bw * c->bh * 64, 0);
            c->pred = 0;
            for (int k = ss; progressive && k <= se; ++k)
                c->coef_bits[k] = al;
        }
        eobrun = 0;
        buf = 0;
        cnt = 0;
        real = 0;
        marker_hit = false;
        insufficient = false;
        next_rst = 0;
        auto block = [&](Component &c, int16_t *blk) {
            switch (kind) {
            case kSequential:
                decode_block(c, blk);
                break;
            case kDcFirst:
                decode_dc_first(c, blk, al);
                break;
            case kDcRefine:
                if (bits(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
                break;
            case kAcFirst:
                decode_ac_first(c, blk, ss, se, al);
                break;
            case kAcRefine:
                decode_ac_refine(c, blk, ss, se, al);
                break;
            }
        };
        // the restart interval counts MCUs: blocks in a non-interleaved
        // scan
        int64_t done = 0;
        auto maybe_restart = [&]() {
            if (restart_interval && done && done % restart_interval == 0)
                restart();
        };
        // past the data, an MCU is left as it is (a DC refinement reads
        // its zero bits: they change nothing)
        auto live = [&]() { return !insufficient || kind == kDcRefine; };
        if (ns == 1) {  // the component's own blocks (width_in_blocks)
            Component &c = *sc[0];
            int w = (c.dw + 7) / 8, hh = (c.dh + 7) / 8;
            for (int by = 0; by < hh; ++by)
                for (int bx = 0; bx < w; ++bx) {
                    maybe_restart();
                    if (live())
                        block(c, &c.coef[((size_t)by * c.bw + bx) * 64]);
                    ++done;
                }
        } else {  // the MCU grid
            for (int my = 0; my < mcuy; ++my)
                for (int mx = 0; mx < mcux; ++mx) {
                    maybe_restart();
                    if (!live()) {
                        ++done;
                        continue;
                    }
                    for (auto *c : sc)
                        for (int y = 0; y < c->v; ++y)
                            for (int x = 0; x < c->h; ++x) {
                                size_t b = (size_t)(my * c->v + y) * c->bw +
                                           mx * c->h + x;
                                block(*c, &c->coef[b * 64]);
                            }
                    ++done;
                }
        }
        // the main parser goes on at the marker that ended the scan
        buf = 0;
        cnt = 0;
        marker_hit = false;
    }

    // ---- reconstruction ------------------------------------------------
    uint8_t idct_limit[1024];
    void make_idct_limit() {
        // jdmaster.c prepare_range_limit_table, as seen from
        // IDCT_range_limit (index x & 1023 for a value x - 128)
        for (int i = 0; i < 1024; ++i) {
            int v;
            if (i < 128) v = i + 128;
            else if (i < 512) v = 255;
            else if (i < 896) v = 0;
            else v = i - 896;
            idct_limit[i] = (uint8_t)v;
        }
    }

    void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                    int stride) {
        const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                      F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                      F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                      F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
        const int CB = 13, P1 = 2;
        int ws[64];
        for (int c = 0; c < 8; ++c) {
            const int16_t *ip = in + c;
            const uint16_t *qp = q + c;
            int *wp = ws + c;
            if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] &&
                !ip[48] && !ip[56]) {
                int dcval = (int)((int64_t)ip[0] * qp[0]) * (1 << P1);
                for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
                continue;
            }
            int64_t z2 = (int64_t)ip[16] * qp[16];
            int64_t z3 = (int64_t)ip[48] * qp[48];
            int64_t z1 = (z2 + z3) * F0_541;
            int64_t tmp2 = z1 + z3 * -F1_847;
            int64_t tmp3 = z1 + z2 * F0_765;
            z2 = (int64_t)ip[0] * qp[0];
            z3 = (int64_t)ip[32] * qp[32];
            int64_t tmp0 = (z2 + z3) * (1 << CB);
            int64_t tmp1 = (z2 - z3) * (1 << CB);
            int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            tmp0 = (int64_t)ip[56] * qp[56];
            tmp1 = (int64_t)ip[40] * qp[40];
            tmp2 = (int64_t)ip[24] * qp[24];
            tmp3 = (int64_t)ip[8] * qp[8];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            int64_t z4 = tmp1 + tmp3;
            int64_t z5 = (z3 + z4) * F1_175;
            tmp0 *= F0_298;
            tmp1 *= F2_053;
            tmp2 *= F3_072;
            tmp3 *= F1_501;
            z1 *= -F0_899;
            z2 *= -F2_562;
            z3 *= -F1_961;
            z4 *= -F0_390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            const int sh = CB - P1;
            const int64_t rnd = (int64_t)1 << (sh - 1);
            wp[0] = (int)((tmp10 + tmp3 + rnd) >> sh);
            wp[56] = (int)((tmp10 - tmp3 + rnd) >> sh);
            wp[8] = (int)((tmp11 + tmp2 + rnd) >> sh);
            wp[48] = (int)((tmp11 - tmp2 + rnd) >> sh);
            wp[16] = (int)((tmp12 + tmp1 + rnd) >> sh);
            wp[40] = (int)((tmp12 - tmp1 + rnd) >> sh);
            wp[24] = (int)((tmp13 + tmp0 + rnd) >> sh);
            wp[32] = (int)((tmp13 - tmp0 + rnd) >> sh);
        }
        const int sh = CB + P1 + 3;
        const int64_t rnd = (int64_t)1 << (sh - 1);
        for (int r = 0; r < 8; ++r) {
            const int *wp = ws + 8 * r;
            uint8_t *op = out + (size_t)r * stride;
            int64_t z2 = wp[2], z3 = wp[6];
            int64_t z1 = (z2 + z3) * F0_541;
            int64_t tmp2 = z1 + z3 * -F1_847;
            int64_t tmp3 = z1 + z2 * F0_765;
            int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB);
            int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
            int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            tmp0 = wp[7];
            tmp1 = wp[5];
            tmp2 = wp[3];
            tmp3 = wp[1];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            int64_t z4 = tmp1 + tmp3;
            int64_t z5 = (z3 + z4) * F1_175;
            tmp0 *= F0_298;
            tmp1 *= F2_053;
            tmp2 *= F3_072;
            tmp3 *= F1_501;
            z1 *= -F0_899;
            z2 *= -F2_562;
            z3 *= -F1_961;
            z4 *= -F0_390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            // the zero-AC row shortcut of jidctint.c gives the same bits
            op[0] = idct_limit[(int)((tmp10 + tmp3 + rnd) >> sh) & 1023];
            op[7] = idct_limit[(int)((tmp10 - tmp3 + rnd) >> sh) & 1023];
            op[1] = idct_limit[(int)((tmp11 + tmp2 + rnd) >> sh) & 1023];
            op[6] = idct_limit[(int)((tmp11 - tmp2 + rnd) >> sh) & 1023];
            op[2] = idct_limit[(int)((tmp12 + tmp1 + rnd) >> sh) & 1023];
            op[5] = idct_limit[(int)((tmp12 - tmp1 + rnd) >> sh) & 1023];
            op[3] = idct_limit[(int)((tmp13 + tmp0 + rnd) >> sh) & 1023];
            op[4] = idct_limit[(int)((tmp13 - tmp0 + rnd) >> sh) & 1023];
        }
    }

    void reconstruct() {
        make_idct_limit();
        for (auto &c : comps) {
            if (c.coef.empty())
                throw JpegError("corrupt data: a component has no scan");
            int stride = c.bw * 8;
            c.plane.assign((size_t)stride * c.bh * 8, 0);
            const uint16_t *q = c.q;
            for (int by = 0; by < c.bh; ++by)
                for (int bx = 0; bx < c.bw; ++bx)
                    idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], q,
                               &c.plane[(size_t)by * 8 * stride + bx * 8],
                               stride);
            std::vector<int16_t>().swap(c.coef);
        }
    }

    // one output row of component c, upsampled to the image's width
    std::vector<uint8_t> tmp;  // an upsampled row before its crop

    // jdsample.c jinit_upsampler's choice, fancy where it is fancy
    void upsample_row(const Component &c, int y, uint8_t *row) {
        int stride = c.bw * 8;
        int rh = hmax / c.h, rv = vmax / c.v;
        int dw = c.dw;
        int last = dw - 1;
        auto in_row = [&](int i) { return &c.plane[(size_t)i * stride]; };
        if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample, at any width
            int i = y / 2;
            int nb = (y & 1) ? (i + 1 < c.dh ? i + 1 : c.dh - 1)
                             : (i > 0 ? i - 1 : 0);
            int bias = (y & 1) ? 2 : 1;
            const uint8_t *in0 = in_row(i), *in1 = in_row(nb);
            for (int x = 0; x < width; ++x)
                row[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
            return;
        }
        if (rh == 2 && rv <= 2 && dw > 2) {
            tmp.resize(2 * (size_t)dw);
            if (rv == 1) {  // h2v1_fancy_upsample
                const uint8_t *in = in_row(y);
                for (int j = 0; j < dw; ++j) {
                    int l = in[j > 0 ? j - 1 : 0], m = in[j] * 3,
                        r = in[j < last ? j + 1 : last];
                    tmp[2 * j] = (uint8_t)((m + l + 1) >> 2);
                    tmp[2 * j + 1] = (uint8_t)((m + r + 2) >> 2);
                }
            } else {  // h2v2_fancy_upsample
                int i = y / 2;
                int nb = (y & 1) ? (i + 1 < c.dh ? i + 1 : c.dh - 1)
                                 : (i > 0 ? i - 1 : 0);
                const uint8_t *in0 = in_row(i), *in1 = in_row(nb);
                auto colsum = [&](int j) { return in0[j] * 3 + in1[j]; };
                for (int j = 0; j < dw; ++j) {
                    int l = colsum(j > 0 ? j - 1 : 0), m = colsum(j) * 3,
                        r = colsum(j < last ? j + 1 : last);
                    tmp[2 * j] = (uint8_t)((m + l + 8) >> 4);
                    tmp[2 * j + 1] = (uint8_t)((m + r + 7) >> 4);
                }
            }
            memcpy(row, tmp.data(), width);
            return;
        }
        // fullsize_upsample, int_upsample, and h2v1_upsample /
        // h2v2_upsample where a component is at most 2 samples wide:
        // replication
        const uint8_t *in = in_row(y / rv);
        if (rh == 1)
            memcpy(row, in, width);
        else
            for (int x = 0; x < width; ++x) row[x] = in[x / rh];
    }

    bool rgb_space() const {
        if (comps.size() != 3) return false;
        if (jfif) return false;
        if (adobe) return adobe_transform == 0;
        return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
    }

    void write(uint8_t *out) {
        int nc = (int)comps.size();
        if (nc == 1) {
            const Component &c = comps[0];
            for (int y = 0; y < height; ++y)
                memcpy(out + (size_t)y * width,
                       &c.plane[(size_t)y * c.bw * 8], width);
            return;
        }
        // jdcolor.c build_ycc_rgb_table
        const int SB = 16;
        const int64_t HALF = (int64_t)1 << (SB - 1);
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        for (int i = 0; i < 256; ++i) {
            int64_t x = i - 128;
            cr_r[i] = (int)((91881 * x + HALF) >> SB);
            cb_b[i] = (int)((116130 * x + HALF) >> SB);
            cr_g[i] = -46802 * x;
            cb_g[i] = -22554 * x + HALF;
        }
        auto clamp = [](int v) -> uint8_t {
            return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
        };
        bool rgb = rgb_space();
        std::vector<uint8_t> r0(width), r1(width), r2(width);
        for (int y = 0; y < height; ++y) {
            upsample_row(comps[0], y, r0.data());
            upsample_row(comps[1], y, r1.data());
            upsample_row(comps[2], y, r2.data());
            uint8_t *o = out + (size_t)y * width * 3;
            if (rgb) {
                for (int x = 0; x < width; ++x) {
                    o[3 * x] = r0[x];
                    o[3 * x + 1] = r1[x];
                    o[3 * x + 2] = r2[x];
                }
                continue;
            }
            for (int x = 0; x < width; ++x) {
                int yy = r0[x], cb = r1[x], cr = r2[x];
                o[3 * x] = clamp(yy + cr_r[cr]);
                o[3 * x + 1] =
                    clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> SB));
                o[3 * x + 2] = clamp(yy + cb_b[cb]);
            }
        }
    }
};

void set_error(char *err, int errlen, const char *msg) {
    if (err && errlen > 0) snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// info = [height, width, channels, EXIF orientation (1 when absent)] from
// the headers up to the first scan. Returns 0, or 1 with a message in err.
int host_jpeg_info(const uint8_t *data, int64_t n, int32_t *info, char *err,
                   int errlen) {
    try {
        Decoder dec(data, (size_t)n);
        dec.parse_headers(true);
        if (!dec.frame) throw JpegError("corrupt data: no SOF marker");
        info[0] = dec.height;
        info[1] = dec.width;
        info[2] = (int32_t)dec.comps.size();
        info[3] = dec.orientation;
        return 0;
    } catch (const std::exception &e) {
        set_error(err, errlen, e.what());
        return 1;
    }
}

// Decode into out (height * width * channels bytes, row-major, RGB or
// grey). Returns 0, or 1 with a message in err.
int host_jpeg_decode(const uint8_t *data, int64_t n, uint8_t *out,
                     int64_t out_size, char *err, int errlen) {
    try {
        Decoder dec(data, (size_t)n);
        dec.parse_headers(false);
        if (!dec.frame) throw JpegError("corrupt data: no SOF marker");
        if (!dec.eoi) dec.truncated();
        if ((int64_t)dec.height * dec.width * (int64_t)dec.comps.size() !=
            out_size)
            throw JpegError("output buffer of the wrong size");
        if (dec.progressive && dec.would_smooth())
            throw JpegError("incomplete progressive script (one of the "
                            "first nine AC coefficients is unfinished: "
                            "libjpeg's block smoothing is not supported)");
        dec.reconstruct();
        dec.write(out);
        return 0;
    } catch (const std::exception &e) {
        set_error(err, errlen, e.what());
        return 1;
    }
}

}  // extern "C"
