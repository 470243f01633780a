// JPEG decoder on the host: the port's reader of JPEG files (what the JAX
// package reads through imageio, i.e. libjpeg-turbo 3.x under Pillow at its
// defaults, and through cv2.imread).
//
// Scope: every JPEG process that libjpeg-turbo decodes at 8 bits:
// SOF0/SOF1 (baseline and extended sequential), SOF2 (progressive) and
// SOF3 (lossless) with Huffman coding, SOF9 (sequential) and SOF10
// (progressive) with arithmetic coding; DQT (8- and 16-bit tables), DHT,
// DAC, DRI and RST0-7, byte stuffing; interleaved and non-interleaved
// scans; 1 component (grey) or 3 (YCbCr, or RGB under Adobe transform 0 or
// the component ids 'R', 'G', 'B'; a lossless file is RGB unless a JFIF or
// an Adobe marker says YCbCr) at any sampling factors whose ratios to the
// largest are integers (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...). A
// progressive scan is checked as jdphuff.c's start_pass_phuff_decoder
// checks it (an error there is an error here; a JWRN_BOGUS_PROGRESSION
// warning decodes as libjpeg decodes it). A Huffman table is built and
// checked when a scan selects it (jdhuff.c jpeg_make_d_derived_tbl), and a
// sequential scan that selects table 0 or 1 with no DHT gets the table of
// the JPEG standard's Annex K.3, as jstdhuff.c gives Motion-JPEG frames.
// Anything else is an error with a message that names the feature:
// lossless arithmetic (SOF11), hierarchical (SOF5-7, SOF13-15), samples of
// other than 8 bits (a lossless file's 2 to 7 are read for cv2, which
// returns them as they are), 4 components (CMYK/YCCK), fractional
// sampling ratios, a lossless file in YCbCr or read as colour from grey
// (libjpeg converts no colour in lossless mode), a lossless restart
// interval that is not whole MCU rows, and truncated data. Read as imageio
// reads it, an arithmetic-coded file is refused where Pillow would hand
// libjpeg its data across a 65536-byte block (see feed).
//
// Damaged data decode as libjpeg decodes them: a read past a segment's
// data gives zero bits and leaves its later MCUs as they are
// (insufficient_data; in a lossless scan, later MCU rows decode as zero
// differences from restarted predictors), a bad Huffman code reads as 0, a
// bad arithmetic code stops the segment (jdarith.c ct == -1), a wrong
// restart marker resyncs as jpeg_resync_to_restart does, other Ss/Se/Ah/Al
// in a sequential scan are ignored (JWRN_NOT_SEQUENTIAL).
//
// Every stage is libjpeg's integer arithmetic, so the pixels are bit-equal
// to libjpeg-turbo's (whose SIMD paths are bit-exact with its C paths while
// the dequantized coefficients fit in 16 bits; past that, on damaged data
// only, this computes as its C code does):
//   * the four progressive scan decoders of jdphuff.c (DC first and
//     refine, AC first and refine with their EOB runs),
//   * the QM decoder of jdarith.c (jaricom.c's state table, the DC and AC
//     statistics bins, the DAC conditioning L, U and Kx with their
//     defaults 0, 1 and 5) for the sequential and the four progressive
//     scans,
//   * lossless (jdlhuff.c, jddiffct.c, jdlossls.c): the seven predictors,
//     the first row and the first column, the predictors restarted after
//     each restart interval, the point transform; no IDCT,
//   * block smoothing (jdcoefct.c decompress_smooth_data as libjpeg-turbo
//     2.1 and later have it: a 5x5 neighbourhood of DC values, ten latched
//     coefficients, the previous scan's coefficient bits past the last
//     good iMCU row) where a progressive script leaves one of the first
//     nine AC coefficients unfinished,
//   * the islow IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2, its
//     DESCALE rounding and the 1024-entry range-limit table) on the
//     quantization table each component latched at its first scan,
//   * the upsampling that jdsample.c's jinit_upsampler picks: fancy h2v1
//     (3/4, 1/4 with +1/+2 bias) and h2v2 (3/4, 1/4 in both directions,
//     +8/+7 bias before >> 4) when the component is more than 2 samples
//     wide, fancy h1v2 (3/4, 1/4 down the column, +1/+2 bias), and
//     replication (int_upsample) for every other integral ratio and for
//     every ratio in a lossless file (its DCT size is 1); edge rows and
//     columns replicated,
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

// the data end before EOI
struct EndOfData : JpegError {
    using JpegError::JpegError;
};

// zigzag index -> natural (row-major) index; 16 extra entries absorb
// corrupt run lengths as libjpeg's table does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jaricom.c jpeg_aritab (ITU-T T.81 Table D.2): Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; the last entry is the fixed
// probability 0.5 of T.851
#define V(qe, lps, mps, sw) \
    (((int32_t)(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

// a DHT table as sent: codes of each length 1..16, then the symbols
struct HuffSpec {
    bool defined = false;
    uint8_t bits[17] = {0};
    uint8_t vals[256] = {0};
};

// Annex K.3 (jstdhuff.c std_huff_tables): DC 0, DC 1, AC 0, AC 1
const uint8_t kStdBits[4][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

HuffSpec std_table(bool dc, int id) {
    HuffSpec s;
    s.defined = true;
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += s.bits[l] = kStdBits[dc ? id : 2 + id][l - 1];
    for (int i = 0; i < total; ++i)
        s.vals[i] = dc ? (uint8_t)i : kStdAcVals[id][i];
    return s;
}

constexpr int kLookBits = 9;

struct Huffman {
    uint8_t look_len[1 << kLookBits];
    uint8_t look_val[1 << kLookBits];
    int32_t maxcode[18];
    int32_t valoffset[17];
    uint8_t vals[256];
};

// jdcoefct.c SAVED_COEFS: the coefficients block smoothing latches
constexpr int kSaved = 10;

struct Component {
    int id, h, v, tq;
    int dc_table = 0, ac_table = 0;
    int bw = 0, bh = 0;          // blocks (samples, lossless) stored: the
                                 // MCU grid's
    int dw = 0, dh = 0;          // downsampled_width / _height
    std::vector<int16_t> coef;   // bw * bh * 64, natural order
    std::vector<uint8_t> plane;  // (bw * unit) x (bh * unit) samples
    int pred = 0;                // last DC (the arithmetic decoder's
                                 // last_dc_val, modulo 2^16)
    int dc_context = 0;          // jdarith.c dc_context
    bool q_latched = false;      // jdinput.c latch_quant_tables
    uint16_t q[64];
    int coef_bits[64];           // progressive: Al of each zigzag
                                 // coefficient's last scan, -1 before any
    int prev_bits[64] = {0};     // coef_bits before this component's last
                                 // scan (libjpeg-turbo's second half of
                                 // cinfo->coef_bits)
    // lossless (jddiffct.c): differences of an iMCU row, and its
    // undifferenced rows (the last one predicts the next row's first)
    std::vector<int32_t> diff, undiff;
    int diff_w = 0;
    bool first_row = true;       // jdlossls.c jpeg_undifference_first_row
};

// the kinds of scan (jdphuff.c's four decoders, and the sequential one)
enum Scan { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

struct Decoder {
    const uint8_t *d;
    size_t n;
    size_t pos = 0;
    int width = 0, height = 0, precision = 8;
    bool frame = false;
    std::vector<Component> comps;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    int unit = 8;                // samples a block edge: 1 in lossless
    uint16_t qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    HuffSpec dc_spec[4], ac_spec[4];
    Huffman dc[4], ac[4];        // built at the scans that select them
    int restart_interval = 0;
    bool progressive = false, arith = false, lossless = false;
    int scan_number = 0;         // jdmarker.c input_scan_number
    // jdinput.c has_multiple_scans false (a sequential first scan of every
    // component) and that scan decoded: libjpeg has every row and reads
    // no more scans (JERR_EOI_EXPECTED); imageio takes the pixels even if
    // the file ends before EOI (Pillow ignores jpeg_finish_decompress's
    // suspension once it has the rows)
    bool single_scan_done = false;
    int last_good = -1;          // jdcoefct.c last_good_iMCU_row
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
    // arithmetic decoder (jdarith.c): DAC conditioning, statistics bins
    uint8_t dac_l[16], dac_u[16], dac_k[16];
    int64_t ar_c = 0, ar_a = 0;
    int ct = -16;
    uint8_t dc_stats[16][64], ac_stats[16][256];
    uint8_t fixed_bin = 113;
    // Pillow feeds libjpeg the file in blocks of this many bytes
    // (ImageFile.MAXBLOCK) and jdarith.c cannot suspend at a block's end
    // (JERR_CANT_SUSPEND): imageio refuses an arithmetic-coded file whose
    // decoder reads a byte at a block boundary. 0: no such limit (cv2
    // reads the file through a stdio source).
    size_t feed = 0;

    Decoder(const uint8_t *data, size_t size) : d(data), n(size) {
        // jdmarker.c get_soi
        std::fill(dac_l, dac_l + 16, 0);
        std::fill(dac_u, dac_u + 16, 1);
        std::fill(dac_k, dac_k + 16, 5);
    }

    [[noreturn]] void truncated() {
        throw EndOfData("truncated data (the file ends inside the image)");
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
        try {
            parse_markers(stop_at_frame_scan);
        } catch (const EndOfData &) {
            if (!single_scan_done) throw;
            eoi = true;
        }
    }

    void parse_markers(bool stop_at_frame_scan) {
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
                read_sof(false, false, false);
                break;
            case 0xC2:
                read_sof(true, false, false);
                break;
            case 0xC3:
                read_sof(false, false, true);
                break;
            case 0xC9:
                read_sof(false, true, false);
                break;
            case 0xCA:
                read_sof(true, true, false);
                break;
            case 0xCB:
                throw JpegError("lossless arithmetic-coded JPEG (SOF11) is "
                                "not supported");
            case 0xC5: case 0xC6: case 0xC7:
                throw JpegError("hierarchical JPEG (SOF5-7) is not "
                                "supported");
            case 0xCD: case 0xCE: case 0xCF:
                throw JpegError("hierarchical arithmetic-coded JPEG "
                                "(SOF13-15) is not supported");
            case 0xC4:
                read_dht();
                break;
            case 0xCC:
                read_dac();
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
            case 0xD8:
                throw JpegError("corrupt data: a second SOI marker");
            case 0xC8:
                throw JpegError("the reserved JPG marker (0xC8) is not "
                                "supported");
            default:
                // APPn, COM and DNL are skipped; libjpeg's read_markers
                // refuses the reserved ones (DHP, EXP, JPGn, RESn)
                if (!(m >= 0xE0 && m <= 0xEF) && m != 0xFE && m != 0xDC) {
                    char hex[8];
                    snprintf(hex, sizeof hex, "0x%02X", m);
                    throw JpegError(std::string("corrupt data: unknown "
                                                "marker ") + hex);
                }
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

    void read_sof(bool prog, bool arithmetic, bool ls) {
        if (frame) throw JpegError("corrupt data: two SOF markers");
        progressive = prog;
        arith = arithmetic;
        lossless = ls;
        unit = ls ? 1 : 8;
        int len;
        size_t at = segment(&len);
        const uint8_t *p = d + at;
        if (len < 6) throw JpegError("corrupt data: short SOF");
        precision = p[0];
        // libjpeg-turbo reads 2- to 8-bit lossless samples through its
        // 8-bit interface (cv2 takes them; Pillow reads 8 bits only)
        if (ls ? precision > 8 && precision <= 16 : precision == 12)
            throw JpegError(std::to_string(precision) +
                            "-bit samples are not supported");
        if (ls ? precision < 2 || precision > 8 : precision != 8)
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
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
                throw JpegError("corrupt data: bad component in SOF");
            std::fill(c.coef_bits, c.coef_bits + 64, -1);
        }
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
        mcux = (width + unit * hmax - 1) / (unit * hmax);
        mcuy = (height + unit * vmax - 1) / (unit * vmax);
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

    // jdmarker.c get_dht: the counts and the symbols only (a later DHT of
    // the same class and id replaces them); the table is built and checked
    // when a scan selects it (build_huffman)
    void read_dht() {
        int len;
        size_t at = segment(&len);
        const uint8_t *p = d + at, *end = p + len;
        while (p < end) {
            if (end - p < 17) throw JpegError("corrupt data: bad DHT");
            int tc = *p >> 4, th = *p & 15;
            ++p;
            if (tc > 1 || th > 3) throw JpegError("corrupt data: bad DHT");
            HuffSpec &s = tc ? ac_spec[th] : dc_spec[th];
            int total = 0;
            s.bits[0] = 0;
            for (int l = 1; l <= 16; ++l) total += s.bits[l] = p[l - 1];
            p += 16;
            if (total > 256 || end - p < total)
                throw JpegError("corrupt data: bad DHT");
            memset(s.vals, 0, sizeof s.vals);
            memcpy(s.vals, p, total);
            p += total;
            s.defined = true;
        }
    }

    // jdmarker.c get_dac: the conditioning of arithmetic tables 0-15
    void read_dac() {
        int len;
        size_t at = segment(&len);
        const uint8_t *p = d + at;
        if (len % 2) throw JpegError("corrupt data: bad DAC");
        for (int i = 0; i < len; i += 2) {
            int index = p[i], val = p[i + 1];
            if (index >= 32) throw JpegError("corrupt data: bad DAC");
            if (index >= 16) {
                dac_k[index - 16] = (uint8_t)val;
            } else {
                dac_l[index] = (uint8_t)(val & 15);
                dac_u[index] = (uint8_t)(val >> 4);
                if (dac_l[index] > dac_u[index])
                    throw JpegError("corrupt data: bad DAC");
            }
        }
    }

    // jdhuff.c jpeg_make_d_derived_tbl, for a table a scan selects: a
    // sequential scan's undefined table 0 or 1 is Annex K.3's (std_tables:
    // jdhuff.c's jinit_huff_decoder fills them in; the progressive and
    // lossless decoders do not). Two passes: the codes are checked against
    // their lengths before any lookahead entry is written, so every
    // entry's index is below 1 << kLookBits.
    void build_huffman(bool is_dc, int id, bool std_tables) {
        if (id > 3) throw JpegError("corrupt data: a Huffman table is missing");
        HuffSpec spec = is_dc ? dc_spec[id] : ac_spec[id];
        if (!spec.defined) {
            if (!std_tables || id > 1)
                throw JpegError("corrupt data: a Huffman table is missing");
            spec = std_table(is_dc, id);
        }
        Huffman &h = is_dc ? dc[id] : ac[id];
        const uint8_t *bits = spec.bits;
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
        // DC symbols are bit counts: 0..15, and 16 (a difference of 32768)
        // in a lossless scan
        if (is_dc)
            for (int i = 0; i < k; ++i)
                if (spec.vals[i] > (lossless ? 16 : 15))
                    throw JpegError("corrupt data: bad Huffman table");
        memcpy(h.vals, spec.vals, sizeof h.vals);
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

    // ---- arithmetic decoding: jdarith.c --------------------------------
    // the arithmetic decoder reads the bytes [from, to) of the file
    void fetched(size_t from, size_t to) const {
        if (!feed || to <= from) return;
        size_t k = std::max<size_t>(1, (from + feed - 1) / feed);
        if (k * feed < to)
            throw JpegError(
                "arithmetic-coded data across a " + std::to_string(feed) +
                "-byte block (imageio's Pillow feeds libjpeg the file in "
                "blocks of that size, and libjpeg's arithmetic decoder "
                "cannot wait for the next one)");
    }

    // arith_decode: one binary decision in statistics bin *st. A marker
    // stops the reads (pos stays on it) and zeros follow, as libjpeg feeds
    // them (hitting a marker is legal in arithmetic coding).
    int arith_decode(uint8_t *st) {
        while (ar_a < 0x8000) {
            if (--ct < 0) {
                int data = 0;
                if (!marker_hit) {
                    if (pos >= n) truncated();
                    data = d[pos];
                    if (data == 0xFF) {
                        size_t q = pos + 1;
                        while (q < n && d[q] == 0xFF) ++q;
                        if (q >= n) truncated();
                        fetched(pos, q + 1);
                        if (d[q] == 0) {
                            pos = q + 1;  // a stuffed zero: the 0xFF
                        } else {
                            marker_hit = true;
                            data = 0;
                        }
                    } else {
                        fetched(pos, pos + 1);
                        ++pos;
                    }
                }
                ar_c = (ar_c << 8) | data;
                if ((ct += 8) < 0)
                    if (++ct == 0) ar_a = 0x8000;  // the 2 initial bytes
            }
            ar_a <<= 1;
        }
        int sv = *st;
        int32_t qe = kAritab[sv & 0x7F];
        uint8_t nl = qe & 0xFF;
        qe >>= 8;
        uint8_t nm = qe & 0xFF;
        qe >>= 8;
        int64_t temp = ar_a - qe;
        ar_a = temp;
        temp <<= ct;
        if (ar_c >= temp) {
            ar_c -= temp;
            if (ar_a < qe) {  // conditional LPS exchange
                ar_a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nm);
            } else {
                ar_a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (ar_a < 0x8000) {  // conditional MPS exchange
            if (ar_a < qe) {
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = (uint8_t)((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }

    // F.1.4.4.1: a DC difference, with its conditioning category. False on
    // a magnitude overflow (JWRN_ARITH_BAD_CODE: ct = -1).
    bool arith_dc(Component &c, int *v_out) {
        int tbl = c.dc_table;
        uint8_t *st = dc_stats[tbl] + c.dc_context;
        if (arith_decode(st) == 0) {
            c.dc_context = 0;
            *v_out = 0;
            return true;
        }
        int sign = arith_decode(st + 1);
        st += 2 + sign;
        int m = arith_decode(st);
        if (m != 0) {
            st = dc_stats[tbl] + 20;  // X1 = 20
            while (arith_decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    ct = -1;
                    return false;
                }
                st += 1;
            }
        }
        if (m < (int)((1L << dac_l[tbl]) >> 1))
            c.dc_context = 0;  // zero diff category
        else if (m > (int)((1L << dac_u[tbl]) >> 1))
            c.dc_context = 12 + sign * 4;  // large diff category
        else
            c.dc_context = 4 + sign * 4;  // small diff category
        int v = m;
        st += 14;
        while (m >>= 1)
            if (arith_decode(st)) v |= m;
        v += 1;
        *v_out = sign ? -v : v;
        return true;
    }

    // Figure F.20's coefficient after the zero run: sign, magnitude
    // category and bits. False on a magnitude overflow.
    bool arith_ac_value(int tbl, uint8_t *st, int k, int *v_out) {
        int sign = arith_decode(&fixed_bin);
        st += 2;
        int m = arith_decode(st);
        if (m != 0 && arith_decode(st)) {
            m <<= 1;
            st = ac_stats[tbl] + (k <= dac_k[tbl] ? 189 : 217);
            while (arith_decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    ct = -1;
                    return false;
                }
                st += 1;
            }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
            if (arith_decode(st)) v |= m;
        v += 1;
        *v_out = sign ? -v : v;
        return true;
    }

    // decode_mcu, for one block; false once the segment is in error
    bool arith_block(Component &c, int16_t *blk) {
        int v;
        if (!arith_dc(c, &v)) return false;
        c.pred = (int)(((unsigned)c.pred + (unsigned)v) & 0xFFFF);
        blk[0] = (int16_t)c.pred;
        int tbl = c.ac_table;
        for (int k = 1; k <= 63; ++k) {
            uint8_t *st = ac_stats[tbl] + 3 * (k - 1);
            if (arith_decode(st)) break;  // EOB
            while (arith_decode(st + 1) == 0) {
                st += 3;
                if (++k > 63) {  // spectral overflow
                    ct = -1;
                    return false;
                }
            }
            if (!arith_ac_value(tbl, st, k, &v)) return false;
            blk[kNatural[k]] = (int16_t)v;
        }
        return true;
    }

    bool arith_dc_first(Component &c, int16_t *blk, int al) {
        int v;
        if (!arith_dc(c, &v)) return false;
        c.pred = (int)(((unsigned)c.pred + (unsigned)v) & 0xFFFF);
        blk[0] = shifted(c.pred, al);
        return true;
    }

    bool arith_ac_first(const Component &c, int16_t *blk, int ss, int se,
                        int al) {
        int tbl = c.ac_table, v;
        for (int k = ss; k <= se; ++k) {
            uint8_t *st = ac_stats[tbl] + 3 * (k - 1);
            if (arith_decode(st)) break;  // EOB
            while (arith_decode(st + 1) == 0) {
                st += 3;
                if (++k > se) {
                    ct = -1;
                    return false;
                }
            }
            if (!arith_ac_value(tbl, st, k, &v)) return false;
            blk[kNatural[k]] = shifted(v, al);
        }
        return true;
    }

    bool arith_ac_refine(const Component &c, int16_t *blk, int ss, int se,
                         int al) {
        int tbl = c.ac_table;
        const int p1 = 1 << al, m1 = -(1 << al);
        int kex = se;  // the previous stage's end of block
        for (; kex > 0; --kex)
            if (blk[kNatural[kex]]) break;
        for (int k = ss; k <= se; ++k) {
            uint8_t *st = ac_stats[tbl] + 3 * (k - 1);
            if (k > kex && arith_decode(st)) break;  // EOB
            for (;;) {
                int16_t &coef = blk[kNatural[k]];
                if (coef) {  // a correction bit
                    if (arith_decode(st + 2))
                        coef = (int16_t)(coef < 0 ? coef + m1 : coef + p1);
                    break;
                }
                if (arith_decode(st + 1)) {  // newly nonzero
                    coef = (int16_t)(arith_decode(&fixed_bin) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > se) {
                    ct = -1;
                    return false;
                }
            }
        }
        return true;
    }

    // jdarith.c start_pass / process_restart: the bins a scan uses start
    // at 0 and C, A, CT start over
    void arith_reset(const std::vector<Component *> &sc, Scan kind) {
        for (auto *c : sc) {
            if (kind == kSequential || kind == kDcFirst) {
                memset(dc_stats[c->dc_table], 0, sizeof dc_stats[0]);
                c->pred = 0;
                c->dc_context = 0;
            }
            if (kind == kSequential || kind == kAcFirst ||
                kind == kAcRefine)
                memset(ac_stats[c->ac_table], 0, sizeof ac_stats[0]);
        }
        ar_c = 0;
        ar_a = 0;
        ct = -16;
    }

    // process_restart (jdhuff.c, jdphuff.c, jdarith.c, jdlhuff.c) with
    // jdmarker.c's read_restart_marker and jpeg_resync_to_restart: the
    // expected RSTn, or one 3 to 5 ahead of it, is read and the data go on
    // after it; one or two behind is skipped and the next marker looked
    // at; one or two ahead, or a marker that is no RSTn, stays unread and
    // the segment reads as empty
    void restart() {
        buf = 0;
        cnt = 0;
        real = 0;
        auto rst = [&](int ahead) { return 0xD0 + ((next_rst + ahead) & 7); };
        const size_t start = pos;
        int m = next_marker();
        size_t far = pos;
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
            far = pos;
        }
        if (arith) fetched(start, far);  // jdarith.c cannot suspend here
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

    // jdcoefct.c smoothing_ok: libjpeg-turbo smooths the blocks when every
    // component's quantizers at the first ten zigzag positions are latched
    // and nonzero, its DC is known, and some component's coefficients 1..9
    // are unfinished. It latches each component's coefficient bits, and
    // the bits before its last scan (-1 after a single scan).
    int latch[4][kSaved], prev_latch[4][kSaved];
    bool would_smooth() {
        bool useful = false;
        for (size_t ci = 0; ci < comps.size(); ++ci) {
            const Component &c = comps[ci];
            if (!c.q_latched) return false;
            for (int k = 0; k < kSaved; ++k)
                if (c.q[kNatural[k]] == 0) return false;
            if (c.coef_bits[0] < 0) return false;
            latch[ci][0] = c.coef_bits[0];
            for (int k = 1; k < kSaved; ++k) {
                prev_latch[ci][k] = scan_number > 1 ? c.prev_bits[k] : -1;
                latch[ci][k] = c.coef_bits[k];
                useful |= c.coef_bits[k] != 0;
            }
        }
        return useful;
    }

    // jdlossls.c start_pass_lossless: the first row of every component
    // starts over
    void restart_predictors() {
        for (auto &c : comps) c.first_row = true;
    }

    void read_sos_and_scan() {
        int len;
        size_t at = segment(&len);
        const uint8_t *p = d + at;
        int ns = len > 0 ? p[0] : 0;
        if (ns < 1 || ns > 4 || len < 4 + 2 * ns)
            throw JpegError("corrupt data: bad SOS");
        if (single_scan_done)
            throw JpegError("corrupt data: a second scan after a complete "
                            "sequential one (libjpeg expects EOI)");
        int ss = p[1 + 2 * ns], se = p[2 + 2 * ns];
        int ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;
        ++scan_number;
        // jdlossls.c start_pass_lossless: Ss the predictor, Pt = Al
        if (lossless &&
            (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision))
            throw JpegError(
                "corrupt data: bad lossless scan (Ss=" + std::to_string(ss) +
                " Se=" + std::to_string(se) + " Ah=" + std::to_string(ah) +
                " Al=" + std::to_string(al) + ")");
        Scan kind = lossless ? kSequential : scan_kind(ns, ss, se, ah, al);
        std::vector<Component *> sc;
        int blocks = 0;
        // jdmarker.c get_sos: the first frame component with the id whose
        // slot (cur_comp_info, indexed by scan position) is still free
        Component *slot[4] = {nullptr, nullptr, nullptr, nullptr};
        for (int i = 0; i < ns; ++i) {
            int id = p[1 + 2 * i], t = p[2 + 2 * i];
            Component *c = nullptr;
            for (size_t ci = 0; !c && ci < comps.size(); ++ci)
                if (comps[ci].id == id && !slot[ci]) c = &comps[ci];
            if (!c) throw JpegError("corrupt data: SOS names no component");
            slot[i] = c;
            c->dc_table = t >> 4;
            c->ac_table = t & 15;
            if (!lossless && !c->q_latched) {
                if (c->tq > 3 || !qt_defined[c->tq])
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
        // jdphuff.c / jdarith.c start_pass: the coefficient bits before
        // and after this scan (jdcoefct.c's block smoothing reads both)
        for (auto *c : sc)
            for (int k = std::min(ss, 1); progressive && k <= std::max(se, 9);
                 ++k)
                c->prev_bits[k] = scan_number > 1 ? c->coef_bits[k] : 0;
        for (auto *c : sc)
            for (int k = ss; progressive && k <= se; ++k)
                c->coef_bits[k] = al;
        // the tables the scan uses, as libjpeg selects them
        if (arith) {
            arith_reset(sc, kind);
        } else {
            for (auto *c : sc) {
                if (kind == kSequential || kind == kDcFirst)
                    build_huffman(true, c->dc_table, !progressive && !lossless);
                if (!lossless && (kind == kSequential || ss != 0))
                    build_huffman(false, c->ac_table, !progressive);
            }
        }
        eobrun = 0;
        buf = 0;
        cnt = 0;
        real = 0;
        marker_hit = false;
        insufficient = false;
        next_rst = 0;
        if (lossless)
            decode_lossless_scan(sc, ss, al);
        else
            decode_dct_scan(sc, kind, ss, se, al);
        single_scan_done = scan_number == 1 && !progressive &&
                           sc.size() == comps.size();
        // the main parser goes on at the marker that ended the scan
        buf = 0;
        cnt = 0;
        marker_hit = false;
    }

    void decode_dct_scan(std::vector<Component *> &sc, Scan kind, int ss,
                         int se, int al) {
        for (auto *c : sc)
            if (c->coef.empty())
                c->coef.assign((size_t)c->bw * c->bh * 64, 0);
        auto block = [&](Component &c, int16_t *blk) -> bool {
            if (arith) {
                switch (kind) {
                case kSequential:
                    return arith_block(c, blk);
                case kDcFirst:
                    return arith_dc_first(c, blk, al);
                case kDcRefine:
                    if (arith_decode(&fixed_bin))
                        blk[0] = (int16_t)(blk[0] | (1 << al));
                    return true;
                case kAcFirst:
                    return arith_ac_first(c, blk, ss, se, al);
                case kAcRefine:
                    return arith_ac_refine(c, blk, ss, se, al);
                }
            }
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
            return true;
        };
        // the restart interval counts MCUs: blocks in a non-interleaved
        // scan
        int64_t done = 0;
        auto maybe_restart = [&]() {
            if (restart_interval && done && done % restart_interval == 0) {
                restart();
                if (arith) arith_reset(sc, kind);
            }
        };
        // past the data, an MCU is left as it is (a DC refinement reads
        // its zero bits: they change nothing); an arithmetic segment in
        // error decodes nothing more (but a DC refinement)
        auto live = [&]() {
            if (arith) return ct != -1 || kind == kDcRefine;
            return !insufficient || kind == kDcRefine;
        };
        // jdcoefct.c consume_data: the iMCU row of the last MCU begun
        // while the data lasted
        auto mark = [&](int row) {
            if (!insufficient) last_good = row;
        };
        if (sc.size() == 1) {  // the component's own blocks (width_in_blocks)
            Component &c = *sc[0];
            int w = (c.dw + 7) / 8, hh = (c.dh + 7) / 8;
            for (int by = 0; by < hh; ++by)
                for (int bx = 0; bx < w; ++bx) {
                    mark(by / c.v);
                    maybe_restart();
                    if (live())
                        block(c, &c.coef[((size_t)by * c.bw + bx) * 64]);
                    ++done;
                }
        } else {  // the MCU grid
            for (int my = 0; my < mcuy; ++my)
                for (int mx = 0; mx < mcux; ++mx) {
                    mark(my);
                    maybe_restart();
                    if (!live()) {
                        ++done;
                        continue;
                    }
                    bool ok = true;
                    for (auto *c : sc)
                        for (int y = 0; ok && y < c->v; ++y)
                            for (int x = 0; ok && x < c->h; ++x) {
                                size_t b = (size_t)(my * c->v + y) * c->bw +
                                           mx * c->h + x;
                                ok = block(*c, &c->coef[b * 64]);
                            }
                    ++done;
                }
        }
    }

    // ---- lossless: jdlhuff.c decode_mcus, jddiffct.c decompress_data,
    // jdlossls.c's undifferencers and scaler -----------------------------
    int lossless_diff(const Component &c) {
        int s = decode(dc[c.dc_table]);
        if (s == 16) return 32768;
        return s ? extend(bits(s), s) : 0;
    }

    // one row: Ra left, Rb above, Rc above-left; modulo 2^16
    static void undifference(int psv, bool first, int initial,
                             const int32_t *diff, const int32_t *prev,
                             int32_t *out, int w) {
        if (first || psv == 1) {  // UNDIFFERENCE_1D
            int ra = (diff[0] + (first ? initial : prev[0])) & 0xFFFF;
            out[0] = ra;
            for (int x = 1; x < w; ++x) out[x] = ra = (diff[x] + ra) & 0xFFFF;
            return;
        }
        int rb = prev[0];  // UNDIFFERENCE_2D
        int ra = (diff[0] + rb) & 0xFFFF;
        out[0] = ra;
        for (int x = 1; x < w; ++x) {
            int rc = rb;
            rb = prev[x];
            int64_t pr;
            switch (psv) {
            case 2: pr = rb; break;
            case 3: pr = rc; break;
            case 4: pr = (int64_t)ra + rb - rc; break;
            case 5: pr = (int64_t)ra + (((int64_t)rb - rc) >> 1); break;
            case 6: pr = (int64_t)rb + (((int64_t)ra - rc) >> 1); break;
            default: pr = ((int64_t)ra + rb) >> 1; break;
            }
            out[x] = ra = (int)((diff[x] + pr) & 0xFFFF);
        }
    }

    void decode_lossless_scan(std::vector<Component *> &sc, int psv, int pt) {
        bool single = sc.size() == 1;
        int per_row = single ? sc[0]->dw : mcux;  // MCUs_per_row
        // jddiffct.c start_input_pass: restarts only at whole MCU rows
        if (restart_interval % per_row)
            throw JpegError(
                "corrupt data: a lossless restart interval of " +
                std::to_string(restart_interval) + " MCUs in rows of " +
                std::to_string(per_row));
        const int rows_per_interval = restart_interval / per_row;
        int rows_to_go = rows_per_interval;
        for (auto *c : sc) {
            c->diff_w = single ? c->dw : mcux * c->h;
            c->diff.assign((size_t)c->v * c->diff_w, 0);
            if (c->undiff.empty()) c->undiff.assign((size_t)c->v * c->dw, 0);
            if (c->plane.empty()) c->plane.assign((size_t)c->bw * c->bh, 0);
        }
        restart_predictors();
        const int initial = 1 << (precision - pt - 1);
        auto last_rows = [](const Component &c) {
            int r = c.dh % c.v;
            return r ? r : c.v;
        };
        for (int r = 0; r < mcuy; ++r) {
            int mcu_rows = single ? (r < mcuy - 1 ? sc[0]->v
                                                  : last_rows(*sc[0]))
                                  : 1;
            for (int y = 0; y < mcu_rows; ++y) {
                if (restart_interval && rows_to_go == 0) {
                    restart();
                    restart_predictors();
                    rows_to_go = rows_per_interval;
                }
                if (insufficient) {  // zeros from restarted predictors
                    for (auto *c : sc) {
                        int y0 = single ? y : 0, y1 = single ? y + 1 : c->v;
                        std::fill(c->diff.begin() + (size_t)y0 * c->diff_w,
                                  c->diff.begin() + (size_t)y1 * c->diff_w, 0);
                    }
                    restart_predictors();
                } else if (single) {
                    Component &c = *sc[0];
                    int32_t *row = &c.diff[(size_t)y * c.diff_w];
                    for (int x = 0; x < per_row; ++x) row[x] = lossless_diff(c);
                } else {
                    for (int mx = 0; mx < mcux; ++mx)
                        for (auto *c : sc)
                            for (int yy = 0; yy < c->v; ++yy)
                                for (int xx = 0; xx < c->h; ++xx)
                                    c->diff[(size_t)yy * c->diff_w +
                                            mx * c->h + xx] =
                                        lossless_diff(*c);
                }
                if (restart_interval) --rows_to_go;
            }
            for (auto *c : sc) {
                int rows = r == mcuy - 1 ? last_rows(*c) : c->v;
                for (int row = 0; row < rows; ++row) {
                    int prev = row ? row - 1 : c->v - 1;
                    int32_t *out = &c->undiff[(size_t)row * c->dw];
                    undifference(psv, c->first_row, initial,
                                 &c->diff[(size_t)row * c->diff_w],
                                 &c->undiff[(size_t)prev * c->dw], out,
                                 c->dw);
                    c->first_row = false;
                    uint8_t *o = &c->plane[(size_t)(r * c->v + row) * c->bw];
                    for (int x = 0; x < c->dw; ++x)
                        o[x] = (uint8_t)(out[x] << pt);
                }
            }
        }
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

    // jdcoefct.c decompress_smooth_data's estimate of one coefficient
    // from num = Q00 x (a kernel on the DC values), rounded and, when the
    // coefficient has Al bits to come, held below 1 << Al
    static int16_t estimate(int64_t num, int64_t q, int al) {
        int pred;
        if (num >= 0) {
            pred = (int)(((q << 7) + num) / (q << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        } else {
            pred = (int)(((q << 7) - num) / (q << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            pred = -pred;
        }
        return (int16_t)pred;
    }

    // decompress_smooth_data for one component: each block's unfinished
    // coefficients among the first ten estimated from the DC values of its
    // 5x5 neighbourhood (edges replicated), then the IDCT. Its block rows
    // and edges follow libjpeg-turbo's bookkeeping by iMCU rows exactly,
    // the last iMCU row's index included.
    void smooth_component(Component &c, int ci, int stride) {
        const int total = mcuy, last_imcu = total - 1;
        const int hib = (c.dh + 7) / 8, wib = (c.dw + 7) / 8;
        const int last_col = wib - 1;
        const uint16_t *qv = c.q;
        const int64_t Q00 = qv[0], Q01 = qv[1], Q10 = qv[8], Q20 = qv[16],
                      Q11 = qv[9], Q02 = qv[2], Q03 = qv[3], Q12 = qv[10],
                      Q21 = qv[17], Q30 = qv[24];
        int16_t ws[64];
        for (int r = 0; r < total; ++r) {
            int block_rows = c.v;
            if (r == last_imcu) {
                block_rows = hib % c.v;
                if (block_rows == 0) block_rows = c.v;
            }
            // past the last good iMCU row, the previous scan's bits
            const int *cb = r > last_good ? prev_latch[ci] : latch[ci];
            bool change_dc = true;
            for (int k = 1; k < kSaved; ++k) change_dc &= cb[k] == -1;
            const int image_rows = block_rows * total;
            for (int br = 0; br < block_rows; ++br) {
                const int ibr = r * block_rows + br;
                const int row = r * c.v + br;
                auto at = [&](int rr) {
                    return &c.coef[(size_t)rr * c.bw * 64];
                };
                const int16_t *cur = at(row);
                const int16_t *prv = ibr > 0 ? at(row - 1) : cur;
                const int16_t *pp = ibr > 1 ? at(row - 2) : prv;
                const int16_t *nxt = ibr < image_rows - 1 ? at(row + 1) : cur;
                const int16_t *nn = ibr < image_rows - 2 ? at(row + 2) : nxt;
                int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10,
                    DC11, DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20,
                    DC21, DC22, DC23, DC24, DC25;
                DC01 = DC02 = DC03 = DC04 = DC05 = pp[0];
                DC06 = DC07 = DC08 = DC09 = DC10 = prv[0];
                DC11 = DC12 = DC13 = DC14 = DC15 = cur[0];
                DC16 = DC17 = DC18 = DC19 = DC20 = nxt[0];
                DC21 = DC22 = DC23 = DC24 = DC25 = nn[0];
                for (int b = 0; b <= last_col; ++b) {
                    const size_t o = (size_t)b * 64;
                    memcpy(ws, cur + o, sizeof ws);
                    if (b == 0 && b < last_col) {
                        DC04 = DC05 = pp[o + 64];
                        DC09 = DC10 = prv[o + 64];
                        DC14 = DC15 = cur[o + 64];
                        DC19 = DC20 = nxt[o + 64];
                        DC24 = DC25 = nn[o + 64];
                    }
                    if (b + 1 < last_col) {
                        DC05 = pp[o + 128];
                        DC10 = prv[o + 128];
                        DC15 = cur[o + 128];
                        DC20 = nxt[o + 128];
                        DC25 = nn[o + 128];
                    }
                    int al;
                    if ((al = cb[1]) != 0 && ws[1] == 0)  // AC01
                        ws[1] = estimate(
                            Q00 * (change_dc
                                       ? (-DC01 - DC02 + DC04 + DC05 -
                                          3 * DC06 + 13 * DC07 - 13 * DC09 +
                                          3 * DC10 - 3 * DC11 + 38 * DC12 -
                                          38 * DC14 + 3 * DC15 - 3 * DC16 +
                                          13 * DC17 - 13 * DC19 + 3 * DC20 -
                                          DC21 - DC22 + DC24 + DC25)
                                       : (-7 * DC11 + 50 * DC12 - 50 * DC14 +
                                          7 * DC15)),
                            Q01, al);
                    if ((al = cb[2]) != 0 && ws[8] == 0)  // AC10
                        ws[8] = estimate(
                            Q00 * (change_dc
                                       ? (-DC01 - 3 * DC02 - 3 * DC03 -
                                          3 * DC04 - DC05 - DC06 + 13 * DC07 +
                                          38 * DC08 + 13 * DC09 - DC10 +
                                          DC16 - 13 * DC17 - 38 * DC18 -
                                          13 * DC19 + DC20 + DC21 +
                                          3 * DC22 + 3 * DC23 + 3 * DC24 +
                                          DC25)
                                       : (-7 * DC03 + 50 * DC08 - 50 * DC18 +
                                          7 * DC23)),
                            Q10, al);
                    if ((al = cb[3]) != 0 && ws[16] == 0)  // AC20
                        ws[16] = estimate(
                            Q00 * (change_dc
                                       ? (DC03 + 2 * DC07 + 7 * DC08 +
                                          2 * DC09 - 5 * DC12 - 14 * DC13 -
                                          5 * DC14 + 2 * DC17 + 7 * DC18 +
                                          2 * DC19 + DC23)
                                       : (-DC03 + 13 * DC08 - 24 * DC13 +
                                          13 * DC18 - DC23)),
                            Q20, al);
                    if ((al = cb[4]) != 0 && ws[9] == 0)  // AC11
                        ws[9] = estimate(
                            Q00 * (change_dc
                                       ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 -
                                          9 * DC17 + 9 * DC19 + DC21 - DC25)
                                       : (DC10 + DC16 - 10 * DC17 +
                                          10 * DC19 - DC02 - DC20 + DC22 -
                                          DC24 + DC04 - DC06 + 10 * DC07 -
                                          10 * DC09)),
                            Q11, al);
                    if ((al = cb[5]) != 0 && ws[2] == 0)  // AC02
                        ws[2] = estimate(
                            Q00 * (change_dc
                                       ? (2 * DC07 - 5 * DC08 + 2 * DC09 +
                                          DC11 + 7 * DC12 - 14 * DC13 +
                                          7 * DC14 + DC15 + 2 * DC17 -
                                          5 * DC18 + 2 * DC19)
                                       : (-DC11 + 13 * DC12 - 24 * DC13 +
                                          13 * DC14 - DC15)),
                            Q02, al);
                    if (change_dc) {
                        if ((al = cb[6]) != 0 && ws[3] == 0)  // AC03
                            ws[3] = estimate(Q00 * (DC07 - DC09 + 2 * DC12 -
                                                    2 * DC14 + DC17 - DC19),
                                             Q03, al);
                        if ((al = cb[7]) != 0 && ws[10] == 0)  // AC12
                            ws[10] = estimate(Q00 * (DC07 - 3 * DC08 + DC09 -
                                                     DC17 + 3 * DC18 - DC19),
                                              Q12, al);
                        if ((al = cb[8]) != 0 && ws[17] == 0)  // AC21
                            ws[17] = estimate(Q00 * (DC07 - DC09 - 3 * DC12 +
                                                     3 * DC14 + DC17 - DC19),
                                              Q21, al);
                        if ((al = cb[9]) != 0 && ws[24] == 0)  // AC30
                            ws[24] = estimate(Q00 * (DC07 + 2 * DC08 + DC09 -
                                                     DC17 - 2 * DC18 - DC19),
                                              Q30, al);
                        // the DC itself, from its neighbourhood (sum 256)
                        ws[0] = estimate(
                            Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 -
                                   6 * DC04 - 2 * DC05 - 6 * DC06 +
                                   6 * DC07 + 42 * DC08 + 6 * DC09 -
                                   6 * DC10 - 8 * DC11 + 42 * DC12 +
                                   152 * DC13 + 42 * DC14 - 8 * DC15 -
                                   6 * DC16 + 6 * DC17 + 42 * DC18 +
                                   6 * DC19 - 6 * DC20 - 2 * DC21 -
                                   6 * DC22 - 8 * DC23 - 6 * DC24 -
                                   2 * DC25),
                            Q00, 0);
                    }
                    idct_islow(ws, qv,
                               &c.plane[(size_t)row * 8 * stride + b * 8],
                               stride);
                    DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                    DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                    DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                    DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                    DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
                }
            }
        }
    }

    void reconstruct() {
        // a lossy component that no scan reached stays zero (libjpeg's
        // pre-zeroed coefficient array): flat 128, whatever its table; a
        // lossless one would read libjpeg's uninitialized sample buffer
        for (auto &c : comps) {
            if (lossless && c.plane.empty())
                throw JpegError("corrupt data: a component has no scan");
            if (!lossless && c.coef.empty()) {
                c.coef.assign((size_t)c.bw * c.bh * 64, 0);
                std::fill(c.q, c.q + 64, 0);
            }
        }
        if (lossless) return;  // the scans wrote the samples
        make_idct_limit();
        bool smooth = progressive && would_smooth();
        for (size_t ci = 0; ci < comps.size(); ++ci) {
            Component &c = comps[ci];
            int stride = c.bw * 8;
            c.plane.assign((size_t)stride * c.bh * 8, 0);
            if (smooth) {
                smooth_component(c, (int)ci, stride);
            } else {
                for (int by = 0; by < c.bh; ++by)
                    for (int bx = 0; bx < c.bw; ++bx)
                        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64],
                                   c.q,
                                   &c.plane[(size_t)by * 8 * stride + bx * 8],
                                   stride);
            }
            std::vector<int16_t>().swap(c.coef);
        }
    }

    // one output row of component c, upsampled to the image's width
    std::vector<uint8_t> tmp;  // an upsampled row before its crop

    // jdsample.c jinit_upsampler's choice, fancy where it is fancy (never
    // in a lossless file: its min_DCT_scaled_size is 1)
    void upsample_row(const Component &c, int y, uint8_t *row) {
        int stride = c.bw * unit;
        int rh = hmax / c.h, rv = vmax / c.v;
        int dw = c.dw;
        int last = dw - 1;
        auto in_row = [&](int i) { return &c.plane[(size_t)i * stride]; };
        if (!lossless && rh == 1 && rv == 2) {  // h1v2_fancy_upsample
            int i = y / 2;
            int nb = (y & 1) ? (i + 1 < c.dh ? i + 1 : c.dh - 1)
                             : (i > 0 ? i - 1 : 0);
            int bias = (y & 1) ? 2 : 1;
            const uint8_t *in0 = in_row(i), *in1 = in_row(nb);
            for (int x = 0; x < width; ++x)
                row[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
            return;
        }
        if (!lossless && rh == 2 && rv <= 2 && dw > 2) {
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

    // jdapimin.c default_decompress_parms; a lossless file without a JFIF
    // or an Adobe marker is RGB whatever its component ids
    bool rgb_space() const {
        if (comps.size() != 3) return false;
        if (jfif) return false;
        if (adobe) return adobe_transform == 0;
        if (lossless) return true;
        return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
    }

    // jdcolor.c jinit_color_deconverter allows no lossy conversion in
    // lossless mode: RGB out of YCbCr, or out of grey (as cv2.imread asks)
    void check_lossless_colour(bool want_colour) const {
        if (!lossless) return;
        if (comps.size() == 3 && !rgb_space())
            throw JpegError("lossless JPEG in YCbCr is not supported "
                            "(libjpeg converts no colour in lossless mode)");
        if (comps.size() == 1 && want_colour)
            throw JpegError("grey lossless JPEG read as colour is not "
                            "supported (libjpeg converts no colour in "
                            "lossless mode)");
    }

    void write(uint8_t *out) {
        int nc = (int)comps.size();
        if (nc == 1) {
            const Component &c = comps[0];
            for (int y = 0; y < height; ++y)
                memcpy(out + (size_t)y * width,
                       &c.plane[(size_t)y * c.bw * unit], width);
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
// grey). as_cv2 0: as imageio reads the file (Pillow feeds it to libjpeg
// in blocks of 65536 bytes); 1: as cv2.imread reads it, in colour (a grey
// file is then repeated by the caller; libjpeg refuses that conversion in
// lossless mode). Returns 0, or 1 with a message in err.
int host_jpeg_decode(const uint8_t *data, int64_t n, uint8_t *out,
                     int64_t out_size, int as_cv2, char *err, int errlen) {
    try {
        Decoder dec(data, (size_t)n);
        dec.feed = as_cv2 ? 0 : 65536;
        dec.parse_headers(false);
        if (!dec.frame) throw JpegError("corrupt data: no SOF marker");
        if (!dec.eoi) dec.truncated();
        // jdinput.c consume_markers: EOI before any scan (JERR_SOF_NO_SOS)
        if (!dec.scan_number) throw JpegError("corrupt data: no SOS marker");
        if ((int64_t)dec.height * dec.width * (int64_t)dec.comps.size() !=
            out_size)
            throw JpegError("output buffer of the wrong size");
        dec.check_lossless_colour(as_cv2 != 0);
        if (!as_cv2 && dec.precision != 8)  // Pillow: "cannot handle"
            throw JpegError(std::to_string(dec.precision) +
                            "-bit samples are not supported (imageio reads "
                            "8-bit JPEG only)");
        dec.reconstruct();
        dec.write(out);
        return 0;
    } catch (const std::exception &e) {
        set_error(err, errlen, e.what());
        return 1;
    }
}

}  // extern "C"
