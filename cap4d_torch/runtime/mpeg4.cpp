// MPEG-4 Part 2 video decoder (ISO/IEC 14496-2, rectangular 8-bit 4:2:0
// VOPs of the Simple and Advanced Simple profiles): the port's counterpart
// of the host decode that the JAX package gets from cv2 (ffmpeg) for an
// `mp4v` track, cv2's VideoWriter default. Built into the runtime's
// library with cap4d_runtime.cpp and h264.cpp.
//
// Scope: VOS, VO (video_signal_type), VOL, GOV and user data headers, from
// the DecoderSpecificInfo and in band; I-, P- and B-VOPs; the mcbpc, cbpy,
// TCOEF (escape types 1-3), DC-size and motion VLCs; intra DC prediction
// with the DC scalers and intra_dc_vlc_thr; AC prediction with its
// quantiser rescaling; the zig-zag and both alternate scans; 1MV and 4MV;
// motion-vector prediction with its video-packet rules; unrestricted
// vectors; half- and quarter-sample prediction under vop_rounding_type;
// not-coded macroblocks; dquant and dbquant; H.263 and MPEG quantisation
// (default and loaded matrices, mismatch control); resync markers and video
// packets (with the header extension); vop_coded 0; B-VOPs in all four
// modes (direct from 1MV or 4MV co-located macroblocks with TRB/TRD from
// the VOP times, interpolated, forward, backward; skipped where the future
// reference's co-located macroblock was not coded).
//
// The standard bounds only the IDCT's accuracy (IEEE 1180), so a decoder's
// pictures are its own: this one follows ffmpeg, whose decode is what cv2
// returns. It runs libavcodec's "simple" integer IDCT (a row pass then a
// column pass; ffmpeg's x86 SIMD version gives the same output on every
// stream the tests hold), and the Xvid IDCT that ffmpeg switches to when
// the user data names an Xvid build. ffmpeg's other choices are followed as
// well: references extend from the macroblock-aligned size (the edge it
// pads from), 8x8 prediction clamps its source to the picture, the
// quarter-sample chroma vector halves the luma vector by truncation, direct
// mode under quarter-sample predicts 8x8 blocks, and the user-data keyed
// bug workarounds (edge, DC clip, quarter-sample chroma) apply for the
// encoder builds ffmpeg applies them to.
//
// Refused by name (a ValueError on the Python side): interlaced VOLs,
// sprites (static and GMC) and S-VOPs, data partitioning and reversible
// VLCs, the short video header (H.263 baseline), scalability, shapes other
// than rectangular, newpred, reduced-resolution VOPs, not_8_bit, the
// studio profile, complexity estimation headers, more than one VOP in one
// sample (DivX's packed bitstream), quarter-sample under user data naming a
// libavcodec build before 4653 (ffmpeg's old filter), and a B-VOP without
// two references.
// Nothing is concealed: a stream that does not parse raises, naming the
// element.
//
// Layout: bit reader, VLC tables, IDCTs, motion compensation, headers,
// macroblocks, VOP decode, C API.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {
namespace mpeg4 {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Error(what); }

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
inline int mid3(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

// ------------------------------------------------------------ bit reader --

struct Bits {
  const uint8_t* d = nullptr;
  size_t n_bits = 0;
  size_t pos = 0;

  Bits() = default;
  Bits(const uint8_t* data, size_t n) : d(data), n_bits(n * 8) {}

  // the next k <= 32 bits, zeros past the end
  uint32_t peek(int k) const {
    if (k == 0) return 0;
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 5; ++i) v = (v << 8) | (byte + i < (n_bits >> 3) ? d[byte + i] : 0);
    v <<= 24;                                  // 64-bit window, bit 63 the first
    v <<= (pos & 7);
    return static_cast<uint32_t>(v >> (64 - k));
  }
  uint32_t u(int k, const char* what) {
    uint32_t v = peek(k);
    pos += k;
    if (pos > n_bits) fail(std::string("the stream ends inside ") + what);
    return v;
  }
  int u1(const char* what) { return static_cast<int>(u(1, what)); }
  void skip(int k) { pos += k; }
  long left() const { return static_cast<long>(n_bits) - static_cast<long>(pos); }
  void align() { pos = (pos + 7) & ~size_t(7); }
  void marker(const char* what) {
    if (!u1(what)) fail(std::string("missing marker bit ") + what);
  }
};

// --------------------------------------------------------------- tables --

struct Vlc {
  int bits = 0;
  std::vector<int32_t> table;   // peek(bits) -> (symbol << 8) | length, -1: no code

  void build(int max_bits, const std::vector<std::array<int, 3>>& codes) {  // code, length, symbol
    bits = max_bits;
    table.assign(size_t(1) << max_bits, -1);
    for (auto& c : codes) {
      int shift = max_bits - c[1];
      for (uint32_t s = 0; s < (1u << shift); ++s)
        table[(uint32_t(c[0]) << shift) | s] = (c[2] << 8) | c[1];
    }
  }
  int read(Bits& b, const char* what) const {
    int32_t e = table[b.peek(bits)];
    if (e < 0) fail(std::string("invalid ") + what + " code");
    b.pos += e & 0xFF;
    if (b.pos > b.n_bits) fail(std::string("the stream ends inside ") + what);
    return e >> 8;
  }
};

// H.263 Table 7 / MPEG-4 Table B-6: I-VOP mcbpc, symbol = mb_type bit 2 (dquant) | cbpc; 8 stuffing
const int kMcbpcIntra[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4}, {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// Table B-7: P-VOP mcbpc, symbol = mb_type * 4 + cbpc (0 inter, 1 inter+q, 2 inter4v, 3 intra,
// 4 intra+q), 20 stuffing
const int kMcbpcInter[21][3] = {
    {1, 1, 0},  {3, 4, 1},  {2, 4, 2},  {5, 6, 3},  {3, 3, 4},  {7, 7, 5},  {6, 7, 6},
    {5, 9, 7},  {2, 3, 8},  {5, 7, 9},  {4, 7, 10}, {5, 8, 11}, {3, 5, 12}, {4, 8, 13},
    {3, 8, 14}, {3, 7, 15}, {4, 6, 16}, {4, 9, 17}, {3, 9, 18}, {2, 9, 19}, {1, 9, 20}};
// Table B-8: cbpy (intra order), [cbpy] -> code, length
const int kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                          {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Tables B-13 and B-14: dct_dc_size_luminance / _chrominance, [size] -> code, length
const int kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                           {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const int kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6},
                             {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};
// Table B-12: motion_code, [|code|] -> code, length (a sign bit follows a non-zero code)
const int kMv[33][2] = {{1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},
                        {3, 7},   {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10},
                        {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},
                        {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},  {5, 11},
                        {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};

// Tables B-16 (intra) and B-17 (inter) of TCOEF: the codes of (last, run, level) in the order
// last 0 then 1, run ascending, level ascending; [102] is the escape. Both tables share one set
// of code words.
const int kTcoefIntraCode[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const int kTcoefInterCode[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
// the largest level of each run, (last 0 runs..., -1, last 1 runs..., -1): the tables' shapes
const int kIntraMaxLevel[] = {27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1, -1,
                              8,  3,  2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1};
const int kInterMaxLevel[] = {12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, -1, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, -1};

const int kEscape = 0xFFFF;

// One TCOEF table: its VLC (symbol = last << 12 | run << 6 | level, or kEscape) and the
// escape offsets LMAX (by last, run) and RMAX (by last, level).
struct Tcoef {
  Vlc vlc;
  int max_level[2][64] = {};
  int max_run[2][64] = {};

  void build(const int (*codes)[2], const int* shape) {
    std::vector<std::array<int, 3>> entries;
    int k = 0;
    for (int last = 0; last < 2; ++last) {
      for (int run = 0; *shape >= 0; ++run, ++shape) {
        max_level[last][run] = *shape;
        for (int level = 1; level <= *shape; ++level, ++k) {
          entries.push_back({codes[k][0], codes[k][1], (last << 12) | (run << 6) | level});
          max_run[last][level] = std::max(max_run[last][level], run);
        }
      }
      ++shape;
    }
    entries.push_back({codes[k][0], codes[k][1], kEscape});
    vlc.build(12, entries);
  }
};

struct Tables {
  Vlc mcbpc_i, mcbpc_p, cbpy, dc_lum, dc_chrom, mv, mb_type_b;
  Tcoef intra, inter;

  Tables() {
    std::vector<std::array<int, 3>> e;
    for (int i = 0; i < 9; ++i) e.push_back({kMcbpcIntra[i][0], kMcbpcIntra[i][1], i});
    mcbpc_i.build(9, e);
    e.clear();
    for (auto& c : kMcbpcInter) e.push_back({c[0], c[1], c[2]});
    mcbpc_p.build(9, e);
    e.clear();
    for (int i = 0; i < 16; ++i) e.push_back({kCbpy[i][0], kCbpy[i][1], i});
    cbpy.build(6, e);
    e.clear();
    for (int i = 0; i < 13; ++i) e.push_back({kDcLum[i][0], kDcLum[i][1], i});
    dc_lum.build(11, e);
    e.clear();
    for (int i = 0; i < 13; ++i) e.push_back({kDcChrom[i][0], kDcChrom[i][1], i});
    dc_chrom.build(12, e);
    e.clear();
    for (int i = 0; i < 33; ++i) e.push_back({kMv[i][0], kMv[i][1], i});
    mv.build(12, e);
    // Table B-4: 1 direct, 01 interpolate, 001 backward, 0001 forward
    mb_type_b.build(4, {{1, 1, 0}, {1, 2, 1}, {1, 3, 2}, {1, 4, 3}});
    intra.build(kTcoefIntraCode, kIntraMaxLevel);
    inter.build(kTcoefInterCode, kInterMaxLevel);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
                                    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                                    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                                    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
                                  41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
                                  51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
                                  53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
// the default intra and non-intra quantiser matrices (6.3.3), raster order
const uint8_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};
// Table 7-1: DC scalers by quantiser
inline int y_dc_scale(int q) { return q < 5 ? 8 : (q < 9 ? 2 * q : (q < 25 ? q + 8 : 2 * q - 16)); }
inline int c_dc_scale(int q) { return q < 5 ? 8 : (q < 25 ? (q + 13) / 2 : q - 6); }
// intra_dc_vlc_thr -> the quantiser from which DC goes with the AC coefficients
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kDquant[4] = {-1, -2, 1, 2};

// ----------------------------------------------------------------- IDCTs --

// libavcodec's "simple" IDCT for 8-bit samples (row pass, 11-bit shift; column pass, 20-bit
// shift), with its constants cos(i pi / 16) sqrt(2) 2^14 and its DC-only row shortcut.
namespace simple {
const int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;

inline void row(int16_t* r) {
  if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
    int16_t t = static_cast<int16_t>(static_cast<uint16_t>(r[0] * 8));
    for (int i = 0; i < 8; ++i) r[i] = t;
    return;
  }
  uint32_t a0 = uint32_t(W4) * r[0] + (1u << 10), a1 = a0, a2 = a0, a3 = a0;
  a0 += uint32_t(W2) * r[2];
  a1 += uint32_t(W6) * r[2];
  a2 -= uint32_t(W6) * r[2];
  a3 -= uint32_t(W2) * r[2];
  uint32_t b0 = uint32_t(W1) * r[1] + uint32_t(W3) * r[3];
  uint32_t b1 = uint32_t(W3) * r[1] - uint32_t(W7) * r[3];
  uint32_t b2 = uint32_t(W5) * r[1] - uint32_t(W1) * r[3];
  uint32_t b3 = uint32_t(W7) * r[1] - uint32_t(W5) * r[3];
  a0 += uint32_t(W4) * r[4] + uint32_t(W6) * r[6];
  a1 += -uint32_t(W4) * r[4] - uint32_t(W2) * r[6];
  a2 += -uint32_t(W4) * r[4] + uint32_t(W2) * r[6];
  a3 += uint32_t(W4) * r[4] - uint32_t(W6) * r[6];
  b0 += uint32_t(W5) * r[5] + uint32_t(W7) * r[7];
  b1 += -uint32_t(W1) * r[5] - uint32_t(W5) * r[7];
  b2 += uint32_t(W7) * r[5] + uint32_t(W3) * r[7];
  b3 += uint32_t(W3) * r[5] - uint32_t(W1) * r[7];
  r[0] = int16_t(int32_t(a0 + b0) >> 11);
  r[7] = int16_t(int32_t(a0 - b0) >> 11);
  r[1] = int16_t(int32_t(a1 + b1) >> 11);
  r[6] = int16_t(int32_t(a1 - b1) >> 11);
  r[2] = int16_t(int32_t(a2 + b2) >> 11);
  r[5] = int16_t(int32_t(a2 - b2) >> 11);
  r[3] = int16_t(int32_t(a3 + b3) >> 11);
  r[4] = int16_t(int32_t(a3 - b3) >> 11);
}

// column c of the row-transformed block -> its 8 outputs (before clipping)
inline void col(const int16_t* c, int* out) {
  uint32_t a0 = uint32_t(W4) * (c[0] + ((1 << 19) / W4)), a1 = a0, a2 = a0, a3 = a0;
  a0 += uint32_t(W2) * c[16];
  a1 += uint32_t(W6) * c[16];
  a2 -= uint32_t(W6) * c[16];
  a3 -= uint32_t(W2) * c[16];
  uint32_t b0 = uint32_t(W1) * c[8] + uint32_t(W3) * c[24];
  uint32_t b1 = uint32_t(W3) * c[8] - uint32_t(W7) * c[24];
  uint32_t b2 = uint32_t(W5) * c[8] - uint32_t(W1) * c[24];
  uint32_t b3 = uint32_t(W7) * c[8] - uint32_t(W5) * c[24];
  a0 += uint32_t(W4) * c[32];
  a1 -= uint32_t(W4) * c[32];
  a2 -= uint32_t(W4) * c[32];
  a3 += uint32_t(W4) * c[32];
  b0 += uint32_t(W5) * c[40];
  b1 -= uint32_t(W1) * c[40];
  b2 += uint32_t(W7) * c[40];
  b3 += uint32_t(W3) * c[40];
  a0 += uint32_t(W6) * c[48];
  a1 -= uint32_t(W2) * c[48];
  a2 += uint32_t(W2) * c[48];
  a3 -= uint32_t(W6) * c[48];
  b0 += uint32_t(W7) * c[56];
  b1 -= uint32_t(W5) * c[56];
  b2 += uint32_t(W3) * c[56];
  b3 -= uint32_t(W1) * c[56];
  out[0] = int32_t(a0 + b0) >> 20;
  out[1] = int32_t(a1 + b1) >> 20;
  out[2] = int32_t(a2 + b2) >> 20;
  out[3] = int32_t(a3 + b3) >> 20;
  out[4] = int32_t(a3 - b3) >> 20;
  out[5] = int32_t(a2 - b2) >> 20;
  out[6] = int32_t(a1 - b1) >> 20;
  out[7] = int32_t(a0 - b0) >> 20;
}

// the residual of the block in place (raster order), as int16 before clipping
void idct(int16_t* blk, int* res) {
  for (int i = 0; i < 8; ++i) row(blk + 8 * i);
  int out[8];
  for (int x = 0; x < 8; ++x) {
    col(blk + x, out);
    for (int y = 0; y < 8; ++y) res[8 * y + x] = out[y];
  }
}
}  // namespace simple

// The Xvid IDCT (libavcodec's C version of Xvid's): rows with their own rounding constants
// and cosine tables, then an AAN-style column pass whose products are taken as 16-bit
// high halves.
namespace xvid {
const int kRowRnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
const unsigned kTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
const unsigned kTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
const unsigned kTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
const unsigned kTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};
const unsigned* const kRowTab[8] = {kTab04, kTab17, kTab26, kTab35, kTab04, kTab35, kTab26, kTab17};

inline void row(int16_t* in, const unsigned* tab, int rnd) {
  const unsigned c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3], c5 = tab[4], c6 = tab[5],
                 c7 = tab[6];
  if (!(in[1] | in[2] | in[3] | in[4] | in[5] | in[6] | in[7])) {
    const int k = int(c4 * in[0]) + rnd;
    const int a0 = k >> 11;
    if (a0)
      for (int i = 0; i < 8; ++i) in[i] = int16_t(a0);
    return;
  }
  const int k = int(c4 * in[0]) + rnd;
  const unsigned a0 = k + c2 * in[2] + c4 * in[4] + c6 * in[6];
  const unsigned a1 = k + c6 * in[2] - c4 * in[4] - c2 * in[6];
  const unsigned a2 = k - c6 * in[2] - c4 * in[4] + c2 * in[6];
  const unsigned a3 = k - c2 * in[2] + c4 * in[4] - c6 * in[6];
  const int b0 = int(c1 * in[1] + c3 * in[3] + c5 * in[5] + c7 * in[7]);
  const int b1 = int(c3 * in[1] - c7 * in[3] - c1 * in[5] - c5 * in[7]);
  const int b2 = int(c5 * in[1] - c1 * in[3] + c7 * in[5] + c3 * in[7]);
  const int b3 = int(c7 * in[1] - c5 * in[3] + c3 * in[5] - c1 * in[7]);
  in[0] = int16_t(int(a0 + b0) >> 11);
  in[1] = int16_t(int(a1 + b1) >> 11);
  in[2] = int16_t(int(a2 + b2) >> 11);
  in[3] = int16_t(int(a3 + b3) >> 11);
  in[4] = int16_t(int(a3 - b3) >> 11);
  in[5] = int16_t(int(a2 - b2) >> 11);
  in[6] = int16_t(int(a1 - b1) >> 11);
  in[7] = int16_t(int(a0 - b0) >> 11);
}

const int TAN1 = 0x32EC, TAN2 = 0x6A0A, TAN3 = 0xAB0E, SQRT2 = 0x5A82;
inline int mult(int c, int x) { return int(unsigned(int(unsigned(c) * unsigned(x)) >> 16)); }

inline void col(int16_t* in) {
  int mm0, mm1, mm2, mm3, mm4, mm5, mm6, mm7;
  mm4 = in[7 * 8];
  mm5 = in[5 * 8];
  mm6 = in[3 * 8];
  mm7 = in[1 * 8];
  mm0 = mult(TAN1, mm4) + mm7;
  mm1 = mult(TAN1, mm7) - mm4;
  mm2 = mult(TAN3, mm5) + mm6;
  mm3 = mult(TAN3, mm6) - mm5;
  mm7 = mm0 + mm2;
  mm4 = mm1 - mm3;
  mm0 = mm0 - mm2;
  mm1 = mm1 + mm3;
  mm6 = mm0 + mm1;
  mm5 = mm0 - mm1;
  mm5 = 2 * mult(SQRT2, mm5);
  mm6 = 2 * mult(SQRT2, mm6);
  mm1 = in[2 * 8];
  mm2 = in[6 * 8];
  mm3 = mult(TAN2, mm2) + mm1;
  mm2 = mult(TAN2, mm1) - mm2;
  const int e0 = in[0] + in[4 * 8], e1 = in[0] - in[4 * 8];
  int t;
  mm0 = e0;
  mm1 = e1;
  t = mm0 + mm3; mm3 = mm0 - mm3; mm0 = t;     // BUTF(mm0, mm3)
  t = mm0 + mm7; mm7 = mm0 - mm7; mm0 = t;     // BUTF(mm0, mm7)
  in[8 * 0] = int16_t(mm0 >> 6);
  in[8 * 7] = int16_t(mm7 >> 6);
  t = mm3 + mm4; mm4 = mm3 - mm4; mm3 = t;     // BUTF(mm3, mm4)
  in[8 * 3] = int16_t(mm3 >> 6);
  in[8 * 4] = int16_t(mm4 >> 6);
  t = mm1 + mm2; mm2 = mm1 - mm2; mm1 = t;     // BUTF(mm1, mm2)
  t = mm1 + mm6; mm6 = mm1 - mm6; mm1 = t;     // BUTF(mm1, mm6)
  in[8 * 1] = int16_t(mm1 >> 6);
  in[8 * 6] = int16_t(mm6 >> 6);
  t = mm2 + mm5; mm5 = mm2 - mm5; mm2 = t;     // BUTF(mm2, mm5)
  in[8 * 2] = int16_t(mm2 >> 6);
  in[8 * 5] = int16_t(mm5 >> 6);
}

void idct(int16_t* blk, int* res) {
  for (int i = 0; i < 8; ++i) row(blk + 8 * i, kRowTab[i], kRowRnd[i]);
  for (int x = 0; x < 8; ++x) col(blk + x);
  for (int i = 0; i < 64; ++i) res[i] = blk[i];
}
}  // namespace xvid

// --------------------------------------------------- motion compensation --

// The (bw x bh) block at (x, y) of a plane whose samples are defined on [0, ew) x [0, eh) and
// extend by repetition beyond: a pointer into the plane, or into `buf` (stride bw).
const uint8_t* fetch(const uint8_t* plane, int stride, int ew, int eh, int x, int y, int bw, int bh,
                     uint8_t* buf, int* out_stride) {
  if (x >= 0 && y >= 0 && x + bw <= ew && y + bh <= eh) {
    *out_stride = stride;
    return plane + size_t(y) * stride + x;
  }
  for (int j = 0; j < bh; ++j) {
    const uint8_t* r = plane + size_t(clampi(y + j, 0, eh - 1)) * stride;
    for (int i = 0; i < bw; ++i) buf[j * bw + i] = r[clampi(x + i, 0, ew - 1)];
  }
  *out_stride = bw;
  return buf;
}

// half-sample prediction of an n x n block (dxy: bit 0 horizontal, bit 1 vertical half).
// With no_rnd, ffmpeg's x86 8-wide horizontal and vertical halves (put_no_rnd_pixels8_x2 and
// _y2, taken unless the caller asks for bit-exact output, which cv2 does not) are pavgb of two
// samples one of which is first lowered by 1, saturating: the left one, and the one on the odd
// row. They differ from (a + b) >> 1 where that sample is 0; the port does as they do.
void hpel(uint8_t* dst, const uint8_t* s, int ss, int n, int dxy, int no_rnd) {
  const bool approx = no_rnd && n == 8;
  for (int j = 0; j < n; ++j, s += ss)
    for (int i = 0; i < n; ++i) {
      int v;
      if (dxy == 0) {
        v = s[i];
      } else if (dxy == 3) {
        v = (s[i] + s[i + 1] + s[i + ss] + s[i + ss + 1] + 2 - no_rnd) >> 2;
      } else {
        int a = s[i], b = dxy == 1 ? s[i + 1] : s[i + ss];
        if (approx) {
          if (dxy == 1 || (j & 1)) a = std::max(a - 1, 0) + 1;
          else b = std::max(b - 1, 0) + 1;
        }
        v = (a + b + 1 - no_rnd) >> 1;
      }
      dst[j * n + i] = uint8_t(v);
    }
}

// the 8-tap half-sample filter of quarter-sample prediction along a line of n + 1 samples,
// mirrored at the block's edges (sample -1 is sample 0, n + 1 is n)
inline int qfilter(const uint8_t* s, int step, int n, int i) {
  auto at = [&](int k) { return int(s[(k < 0 ? -1 - k : (k > n ? 2 * n + 1 - k : k)) * step]); };
  return 20 * (at(i) + at(i + 1)) - 6 * (at(i - 1) + at(i + 2)) + 3 * (at(i - 2) + at(i + 3)) -
         (at(i - 3) + at(i + 4));
}

// quarter-sample prediction of an n x n block from the (n + 1) x (n + 1) samples at `s`, as
// libavcodec's qpeldsp composes it: a horizontal stage on n + 1 rows (integer, half or quarter
// position), then a vertical stage on that
void qpel(uint8_t* dst, const uint8_t* s, int ss, int n, int dxy, int no_rnd) {
  const int fx = dxy & 3, fy = dxy >> 2, r = 16 - no_rnd, ra = 1 - no_rnd;
  const int w = n + 1;
  uint8_t h[17 * 17];          // rows 0..n of the horizontal stage
  for (int j = 0; j <= n; ++j)
    for (int i = 0; i < n; ++i) {
      const uint8_t* line = s + size_t(j) * ss;
      int v;
      if (fx == 0) {
        v = line[i];
      } else {
        int half = clip8((qfilter(line, 1, n, i) + r) >> 5);
        v = fx == 2 ? half : (half + line[i + (fx == 3)] + ra) >> 1;
      }
      h[j * w + i] = uint8_t(v);
    }
  for (int j = 0; j < n; ++j)
    for (int i = 0; i < n; ++i) {
      int v;
      if (fy == 0) {
        v = h[j * w + i];
      } else {
        int half = clip8((qfilter(h + i, w, n, j) + r) >> 5);
        v = fy == 2 ? half : (half + h[(j + (fy == 3)) * w + i] + ra) >> 1;
      }
      dst[j * n + i] = uint8_t(v);
    }
}

// put (avg 0) or average with what is there (avg 1), an n x n block into a plane
inline void store(uint8_t* d, int ds, const uint8_t* p, int n, bool avg) {
  for (int j = 0; j < n; ++j, d += ds)
    for (int i = 0; i < n; ++i) d[i] = avg ? uint8_t((d[i] + p[j * n + i] + 1) >> 1) : p[j * n + i];
}

// ffmpeg's chroma vector from the sum of four luma vectors (half-sample units)
inline int round_chroma4(int x) {
  static const int tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
  return tab[x & 15] + ((x >> 3) & ~1);
}

// -------------------------------------------------------------- pictures --

struct Picture {
  int mbw = 0, mbh = 0;
  std::vector<uint8_t> y, u, v;          // macroblock-aligned planes
  std::vector<uint8_t> not_coded;        // per macroblock: skipped in a P-VOP
  std::vector<uint8_t> four_mv;          // per macroblock: 4MV (8x8 motion)
  std::vector<int16_t> mv;               // per 8x8 block (2mbw x 2mbh), x then y
  int64_t time = 0;
  int type = 0;

  Picture(int w, int h) : mbw(w), mbh(h) {
    y.assign(size_t(mbw) * 16 * mbh * 16, 0);
    u.assign(size_t(mbw) * 8 * mbh * 8, 0);
    v.assign(u.size(), 0);
    not_coded.assign(size_t(mbw) * mbh, 0);
    four_mv.assign(size_t(mbw) * mbh, 0);
    mv.assign(size_t(mbw) * mbh * 8, 0);
  }
};

enum { I_VOP = 0, P_VOP = 1, B_VOP = 2, S_VOP = 3 };
const char* const kVopName[4] = {"I-VOP", "P-VOP", "B-VOP", "S-VOP"};

// ffmpeg's bug workarounds that key on the user data (libavcodec's FF_BUG_*)
enum { BUG_EDGE = 1, BUG_DC_CLIP = 2, BUG_QPEL_CHROMA = 4, BUG_QPEL_CHROMA2 = 8, BUG_STD_QPEL = 16 };

struct Decoder {
  // VOS / VO
  int profile_level = -1;
  int full_range = 0, matrix = 2;        // video_signal_type (2: unspecified)
  // VOL
  bool have_vol = false;
  int width = 0, height = 0, mbw = 0, mbh = 0;
  int time_res = 1, time_bits = 1;
  bool quarter = false, mpeg_quant = false, resync_disable = true;
  uint8_t intra_matrix[64], inter_matrix[64];   // raster order
  // user data
  int xvid_build = -1, divx_version = -1, divx_build = -1, lavc_build = -1;
  // time
  int64_t time_base = 0, last_time_base = 0, last_non_b_time = 0;
  int pp_time = 0, pb_time = 0;
  // references: past (older) and future (newer) I/P-VOPs; the last B-VOP; what the sample shows
  std::unique_ptr<Picture> past, future, b_pic;
  const Picture* shown = nullptr;
  int out_type = 0, out_coded = 1;
  int64_t out_time = 0;

  // the VOP being decoded
  Bits bs;
  int vop_type = 0, rounding = 0, dc_thr = 99, qscale = 1, vop_quant = 1, f_code = 1, b_code = 1;
  Picture* cur = nullptr;
  int mb_x = 0, mb_y = 0, resync_x = 0, resync_y = 0;
  bool first_slice_line = true;
  int b8_stride = 0, mb_stride = 0;
  std::vector<int16_t> dc_val[3];        // luma on the 8x8 grid, chroma per macroblock
  std::vector<int16_t> ac_val[3];        // 16 a block: [1..7] first column, [9..15] first row
  std::vector<int8_t> qscale_table;
  std::vector<int16_t> mv_grid;          // the current P-VOP's vectors on the 8x8 grid (guarded)
  int last_mv[2][2] = {};                // B-VOP predictors: forward, backward
  int bugs = 0;

  Decoder() {
    std::memcpy(intra_matrix, kDefaultIntraMatrix, 64);
    std::memcpy(inter_matrix, kDefaultInterMatrix, 64);
  }

  // ---------------------------------------------------------- headers --

  void parse_vol(Bits& b) {
    b.skip(1);                                   // random_accessible_vol
    int object_type = b.u(8, "video_object_type_indication");
    if (object_type == 0x12)
      fail("video_object_type_indication 0x12 (Fine Granularity Scalable) is not supported");
    int verid = 1;
    if (b.u1("is_object_layer_identifier")) {
      verid = b.u(4, "video_object_layer_verid");
      b.skip(3);
    }
    if (b.u(4, "aspect_ratio_info") == 15) b.skip(16);
    if (b.u1("vol_control_parameters")) {
      int chroma = b.u(2, "chroma_format");
      if (chroma != 1) fail("chroma_format " + std::to_string(chroma) + " (the port reads 4:2:0)");
      b.skip(1);                                 // low_delay: the reader orders by ctts
      if (b.u1("vbv_parameters")) b.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);
    }
    int shape = b.u(2, "video_object_layer_shape");
    if (shape != 0)
      fail("video_object_layer_shape " + std::to_string(shape) +
           " (binary, binary-only or grayscale shape); the port reads rectangular VOLs");
    b.marker("before vop_time_increment_resolution");
    time_res = b.u(16, "vop_time_increment_resolution");
    if (time_res == 0) fail("vop_time_increment_resolution 0");
    time_bits = 1;
    while ((1 << time_bits) < time_res) ++time_bits;
    b.marker("after vop_time_increment_resolution");
    if (b.u1("fixed_vop_rate")) b.skip(time_bits);
    b.marker("before video_object_layer_width");
    int w = b.u(13, "video_object_layer_width");
    b.marker("before video_object_layer_height");
    int h = b.u(13, "video_object_layer_height");
    b.marker("after video_object_layer_height");
    if (w <= 0 || h <= 0 || w > 8192 || h > 8192)
      fail("video_object_layer size " + std::to_string(w) + "x" + std::to_string(h));
    if (b.u1("interlaced")) fail("interlaced (field coding) is not supported");
    b.skip(1);                                   // obmc_disable: ffmpeg ignores OBMC
    int sprite = verid == 1 ? b.u1("sprite_enable") : b.u(2, "sprite_enable");
    if (sprite)
      fail("sprite_enable " + std::to_string(sprite) + (sprite == 2 ? " (GMC)" : " (static sprites)") +
           " is not supported");
    if (b.u1("not_8_bit"))
      fail("not_8_bit (a quantiser precision or bit depth other than 5 and 8) is not supported");
    mpeg_quant = b.u1("quant_type");
    std::memcpy(intra_matrix, kDefaultIntraMatrix, 64);
    std::memcpy(inter_matrix, kDefaultInterMatrix, 64);
    if (mpeg_quant) {
      for (uint8_t* m : {intra_matrix, inter_matrix}) {
        if (!b.u1("load_quant_mat")) continue;
        int last = 0, i = 0;
        for (; i < 64; ++i) {
          int v = b.u(8, "quant_mat");
          if (v == 0) break;
          last = v;
          m[kZigzag[i]] = uint8_t(v);
        }
        if (i == 0) fail("a loaded quantiser matrix without values");
        for (; i < 64; ++i) m[kZigzag[i]] = uint8_t(last);
      }
    }
    quarter = verid != 1 ? b.u1("quarter_sample") : false;
    if (!b.u1("complexity_estimation_disable"))
      fail("complexity_estimation_disable 0 (complexity estimation headers) is not supported");
    resync_disable = b.u1("resync_marker_disable");
    if (b.u1("data_partitioned")) {
      bool rvlc = b.u1("reversible_vlc");
      fail(std::string("data_partitioned") + (rvlc ? " with reversible_vlc (RVLC)" : "") +
           " is not supported");
    }
    if (verid != 1) {
      if (b.u1("newpred_enable")) fail("newpred_enable is not supported");
      if (b.u1("reduced_resolution_vop_enable")) fail("reduced_resolution_vop_enable is not supported");
    }
    if (b.u1("scalability")) fail("scalability (spatial or temporal enhancement layers) is not supported");
    if (have_vol && (w != width || h != height))
      fail("the VOL changes the size from " + std::to_string(width) + "x" + std::to_string(height) + " to " +
           std::to_string(w) + "x" + std::to_string(h));
    width = w;
    height = h;
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    have_vol = true;
  }

  void parse_vo(Bits& b) {
    if (b.u1("is_visual_object_identifier")) b.skip(7);
    int type = b.u(4, "visual_object_type");
    if (type != 1)
      fail("visual_object_type " + std::to_string(type) + " (the port reads video objects, type 1)");
    if (b.u1("video_signal_type")) {
      b.skip(3);                                 // video_format
      full_range = b.u1("video_range");
      if (b.u1("colour_description")) {
        b.skip(16);                              // colour_primaries, transfer_characteristics
        matrix = b.u(8, "matrix_coefficients");
      }
    }
  }

  // libavcodec's encoder identification (decode_user_data), which keys its workarounds
  void parse_user_data(const uint8_t* p, size_t n) {
    std::string s(reinterpret_cast<const char*>(p), std::min<size_t>(n, 255));
    int ver = 0, build = 0, v2 = 0, v3 = 0;
    char last = 0;
    int e = std::sscanf(s.c_str(), "DivX%dBuild%d%c", &ver, &build, &last);
    if (e < 2) e = std::sscanf(s.c_str(), "DivX%db%d%c", &ver, &build, &last);
    if (e >= 2) {
      divx_version = ver;
      divx_build = build;
    }
    if (std::sscanf(s.c_str(), "FFmpe%*[^b]b%d", &build) == 1) {
      lavc_build = build;
    } else if (std::sscanf(s.c_str(), "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &v2, &v3,
                           &build) == 4) {
      lavc_build = build;
    } else if (std::sscanf(s.c_str(), "Lavc%d.%d.%d", &ver, &v2, &v3) == 3) {
      if (ver <= 255 && v2 <= 255 && v3 <= 255) lavc_build = (ver << 16) + (v2 << 8) + v3;
    } else if (s == "ffmpeg") {
      lavc_build = 4600;
    }
    if (std::sscanf(s.c_str(), "XviD%d", &build) == 1) xvid_build = build;
  }

  void set_bugs() {
    bugs = 0;
    auto u = [](int v) { return unsigned(v); };
    if (divx_version >= 500 && u(divx_build) < 1814u) bugs |= BUG_QPEL_CHROMA;
    if (divx_version > 502 && u(divx_build) < 1814u) bugs |= BUG_QPEL_CHROMA2;
    if (u(xvid_build) <= 1u) bugs |= BUG_QPEL_CHROMA;
    if (u(xvid_build) <= 12u) bugs |= BUG_EDGE;
    if (u(xvid_build) <= 32u) bugs |= BUG_DC_CLIP;
    if (u(lavc_build) < 4653u) bugs |= BUG_STD_QPEL;
    if (u(lavc_build) < 4670u) bugs |= BUG_EDGE;
    if (u(lavc_build) <= 4712u) bugs |= BUG_DC_CLIP;
    if (u(divx_version) < 500u) bugs |= BUG_EDGE;
  }

  // every header start code of a buffer (a DecoderSpecificInfo or a sample); a VOP decodes
  // into `out` and returns true. `scan` reads the headers up to the first VOP's vop_coded
  // into scan_type / scan_coded instead, leaving the times and references alone.
  int scan_type = -1, scan_coded = 0;
  bool parse(const uint8_t* d, size_t n, bool scan = false) {
    std::vector<size_t> codes;
    for (size_t i = 0; i + 3 < n; ++i)
      if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) {
        codes.push_back(i);
        i += 2;
      }
    if (codes.empty()) {
      if (n >= 3 && d[0] == 0 && d[1] == 0 && (d[2] & 0xFC) == 0x80)
        fail("short_video_header (an H.263 baseline picture) is not supported");
      fail("no start code (00 00 01) in the sample");
    }
    bool vop = false;
    for (size_t k = 0; k < codes.size(); ++k) {
      size_t a = codes[k] + 4, e = k + 1 < codes.size() ? codes[k + 1] : n;
      int code = d[codes[k] + 3];
      Bits b(d + a, e > a ? e - a : 0);
      if (code <= 0x1F) {
        // video_object_start_code
      } else if (code <= 0x2F) {
        parse_vol(b);
      } else if (code == 0xB0) {
        profile_level = b.u(8, "profile_and_level_indication");
        if ((profile_level >> 4) == 0xE)
          fail("the studio profile (profile_and_level_indication " + std::to_string(profile_level) +
               ") is not supported");
      } else if (code == 0xB2) {
        parse_user_data(d + a, e - a);
      } else if (code == 0xB3) {
        if (scan) continue;
        int hours = b.u(5, "time_code_hours"), minutes = b.u(6, "time_code_minutes");
        b.marker("in the GOV header");
        int seconds = b.u(6, "time_code_seconds");
        time_base = seconds + 60 * (minutes + 60 * int64_t(hours));
      } else if (code == 0xB5) {
        parse_vo(b);
      } else if (code == 0xB6) {
        if (vop) fail("more than one VOP in one sample (DivX's packed bitstream) is not supported");
        vop = true;
        if (scan) {
          if (!have_vol) fail("a VOP before any video object layer header");
          scan_type = b.u(2, "vop_coding_type");
          while (b.u1("modulo_time_base")) {
          }
          b.marker("before vop_time_increment");
          b.skip(time_bits);
          b.marker("after vop_time_increment");
          scan_coded = b.u1("vop_coded");
          return true;
        }
        decode_vop(d + a, e - a);
      } else if (code >= 0x30 && code <= 0xAF) {
        fail("start code " + std::to_string(code) + " (a scalable or still-texture layer) is not supported");
      } else if ((code & 0xF8) == 0x80 && codes[k] == 0) {
        fail("short_video_header (an H.263 baseline picture) is not supported");
      }
    }
    return vop;
  }

  // ---------------------------------------------------- prediction state --

  int lum_index(int bx, int by) const { return 1 + b8_stride + by * b8_stride + bx; }
  int chroma_index(int x, int y) const { return 1 + mb_stride + y * mb_stride + x; }
  // the n-th block of the current macroblock's index into dc_val / ac_val and its row stride
  int block_index(int n) const {
    return n < 4 ? lum_index(2 * mb_x + (n & 1), 2 * mb_y + (n >> 1)) : chroma_index(mb_x, mb_y);
  }
  int block_wrap(int n) const { return n < 4 ? b8_stride : mb_stride; }

  void set_qscale(int q) { qscale = clampi(q, 1, 31); }

  // ffmpeg's ff_mpeg4_clean_buffers: AC of the row above from the left neighbour on, and of
  // the current row up to the left neighbour; the B-VOP predictors
  void clean_buffers() {
    int l_xy = lum_index(2 * mb_x - 1, 2 * mb_y - 1);
    for (int i = 0; i < 2 * b8_stride + 1; ++i) std::fill_n(&ac_val[0][(l_xy + i) * 16], 16, 0);
    int c_xy = chroma_index(mb_x - 1, mb_y - 1);
    for (int c = 1; c < 3; ++c)
      for (int i = 0; i < mb_stride + 1; ++i) std::fill_n(&ac_val[c][(c_xy + i) * 16], 16, 0);
    std::memset(last_mv, 0, sizeof(last_mv));
  }

  // intra DC prediction (ff_mpeg4_pred_dc): the quantised DC with its predictor added, the
  // direction (0 left, 1 top); stores the reconstructed DC for the neighbours
  int pred_dc(int n, int level, int* dir) {
    int scale = n < 4 ? y_dc_scale(qscale) : c_dc_scale(qscale);
    int wrap = block_wrap(n), xy = block_index(n);
    std::vector<int16_t>& dc = dc_val[n < 4 ? 0 : n - 3];
    int a = dc[xy - 1], b = dc[xy - 1 - wrap], c = dc[xy - wrap];
    if (first_slice_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x == resync_x) b = a = 1024;
    }
    if (mb_x == resync_x && mb_y == resync_y + 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
    int pred;
    if (std::abs(a - b) < std::abs(b - c)) {
      pred = c;
      *dir = 1;
    } else {
      pred = a;
      *dir = 0;
    }
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int rec = level * scale;
    if (rec & ~2047) {
      if (rec < 0) rec = 0;
      else if (!(bugs & BUG_DC_CLIP)) rec = 2047;
    }
    dc[xy] = int16_t(rec);
    return level;
  }

  // AC prediction (ff_mpeg4_pred_ac) and the store of the block's first row and column
  void pred_ac(int16_t* blk, int n, int dir, bool ac_pred) {
    int xy = block_index(n);
    std::vector<int16_t>& acv = ac_val[n < 4 ? 0 : n - 3];
    int16_t* ac = &acv[size_t(xy) * 16];
    if (ac_pred) {
      if (dir == 0) {
        const int16_t* left = ac - 16;
        int q = mb_x > 0 ? qscale_table[mb_y * mbw + mb_x - 1] : qscale;
        bool same = mb_x == 0 || qscale == q || n == 1 || n == 3;
        for (int i = 1; i < 8; ++i)
          blk[i * 8] = int16_t(blk[i * 8] + (same ? left[i] : rounded_div(left[i] * q, qscale)));
      } else {
        const int16_t* top = ac - 16 * block_wrap(n);
        int q = mb_y > 0 ? qscale_table[(mb_y - 1) * mbw + mb_x] : qscale;
        bool same = mb_y == 0 || qscale == q || n == 2 || n == 3;
        for (int i = 1; i < 8; ++i)
          blk[i] = int16_t(blk[i] + (same ? top[i + 8] : rounded_div(top[i + 8] * q, qscale)));
      }
    }
    for (int i = 1; i < 8; ++i) ac[i] = blk[i * 8];
    for (int i = 1; i < 8; ++i) ac[8 + i] = blk[i];
  }
  static int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

  // motion-vector prediction of 8x8 block `block` of the current macroblock (ff_h263_pred_motion)
  void pred_motion(int block, int* px, int* py) {
    static const int off[4] = {2, 1, 1, -1};
    int wrap = b8_stride;
    int xy = lum_index(2 * mb_x + (block & 1), 2 * mb_y + (block >> 1));
    const int16_t* mv = mv_grid.data();
    auto A = [&](int k) { return mv[2 * (xy - 1) + k]; };
    auto B = [&](int k) { return mv[2 * (xy - wrap) + k]; };
    auto C = [&](int k) { return mv[2 * (xy + off[block] - wrap) + k]; };
    if (first_slice_line && block < 3) {
      if (block == 0) {
        if (mb_x == resync_x) {
          *px = *py = 0;
        } else if (mb_x + 1 == resync_x) {
          if (mb_x == 0) {
            *px = C(0);
            *py = C(1);
          } else {
            *px = mid3(A(0), 0, C(0));
            *py = mid3(A(1), 0, C(1));
          }
        } else {
          *px = A(0);
          *py = A(1);
        }
      } else if (block == 1) {
        if (mb_x + 1 == resync_x) {
          *px = mid3(A(0), 0, C(0));
          *py = mid3(A(1), 0, C(1));
        } else {
          *px = A(0);
          *py = A(1);
        }
      } else {
        if (mb_x == resync_x) {
          // ffmpeg zeroes the candidate in place: the left macroblock's block 3, in the
          // packet before, which a B-VOP's direct mode then reads as its co-located vector
          mv_grid[2 * (xy - 1)] = mv_grid[2 * (xy - 1) + 1] = 0;
        }
        *px = mid3(A(0), B(0), C(0));
        *py = mid3(A(1), B(1), C(1));
      }
    } else {
      *px = mid3(A(0), B(0), C(0));
      *py = mid3(A(1), B(1), C(1));
    }
  }

  void set_mv(int block, int x, int y) {
    int xy = lum_index(2 * mb_x + (block & 1), 2 * mb_y + (block >> 1));
    mv_grid[2 * xy] = int16_t(x);
    mv_grid[2 * xy + 1] = int16_t(y);
  }

  // a motion vector component: the decoded differential added to `pred`, wrapped to the range
  int decode_motion(int pred, int fcode) {
    int code = tables().mv.read(bs, "motion_code");
    if (code == 0) return pred;
    int sign = bs.u1("motion_code sign");
    int shift = fcode - 1, val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= int(bs.u(shift, "motion_residual"));
      ++val;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + fcode;             // sign_extend(val, 5 + fcode)
    val = int(uint32_t(val) << (32 - bits)) >> (32 - bits);
    return val;
  }

  // ------------------------------------------------------------ blocks --

  // one block's coefficients (raster order); intra: quantised levels with the DC predicted,
  // inter: dequantised for H.263 quantisation, levels for MPEG quantisation. Returns the last
  // scan index (-1 without coefficients)
  int decode_block(int16_t* blk, int n, bool coded, bool intra, bool use_dc_vlc, bool ac_pred, int* dc_dir) {
    const Tables& t = tables();
    const Tcoef& tc = intra ? t.intra : t.inter;
    const uint8_t* scan = kZigzag;
    int i, qmul = 1, qadd = 0;
    if (intra) {
      if (use_dc_vlc) {
        int size = n < 4 ? t.dc_lum.read(bs, "dct_dc_size_luminance")
                         : t.dc_chrom.read(bs, "dct_dc_size_chrominance");
        if (size > 9) fail("dct_dc_size " + std::to_string(size) + " (at most 9 for 8-bit video)");
        int level = 0;
        if (size) {
          uint32_t v = bs.u(size, "dct_dc_differential");
          level = (v >> (size - 1)) ? int(v) : int(v) - ((1 << size) - 1);
          if (size > 8) bs.marker("after dct_dc_differential");
        }
        blk[0] = int16_t(pred_dc(n, level, dc_dir));
        i = 0;
      } else {
        i = -1;
        pred_dc(n, 0, dc_dir);     // the direction (the DC is predicted again below)
      }
      if (ac_pred) scan = *dc_dir == 0 ? kAltVertical : kAltHorizontal;
    } else {
      i = -1;
      if (!mpeg_quant) {
        qmul = qscale << 1;
        qadd = (qscale - 1) | 1;
      }
    }
    if (coded) {
      for (;;) {
        int sym = tc.vlc.read(bs, "TCOEF");
        int last, run, level;
        if (sym != kEscape) {
          last = sym >> 12;
          run = (sym >> 6) & 63;
          level = sym & 63;
          if (bs.u1("TCOEF sign")) level = -level;
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
        } else if (!bs.u1("escape type")) {           // type 1: level offset
          sym = tc.vlc.read(bs, "TCOEF after escape type 1");
          if (sym == kEscape) fail("an escape inside escape type 1");
          last = sym >> 12;
          run = (sym >> 6) & 63;
          level = (sym & 63) + tc.max_level[last][run];
          if (bs.u1("TCOEF sign")) level = -level;
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
        } else if (!bs.u1("escape type")) {           // type 2: run offset
          sym = tc.vlc.read(bs, "TCOEF after escape type 2");
          if (sym == kEscape) fail("an escape inside escape type 2");
          last = sym >> 12;
          level = sym & 63;
          run = ((sym >> 6) & 63) + tc.max_run[last][level] + 1;
          if (bs.u1("TCOEF sign")) level = -level;
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
        } else {                                      // type 3: fixed length
          last = bs.u1("escape type 3 last");
          run = bs.u(6, "escape type 3 run");
          bs.marker("before escape type 3 level");
          level = int(bs.u(12, "escape type 3 level"));
          if (level & 0x800) level -= 0x1000;
          bs.marker("after escape type 3 level");
          if (level == 0) fail("escape type 3 with level 0");
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
          if (unsigned(level + 2048) > 4095u) level = level < 0 ? -2048 : 2047;
        }
        i += run + 1;
        if (i > 63) fail(std::string(intra ? "intra" : "inter") + " block " + std::to_string(n) +
                         ": TCOEF run past coefficient 63");
        blk[scan[i]] = int16_t(level);
        if (last) break;
      }
    }
    if (intra) {
      if (!use_dc_vlc) {
        blk[0] = int16_t(pred_dc(n, blk[0], dc_dir));
        if (i < 0) i = 0;
      }
      pred_ac(blk, n, *dc_dir, ac_pred);
      if (ac_pred) i = 63;
    }
    return i;
  }

  // dequantisation and the inverse transform; intra: put, inter: add to the prediction
  void reconstruct(int16_t* blk, int n, bool intra, int last, uint8_t* dst, int stride) {
    if (intra) {
      int scale = n < 4 ? y_dc_scale(qscale) : c_dc_scale(qscale);
      blk[0] = int16_t(blk[0] * scale);
      if (!mpeg_quant) {
        int qmul = qscale << 1, qadd = (qscale - 1) | 1;
        for (int i = 1; i < 64; ++i) {
          int l = blk[i];
          if (l) blk[i] = int16_t(l < 0 ? l * qmul - qadd : l * qmul + qadd);
        }
      } else {
        int q = qscale << 1;
        for (int i = 1; i < 64; ++i) {
          int l = blk[i];
          if (!l) continue;
          int m = (std::abs(l) * q * intra_matrix[i]) >> 4;
          blk[i] = int16_t(l < 0 ? -m : m);
        }
      }
    } else {
      if (last < 0) return;
      if (mpeg_quant) {
        int q = qscale << 1, sum = -1;
        for (int i = 0; i < 64; ++i) {
          int l = blk[i];
          if (!l) continue;
          int m = (((std::abs(l) << 1) + 1) * q * inter_matrix[i]) >> 5;
          blk[i] = int16_t(l < 0 ? -m : m);
          sum += blk[i];
        }
        blk[63] = int16_t(blk[63] ^ (sum & 1));
      }
    }
    int res[64];
    if (xvid_build >= 0) xvid::idct(blk, res);
    else simple::idct(blk, res);
    for (int y = 0; y < 8; ++y, dst += stride)
      for (int x = 0; x < 8; ++x) dst[x] = intra ? clip8(res[8 * y + x]) : clip8(dst[x] + res[8 * y + x]);
  }

  // ---------------------------------------------------------- prediction --

  int edge_w() const { return (bugs & BUG_EDGE) ? width : mbw * 16; }
  int edge_h() const { return (bugs & BUG_EDGE) ? height : mbh * 16; }

  // 16x16 prediction with one vector (ffmpeg's mpeg_motion / qpel_motion)
  void mc_16x16(const Picture& ref, int mx, int my, bool avg) {
    uint8_t buf[17 * 17], pred[256];
    int ss, no_rnd = rounding;
    const int ew = edge_w(), eh = edge_h();
    uint8_t* dy = &cur->y[size_t(mb_y) * 16 * mbw * 16 + mb_x * 16];
    int uvdxy, uvx, uvy;
    if (quarter) {
      int dxy = ((my & 3) << 2) | (mx & 3);
      const uint8_t* s = fetch(ref.y.data(), mbw * 16, ew, eh, mb_x * 16 + (mx >> 2),
                               mb_y * 16 + (my >> 2), 17, 17, buf, &ss);
      qpel(pred, s, ss, 16, dxy, no_rnd);
      int cx, cy;
      if (bugs & BUG_QPEL_CHROMA2) {
        static const int rtab[8] = {0, 0, 1, 1, 0, 0, 0, 1};
        cx = (mx >> 1) + rtab[mx & 7];
        cy = (my >> 1) + rtab[my & 7];
      } else if (bugs & BUG_QPEL_CHROMA) {
        cx = (mx >> 1) | (mx & 1);
        cy = (my >> 1) | (my & 1);
      } else {
        cx = mx / 2;
        cy = my / 2;
      }
      cx = (cx >> 1) | (cx & 1);
      cy = (cy >> 1) | (cy & 1);
      uvdxy = (cx & 1) | ((cy & 1) << 1);
      uvx = mb_x * 8 + (cx >> 1);
      uvy = mb_y * 8 + (cy >> 1);
    } else {
      int dxy = ((my & 1) << 1) | (mx & 1);
      int sx = mb_x * 16 + (mx >> 1), sy = mb_y * 16 + (my >> 1);
      const uint8_t* s = fetch(ref.y.data(), mbw * 16, ew, eh, sx, sy, 17, 17, buf, &ss);
      hpel(pred, s, ss, 16, dxy, no_rnd);
      uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      uvx = sx >> 1;
      uvy = sy >> 1;
    }
    store(dy, mbw * 16, pred, 16, avg);
    chroma(ref, uvx, uvy, uvdxy, avg);
  }

  void chroma(const Picture& ref, int x, int y, int dxy, bool avg) {
    uint8_t buf[9 * 9], pred[64];
    int ss;
    const int cw = mbw * 8, ew = edge_w() >> 1, eh = edge_h() >> 1;
    for (int c = 0; c < 2; ++c) {
      const std::vector<uint8_t>& p = c ? ref.v : ref.u;
      std::vector<uint8_t>& d = c ? cur->v : cur->u;
      const uint8_t* s = fetch(p.data(), cw, ew, eh, x, y, 9, 9, buf, &ss);
      hpel(pred, s, ss, 8, dxy, rounding);
      store(&d[size_t(mb_y) * 8 * cw + mb_x * 8], cw, pred, 8, avg);
    }
  }

  // four 8x8 luma predictions and the chroma from their vectors' sum (hpel_motion /
  // the 8x8 quarter-sample path, chroma_4mv_motion)
  void mc_8x8(const Picture& ref, const int (*mv)[2], bool avg) {
    uint8_t buf[9 * 9], pred[64];
    int ss, sum_x = 0, sum_y = 0;
    const int ew = edge_w(), eh = edge_h(), lw = mbw * 16;
    for (int i = 0; i < 4; ++i) {
      int mx = mv[i][0], my = mv[i][1];
      uint8_t* d = &cur->y[size_t(mb_y * 16 + (i >> 1) * 8) * lw + mb_x * 16 + (i & 1) * 8];
      if (quarter) {
        int dxy = ((my & 3) << 2) | (mx & 3);
        int sx = mb_x * 16 + (mx >> 2) + (i & 1) * 8, sy = mb_y * 16 + (my >> 2) + (i >> 1) * 8;
        sx = clampi(sx, -16, width);
        if (sx == width) dxy &= ~3;
        sy = clampi(sy, -16, height);
        if (sy == height) dxy &= ~12;
        const uint8_t* s = fetch(ref.y.data(), lw, ew, eh, sx, sy, 9, 9, buf, &ss);
        qpel(pred, s, ss, 8, dxy, rounding);
        sum_x += mx / 2;
        sum_y += my / 2;
      } else {
        int dxy = 0;
        int sx = mb_x * 16 + (i & 1) * 8 + (mx >> 1), sy = mb_y * 16 + (i >> 1) * 8 + (my >> 1);
        sx = clampi(sx, -16, width);
        if (sx != width) dxy |= mx & 1;
        sy = clampi(sy, -16, height);
        if (sy != height) dxy |= (my & 1) << 1;
        const uint8_t* s = fetch(ref.y.data(), lw, ew, eh, sx, sy, 9, 9, buf, &ss);
        hpel(pred, s, ss, 8, dxy, rounding);
        sum_x += mx;
        sum_y += my;
      }
      store(d, lw, pred, 8, avg);
    }
    int cx = round_chroma4(sum_x), cy = round_chroma4(sum_y);
    int dxy = ((cy & 1) << 1) | (cx & 1);
    int x = mb_x * 8 + (cx >> 1), y = mb_y * 8 + (cy >> 1);
    x = clampi(x, -8, width >> 1);
    if (x == (width >> 1)) dxy &= ~1;
    y = clampi(y, -8, height >> 1);
    if (y == (height >> 1)) dxy &= ~2;
    chroma(ref, x, y, dxy, avg);
  }

  // ------------------------------------------------------- macroblocks --

  void residual(int cbp, bool intra, bool ac_pred, bool use_dc_vlc) {
    int16_t blocks[6][64];
    int last[6], dir = 0;
    std::memset(blocks, 0, sizeof(blocks));
    for (int n = 0; n < 6; ++n)
      last[n] = decode_block(blocks[n], n, (cbp >> (5 - n)) & 1, intra, use_dc_vlc, ac_pred, &dir);
    const int lw = mbw * 16, cw = mbw * 8;
    for (int n = 0; n < 6; ++n) {
      uint8_t* dst;
      int stride;
      if (n < 4) {
        dst = &cur->y[size_t(mb_y * 16 + (n >> 1) * 8) * lw + mb_x * 16 + (n & 1) * 8];
        stride = lw;
      } else {
        dst = &(n == 4 ? cur->u : cur->v)[size_t(mb_y) * 8 * cw + mb_x * 8];
        stride = cw;
      }
      reconstruct(blocks[n], n, intra, last[n], dst, stride);
    }
  }

  void intra_mb(int cbpc, bool dquant) {
    bool ac_pred = bs.u1("ac_pred_flag");
    int cbpy = tables().cbpy.read(bs, "cbpy");
    int cbp = (cbpc & 3) | (cbpy << 2);
    bool use_dc_vlc = qscale < dc_thr;     // the quantiser before this macroblock's dquant
    if (dquant) set_qscale(qscale + kDquant[bs.u(2, "dquant")]);
    qscale_table[mb_y * mbw + mb_x] = int8_t(qscale);
    for (int i = 0; i < 4; ++i) set_mv(i, 0, 0);
    residual(cbp, true, ac_pred, use_dc_vlc);
  }

  void p_mb() {
    const int xy = mb_y * mbw + mb_x;
    int cbpc;
    for (;;) {
      if (bs.u1("not_coded")) {
        cur->not_coded[xy] = 1;
        for (int i = 0; i < 4; ++i) set_mv(i, 0, 0);
        qscale_table[xy] = int8_t(qscale);
        mc_16x16(*future, 0, 0, false);
        return;
      }
      cbpc = tables().mcbpc_p.read(bs, "mcbpc");
      if (cbpc != 20) break;                   // stuffing
    }
    int type = cbpc >> 2;
    if (type == 3 || type == 4) {
      intra_mb(cbpc & 3, type == 4);
      return;
    }
    int cbpy = tables().cbpy.read(bs, "cbpy") ^ 15;
    int cbp = (cbpc & 3) | (cbpy << 2);
    if (type == 1) set_qscale(qscale + kDquant[bs.u(2, "dquant")]);
    qscale_table[xy] = int8_t(qscale);
    if (type == 2) {
      int mv[4][2];
      cur->four_mv[xy] = 1;
      for (int i = 0; i < 4; ++i) {
        int px, py;
        pred_motion(i, &px, &py);
        mv[i][0] = decode_motion(px, f_code);
        mv[i][1] = decode_motion(py, f_code);
        set_mv(i, mv[i][0], mv[i][1]);
      }
      mc_8x8(*future, mv, false);
    } else {
      int px, py;
      pred_motion(0, &px, &py);
      int mx = decode_motion(px, f_code), my = decode_motion(py, f_code);
      for (int i = 0; i < 4; ++i) set_mv(i, mx, my);
      mc_16x16(*future, mx, my, false);
    }
    residual(cbp, false, false, false);
  }

  // direct-mode vectors of block i from the future reference's co-located vector
  void direct_mv(int i, int dx, int dy, int (*fwd)[2], int (*bwd)[2]) {
    int bx = 2 * mb_x + (i & 1), by = 2 * mb_y + (i >> 1);
    const int16_t* p = &future->mv[2 * (size_t(by) * 2 * mbw + bx)];
    int d[2] = {dx, dy};
    for (int k = 0; k < 2; ++k) {
      int pm = p[k];
      fwd[i][k] = pm * pb_time / pp_time + d[k];
      bwd[i][k] = d[k] ? fwd[i][k] - pm : pm * (pb_time - pp_time) / pp_time;
    }
  }

  void b_mb() {
    const int xy = mb_y * mbw + mb_x;
    if (mb_x == 0) std::memset(last_mv, 0, sizeof(last_mv));
    if (future->not_coded[xy]) {               // skipped: forward, vector zero
      mc_16x16(*past, 0, 0, false);
      return;
    }
    int mode, cbp = 0, dx = 0, dy = 0;         // mode: 0 direct, 1 interpolate, 2 backward, 3 forward
    if (bs.u1("modb")) {
      mode = 0;
    } else {
      bool no_cbp = bs.u1("modb");
      mode = tables().mb_type_b.read(bs, "mb_type");
      if (!no_cbp) cbp = bs.u(6, "cbpb");
      if (mode != 0 && cbp && bs.u1("dbquant")) set_qscale(qscale + (bs.u1("dbquant") ? 2 : -2));
      if (mode == 1 || mode == 3) {
        last_mv[0][0] = decode_motion(last_mv[0][0], f_code);
        last_mv[0][1] = decode_motion(last_mv[0][1], f_code);
      }
      if (mode == 1 || mode == 2) {
        last_mv[1][0] = decode_motion(last_mv[1][0], b_code);
        last_mv[1][1] = decode_motion(last_mv[1][1], b_code);
      }
      if (mode == 0) {
        dx = decode_motion(0, 1);
        dy = decode_motion(0, 1);
      }
    }
    if (mode == 0) {
      int fwd[4][2], bwd[4][2];
      bool eight = future->four_mv[xy] || quarter;
      if (future->four_mv[xy]) {
        for (int i = 0; i < 4; ++i) direct_mv(i, dx, dy, fwd, bwd);
      } else {
        direct_mv(0, dx, dy, fwd, bwd);
        for (int i = 1; i < 4; ++i) {
          std::memcpy(fwd[i], fwd[0], sizeof(fwd[0]));
          std::memcpy(bwd[i], bwd[0], sizeof(bwd[0]));
        }
      }
      if (eight) {
        mc_8x8(*past, fwd, false);
        mc_8x8(*future, bwd, true);
      } else {
        mc_16x16(*past, fwd[0][0], fwd[0][1], false);
        mc_16x16(*future, bwd[0][0], bwd[0][1], true);
      }
    } else {
      if (mode == 1 || mode == 3) mc_16x16(*past, last_mv[0][0], last_mv[0][1], false);
      if (mode == 1 || mode == 2) mc_16x16(*future, last_mv[1][0], last_mv[1][1], mode == 1);
    }
    residual(cbp, false, false, false);
  }

  void i_mb() {
    int cbpc;
    do cbpc = tables().mcbpc_i.read(bs, "mcbpc");
    while (cbpc == 8);
    intra_mb(cbpc & 3, cbpc & 4);
  }

  // a resync marker at the position (after next_resync_marker's stuffing)? then the first
  // macroblock number of the packet after it, else -1
  int resync_at() {
    long left = bs.left();
    int stuff = 8 - int(bs.pos & 7);           // '0' then up to 7 '1's
    if (left < stuff + 17) return -1;
    if (bs.peek(stuff) != (1u << (stuff - 1)) - 1) return -1;
    int prefix = vop_type == I_VOP   ? 16
                 : vop_type == P_VOP ? f_code + 15
                                     : std::max({f_code, b_code, 2}) + 15;
    Bits b = bs;
    b.skip(stuff);
    int zeros = 0;
    while (zeros < 32 && b.left() > 0 && !b.u1("resync_marker")) ++zeros;
    if (zeros < prefix) return -1;
    int bits = 1;
    while ((1 << bits) < mbw * mbh) ++bits;
    return int(b.u(bits, "macroblock_number"));
  }

  // video_packet_header after the resync marker
  void packet_header(int expect) {
    bs.skip(8 - int(bs.pos & 7));
    while (!bs.u1("resync_marker")) {
    }
    int bits = 1;
    while ((1 << bits) < mbw * mbh) ++bits;
    int mb_num = bs.u(bits, "macroblock_number");
    if (mb_num != expect)
      fail("a video packet starts at macroblock " + std::to_string(mb_num) + ", not " +
           std::to_string(expect));
    int q = bs.u(5, "quant_scale");
    if (q) set_qscale(q);
    if (bs.u1("header_extension_code")) {
      while (bs.u1("modulo_time_base")) {
      }
      bs.marker("before vop_time_increment in the video packet header");
      bs.skip(time_bits);
      bs.marker("after vop_time_increment in the video packet header");
      bs.skip(2);                                 // vop_coding_type
      bs.skip(3);                                 // intra_dc_vlc_thr
      if (vop_type != I_VOP && bs.u(3, "vop_fcode_forward") == 0)
        fail("vop_fcode_forward 0 in the video packet header");
      if (vop_type == B_VOP && bs.u(3, "vop_fcode_backward") == 0)
        fail("vop_fcode_backward 0 in the video packet header");
    }
  }

  // --------------------------------------------------------------- VOPs --

  void decode_vop(const uint8_t* d, size_t n) {
    if (!have_vol) fail("a VOP before any video object layer header");
    set_bugs();
    if ((bugs & BUG_STD_QPEL) && quarter)
      fail("quarter_sample from a libavcodec build before 4653 (ffmpeg's old quarter-sample filter) "
           "is not supported");
    bs = Bits(d, n);
    vop_type = bs.u(2, "vop_coding_type");
    if (vop_type == S_VOP) fail("an S-VOP (sprite) is not supported");
    int incr = 0;
    while (bs.u1("modulo_time_base")) ++incr;
    bs.marker("before vop_time_increment");
    int time_inc = bs.u(time_bits, "vop_time_increment");
    bs.marker("after vop_time_increment");
    int64_t time;
    if (vop_type != B_VOP) {
      last_time_base = time_base;
      time_base += incr;
      time = time_base * time_res + time_inc;
      pp_time = int(time - last_non_b_time);
      last_non_b_time = time;
    } else {
      time = (last_time_base + incr) * time_res + time_inc;
      pb_time = int(pp_time - (last_non_b_time - time));
    }
    out_time = time;
    out_type = vop_type;
    if (!bs.u1("vop_coded")) {
      // not coded: the picture repeats the last reference, which stays the reference
      if (!future) fail("a not-coded VOP before any reference VOP");
      out_coded = 0;
      shown = future.get();
      return;
    }
    out_coded = 1;
    if (vop_type == B_VOP) {
      if (!past || !future) fail("a B-VOP without two reference VOPs (its past reference is not held)");
      if (pp_time <= pb_time || pp_time <= pp_time - pb_time || pp_time <= 0)
        fail("B-VOP time " + std::to_string(time) + " does not lie between its references' times");
    }
    if (vop_type == P_VOP && !future) fail("a P-VOP without a reference VOP");
    rounding = vop_type == P_VOP ? bs.u1("vop_rounding_type") : 0;
    dc_thr = kDcThreshold[bs.u(3, "intra_dc_vlc_thr")];
    qscale = vop_quant = bs.u(5, "vop_quant");
    if (qscale == 0) fail("vop_quant 0");
    f_code = b_code = 1;
    if (vop_type != I_VOP) {
      f_code = bs.u(3, "vop_fcode_forward");
      if (f_code == 0) fail("vop_fcode_forward 0");
    }
    if (vop_type == B_VOP) {
      b_code = bs.u(3, "vop_fcode_backward");
      if (b_code == 0) fail("vop_fcode_backward 0");
    }
    auto pic = std::make_unique<Picture>(mbw, mbh);
    pic->time = time;
    pic->type = vop_type;
    cur = pic.get();
    b8_stride = 2 * mbw + 1;
    mb_stride = mbw + 1;
    dc_val[0].assign(size_t(b8_stride) * (2 * mbh + 1) + 1, 1024);
    ac_val[0].assign(dc_val[0].size() * 16, 0);
    for (int c = 1; c < 3; ++c) {
      dc_val[c].assign(size_t(mb_stride) * (mbh + 1) + 1, 1024);
      ac_val[c].assign(dc_val[c].size() * 16, 0);
    }
    mv_grid.assign(dc_val[0].size() * 2, 0);
    qscale_table.assign(size_t(mbw) * mbh, 0);
    std::memset(last_mv, 0, sizeof(last_mv));
    const int total = mbw * mbh;
    int index = 0;
    resync_x = resync_y = 0;
    mb_x = mb_y = 0;
    first_slice_line = true;
    while (index < total) {
      mb_x = index % mbw;
      mb_y = index / mbw;
      if (mb_x == resync_x && mb_y == resync_y + 1) first_slice_line = false;
      if (vop_type == I_VOP) i_mb();
      else if (vop_type == P_VOP) p_mb();
      else b_mb();
      if (bs.pos > bs.n_bits)
        fail(std::string("the ") + kVopName[vop_type] + " ends inside macroblock " + std::to_string(index));
      ++index;
      if (index < total && !resync_disable) {
        // a packet that starts further on leaves macroblocks between without bits: B-VOP
        // macroblocks skipped for their co-located ones (ffmpeg reads on to its number)
        int next = resync_at();
        if (next >= 0 && next <= index) {
          packet_header(index);
          mb_x = index % mbw;
          mb_y = index / mbw;
          resync_x = mb_x;
          resync_y = mb_y;
          first_slice_line = true;
          clean_buffers();
        }
      }
    }
    // the grid's vectors, unguarded, for direct mode of the B-VOPs that follow
    if (vop_type != B_VOP) {
      for (int by = 0; by < 2 * mbh; ++by)
        for (int bx = 0; bx < 2 * mbw; ++bx)
          for (int k = 0; k < 2; ++k)
            pic->mv[2 * (size_t(by) * 2 * mbw + bx) + k] = mv_grid[2 * lum_index(bx, by) + k];
      past = std::move(future);
      future = std::move(pic);
      shown = future.get();
    } else {
      b_pic = std::move(pic);
      shown = b_pic.get();
    }
    cur = nullptr;
  }

  void reset() {
    past.reset();
    future.reset();
    b_pic.reset();
    shown = nullptr;
    time_base = last_time_base = last_non_b_time = 0;
    pp_time = pb_time = 0;
  }

  void output(uint8_t* y, uint8_t* u, uint8_t* v) const {
    const int lw = mbw * 16, cw = mbw * 8, ch = (height + 1) / 2, cwo = (width + 1) / 2;
    for (int j = 0; j < height; ++j) std::memcpy(y + size_t(j) * width, &shown->y[size_t(j) * lw], width);
    for (int j = 0; j < ch; ++j) {
      std::memcpy(u + size_t(j) * cwo, &shown->u[size_t(j) * cw], cwo);
      std::memcpy(v + size_t(j) * cwo, &shown->v[size_t(j) * cw], cwo);
    }
  }
};

}  // namespace mpeg4
}  // namespace

extern "C" {

// A decoder from the DecoderSpecificInfo (the VOS, VO and VOL headers; may be empty when they
// come in band). Returns null and fills err on failure.
void* c4d_mpeg4_open(const uint8_t* dsi, long n, char* err, int err_cap) {
  auto* d = new mpeg4::Decoder();
  try {
    if (n > 0 && d->parse(dsi, size_t(n))) mpeg4::fail("a VOP in the DecoderSpecificInfo");
    return d;
  } catch (const std::exception& e) {
    std::snprintf(err, err_cap, "%s", e.what());
    delete d;
    return nullptr;
  }
}

// The VOL's size and colour signal (video_range, matrix_coefficients: 0 and 2 without a
// video_signal_type); 0 on success, -1 before any VOL header.
int c4d_mpeg4_info(void* dec, int* width, int* height, int* full_range, int* matrix) {
  auto* d = static_cast<mpeg4::Decoder*>(dec);
  if (!d->have_vol) return -1;
  *width = d->width;
  *height = d->height;
  *full_range = d->full_range;
  *matrix = d->matrix;
  return 0;
}

// Decode one sample into caller-owned planes of the VOL's size (width x height luma,
// ceil(width/2) x ceil(height/2) chroma); info[0..3] receive the VOP's time (in ticks of
// vop_time_increment_resolution), its coding type (0 I, 1 P, 2 B), whether the Xvid IDCT
// decoded it, and its vop_quant (0 when it was not coded: a not-coded VOP repeats the last
// reference). Returns 0, or -1 with the reason in err (after which the decoder holds no
// references).
int c4d_mpeg4_decode(void* dec, const uint8_t* sample, long n, uint8_t* y, uint8_t* u, uint8_t* v,
                     int width, int height, long long* info, char* err, int err_cap) {
  auto* d = static_cast<mpeg4::Decoder*>(dec);
  try {
    if (!d->parse(sample, size_t(n))) mpeg4::fail("the sample holds no VOP");
    if (d->width != width || d->height != height)
      mpeg4::fail("the VOL is " + std::to_string(d->width) + "x" + std::to_string(d->height) + ", not " +
                  std::to_string(width) + "x" + std::to_string(height));
    d->output(y, u, v);
    info[0] = d->out_time;
    info[1] = d->out_type;
    info[2] = d->xvid_build >= 0;
    info[3] = d->out_coded ? d->vop_quant : 0;
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, err_cap, "%s", e.what());
    d->reset();
    return -1;
  }
}

// The first VOP of a sample (or of its first n bytes), read up to vop_coded without decoding:
// type (0 I, 1 P, 2 B, 3 S; -1 when the bytes hold no VOP) and coded. Headers before it (a
// VOL in band) are taken as decoding takes them. Returns 0, or -1 with the reason in err.
int c4d_mpeg4_scan(void* dec, const uint8_t* sample, long n, int* type, int* coded, char* err, int err_cap) {
  auto* d = static_cast<mpeg4::Decoder*>(dec);
  try {
    d->scan_type = -1;
    d->scan_coded = 0;
    d->parse(sample, size_t(n), true);
    *type = d->scan_type;
    *coded = d->scan_coded;
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, err_cap, "%s", e.what());
    return -1;
  }
}

// Forget the reference VOPs and the times (before decoding from a sync sample).
void c4d_mpeg4_reset(void* dec) { static_cast<mpeg4::Decoder*>(dec)->reset(); }

void c4d_mpeg4_close(void* dec) { delete static_cast<mpeg4::Decoder*>(dec); }

}  // extern "C"

// libavcodec's simple IDCT for the runtime's Motion-JPEG planes (cap4d_runtime.cpp): the
// residual of a raster-order block, before clipping.
void c4d_simple_idct(int16_t* blk, int* res) { mpeg4::simple::idct(blk, res); }
