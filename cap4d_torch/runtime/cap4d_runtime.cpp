// cap4d_torch native runtime: threaded image decode + fused crop/resize
// loader, and a JPEG encoder.
//
// The port's own copy of the JAX package's runtime. Its crop, resize,
// [-1, 1] normalisation, prefetch pool and C entry points are that file's,
// unchanged, so a frame loads to the same floats. The codecs differ: the
// card's machine has neither libpng nor libjpeg (headers or libraries), so
// this file carries its own, with no dependency beyond the C++ standard
// library and pthreads:
//
//   - inflate (RFC 1951) and a PNG decoder (every colour type and bit depth,
//     Adam7), normalised to 8-bit RGB as the JAX runtime asks libpng to:
//     16-bit samples keep their high byte, low-depth grey is scaled to 8
//     bits, palettes expand, alpha (and tRNS) is dropped;
//   - a JPEG decoder for Huffman-coded JPEGs (baseline, extended and
//     progressive; 8-bit, one or three components, any sampling factors)
//     that reproduces libjpeg's default decode bit for bit: the integer
//     "islow" IDCT and its range limit, "fancy" triangle upsampling for
//     h2v1, h1v2 and h2v2 chroma (edges replicated as libjpeg's context
//     rows are), and its fixed-point YCbCr to RGB tables. Arithmetic-coded,
//     lossless and hierarchical JPEGs, 12-bit samples, CMYK, and progressive
//     files whose scans leave low coefficients unrefined (libjpeg smooths
//     those blocks) are refused with their own status;
//   - a JPEG encoder with libjpeg's defaults: islow forward DCT, the
//     standard quantisation tables scaled by quality, 4:2:0 chroma averaged
//     with libjpeg's alternating bias, edge replication and dummy blocks as
//     libjpeg pads, the standard Huffman tables, a JFIF header.
//
// C ABI only (consumed via ctypes). Status codes are the C4D_* values below.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Status {
  C4D_OK = 0,
  C4D_EOPEN = -1,          // the file cannot be opened or read
  C4D_ECAPACITY = -2,      // the caller's buffer is too small
  C4D_EFORMAT = -3,        // neither PNG nor JPEG
  C4D_ECORRUPT_PNG = -4,   // a malformed or truncated PNG
  C4D_ECORRUPT_JPEG = -5,  // a malformed or truncated JPEG
  C4D_EUNSUPPORTED = -6,   // a JPEG this decoder does not take (see above)
  C4D_EWRITE = -7,         // the output file cannot be written
  C4D_EARG = -8,           // invalid arguments
};

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h*w*3
};

// ============================================================== inflate ====

struct InflateBits {
  const uint8_t* p;
  size_t n, pos = 0;  // pos counts bytes loaded, zero bytes past the end too
  uint64_t buf = 0;
  int cnt = 0;
  void fill() {
    while (cnt <= 56) {
      buf |= static_cast<uint64_t>(pos < n ? p[pos] : 0) << cnt;
      ++pos;
      cnt += 8;
    }
  }
  uint32_t bits(int k) {  // k <= 32
    if (k == 0) return 0;
    if (cnt < k) fill();
    const uint32_t v = static_cast<uint32_t>(buf & ((uint64_t(1) << k) - 1));
    buf >>= k;
    cnt -= k;
    return v;
  }
  bool overrun() const {  // consumed more bits than the stream holds
    return pos * 8 - cnt > n * 8;
  }
};

struct InflateHuffman {
  int16_t count[16];
  int16_t symbol[320];
  uint16_t fast[1 << 10];  // (len << 9) | symbol for codes of <= 10 bits
};

bool build_inflate_huffman(InflateHuffman* h, const uint8_t* lengths, int n) {
  std::memset(h->count, 0, sizeof(h->count));
  for (int i = 0; i < n; ++i) h->count[lengths[i]]++;
  h->count[0] = 0;
  int left = 1;
  for (int len = 1; len < 16; ++len) {
    left <<= 1;
    left -= h->count[len];
    if (left < 0) return false;  // over-subscribed
  }
  int offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + h->count[len];
  for (int i = 0; i < n; ++i)
    if (lengths[i]) h->symbol[offs[lengths[i]]++] = static_cast<int16_t>(i);
  // fast table: codes are canonical MSB-first, the stream is LSB-first
  std::memset(h->fast, 0, sizeof(h->fast));
  int code = 0, index = 0;
  for (int len = 1; len <= 10; ++len) {
    for (int k = 0; k < h->count[len]; ++k) {
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
      const uint16_t e = static_cast<uint16_t>((len << 9) | h->symbol[index + k]);
      for (int f = rev; f < (1 << 10); f += 1 << len) h->fast[f] = e;
      ++code;
    }
    index += h->count[len];
    code <<= 1;
  }
  return true;
}

int inflate_decode(InflateBits& br, const InflateHuffman& h) {
  if (br.cnt < 15) br.fill();
  const uint16_t e = h.fast[br.buf & 1023];
  if (e) {
    br.buf >>= e >> 9;
    br.cnt -= e >> 9;
    return e & 511;
  }
  int code = 0, first = 0, index = 0;
  for (int len = 1; len < 16; ++len) {
    code |= static_cast<int>(br.bits(1));
    const int count = h.count[len];
    if (code - count < first) return h.symbol[index + (code - first)];
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  return -1;
}

const uint16_t kLenBase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                                193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                                6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// zlib stream (RFC 1950) → exactly `expect` bytes; false on any defect.
bool zlib_inflate(const uint8_t* data, size_t n, size_t expect, std::vector<uint8_t>* out) {
  if (n < 6) return false;
  const int cmf = data[0], flg = data[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 != 0 || (flg & 32))
    return false;
  out->clear();
  out->reserve(expect);
  InflateBits br{data + 2, n - 2};
  InflateHuffman lit, dist;
  bool final_block = false;
  while (!final_block) {
    final_block = br.bits(1);
    const int type = static_cast<int>(br.bits(2));
    if (type == 0) {
      br.bits(br.cnt & 7);  // to a byte boundary
      const uint32_t len = br.bits(16), nlen = br.bits(16);
      if ((len ^ 0xFFFF) != nlen || out->size() + len > expect) return false;
      for (uint32_t i = 0; i < len; ++i) out->push_back(static_cast<uint8_t>(br.bits(8)));
    } else if (type == 1 || type == 2) {
      if (type == 1) {
        uint8_t l[320];
        for (int i = 0; i < 144; ++i) l[i] = 8;
        for (int i = 144; i < 256; ++i) l[i] = 9;
        for (int i = 256; i < 280; ++i) l[i] = 7;
        for (int i = 280; i < 288; ++i) l[i] = 8;
        build_inflate_huffman(&lit, l, 288);
        for (int i = 0; i < 30; ++i) l[i] = 5;
        build_inflate_huffman(&dist, l, 30);
      } else {
        static const uint8_t order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                          11, 4, 12, 3, 13, 2, 14, 1, 15};
        const int nlen = static_cast<int>(br.bits(5)) + 257;
        const int ndist = static_cast<int>(br.bits(5)) + 1;
        const int ncode = static_cast<int>(br.bits(4)) + 4;
        if (nlen > 286 || ndist > 30) return false;
        uint8_t lengths[320] = {0};
        for (int i = 0; i < ncode; ++i) lengths[order[i]] = static_cast<uint8_t>(br.bits(3));
        InflateHuffman lencode;
        if (!build_inflate_huffman(&lencode, lengths, 19)) return false;
        int idx = 0;
        while (idx < nlen + ndist) {
          int sym = inflate_decode(br, lencode);
          if (sym < 0) return false;
          if (sym < 16) {
            lengths[idx++] = static_cast<uint8_t>(sym);
          } else {
            int len = 0, rep;
            if (sym == 16) {
              if (idx == 0) return false;
              len = lengths[idx - 1];
              rep = 3 + static_cast<int>(br.bits(2));
            } else if (sym == 17) {
              rep = 3 + static_cast<int>(br.bits(3));
            } else {
              rep = 11 + static_cast<int>(br.bits(7));
            }
            if (idx + rep > nlen + ndist) return false;
            while (rep--) lengths[idx++] = static_cast<uint8_t>(len);
          }
          if (br.overrun()) return false;
        }
        if (lengths[256] == 0) return false;
        if (!build_inflate_huffman(&lit, lengths, nlen)) return false;
        if (!build_inflate_huffman(&dist, lengths + nlen, ndist)) return false;
      }
      for (;;) {
        int sym = inflate_decode(br, lit);
        if (sym < 0) return false;
        if (sym < 256) {
          if (out->size() >= expect) return false;
          out->push_back(static_cast<uint8_t>(sym));
        } else if (sym == 256) {
          break;
        } else {
          sym -= 257;
          if (sym >= 29) return false;
          const size_t len = kLenBase[sym] + br.bits(kLenExtra[sym]);
          const int ds = inflate_decode(br, dist);
          if (ds < 0 || ds >= 30) return false;
          const size_t d = kDistBase[ds] + br.bits(kDistExtra[ds]);
          if (d > out->size() || out->size() + len > expect) return false;
          const size_t from = out->size() - d;
          for (size_t i = 0; i < len; ++i) out->push_back((*out)[from + i]);
        }
        if (br.overrun()) return false;
      }
    } else {
      return false;
    }
    if (br.overrun()) return false;
  }
  return out->size() == expect;
}

// ================================================================== PNG ====

uint32_t crc32_table(int i) {
  uint32_t c = static_cast<uint32_t>(i);
  for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
  return c;
}

uint32_t crc32(const uint8_t* p, size_t n) {
  static const std::vector<uint32_t> table = [] {
    std::vector<uint32_t> t(256);
    for (int i = 0; i < 256; ++i) t[i] = crc32_table(i);
    return t;
  }();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the filters of `rows` rows of `stride` bytes in place (filter byte
// first in each row); `bpp` is the filter's byte distance.
bool png_unfilter(uint8_t* data, size_t rows, size_t stride, int bpp) {
  const uint8_t* prev = nullptr;
  for (size_t y = 0; y < rows; ++y) {
    uint8_t* row = data + y * (stride + 1);
    const int type = row[0];
    uint8_t* x = row + 1;
    switch (type) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < stride; ++i) x[i] = static_cast<uint8_t>(x[i] + x[i - bpp]);
        break;
      case 2:
        if (prev)
          for (size_t i = 0; i < stride; ++i) x[i] = static_cast<uint8_t>(x[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= static_cast<size_t>(bpp) ? x[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          x[i] = static_cast<uint8_t>(x[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= static_cast<size_t>(bpp) ? x[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= static_cast<size_t>(bpp)) ? prev[i - bpp] : 0;
          x[i] = static_cast<uint8_t>(x[i] + paeth(a, b, c));
        }
        break;
      default:
        return false;
    }
    prev = x;
  }
  return true;
}

int decode_png_buffer(const uint8_t* d, size_t n, Image* img) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A, 0x0A};
  if (n < 8 || std::memcmp(d, sig, 8) != 0) return C4D_ECORRUPT_PNG;
  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = -1, interlace = 0;
  uint8_t palette[256][3];
  std::memset(palette, 0, sizeof(palette));
  std::vector<uint8_t> idat;
  bool seen_ihdr = false, seen_iend = false;
  while (pos + 12 <= n && !seen_iend) {
    const uint32_t len = be32(d + pos);
    if (len > n - pos - 12) return C4D_ECORRUPT_PNG;
    const uint8_t* type = d + pos + 4;
    const uint8_t* body = d + pos + 8;
    const bool critical = !(type[0] & 0x20);
    if (crc32(type, len + 4) != be32(body + len)) {
      if (critical) return C4D_ECORRUPT_PNG;  // libpng discards ancillary ones
    } else if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13 || seen_ihdr) return C4D_ECORRUPT_PNG;
      w = be32(body);
      h = be32(body + 4);
      depth = body[8];
      ctype = body[9];
      interlace = body[12];
      if (body[10] != 0 || body[11] != 0 || interlace > 1) return C4D_ECORRUPT_PNG;
      seen_ihdr = true;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      if (len % 3 || len > 768) return C4D_ECORRUPT_PNG;
      std::memcpy(palette, body, len);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      seen_iend = true;
    }
    pos += 12 + static_cast<size_t>(len);
  }
  if (!seen_ihdr || w == 0 || h == 0 || w > (1u << 24) || h > (1u << 24)) return C4D_ECORRUPT_PNG;
  int channels;
  switch (ctype) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 3: channels = 1; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return C4D_ECORRUPT_PNG;
  }
  const bool depth_ok =
      (ctype == 0 && (depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16)) ||
      (ctype == 3 && (depth == 1 || depth == 2 || depth == 4 || depth == 8)) ||
      ((ctype == 2 || ctype == 4 || ctype == 6) && (depth == 8 || depth == 16));
  if (!depth_ok) return C4D_ECORRUPT_PNG;
  const int bits_pp = channels * depth;
  const int bpp = std::max(1, bits_pp / 8);

  // Adam7 passes (x0, y0, dx, dy); one pass of the whole image otherwise
  static const int adam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                  {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int whole[1][4] = {{0, 0, 1, 1}};
  const int n_pass = interlace ? 7 : 1;
  const int(*passes)[4] = interlace ? adam7 : whole;
  size_t total = 0;
  size_t pw[7], ph[7], pstride[7];
  for (int p = 0; p < n_pass; ++p) {
    pw[p] = (w + passes[p][2] - 1 - passes[p][0]) / passes[p][2];
    ph[p] = (h + passes[p][3] - 1 - passes[p][1]) / passes[p][3];
    if (w <= static_cast<uint32_t>(passes[p][0])) pw[p] = 0;
    if (h <= static_cast<uint32_t>(passes[p][1])) ph[p] = 0;
    pstride[p] = (pw[p] * bits_pp + 7) / 8;
    if (pw[p] && ph[p]) total += ph[p] * (pstride[p] + 1);
  }
  std::vector<uint8_t> raw;
  if (!zlib_inflate(idat.data(), idat.size(), total, &raw)) return C4D_ECORRUPT_PNG;

  img->w = static_cast<int>(w);
  img->h = static_cast<int>(h);
  img->rgb.assign(static_cast<size_t>(w) * h * 3, 0);
  const int maxv = (1 << depth) - 1;
  size_t off = 0;
  for (int p = 0; p < n_pass; ++p) {
    if (!pw[p] || !ph[p]) continue;
    uint8_t* data = raw.data() + off;
    if (!png_unfilter(data, ph[p], pstride[p], bpp)) return C4D_ECORRUPT_PNG;
    for (size_t py = 0; py < ph[p]; ++py) {
      const uint8_t* row = data + py * (pstride[p] + 1) + 1;
      const size_t y = passes[p][1] + py * passes[p][3];
      for (size_t px = 0; px < pw[p]; ++px) {
        const size_t x = passes[p][0] + px * passes[p][2];
        uint8_t* o = img->rgb.data() + (y * w + x) * 3;
        if (depth == 8 || depth == 16) {
          const int step = depth / 8;  // 16-bit samples keep their high byte
          const uint8_t* s = row + px * channels * step;
          if (ctype == 3) {
            std::memcpy(o, palette[s[0]], 3);
          } else if (channels <= 2) {
            o[0] = o[1] = o[2] = s[0];
          } else {
            o[0] = s[0];
            o[1] = s[step];
            o[2] = s[2 * step];
          }
        } else {
          const size_t bit = px * depth;
          const int v = (row[bit >> 3] >> (8 - depth - (bit & 7))) & maxv;
          if (ctype == 3) {
            std::memcpy(o, palette[v], 3);
          } else {
            o[0] = o[1] = o[2] = static_cast<uint8_t>(v * 255 / maxv);
          }
        }
      }
    }
    off += ph[p] * (pstride[p] + 1);
  }
  return C4D_OK;
}

// ================================================================= JPEG ====

const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};  // corrupt-run guard

// islow fixed point (CONST_BITS 13, PASS1_BITS 2), shared by both DCTs
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

inline int32_t descale64(int64_t x, int n) {
  return static_cast<int32_t>((x + (int64_t(1) << (n - 1))) >> n);
}

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// libjpeg's post-IDCT range limit: the index is masked to 10 bits first
inline uint8_t idct_range_limit(int32_t x) {
  const int i = x & 1023;
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

// jpeg_idct_islow: coef in natural order, quant in natural order
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int out_stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int32_t* wp = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      const int32_t dc = (in[0] * q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * q[16], z3 = int64_t(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    z2 = int64_t(in[0]) * q[0];
    z3 = int64_t(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * q[56];
    tmp1 = int64_t(in[40]) * q[40];
    tmp2 = int64_t(in[24]) * q[24];
    tmp3 = int64_t(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    wp[0] = descale64(tmp10 + tmp3, s);
    wp[56] = descale64(tmp10 - tmp3, s);
    wp[8] = descale64(tmp11 + tmp2, s);
    wp[48] = descale64(tmp11 - tmp2, s);
    wp[16] = descale64(tmp12 + tmp1, s);
    wp[40] = descale64(tmp12 - tmp1, s);
    wp[24] = descale64(tmp13 + tmp0, s);
    wp[32] = descale64(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* o = out + r * out_stride;
    constexpr int s = kConstBits + kPass1Bits + 3;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t v = idct_range_limit(descale64(wp[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_range_limit(descale64(tmp10 + tmp3, s));
    o[7] = idct_range_limit(descale64(tmp10 - tmp3, s));
    o[1] = idct_range_limit(descale64(tmp11 + tmp2, s));
    o[6] = idct_range_limit(descale64(tmp11 - tmp2, s));
    o[2] = idct_range_limit(descale64(tmp12 + tmp1, s));
    o[5] = idct_range_limit(descale64(tmp12 - tmp1, s));
    o[3] = idct_range_limit(descale64(tmp13 + tmp0, s));
    o[4] = idct_range_limit(descale64(tmp13 - tmp0, s));
  }
}

struct JpegHuffman {
  uint8_t bits[17];  // bits[l]: number of codes of length l
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint16_t lookup[1 << 9];  // (len << 8) | value for codes of <= 9 bits; 0 = none
  bool defined = false;
};

bool build_jpeg_huffman(JpegHuffman* t) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += t->bits[l];
  if (count > 256) return false;
  int code = 0, k = 0;
  std::memset(t->lookup, 0, sizeof(t->lookup));
  for (int l = 1; l <= 16; ++l) {
    t->valoffset[l] = k - code;
    for (int i = 0; i < t->bits[l]; ++i, ++k, ++code) {
      if (l <= 9) {
        const int shift = 9 - l;
        for (int f = 0; f < (1 << shift); ++f)
          t->lookup[(code << shift) | f] = static_cast<uint16_t>((l << 8) | t->vals[k]);
      }
    }
    t->maxcode[l] = t->bits[l] ? code - 1 : -1;
    if (code > (1 << l)) return false;
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  t->defined = true;
  return true;
}

struct JpegBits {
  const uint8_t* p;
  size_t n, pos;
  uint32_t buf = 0;  // MSB-aligned
  int cnt = 0;
  bool hit_marker = false;
  void fill() {
    while (cnt <= 24) {
      int byte = 0;
      if (!hit_marker && pos < n) {
        byte = p[pos];
        if (byte == 0xFF) {
          const int next = pos + 1 < n ? p[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {  // a marker: feed zeros from here, as libjpeg does
            hit_marker = true;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= static_cast<uint32_t>(byte) << (24 - cnt);
      cnt += 8;
    }
  }
  int bits(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    const int v = static_cast<int>(buf >> (32 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int decode(const JpegHuffman& t) {
    if (cnt < 16) fill();
    const uint16_t e = t.lookup[buf >> 23];
    if (e) {
      const int l = e >> 8;
      buf <<= l;
      cnt -= l;
      return e & 0xFF;
    }
    int l = 10;
    int code = static_cast<int>(buf >> (32 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = static_cast<int>(buf >> (32 - l));
    }
    if (l > 16) return -1;
    buf <<= l;
    cnt -= l;
    return t.vals[(t.valoffset[l] + code) & 0xFF];
  }
  void reset() {
    buf = 0;
    cnt = 0;
    hit_marker = false;
  }
};

inline int jpeg_extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct JpegComponent {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int wib = 0, hib = 0;  // blocks holding image data
  int bw = 0, bh = 0;    // blocks stored (whole MCUs)
  int dw = 0, dh = 0;    // downsampled size in samples
  std::vector<int16_t> coef;
  int pred = 0;
};

struct JpegDecoder {
  const uint8_t* d;
  size_t n, pos = 2;
  uint16_t qt[4][64];  // natural order
  bool qt_set[4] = {false, false, false, false};
  JpegHuffman dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool frame = false, progressive = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  JpegComponent comp[4];
  // progressive scans: the scan's band and bit positions, the end-of-band
  // run, and per component the lowest bit known of each coefficient (-1:
  // none yet), as libjpeg's coef_bits
  int ss = 0, se = 63, ah = 0, al = 0, eobrun = 0;
  int coef_bits[4][64];

  int u16(size_t at) const { return (d[at] << 8) | d[at + 1]; }

  // baseline / extended sequential: the whole block in one scan
  int decode_block(JpegBits& br, JpegComponent& c, int16_t* blk) {
    const int t = br.decode(dc[c.td]);
    if (t < 0 || t > 15) return C4D_ECORRUPT_JPEG;
    const int diff = t ? jpeg_extend(br.bits(t), t) : 0;
    c.pred += diff;
    blk[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(ac[c.ta]);
      if (rs < 0) return C4D_ECORRUPT_JPEG;
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNaturalOrder[k]] = static_cast<int16_t>(jpeg_extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return C4D_OK;
  }

  // progressive DC scans (jdphuff.c decode_mcu_DC_first / _refine)
  int decode_dc_progressive(JpegBits& br, JpegComponent& c, int16_t* blk) {
    if (ah) {
      if (br.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      return C4D_OK;
    }
    const int t = br.decode(dc[c.td]);
    if (t < 0 || t > 15) return C4D_ECORRUPT_JPEG;
    c.pred += t ? jpeg_extend(br.bits(t), t) : 0;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al);
    return C4D_OK;
  }

  // progressive AC scans of band [ss, se] (decode_mcu_AC_first / _refine)
  int decode_ac_progressive(JpegBits& br, JpegComponent& c, int16_t* blk) {
    if (!ah) {
      if (eobrun > 0) {
        --eobrun;
        return C4D_OK;
      }
      for (int k = ss; k <= se; ++k) {
        const int rs = br.decode(ac[c.ta]);
        if (rs < 0) return C4D_ECORRUPT_JPEG;
        int r = rs >> 4;
        const int s = rs & 15;
        if (s) {
          k += r;
          blk[kNaturalOrder[k]] =
              static_cast<int16_t>(static_cast<unsigned>(jpeg_extend(br.bits(s), s)) << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          --eobrun;
          break;
        }
      }
      return C4D_OK;
    }
    const int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    auto refine = [&](int16_t* coef) {
      if (br.bits(1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(ac[c.ta]);
        if (rs < 0) return C4D_ECORRUPT_JPEG;
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNaturalOrder[k];
          if (*coef != 0) {
            refine(coef);
          } else if (--r < 0) {
            break;  // the zero coefficient this run ends at
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNaturalOrder[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k)
        if (blk[kNaturalOrder[k]] != 0) refine(blk + kNaturalOrder[k]);
      --eobrun;
    }
    return C4D_OK;
  }

  // After `restart` MCUs: drop the buffered bits, step over RSTn, reset DC.
  void next_restart(JpegBits& br, const std::vector<int>& scan) {
    size_t p = br.pos;
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7)) {
      if (d[p] == 0xFF && d[p + 1] != 0x00 && d[p + 1] != 0xFF) break;  // another marker
      ++p;
    }
    if (p + 1 < n && d[p] == 0xFF && d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7) p += 2;
    br.pos = p;
    br.reset();
    eobrun = 0;
    for (int ci : scan) comp[ci].pred = 0;
  }

  int decode_scan(const std::vector<int>& scan, size_t start, size_t* end) {
    JpegBits br{d, n, start};
    for (int ci : scan) comp[ci].pred = 0;
    eobrun = 0;
    int mcus = 0;
    auto store = [&](JpegComponent& c, int bx, int by) -> int {
      int16_t* blk = c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
      if (!progressive) return decode_block(br, c, blk);
      return ss == 0 ? decode_dc_progressive(br, c, blk) : decode_ac_progressive(br, c, blk);
    };
    if (scan.size() == 1) {  // non-interleaved: one block an MCU, image blocks only
      JpegComponent& c = comp[scan[0]];
      for (int by = 0; by < c.hib; ++by)
        for (int bx = 0; bx < c.wib; ++bx) {
          if (restart && mcus && mcus % restart == 0) next_restart(br, scan);
          if (int rc = store(c, bx, by)) return rc;
          ++mcus;
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart && mcus && mcus % restart == 0) next_restart(br, scan);
          for (int ci : scan) {
            JpegComponent& c = comp[ci];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h)
                if (int rc = store(c, mx * c.h + h, my * c.v + v)) return rc;
          }
          ++mcus;
        }
    }
    // on to the next marker
    size_t p = br.pos;
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0x00 && !(d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7)))
      ++p;
    *end = p;
    return C4D_OK;
  }

  int parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return C4D_ECORRUPT_JPEG;
    bool any_scan = false;
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;  // skip garbage between markers
      while (pos < n && d[pos] == 0xFF) ++pos;  // fill bytes
      if (pos >= n) return any_scan ? C4D_OK : C4D_ECORRUPT_JPEG;
      const int marker = d[pos++];
      if (marker == 0xD9) return any_scan ? C4D_OK : C4D_ECORRUPT_JPEG;  // EOI
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      if (pos + 2 > n) return C4D_ECORRUPT_JPEG;
      const size_t len = static_cast<size_t>(u16(pos));
      if (len < 2 || pos + len > n) return C4D_ECORRUPT_JPEG;
      const size_t body = pos + 2, stop = pos + len;
      switch (marker) {
        case 0xC0:
        case 0xC1:
        case 0xC2: {
          if (frame || len < 8) return C4D_ECORRUPT_JPEG;
          progressive = marker == 0xC2;
          for (auto& bits : coef_bits) std::fill(bits, bits + 64, -1);
          if (d[body] != 8) return C4D_EUNSUPPORTED;  // 12-bit samples
          height = u16(body + 1);
          width = u16(body + 3);
          ncomp = d[body + 5];
          if (height == 0) return C4D_EUNSUPPORTED;  // height from a DNL marker
          if (width == 0) return C4D_ECORRUPT_JPEG;
          if (ncomp != 1 && ncomp != 3) return C4D_EUNSUPPORTED;  // CMYK / YCCK
          if (len != 8 + 3 * static_cast<size_t>(ncomp)) return C4D_ECORRUPT_JPEG;
          for (int i = 0; i < ncomp; ++i) {
            JpegComponent& c = comp[i];
            c.id = d[body + 6 + 3 * i];
            c.h = d[body + 7 + 3 * i] >> 4;
            c.v = d[body + 7 + 3 * i] & 15;
            c.tq = d[body + 8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return C4D_ECORRUPT_JPEG;
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
          }
          mcux = (width + 8 * hmax - 1) / (8 * hmax);
          mcuy = (height + 8 * vmax - 1) / (8 * vmax);
          for (int i = 0; i < ncomp; ++i) {
            JpegComponent& c = comp[i];
            c.wib = (width * c.h + 8 * hmax - 1) / (8 * hmax);
            c.hib = (height * c.v + 8 * vmax - 1) / (8 * vmax);
            c.dw = (width * c.h + hmax - 1) / hmax;
            c.dh = (height * c.v + vmax - 1) / vmax;
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
          }
          frame = true;
          break;
        }
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9:
        case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          return C4D_EUNSUPPORTED;  // lossless, hierarchical, arithmetic
        case 0xC4: {  // DHT
          size_t p = body;
          while (p < stop) {
            const int tc = d[p] >> 4, th = d[p] & 15;
            if (tc > 1 || th > 3 || p + 17 > stop) return C4D_ECORRUPT_JPEG;
            JpegHuffman& t = tc ? ac[th] : dc[th];
            int count = 0;
            t.bits[0] = 0;
            for (int l = 1; l <= 16; ++l) count += t.bits[l] = d[p + l];
            if (count > 256 || p + 17 + count > stop) return C4D_ECORRUPT_JPEG;
            std::memcpy(t.vals, d + p + 17, count);
            if (!build_jpeg_huffman(&t)) return C4D_ECORRUPT_JPEG;
            p += 17 + count;
          }
          break;
        }
        case 0xDB: {  // DQT
          size_t p = body;
          while (p < stop) {
            const int pq = d[p] >> 4, tq = d[p] & 15;
            if (pq > 1 || tq > 3 || p + 1 + 64 * (pq + 1) > stop) return C4D_ECORRUPT_JPEG;
            for (int k = 0; k < 64; ++k)
              qt[tq][kNaturalOrder[k]] =
                  static_cast<uint16_t>(pq ? u16(p + 1 + 2 * k) : d[p + 1 + k]);
            qt_set[tq] = true;
            p += 1 + 64 * (pq + 1);
          }
          break;
        }
        case 0xDD:
          if (len != 4) return C4D_ECORRUPT_JPEG;
          restart = u16(body);
          break;
        case 0xE0:
          if (len >= 7 && !std::memcmp(d + body, "JFIF\0", 5)) jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && !std::memcmp(d + body, "Adobe", 5)) {
            adobe = true;
            adobe_transform = d[body + 11];
          }
          break;
        case 0xDA: {  // SOS
          if (!frame) return C4D_ECORRUPT_JPEG;
          const int ns = d[body];
          if (ns < 1 || ns > ncomp || len != 6 + 2 * static_cast<size_t>(ns))
            return C4D_ECORRUPT_JPEG;
          ss = d[body + 1 + 2 * ns];
          se = d[body + 2 + 2 * ns];
          ah = d[body + 3 + 2 * ns] >> 4;
          al = d[body + 3 + 2 * ns] & 15;
          if (progressive) {  // a DC band of any components, or an AC band of one
            const bool dc_scan = ss == 0;
            if ((dc_scan && se != 0) || (!dc_scan && (ns != 1 || se < ss || se > 63)) ||
                al > 13 || (ah && ah != al + 1))
              return C4D_ECORRUPT_JPEG;
          }
          std::vector<int> scan;
          int blocks = 0;
          for (int i = 0; i < ns; ++i) {
            const int cid = d[body + 1 + 2 * i];
            int ci = -1;
            for (int k = 0; k < ncomp; ++k)
              if (comp[k].id == cid) ci = k;
            if (ci < 0) return C4D_ECORRUPT_JPEG;
            comp[ci].td = d[body + 2 + 2 * i] >> 4;
            comp[ci].ta = d[body + 2 + 2 * i] & 15;
            const bool needs_dc = !progressive || (ss == 0 && ah == 0);
            const bool needs_ac = !progressive || ss > 0;
            if (comp[ci].td > 3 || comp[ci].ta > 3 || (needs_dc && !dc[comp[ci].td].defined) ||
                (needs_ac && !ac[comp[ci].ta].defined) || !qt_set[comp[ci].tq])
              return C4D_ECORRUPT_JPEG;
            if (progressive)
              for (int k = ss; k <= se; ++k) coef_bits[ci][k] = al;
            blocks += comp[ci].h * comp[ci].v;
            scan.push_back(ci);
          }
          if (ns > 1 && blocks > 10) return C4D_ECORRUPT_JPEG;
          size_t end;
          if (int rc = decode_scan(scan, stop, &end)) return rc;
          any_scan = true;
          pos = end;
          continue;
        }
        default:
          break;  // APPn, COM and the rest are skipped
      }
      pos = stop;
    }
  }

  bool rgb_components() const {
    if (ncomp != 3) return false;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // IDCT every stored block of component c into a plane of bw*8 x bh*8
  std::vector<uint8_t> plane(const JpegComponent& c) const {
    const int pw = c.bw * 8;
    std::vector<uint8_t> out(static_cast<size_t>(pw) * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, qt[c.tq],
                   out.data() + static_cast<size_t>(by) * 8 * pw + bx * 8, pw);
    return out;
  }

  // Upsample component c to width x height (libjpeg's fancy filters with
  // edge rows and columns replicated at the downsampled size).
  std::vector<uint8_t> upsample(const JpegComponent& c) const {
    const std::vector<uint8_t> src = plane(c);
    const int pw = c.bw * 8, dw = c.dw, dh = c.dh;
    const int fh = hmax / c.h, fv = vmax / c.v;
    std::vector<uint8_t> out(static_cast<size_t>(width) * height);
    auto at = [&](int y, int x) -> int { return src[static_cast<size_t>(y) * pw + x]; };
    const bool h2 = fh == 2 && dw > 2, v2 = fv == 2;
    if (fh == 1 && fv == 1) {
      for (int y = 0; y < height; ++y)
        std::memcpy(out.data() + static_cast<size_t>(y) * width, src.data() + static_cast<size_t>(y) * pw, width);
    } else if (h2 && fv == 1) {  // h2v1_fancy_upsample (more than 2 columns)
      std::vector<uint8_t> row(2 * dw);
      for (int y = 0; y < height; ++y) {
        {
          row[0] = static_cast<uint8_t>(at(y, 0));
          row[1] = static_cast<uint8_t>((at(y, 0) * 3 + at(y, 1) + 2) >> 2);
          for (int x = 1; x < dw - 1; ++x) {
            const int v = at(y, x) * 3;
            row[2 * x] = static_cast<uint8_t>((v + at(y, x - 1) + 1) >> 2);
            row[2 * x + 1] = static_cast<uint8_t>((v + at(y, x + 1) + 2) >> 2);
          }
          row[2 * dw - 2] = static_cast<uint8_t>((at(y, dw - 1) * 3 + at(y, dw - 2) + 1) >> 2);
          row[2 * dw - 1] = static_cast<uint8_t>(at(y, dw - 1));
        }
        std::memcpy(out.data() + static_cast<size_t>(y) * width, row.data(), width);
      }
    } else if (fh == 1 && v2) {  // h1v2_fancy_upsample
      for (int y = 0; y < height; ++y) {
        const int r = y >> 1;
        const int nb = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
        const int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; ++x)
          out[static_cast<size_t>(y) * width + x] =
              static_cast<uint8_t>((at(r, x) * 3 + at(nb, x) + bias) >> 2);
      }
    } else if (h2 && v2) {  // h2v2_fancy_upsample (more than 2 columns)
      std::vector<uint8_t> row(2 * dw);
      for (int y = 0; y < height; ++y) {
        const int r = y >> 1;
        const int nb = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
        auto colsum = [&](int x) { return at(r, x) * 3 + at(nb, x); };
        {
          int thiscol = colsum(0), nextcol = colsum(1), lastcol;
          row[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
          row[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
          for (int x = 1; x < dw - 1; ++x) {
            nextcol = colsum(x + 1);
            row[2 * x] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
            row[2 * x + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
            lastcol = thiscol;
            thiscol = nextcol;
          }
          row[2 * dw - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
          row[2 * dw - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
        }
        std::memcpy(out.data() + static_cast<size_t>(y) * width, row.data(), width);
      }
    } else {  // int_upsample: replicate
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x)
          out[static_cast<size_t>(y) * width + x] = static_cast<uint8_t>(at(y / fv, x / fh));
    }
    return out;
  }

  int to_rgb(Image* img) const {
    for (int i = 0; i < ncomp; ++i)
      if (hmax % comp[i].h || vmax % comp[i].v) return C4D_EUNSUPPORTED;
    // libjpeg smooths the blocks of a progressive image whose DC is known
    // and whose first AC coefficients are not wholly refined; this decoder
    // does not, so it refuses such (truncated) files
    for (int i = 0; progressive && i < ncomp; ++i)
      if (coef_bits[i][0] >= 0)
        for (int k = 1; k < 10; ++k)
          if (coef_bits[i][k] != 0) return C4D_EUNSUPPORTED;
    img->w = width;
    img->h = height;
    img->rgb.resize(static_cast<size_t>(width) * height * 3);
    const size_t np = static_cast<size_t>(width) * height;
    if (ncomp == 1) {
      const std::vector<uint8_t> g = upsample(comp[0]);
      for (size_t i = 0; i < np; ++i) img->rgb[3 * i] = img->rgb[3 * i + 1] = img->rgb[3 * i + 2] = g[i];
      return C4D_OK;
    }
    const std::vector<uint8_t> a = upsample(comp[0]), b = upsample(comp[1]), c = upsample(comp[2]);
    if (rgb_components()) {
      for (size_t i = 0; i < np; ++i) {
        img->rgb[3 * i] = a[i];
        img->rgb[3 * i + 1] = b[i];
        img->rgb[3 * i + 2] = c[i];
      }
      return C4D_OK;
    }
    // jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
    static int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    static std::once_flag once;
    std::call_once(once, [] {
      const int64_t half = int64_t(1) << 15;
      auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
      for (int i = 0; i < 256; ++i) {
        const int64_t x = i - 128;
        cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
        cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
        cr_g[i] = static_cast<int>(-fix(0.71414) * x);
        cb_g[i] = static_cast<int>(-fix(0.34414) * x + half);
      }
    });
    for (size_t i = 0; i < np; ++i) {
      const int y = a[i], cb = b[i], cr = c[i];
      img->rgb[3 * i] = clamp255(y + cr_r[cr]);
      img->rgb[3 * i + 1] = clamp255(y + ((cb_g[cb] + cr_g[cr]) >> 16));
      img->rgb[3 * i + 2] = clamp255(y + cb_b[cb]);
    }
    return C4D_OK;
  }
};

int decode_jpeg_buffer(const uint8_t* data, size_t n, Image* img) {
  JpegDecoder dec;
  dec.d = data;
  dec.n = n;
  const int rc = dec.parse();
  if (rc) return rc;
  if (!dec.frame) return C4D_ECORRUPT_JPEG;
  return dec.to_rgb(img);
}

// --------------------------------------------------------- JPEG encoder ----

const uint8_t kStdLuma[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,
                              58, 60, 55, 14, 13,  16,  24,  40,  57, 69, 56, 14, 17,
                              22, 29, 51, 87, 80,  62,  18,  22,  37, 56, 68, 109, 103,
                              77, 24, 35, 55, 64,  81,  104, 113, 92, 49, 64, 78,  87,
                              103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99,
                                99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
// Annex K.3 tables: bits[1..16], then values
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
};

EncTable make_enc_table(const uint8_t* bits, const uint8_t* vals) {
  EncTable t;
  std::memset(&t, 0, sizeof(t));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
      t.code[vals[k]] = static_cast<uint16_t>(code);
      t.size[vals[k]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
  return t;
}

struct BitWriter {
  std::vector<uint8_t>* out;
  uint32_t buf = 0;
  int cnt = 0;
  void put(uint32_t code, int size) {
    buf = (buf << size) | (code & ((1u << size) - 1));
    cnt += size;
    while (cnt >= 8) {
      const uint8_t byte = static_cast<uint8_t>(buf >> (cnt - 8));
      out->push_back(byte);
      if (byte == 0xFF) out->push_back(0);
      cnt -= 8;
    }
  }
  void flush() { put(0x7F, 7); cnt = 0; buf = 0; }
};

// jpeg_fdct_islow on samples − 128, then libjpeg's rounding division by
// quant·8, in natural order
void fdct_quantize(const int32_t* in, const uint16_t* quant, int16_t* out) {
  int32_t ws[64];
  std::memcpy(ws, in, sizeof(ws));
  for (int r = 0; r < 8; ++r) {
    int32_t* p = ws + 8 * r;
    const int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    const int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    p[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
    const int32_t z1 = (tmp12 + tmp13) * F0_541196100;
    p[2] = descale(z1 + tmp13 * F0_765366865, kConstBits - kPass1Bits);
    p[6] = descale(z1 + tmp12 * -F1_847759065, kConstBits - kPass1Bits);
    int32_t a1 = tmp4 + tmp7, a2 = tmp5 + tmp6, a3 = tmp4 + tmp6, a4 = tmp5 + tmp7;
    const int32_t z5 = (a3 + a4) * F1_175875602;
    const int32_t t4 = tmp4 * F0_298631336, t5 = tmp5 * F2_053119869;
    const int32_t t6 = tmp6 * F3_072711026, t7 = tmp7 * F1_501321110;
    a1 *= -F0_899976223;
    a2 *= -F2_562915447;
    a3 *= -F1_961570560;
    a4 *= -F0_390180644;
    a3 += z5;
    a4 += z5;
    p[7] = descale(t4 + a1 + a3, kConstBits - kPass1Bits);
    p[5] = descale(t5 + a2 + a4, kConstBits - kPass1Bits);
    p[3] = descale(t6 + a2 + a3, kConstBits - kPass1Bits);
    p[1] = descale(t7 + a1 + a4, kConstBits - kPass1Bits);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = ws + c;
    const int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    const int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, kPass1Bits);
    p[32] = descale(tmp10 - tmp11, kPass1Bits);
    const int32_t z1 = (tmp12 + tmp13) * F0_541196100;
    p[16] = descale(z1 + tmp13 * F0_765366865, kConstBits + kPass1Bits);
    p[48] = descale(z1 + tmp12 * -F1_847759065, kConstBits + kPass1Bits);
    int32_t a1 = tmp4 + tmp7, a2 = tmp5 + tmp6, a3 = tmp4 + tmp6, a4 = tmp5 + tmp7;
    const int32_t z5 = (a3 + a4) * F1_175875602;
    const int32_t t4 = tmp4 * F0_298631336, t5 = tmp5 * F2_053119869;
    const int32_t t6 = tmp6 * F3_072711026, t7 = tmp7 * F1_501321110;
    a1 *= -F0_899976223;
    a2 *= -F2_562915447;
    a3 *= -F1_961570560;
    a4 *= -F0_390180644;
    a3 += z5;
    a4 += z5;
    p[56] = descale(t4 + a1 + a3, kConstBits + kPass1Bits);
    p[40] = descale(t5 + a2 + a4, kConstBits + kPass1Bits);
    p[24] = descale(t6 + a2 + a3, kConstBits + kPass1Bits);
    p[8] = descale(t7 + a1 + a4, kConstBits + kPass1Bits);
  }
  for (int i = 0; i < 64; ++i) {
    const int32_t q = quant[i] * 8;
    int32_t t = ws[i];
    const bool neg = t < 0;
    t = (neg ? -t : t) + (q >> 1);
    t = t >= q ? t / q : 0;
    out[i] = static_cast<int16_t>(neg ? -t : t);
  }
}

void encode_block(BitWriter& bw, const int16_t* blk, int* pred, const EncTable& dc,
                  const EncTable& ac) {
  auto nbits = [](int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) { ++n; a >>= 1; }
    return n;
  };
  int diff = blk[0] - *pred;
  *pred = blk[0];
  int n = nbits(diff);
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = blk[kNaturalOrder[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    n = nbits(v);
    const int rs = (run << 4) | n;
    bw.put(ac.code[rs], ac.size[rs]);
    bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run) bw.put(ac.code[0], ac.size[0]);
}

// RGB (h, w, 3) → baseline JPEG bytes, 4:2:0, libjpeg's defaults at `quality`
std::vector<uint8_t> encode_jpeg_buffer(const uint8_t* rgb, int w, int h, int quality) {
  // jcparam.c: jpeg_quality_scaling, force_baseline
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qt[2][64];
  for (int i = 0; i < 64; ++i) {
    qt[0][i] = static_cast<uint16_t>(std::min(255, std::max(1, (kStdLuma[i] * scale + 50) / 100)));
    qt[1][i] = static_cast<uint16_t>(std::min(255, std::max(1, (kStdChroma[i] * scale + 50) / 100)));
  }
  // jccolor.c rgb_ycc_convert (SCALEBITS 16)
  auto fix = [](double x) { return static_cast<int32_t>(x * 65536.0 + 0.5); };
  const int32_t half = 1 << 15, cbcr_off = 128 << 16;
  const size_t np = static_cast<size_t>(w) * h;
  std::vector<uint8_t> Y(np), Cb(np), Cr(np);
  for (size_t i = 0; i < np; ++i) {
    const int32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    Y[i] = static_cast<uint8_t>((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16);
    Cb[i] = static_cast<uint8_t>((-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + cbcr_off + half - 1) >> 16);
    Cr[i] = static_cast<uint8_t>((fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + cbcr_off + half - 1) >> 16);
  }
  // planes padded by edge replication as libjpeg's prep and downsampler pad
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int ywib = (w + 7) / 8, yhib = (h + 7) / 8;
  const int cwib = mcux, chib = mcuy;  // (w + 15) / 16 blocks of chroma
  const int yw = ywib * 8, yh = yhib * 8, cw = cwib * 8, ch = chib * 8;
  std::vector<uint8_t> yp(static_cast<size_t>(yw) * yh);
  for (int y = 0; y < yh; ++y)
    for (int x = 0; x < yw; ++x)
      yp[static_cast<size_t>(y) * yw + x] = Y[static_cast<size_t>(std::min(y, h - 1)) * w + std::min(x, w - 1)];
  std::vector<uint8_t> cbp(static_cast<size_t>(cw) * ch), crp(cbp.size());
  const int crows = (h + 1) / 2;
  for (int r = 0; r < ch; ++r) {
    const int rr = std::min(r, crows - 1);
    const int y0 = std::min(2 * rr, h - 1), y1 = std::min(2 * rr + 1, h - 1);
    for (int c = 0; c < cw; ++c) {
      const int x0 = std::min(2 * c, w - 1), x1 = std::min(2 * c + 1, w - 1);
      const int bias = (c & 1) ? 2 : 1;
      const size_t a = static_cast<size_t>(y0) * w, b = static_cast<size_t>(y1) * w;
      cbp[static_cast<size_t>(r) * cw + c] =
          static_cast<uint8_t>((Cb[a + x0] + Cb[a + x1] + Cb[b + x0] + Cb[b + x1] + bias) >> 2);
      crp[static_cast<size_t>(r) * cw + c] =
          static_cast<uint8_t>((Cr[a + x0] + Cr[a + x1] + Cr[b + x0] + Cr[b + x1] + bias) >> 2);
    }
  }

  std::vector<uint8_t> out;
  auto put16 = [&](int v) {
    out.push_back(static_cast<uint8_t>(v >> 8));
    out.push_back(static_cast<uint8_t>(v & 0xFF));
  };
  auto marker = [&](int m, int len) {
    out.push_back(0xFF);
    out.push_back(static_cast<uint8_t>(m));
    put16(len);
  };
  out.push_back(0xFF);
  out.push_back(0xD8);
  marker(0xE0, 16);  // JFIF 1.01, no units, 1:1, no thumbnail
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out.insert(out.end(), jfif, jfif + 14);
  for (int t = 0; t < 2; ++t) {
    marker(0xDB, 67);
    out.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) out.push_back(static_cast<uint8_t>(qt[t][kNaturalOrder[k]]));
  }
  marker(0xC0, 17);
  out.push_back(8);
  put16(h);
  put16(w);
  out.push_back(3);
  const uint8_t sof[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  out.insert(out.end(), sof, sof + 9);
  auto dht = [&](int cls_id, const uint8_t* bits, const uint8_t* vals) {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    marker(0xC4, 19 + count);
    out.push_back(static_cast<uint8_t>(cls_id));
    out.insert(out.end(), bits + 1, bits + 17);
    out.insert(out.end(), vals, vals + count);
  };
  dht(0x00, kDcLumaBits, kDcLumaVals);
  dht(0x10, kAcLumaBits, kAcLumaVals);
  dht(0x01, kDcChromaBits, kDcChromaVals);
  dht(0x11, kAcChromaBits, kAcChromaVals);
  marker(0xDA, 12);
  const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  out.insert(out.end(), sos, sos + 10);

  const EncTable dcl = make_enc_table(kDcLumaBits, kDcLumaVals);
  const EncTable acl = make_enc_table(kAcLumaBits, kAcLumaVals);
  const EncTable dcc = make_enc_table(kDcChromaBits, kDcChromaVals);
  const EncTable acc = make_enc_table(kAcChromaBits, kAcChromaVals);
  BitWriter bw{&out};
  int pred[3] = {0, 0, 0};
  int32_t samples[64];
  auto block_of = [&](const std::vector<uint8_t>& plane, int pw, int bx, int by, const uint16_t* q,
                      int16_t* blk) {
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        samples[8 * r + c] = plane[static_cast<size_t>(by * 8 + r) * pw + bx * 8 + c] - 128;
    fdct_quantize(samples, q, blk);
  };
  int16_t mcu[4][64];
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      // luma: 2x2 blocks, dummies (zero AC, the previous block's DC) outside
      for (int v = 0; v < 2; ++v) {
        const int by = my * 2 + v;
        for (int hh = 0; hh < 2; ++hh) {
          const int bx = mx * 2 + hh, k = v * 2 + hh;
          if (by < yhib && bx < ywib) {
            block_of(yp, yw, bx, by, qt[0], mcu[k]);
          } else {
            std::memset(mcu[k], 0, sizeof(mcu[k]));
            mcu[k][0] = mcu[k - 1][0];
          }
        }
      }
      for (int k = 0; k < 4; ++k) encode_block(bw, mcu[k], &pred[0], dcl, acl);
      int16_t blk[64];
      block_of(cbp, cw, mx, my, qt[1], blk);
      encode_block(bw, blk, &pred[1], dcc, acc);
      block_of(crp, cw, mx, my, qt[1], blk);
      encode_block(bw, blk, &pred[2], dcc, acc);
    }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

// ============================================================ file I/O ====

int decode_image(const char* path, Image* img) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return C4D_EOPEN;
  std::vector<uint8_t> data;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = fread(chunk, 1, sizeof(chunk), fp)) > 0) data.insert(data.end(), chunk, chunk + got);
  const bool read_error = ferror(fp);
  fclose(fp);
  if (read_error) return C4D_EOPEN;
  if (data.size() >= 2 && data[0] == 0x89 && data[1] == 'P')
    return decode_png_buffer(data.data(), data.size(), img);
  if (data.size() >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg_buffer(data.data(), data.size(), img);
  return C4D_EFORMAT;
}

// pad-crop (crop_image semantics: OOB → bg value) into a square crop buffer
void pad_crop(const Image& img, const int box[4], uint8_t bg, Image* out) {
  const int x0 = box[0], y0 = box[1], x1 = box[2], y1 = box[3];
  out->w = x1 - x0;
  out->h = y1 - y0;
  out->rgb.assign(static_cast<size_t>(out->w) * out->h * 3, bg);
  const int sx0 = std::max(0, x0), sy0 = std::max(0, y0);
  const int sx1 = std::min(img.w, x1), sy1 = std::min(img.h, y1);
  for (int y = sy0; y < sy1; ++y) {
    if (sx1 <= sx0) continue;
    std::memcpy(out->rgb.data() +
                    (static_cast<size_t>(y - y0) * out->w + (sx0 - x0)) * 3,
                img.rgb.data() + (static_cast<size_t>(y) * img.w + sx0) * 3,
                static_cast<size_t>(sx1 - sx0) * 3);
  }
}

// area-average resize for downscale, bilinear for upscale; output float [-1,1]
void resize_normalize(const Image& img, int res, float* out) {
  const float sx = static_cast<float>(img.w) / res;
  const float sy = static_cast<float>(img.h) / res;
  const bool down = res < img.h;
  for (int oy = 0; oy < res; ++oy) {
    for (int ox = 0; ox < res; ++ox) {
      float acc[3] = {0, 0, 0};
      if (down) {  // box filter over the source cell
        int x0 = static_cast<int>(ox * sx), x1 = static_cast<int>((ox + 1) * sx);
        int y0 = static_cast<int>(oy * sy), y1 = static_cast<int>((oy + 1) * sy);
        x1 = std::max(x1, x0 + 1);
        y1 = std::max(y1, y0 + 1);
        x1 = std::min(x1, img.w);
        y1 = std::min(y1, img.h);
        const float inv = 1.0f / ((x1 - x0) * (y1 - y0));
        for (int y = y0; y < y1; ++y)
          for (int x = x0; x < x1; ++x) {
            const uint8_t* p = img.rgb.data() + (static_cast<size_t>(y) * img.w + x) * 3;
            acc[0] += p[0];
            acc[1] += p[1];
            acc[2] += p[2];
          }
        acc[0] *= inv;
        acc[1] *= inv;
        acc[2] *= inv;
      } else {  // bilinear
        const float fx = (ox + 0.5f) * sx - 0.5f;
        const float fy = (oy + 0.5f) * sy - 0.5f;
        const int x0 = std::max(0, std::min(img.w - 1, static_cast<int>(fx)));
        const int y0 = std::max(0, std::min(img.h - 1, static_cast<int>(fy)));
        const int x1 = std::min(img.w - 1, x0 + 1);
        const int y1 = std::min(img.h - 1, y0 + 1);
        const float ax = std::max(0.0f, std::min(1.0f, fx - x0));
        const float ay = std::max(0.0f, std::min(1.0f, fy - y0));
        for (int c = 0; c < 3; ++c) {
          const float v00 = img.rgb[(static_cast<size_t>(y0) * img.w + x0) * 3 + c];
          const float v01 = img.rgb[(static_cast<size_t>(y0) * img.w + x1) * 3 + c];
          const float v10 = img.rgb[(static_cast<size_t>(y1) * img.w + x0) * 3 + c];
          const float v11 = img.rgb[(static_cast<size_t>(y1) * img.w + x1) * 3 + c];
          acc[c] = (1 - ay) * ((1 - ax) * v00 + ax * v01) +
                   ay * ((1 - ax) * v10 + ax * v11);
        }
      }
      float* o = out + (static_cast<size_t>(oy) * res + ox) * 3;
      o[0] = acc[0] / 127.5f - 1.0f;
      o[1] = acc[1] / 127.5f - 1.0f;
      o[2] = acc[2] / 127.5f - 1.0f;
    }
  }
}

int load_frame_impl(const char* path, const int box[4], int res, uint8_t bg,
                    float* out) {
  Image img;
  if (int rc = decode_image(path, &img)) return rc;
  Image cropped;
  const Image* src = &img;
  if (box) {
    pad_crop(img, box, bg, &cropped);
    src = &cropped;
  }
  resize_normalize(*src, res, out);
  return 0;
}

// ---------------- prefetch pool ----------------

struct Job {
  std::string path;
  int box[4];
  bool has_box;
  int res;
  uint8_t bg;
  int ticket;
};

struct Pool {
  std::vector<std::thread> workers;
  std::deque<Job> queue;
  std::map<int, std::pair<int, std::vector<float>>> results;  // ticket → (status, data)
  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  bool stop = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i)
      workers.emplace_back([this] { run(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_job.notify_all();
    for (auto& w : workers) w.join();
  }
  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        job = std::move(queue.front());
        queue.pop_front();
      }
      std::vector<float> buf(static_cast<size_t>(job.res) * job.res * 3);
      int status = load_frame_impl(job.path.c_str(),
                                   job.has_box ? job.box : nullptr, job.res,
                                   job.bg, buf.data());
      {
        std::lock_guard<std::mutex> lk(mu);
        results[job.ticket] = {status, std::move(buf)};
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Decode + optional pad-crop + resize + [-1,1] normalise. box may be null.
// Returns 0 on success, else a C4D_* status.
int c4d_load_frame(const char* path, const int* box, int target_res, int bg,
                   float* out) {
  return load_frame_impl(path, box, target_res, static_cast<uint8_t>(bg), out);
}

// Raw decode: caller passes a buffer of cap_bytes; dims returned via w/h.
int c4d_decode_image(const char* path, uint8_t* out, long cap_bytes, int* w,
                     int* h) {
  Image img;
  if (int rc = decode_image(path, &img)) return rc;
  *w = img.w;
  *h = img.h;
  const long need = static_cast<long>(img.rgb.size());
  if (need > cap_bytes) return C4D_ECAPACITY;
  std::memcpy(out, img.rgb.data(), need);
  return 0;
}

// RGB (h, w, 3) uint8 → a baseline 4:2:0 JPEG file at `quality` (1..100).
int c4d_encode_jpeg(const char* path, const uint8_t* rgb, int w, int h, int quality) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535 || quality < 1 || quality > 100)
    return C4D_EARG;
  const std::vector<uint8_t> bytes = encode_jpeg_buffer(rgb, w, h, quality);
  FILE* fp = fopen(path, "wb");
  if (!fp) return C4D_EWRITE;
  const bool ok = fwrite(bytes.data(), 1, bytes.size(), fp) == bytes.size();
  return (fclose(fp) == 0 && ok) ? 0 : C4D_EWRITE;
}

void* c4d_pool_create(int n_threads) { return new Pool(n_threads); }

void c4d_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

int c4d_pool_submit(void* pool, const char* path, const int* box,
                    int target_res, int bg, int ticket) {
  auto* p = static_cast<Pool*>(pool);
  Job job;
  job.path = path;
  job.has_box = box != nullptr;
  if (box) std::memcpy(job.box, box, sizeof(job.box));
  job.res = target_res;
  job.bg = static_cast<uint8_t>(bg);
  job.ticket = ticket;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->queue.push_back(std::move(job));
  }
  p->cv_job.notify_one();
  return 0;
}

// Blocks until the ticket's frame is ready; copies into out. Returns the
// job status (0 ok, else a C4D_* status).
int c4d_pool_wait(void* pool, int ticket, float* out, int target_res) {
  auto* p = static_cast<Pool*>(pool);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_done.wait(lk, [&] { return p->results.count(ticket) > 0; });
  auto node = p->results.extract(ticket);
  const auto& [status, data] = node.mapped();
  if (status == 0)
    std::memcpy(out, data.data(),
                sizeof(float) * static_cast<size_t>(target_res) * target_res * 3);
  return status;
}

}  // extern "C"
