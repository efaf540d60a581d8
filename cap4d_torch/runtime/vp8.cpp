// VP8 video decoder (RFC 6386): the port's counterpart of the host decode
// that the JAX package gets from cv2 (ffmpeg's native vp8 decoder) for a
// V_VP8 track in Matroska/WebM or a VP80 track in an AVI. Built into the
// runtime's library with cap4d_runtime.cpp, h264.cpp, mpeg4.cpp and vp9.cpp.
//
// Scope: the frame tag (key frames, versions 0-3, show_frame, the first
// partition's size); the key frame's start code, size and scaling bits (read
// and ignored: the output is the coded size, as ffmpeg's is), color_space
// and clamping_type; segmentation (map with its tree probabilities,
// quantiser and filter-level features, absolute or delta values); the
// normal and simple loop filters with level, sharpness and the reference
// and mode deltas; 1, 2, 4 or 8 token partitions; the quantiser indices and
// their five deltas; golden and alt-ref refresh, copy_buffer_to_gf/arf and
// the sign biases; refresh_entropy_probs and refresh_last; coefficient,
// intra-mode and vector probability updates; mb_no_coeff_skip. Per
// macroblock: segment, skip, reference frame, key-frame and inter-frame
// intra modes (16x16 and B_PRED with contextual sub-block probabilities),
// the near-vector search with sign-bias inversion, NEAREST/NEAR/ZERO/NEW
// and SPLITMV (16x8, 8x16, 8x8, 4x4; LEFT/ABOVE/ZERO/NEW sub-vectors),
// tokens with bands and contexts, the Y2 block and its WHT, dequantisation;
// the 4x4 inverse DCT; VP8's intra predictors and edge values (127 above,
// 129 left); six-tap (version 0), bilinear (1, 2) and full-pixel chroma (3)
// prediction from edge-extended references; the loop filters over the
// macroblock-aligned frame after it is reconstructed (intra prediction
// reads unfiltered pixels, as ffmpeg's and libvpx's decoders do); the last,
// golden and alt-ref buffers.
//
// The pictures are ffmpeg's, which cv2 returns. Where libvpx's decoder and
// ffmpeg part (copy_buffer_to_gf from the alt-ref in a frame that also
// copies the golden frame to the alt-ref: ffmpeg copies the buffers as
// they stood before the frame, libvpx the alt-ref it has just replaced;
// a segment's filter level that leaves 0..63 before the deltas: libvpx
// clamps it there, ffmpeg only after them), this follows ffmpeg.
//
// Versions 4-7 (reserved) decode as ffmpeg decodes them: as versions 1 and 2
// (libvpx decodes them as version 0).
//
// Refused by name (a ValueError on the Python side): an inter frame before
// the first key frame, a key frame without the start
// code or with a zero size, partitions that run past the sample, and
// anything that does not parse. Nothing is concealed.
//
// Layout: tables, bool decoder, frame header, modes and vectors, tokens,
// transforms, prediction, loop filter, frame decode, C API.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {
namespace vp8 {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Error(what); }

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// ------------------------------------------------------------- tables --
// RFC 6386's constant tables (sections 9-14, 17 and 20).

const uint8_t kDefaultCoefProbs[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoefUpdateProbs[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kKfBmodeProbs[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// dequantisation (14.1): index -> factor
const uint8_t kDcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const int16_t kAcQ[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

// intra modes (RFC 6386 enums) and their trees (8.1: negative entries are leaves)
enum { DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED };
enum { B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU };
const int8_t kYmodeTree[8] = {-DC_PRED, 2, 4, 6, -V_PRED, -H_PRED, -TM_PRED, -B_PRED};
const int8_t kKfYmodeTree[8] = {-B_PRED, 2, 4, 6, -DC_PRED, -V_PRED, -H_PRED, -TM_PRED};
const int8_t kUvModeTree[6] = {-DC_PRED, 2, -V_PRED, 4, -H_PRED, -TM_PRED};
const int8_t kBmodeTree[18] = {-B_DC, 2, -B_TM, 4, -B_VE, 6, 8, 12, -B_HE, 10,
                               -B_RD, -B_VR, -B_LD, 14, -B_VL, 16, -B_HD, -B_HU};
const int8_t kSmallMvTree[14] = {2, 8, 4, 6, -0, -1, -2, -3, 10, 12, -4, -5, -6, -7};
const int8_t kSegmentTree[6] = {2, 4, -0, -1, -2, -3};
const uint8_t kKfYmodeProbs[4] = {145, 156, 163, 128};
const uint8_t kKfUvModeProbs[3] = {142, 114, 183};
const uint8_t kYmodeProbs[4] = {112, 86, 140, 37};
const uint8_t kUvModeProbs[3] = {162, 101, 204};
const uint8_t kBmodeProbs[9] = {120, 90, 79, 133, 87, 85, 80, 111, 151};
// the sub-block mode a 16x16 mode implies, for key frames' B_PRED contexts
const uint8_t kImpliedBmode[4] = {B_DC, B_VE, B_HE, B_TM};

// motion vectors (17)
const uint8_t kMvDefaultProbs[2][19] = {
    {162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254},
    {164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254}};
const uint8_t kMvUpdateProbs[2][19] = {
    {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254},
    {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254}};
const uint8_t kModeContexts[6][4] = {{7, 1, 1, 143},   {14, 18, 14, 107}, {135, 64, 57, 68},
                                     {60, 56, 128, 65}, {159, 134, 128, 34}, {234, 188, 128, 28}};
const uint8_t kSplitProbs[3] = {110, 111, 150};
const uint8_t kSubMvProbs[5][3] = {{147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1}};
// SPLITMV partitionings (ffmpeg's order): 16x8, 8x16, 8x8, 4x4, none
enum { SPLIT_16x8, SPLIT_8x16, SPLIT_8x8, SPLIT_4x4, SPLIT_NONE };
const uint8_t kSplits[5][16] = {{0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
                                {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
                                {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
                                {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
                                {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
const uint8_t kSplitFirst[4][16] = {{0, 8}, {0, 2}, {0, 2, 8, 10},
                                    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
const int kSplitCount[4] = {2, 2, 4, 16};

// tokens (13)
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[3] = {173, 148, 140};
const uint8_t kCat4[4] = {176, 155, 140, 135};
const uint8_t kCat5[5] = {180, 157, 141, 134, 130};
const uint8_t kCat6[11] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129};

// inter prediction filters (18): six taps by eighth-sample position
const int kSixtap[8][6] = {{0, 0, 128, 0, 0, 0},   {0, -6, 123, 12, -1, 0}, {2, -11, 108, 36, -8, 1},
                           {0, -9, 93, 50, -6, 0}, {3, -16, 77, 77, -16, 3}, {0, -6, 50, 93, -9, 0},
                           {1, -8, 36, 108, -11, 2}, {0, -1, 12, 123, -6, 0}};

// What a decode used: the bits of Decoder::tools (runtime/vp8.py's TOOLS, in order).
enum Tool {
  T_KEY_FRAME, T_INTER_FRAME, T_HIDDEN_FRAME, T_VERSION_0, T_VERSION_1, T_VERSION_2, T_VERSION_3,
  T_SIZE_CHANGE, T_ODD_SIZE, T_SCALING_BITS, T_COLOR_SPACE, T_CLAMPING_TYPE, T_SEGMENTATION,
  T_SEG_MAP_UPDATE, T_SEG_MAP_KEPT, T_SEG_DATA_UPDATE, T_SEG_ABSOLUTE, T_SEG_QUANT, T_SEG_FILTER,
  T_FILTER_NORMAL, T_FILTER_SIMPLE, T_FILTER_OFF, T_SHARPNESS, T_LF_DELTAS, T_LF_DELTA_UPDATE,
  T_PARTITIONS_2, T_PARTITIONS_4, T_PARTITIONS_8, T_QUANT_DELTAS, T_REFRESH_GOLDEN,
  T_REFRESH_ALTREF, T_GOLDEN_FROM_LAST, T_GOLDEN_FROM_ALTREF, T_ALTREF_FROM_LAST,
  T_ALTREF_FROM_GOLDEN, T_SIGN_BIAS, T_KEEP_ENTROPY, T_KEEP_LAST, T_COEF_UPDATES, T_NO_SKIP_FLAG,
  T_SKIP, T_REF_GOLDEN, T_REF_ALTREF, T_YMODE_UPDATE, T_UV_MODE_UPDATE, T_MV_UPDATES, T_B_PRED_KEY,
  T_B_PRED_INTER, T_I16_INTER, T_NEAREST, T_NEAR, T_ZERO, T_NEW, T_SPLIT_16x8, T_SPLIT_8x16,
  T_SPLIT_8x8, T_SPLIT_4x4, T_SUB_LEFT, T_SUB_ABOVE, T_SUB_ZERO, T_SUB_NEW, T_MV_LONG,
  T_TOKEN_CAT6, T_EDGE_MC, T_FAR_MC, T_VERSION_RESERVED, N_TOOLS
};
static_assert(N_TOOLS <= 128, "tool bits fit in two words");

// -------------------------------------------------------- bool decoder --
// 7.3: a two-byte window, renormalised a byte at a time; bytes past the end
// of the partition read as zeros.

struct Bool {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint32_t value = 0, range = 255;
  int bits = 0;

  void init(const uint8_t* d, size_t n) {
    p = d;
    end = d + n;
    value = next() << 8;
    value |= next();
    range = 255;
    bits = 0;
  }
  uint32_t next() { return p < end ? *p++ : 0; }
  int get(int prob) {
    const uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8);
    const uint32_t big = split << 8;
    int bit = 0;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      range = split;
    }
    if (range < 128) {
      const int shift = __builtin_clz(range) - 24;
      range <<= shift;
      value <<= shift;
      bits += shift;
      if (bits >= 8) {
        bits -= 8;
        value |= next() << bits;
      }
    }
    return bit;
  }
  int literal(int n) {
    int v = 0;
    while (n--) v = (v << 1) | get(128);
    return v;
  }
  // a flag, then n bits of magnitude and a sign (9.3, 9.6)
  int sint(int n) {
    if (!get(128)) return 0;
    const int v = literal(n);
    return get(128) ? -v : v;
  }
  int tree(const int8_t* t, const uint8_t* probs) {
    int i = 0;
    while ((i = t[i + get(probs[i >> 1])]) > 0) {
    }
    return -i;
  }
};

// ------------------------------------------------------------- frames --

struct Plane {
  int w = 0, h = 0, border = 0, stride = 0;  // w x h: the macroblock-aligned size
  std::vector<uint8_t> buf;
  void alloc(int w_, int h_, int b) {
    w = w_;
    h = h_;
    border = b;
    stride = w + 2 * b;
    buf.assign(size_t(stride) * (h + 2 * b), 0);
  }
  uint8_t* at(int x, int y) { return buf.data() + size_t(y + border) * stride + x + border; }
  const uint8_t* at(int x, int y) const {
    return buf.data() + size_t(y + border) * stride + x + border;
  }
  // replicate the edge samples into the border (references are read past the edges)
  void extend() {
    for (int y = 0; y < h; ++y) {
      uint8_t* r = at(0, y);
      std::memset(r - border, r[0], border);
      std::memset(r + w, r[w - 1], border);
    }
    for (int y = 1; y <= border; ++y) {
      std::memcpy(at(-border, -y), at(-border, 0), stride);
      std::memcpy(at(-border, h - 1 + y), at(-border, h - 1), stride);
    }
  }
};

struct Frame {
  int width = 0, height = 0;  // the coded (and output) size
  // ffmpeg reads a key frame's clamping_type as the colour range of the
  // frames after it, but cv2 decodes with frame threads that keep the bit
  // each read last, so it converts the inter frames as limited range (all
  // but those its key frame's thread decodes): the range is the key frame's
  bool full_range = false;
  Plane p[3];
};
using FramePtr = std::shared_ptr<Frame>;

struct Mv {
  int16_t x = 0, y = 0;
  bool operator==(const Mv& o) const { return x == o.x && y == o.y; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
  bool zero() const { return !x && !y; }
};

struct MbInfo {
  uint8_t ymode = DC_PRED, uvmode = DC_PRED, ref = 0, segment = 0, skip = 0;
  uint8_t split = SPLIT_NONE;  // SPLITMV's partitioning, SPLIT_NONE otherwise
  bool is_split = false;
  Mv mv;        // the macroblock's vector (SPLITMV: its last partition's)
  Mv bmv[16];   // each partition's vector
  uint8_t bmodes[16];
};

struct Probs {
  uint8_t coef[4][8][3][11];
  uint8_t ymode[4], uvmode[3];
  uint8_t mv[2][19];
};

// ----------------------------------------------------------- transforms --

// 14.3: the inverse Walsh-Hadamard transform of the Y2 block into each Y block's DC
void inverse_wht(const int16_t* in, int16_t (*blocks)[16]) {
  int16_t t[16];
  for (int i = 0; i < 4; ++i) {
    const int a1 = in[i] + in[12 + i], b1 = in[4 + i] + in[8 + i];
    const int c1 = in[4 + i] - in[8 + i], d1 = in[i] - in[12 + i];
    t[i] = int16_t(a1 + b1);
    t[4 + i] = int16_t(c1 + d1);
    t[8 + i] = int16_t(a1 - b1);
    t[12 + i] = int16_t(d1 - c1);
  }
  for (int i = 0; i < 4; ++i) {
    const int a1 = t[4 * i] + t[4 * i + 3], b1 = t[4 * i + 1] + t[4 * i + 2];
    const int c1 = t[4 * i + 1] - t[4 * i + 2], d1 = t[4 * i] - t[4 * i + 3];
    blocks[4 * i][0] = int16_t((a1 + b1 + 3) >> 3);
    blocks[4 * i + 1][0] = int16_t((c1 + d1 + 3) >> 3);
    blocks[4 * i + 2][0] = int16_t((a1 - b1 + 3) >> 3);
    blocks[4 * i + 3][0] = int16_t((d1 - c1 + 3) >> 3);
  }
}

inline int mul20091(int a) { return ((a * 20091) >> 16) + a; }
inline int mul35468(int a) { return (a * 35468) >> 16; }

// 14.4: the inverse DCT of a 4x4 block (raster order), added to dst
void idct_add(const int16_t* in, uint8_t* dst, int stride) {
  int16_t t[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int c = mul35468(in[4 + i]) - mul20091(in[12 + i]);
    const int d = mul20091(in[4 + i]) + mul35468(in[12 + i]);
    t[4 * i] = int16_t(a + d);
    t[4 * i + 1] = int16_t(b + c);
    t[4 * i + 2] = int16_t(b - c);
    t[4 * i + 3] = int16_t(a - d);
  }
  for (int i = 0; i < 4; ++i) {
    const int a = t[i] + t[8 + i], b = t[i] - t[8 + i];
    const int c = mul35468(t[4 + i]) - mul20091(t[12 + i]);
    const int d = mul20091(t[4 + i]) + mul35468(t[12 + i]);
    uint8_t* r = dst + i * stride;
    r[0] = clip8(r[0] + ((a + d + 4) >> 3));
    r[1] = clip8(r[1] + ((b + c + 4) >> 3));
    r[2] = clip8(r[2] + ((b - c + 4) >> 3));
    r[3] = clip8(r[3] + ((a - d + 4) >> 3));
  }
}

// ------------------------------------------------------ intra prediction --

inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }
inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }

// 12.2: a 16x16 luma or 8x8 chroma predictor; the frame's border holds 127
// above and 129 to the left, DC uses only the edges inside the frame
void predict_mb(uint8_t* dst, int stride, int n, int mode, bool has_above, bool has_left) {
  const uint8_t* above = dst - stride;
  const int shift = n == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int sum = 0, v = 128;
      if (has_above && has_left) {
        for (int i = 0; i < n; ++i) sum += above[i] + dst[i * stride - 1];
        v = (sum + n) >> (shift + 1);
      } else if (has_above) {
        for (int i = 0; i < n; ++i) sum += above[i];
        v = (sum + n / 2) >> shift;
      } else if (has_left) {
        for (int i = 0; i < n; ++i) sum += dst[i * stride - 1];
        v = (sum + n / 2) >> shift;
      }
      for (int y = 0; y < n; ++y) std::memset(dst + y * stride, v, n);
      break;
    }
    case V_PRED:
      for (int y = 0; y < n; ++y) std::memcpy(dst + y * stride, above, n);
      break;
    case H_PRED:
      for (int y = 0; y < n; ++y) std::memset(dst + y * stride, dst[y * stride - 1], n);
      break;
    default: {  // TM_PRED
      const int p = above[-1];
      for (int y = 0; y < n; ++y) {
        const int l = dst[y * stride - 1] - p;
        for (int x = 0; x < n; ++x) dst[y * stride + x] = clip8(l + above[x]);
      }
    }
  }
}

// 12.3: a 4x4 sub-block predictor from A[-1..7] (above-left, above, above-right) and L[0..3]
void predict_sub(uint8_t* dst, int stride, int mode, const uint8_t* A, const uint8_t* L) {
  uint8_t B[4][4];
  const int P = A[-1];
  const int E[9] = {L[3], L[2], L[1], L[0], P, A[0], A[1], A[2], A[3]};
  switch (mode) {
    case B_DC: {
      int v = 4;
      for (int i = 0; i < 4; ++i) v += A[i] + L[i];
      std::memset(B, v >> 3, 16);
      break;
    }
    case B_TM:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) B[r][c] = clip8(L[r] + A[c] - P);
      break;
    case B_VE:
      for (int c = 0; c < 4; ++c) {
        const uint8_t v = avg3(A[c - 1], A[c], A[c + 1]);
        for (int r = 0; r < 4; ++r) B[r][c] = v;
      }
      break;
    case B_HE: {
      const uint8_t v[4] = {avg3(P, L[0], L[1]), avg3(L[0], L[1], L[2]), avg3(L[1], L[2], L[3]),
                            avg3(L[2], L[3], L[3])};
      for (int r = 0; r < 4; ++r) std::memset(B[r], v[r], 4);
      break;
    }
    case B_LD:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c)
          B[r][c] = r + c < 6 ? avg3(A[r + c], A[r + c + 1], A[r + c + 2]) : avg3(A[6], A[7], A[7]);
      break;
    case B_RD:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) B[r][c] = avg3(E[3 - r + c], E[4 - r + c], E[5 - r + c]);
      break;
    case B_VR:
      B[3][0] = avg3(E[1], E[2], E[3]);
      B[2][0] = avg3(E[2], E[3], E[4]);
      B[3][1] = B[1][0] = avg3(E[3], E[4], E[5]);
      B[2][1] = B[0][0] = avg2(E[4], E[5]);
      B[3][2] = B[1][1] = avg3(E[4], E[5], E[6]);
      B[2][2] = B[0][1] = avg2(E[5], E[6]);
      B[3][3] = B[1][2] = avg3(E[5], E[6], E[7]);
      B[2][3] = B[0][2] = avg2(E[6], E[7]);
      B[1][3] = avg3(E[6], E[7], E[8]);
      B[0][3] = avg2(E[7], E[8]);
      break;
    case B_VL:
      B[0][0] = avg2(A[0], A[1]);
      B[1][0] = avg3(A[0], A[1], A[2]);
      B[2][0] = B[0][1] = avg2(A[1], A[2]);
      B[1][1] = B[3][0] = avg3(A[1], A[2], A[3]);
      B[2][1] = B[0][2] = avg2(A[2], A[3]);
      B[3][1] = B[1][2] = avg3(A[2], A[3], A[4]);
      B[2][2] = B[0][3] = avg2(A[3], A[4]);
      B[3][2] = B[1][3] = avg3(A[3], A[4], A[5]);
      B[2][3] = avg3(A[4], A[5], A[6]);
      B[3][3] = avg3(A[5], A[6], A[7]);
      break;
    case B_HD:
      B[3][0] = avg2(E[0], E[1]);
      B[3][1] = avg3(E[0], E[1], E[2]);
      B[2][0] = B[3][2] = avg2(E[1], E[2]);
      B[2][1] = B[3][3] = avg3(E[1], E[2], E[3]);
      B[2][2] = B[1][0] = avg2(E[2], E[3]);
      B[2][3] = B[1][1] = avg3(E[2], E[3], E[4]);
      B[1][2] = B[0][0] = avg2(E[3], E[4]);
      B[1][3] = B[0][1] = avg3(E[3], E[4], E[5]);
      B[0][2] = avg3(E[4], E[5], E[6]);
      B[0][3] = avg3(E[5], E[6], E[7]);
      break;
    default:  // B_HU
      B[0][0] = avg2(L[0], L[1]);
      B[0][1] = avg3(L[0], L[1], L[2]);
      B[0][2] = B[1][0] = avg2(L[1], L[2]);
      B[0][3] = B[1][1] = avg3(L[1], L[2], L[3]);
      B[1][2] = B[2][0] = avg2(L[2], L[3]);
      B[1][3] = B[2][1] = avg3(L[2], L[3], L[3]);
      B[2][2] = B[2][3] = B[3][0] = B[3][1] = B[3][2] = B[3][3] = uint8_t(L[3]);
  }
  for (int r = 0; r < 4; ++r) std::memcpy(dst + r * stride, B[r], 4);
}

// ------------------------------------------------------ inter prediction --

// 18: a w x h block of `ref` at (x, y) displaced by (mx, my) eighths of a
// sample (the integer part by >> 3), through the six-tap filters or bilinear;
// reads past the plane's edges repeat its edge samples
void predict_inter(const Plane& ref, uint8_t* dst, int stride, int x, int y, int w, int h, int mx,
                   int my, bool sixtap, bool* edge) {
  const int fx = mx & 7, fy = my & 7;
  const int sx = x + (mx >> 3), sy = y + (my >> 3);
  // the source rectangle the filters read: two before and three after
  const int x0 = sx - 2, y0 = sy - 2, x1 = sx + w + 3, y1 = sy + h + 3;
  uint8_t tmp[(16 + 5) * (16 + 5)];
  const uint8_t* src;
  int ss;
  const bool fx_or_fy = fx || fy;
  if (fx_or_fy ? (x0 < 0 || y0 < 0 || x1 > ref.w || y1 > ref.h)
               : (sx < 0 || sy < 0 || sx + w > ref.w || sy + h > ref.h))
    edge[0] = true;
  if (x0 >= -ref.border && y0 >= -ref.border && x1 <= ref.w + ref.border &&
      y1 <= ref.h + ref.border) {
    src = ref.at(sx, sy);
    ss = ref.stride;
  } else {
    edge[1] = true;
    const int tw = w + 5;
    for (int j = 0; j < h + 5; ++j) {
      const int yy = clampi(y0 + j, 0, ref.h - 1);
      for (int i = 0; i < tw; ++i) tmp[j * tw + i] = *ref.at(clampi(x0 + i, 0, ref.w - 1), yy);
    }
    src = tmp + 2 * tw + 2;
    ss = tw;
  }
  if (!fx && !fy) {
    for (int j = 0; j < h; ++j) std::memcpy(dst + j * stride, src + j * ss, w);
    return;
  }
  uint8_t mid[(16 + 5) * 16];
  if (sixtap) {
    const int* fh = kSixtap[fx];
    const int* fv = kSixtap[fy];
    // horizontal pass over the rows the vertical pass reads (all of them when it filters)
    const int r0 = fy ? -2 : 0, r1 = fy ? h + 3 : h;
    for (int j = r0; j < r1; ++j) {
      const uint8_t* s = src + j * ss;
      uint8_t* m = mid + (j + 2) * w;
      for (int i = 0; i < w; ++i)
        m[i] = fx ? clip8((s[i - 2] * fh[0] + s[i - 1] * fh[1] + s[i] * fh[2] + s[i + 1] * fh[3] +
                           s[i + 2] * fh[4] + s[i + 3] * fh[5] + 64) >> 7)
                  : s[i];
    }
    for (int j = 0; j < h; ++j) {
      const uint8_t* m = mid + (j + 2) * w;
      for (int i = 0; i < w; ++i)
        dst[j * stride + i] =
            fy ? clip8((m[i - 2 * w] * fv[0] + m[i - w] * fv[1] + m[i] * fv[2] + m[i + w] * fv[3] +
                        m[i + 2 * w] * fv[4] + m[i + 3 * w] * fv[5] + 64) >> 7)
               : m[i];
    }
    return;
  }
  // bilinear: (a (8 - f) + b f + 4) >> 3 across, then down
  for (int j = 0; j < h + 1; ++j) {
    const uint8_t* s = src + j * ss;
    for (int i = 0; i < w; ++i) mid[j * w + i] = uint8_t((s[i] * (8 - fx) + s[i + 1] * fx + 4) >> 3);
  }
  for (int j = 0; j < h; ++j)
    for (int i = 0; i < w; ++i)
      dst[j * stride + i] = uint8_t((mid[j * w + i] * (8 - fy) + mid[(j + 1) * w + i] * fy + 4) >> 3);
}

// ---------------------------------------------------------- loop filter --
// 15, in the signed domain (sample ^ 0x80) with libvpx's clamps

inline int s8(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }

inline bool simple_limit(const uint8_t* p, int st, int e) {
  return 2 * std::abs(p[-st] - p[0]) + (std::abs(p[-2 * st] - p[st]) >> 1) <= e;
}

inline bool normal_limit(const uint8_t* p, int st, int e, int i) {
  const int p3 = p[-4 * st], p2 = p[-3 * st], p1 = p[-2 * st], p0 = p[-st];
  const int q0 = p[0], q1 = p[st], q2 = p[2 * st], q3 = p[3 * st];
  return simple_limit(p, st, e) && std::abs(p3 - p2) <= i && std::abs(p2 - p1) <= i &&
         std::abs(p1 - p0) <= i && std::abs(q3 - q2) <= i && std::abs(q2 - q1) <= i &&
         std::abs(q1 - q0) <= i;
}

inline bool high_variance(const uint8_t* p, int st, int t) {
  return std::abs(p[-2 * st] - p[-st]) > t || std::abs(p[st] - p[0]) > t;
}

// the common adjustment of p0 and q0 (with p1 - q1 when `outer`), and of
// p1 and q1 by half of it when not
inline void filter_common(uint8_t* p, int st, bool outer) {
  const int ps1 = p[-2 * st] - 128, ps0 = p[-st] - 128, qs0 = p[0] - 128, qs1 = p[st] - 128;
  int a = s8((outer ? s8(ps1 - qs1) : 0) + 3 * (qs0 - ps0));
  const int f1 = s8(a + 4) >> 3, f2 = s8(a + 3) >> 3;
  p[0] = uint8_t(s8(qs0 - f1) + 128);
  p[-st] = uint8_t(s8(ps0 + f2) + 128);
  if (!outer) {
    a = (f1 + 1) >> 1;
    p[st] = uint8_t(s8(qs1 - a) + 128);
    p[-2 * st] = uint8_t(s8(ps1 + a) + 128);
  }
}

inline void filter_mbedge(uint8_t* p, int st) {
  const int ps2 = p[-3 * st] - 128, ps1 = p[-2 * st] - 128, ps0 = p[-st] - 128;
  const int qs0 = p[0] - 128, qs1 = p[st] - 128, qs2 = p[2 * st] - 128;
  const int w = s8(s8(ps1 - qs1) + 3 * (qs0 - ps0));
  int a = s8((27 * w + 63) >> 7);
  p[0] = uint8_t(s8(qs0 - a) + 128);
  p[-st] = uint8_t(s8(ps0 + a) + 128);
  a = s8((18 * w + 63) >> 7);
  p[st] = uint8_t(s8(qs1 - a) + 128);
  p[-2 * st] = uint8_t(s8(ps1 + a) + 128);
  a = s8((9 * w + 63) >> 7);
  p[2 * st] = uint8_t(s8(qs2 - a) + 128);
  p[-3 * st] = uint8_t(s8(ps2 + a) + 128);
}

// n samples along an edge (`along` apart), across it `st` apart
void edge_normal(uint8_t* p, int st, int along, int n, int e, int i, int hev, bool mb) {
  for (int k = 0; k < n; ++k, p += along) {
    if (!normal_limit(p, st, e, i)) continue;
    if (high_variance(p, st, hev)) filter_common(p, st, true);
    else if (mb) filter_mbedge(p, st);
    else filter_common(p, st, false);
  }
}

void edge_simple(uint8_t* p, int st, int along, int n, int e) {
  for (int k = 0; k < n; ++k, p += along)
    if (simple_limit(p, st, e)) filter_common(p, st, true);
}

struct MbFilter {
  uint8_t level = 0, interior = 0, inner = 0;
};

// ---------------------------------------------------------------- decoder --

struct Peek {
  bool key = false, show = false;
  int version = 0, width = 0, height = 0, first = 0;
};

// the frame tag (9.1) and a key frame's start code and size (9.2)
Peek peek(const uint8_t* d, size_t n) {
  Peek p;
  if (n < 3) fail("VP8 frame tag: the sample holds " + std::to_string(n) + " bytes, fewer than 3");
  const uint32_t tag = d[0] | (d[1] << 8) | (d[2] << 16);
  p.key = !(tag & 1);
  p.version = (tag >> 1) & 7;
  p.show = (tag >> 4) & 1;
  p.first = int(tag >> 5);
  if (p.key) {
    if (n < 10) fail("VP8 key frame header: the sample holds " + std::to_string(n) + " bytes");
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) fail("VP8 key frame start code missing");
    p.width = (d[6] | (d[7] << 8)) & 0x3fff;
    p.height = (d[8] | (d[9] << 8)) & 0x3fff;
    if (!p.width || !p.height) fail("VP8 key frame of size 0");
  }
  return p;
}

struct Decoder {
  unsigned long long tools[2] = {0, 0};
  FramePtr last, golden, altref, shown;
  int width = 0, height = 0, mbw = 0, mbh = 0, version = 0;
  bool key = false;
  int color_space = 0, clamping = 0;
  Probs probs, saved;
  // segmentation (9.3) and loop filter deltas (9.6), kept from frame to frame
  bool seg_enabled = false, seg_update_map = false, seg_absolute = false;
  int seg_quant[4] = {0, 0, 0, 0}, seg_lf[4] = {0, 0, 0, 0};
  uint8_t seg_probs[3] = {255, 255, 255};
  bool lf_delta_enabled = false;
  int ref_delta[4] = {0, 0, 0, 0}, mode_delta[4] = {0, 0, 0, 0};
  std::vector<uint8_t> seg_map;
  // this frame's header
  bool simple = false;
  int level = 0, sharpness = 0;
  int skip_prob = 0, intra_prob = 0, last_prob = 0, golden_prob = 0;
  bool skip_enabled = false;
  int sign_bias[4] = {0, 0, 0, 0};
  int16_t qy[4][2], qy2[4][2], quv[4][2];  // per segment: (DC, AC) factors
  Bool hdr;
  std::vector<Bool> parts;
  // macroblock state
  std::vector<MbInfo> mbs;  // (mbh + 1) x (mbw + 1), a border row and column first
  std::vector<MbFilter> lf;
  std::vector<uint8_t> above_bmodes, above_nz;  // mbw x 4 and mbw x 9
  uint8_t left_bmodes[4], left_nz[9];
  int16_t coef[25][16];
  uint8_t nz[25];

  Decoder() { reset(); }

  void reset() {
    last.reset();
    golden.reset();
    altref.reset();
    shown.reset();
    width = height = mbw = mbh = 0;
  }

  void use(Tool t) { tools[t >> 6] |= 1ull << (t & 63); }

  MbInfo& mb(int x, int y) { return mbs[size_t(y + 1) * (mbw + 1) + x + 1]; }

  void resize(int w, int h) {
    if (width && (w != width || h != height)) use(T_SIZE_CHANGE);
    width = w;
    height = h;
    mbw = (w + 15) >> 4;
    mbh = (h + 15) >> 4;
    seg_map.assign(size_t(mbw) * mbh, 0);
    mbs.assign(size_t(mbw + 1) * (mbh + 1), MbInfo());
    lf.assign(size_t(mbw) * mbh, MbFilter());
    above_bmodes.assign(size_t(mbw) * 4, B_DC);
    above_nz.assign(size_t(mbw) * 9, 0);
  }

  void read_header() {
    Bool& b = hdr;
    if (key) {
      color_space = b.get(128);
      clamping = b.get(128);
      if (color_space) use(T_COLOR_SPACE);
      if (clamping) use(T_CLAMPING_TYPE);
    }
    seg_enabled = b.get(128);
    seg_update_map = false;
    if (seg_enabled) {
      use(T_SEGMENTATION);
      seg_update_map = b.get(128);
      const bool update_data = b.get(128);
      if (update_data) {
        use(T_SEG_DATA_UPDATE);
        seg_absolute = b.get(128);
        for (int i = 0; i < 4; ++i) seg_quant[i] = b.sint(7);
        for (int i = 0; i < 4; ++i) seg_lf[i] = b.sint(6);
      }
      if (seg_update_map) {
        use(T_SEG_MAP_UPDATE);
        for (int i = 0; i < 3; ++i) seg_probs[i] = b.get(128) ? uint8_t(b.literal(8)) : 255;
      } else {
        use(T_SEG_MAP_KEPT);
      }
      if (seg_absolute) use(T_SEG_ABSOLUTE);
      for (int i = 0; i < 4; ++i) {
        if (seg_quant[i]) use(T_SEG_QUANT);
        if (seg_lf[i]) use(T_SEG_FILTER);
      }
    }
    simple = b.get(128);
    level = b.literal(6);
    sharpness = b.literal(3);
    use(!level ? T_FILTER_OFF : (simple ? T_FILTER_SIMPLE : T_FILTER_NORMAL));
    if (sharpness) use(T_SHARPNESS);
    lf_delta_enabled = b.get(128);
    if (lf_delta_enabled) {
      use(T_LF_DELTAS);
      if (b.get(128)) {
        use(T_LF_DELTA_UPDATE);
        for (int i = 0; i < 4; ++i)
          if (b.get(128)) {
            ref_delta[i] = b.literal(6);
            if (b.get(128)) ref_delta[i] = -ref_delta[i];
          }
        for (int i = 0; i < 4; ++i)
          if (b.get(128)) {
            mode_delta[i] = b.literal(6);
            if (b.get(128)) mode_delta[i] = -mode_delta[i];
          }
      }
    }
    const int log2parts = b.literal(2);
    if (log2parts) use(Tool(T_PARTITIONS_2 + log2parts - 1));
    parts.assign(size_t(1) << log2parts, Bool());
    // quantiser indices (9.6)
    const int yac = b.literal(7);
    const int ydc = b.sint(4), y2dc = b.sint(4), y2ac = b.sint(4), uvdc = b.sint(4), uvac = b.sint(4);
    if (ydc || y2dc || y2ac || uvdc || uvac) use(T_QUANT_DELTAS);
    for (int s = 0; s < 4; ++s) {
      int q = yac;
      if (seg_enabled) q = seg_absolute ? seg_quant[s] : yac + seg_quant[s];
      auto at = [](int i) { return clampi(i, 0, 127); };
      qy[s][0] = kDcQ[at(q + ydc)];
      qy[s][1] = kAcQ[at(q)];
      qy2[s][0] = int16_t(kDcQ[at(q + y2dc)] * 2);
      qy2[s][1] = int16_t(std::max(kAcQ[at(q + y2ac)] * 101581 >> 16, 8));
      quv[s][0] = int16_t(std::min<int>(kDcQ[at(q + uvdc)], 132));
      quv[s][1] = kAcQ[at(q + uvac)];
    }
    // reference updates (9.7, 9.8)
    refresh_golden = refresh_altref = key;
    copy_golden = copy_altref = 0;
    if (!key) {
      refresh_golden = b.get(128);
      refresh_altref = b.get(128);
      if (!refresh_golden) copy_golden = b.literal(2);
      if (!refresh_altref) copy_altref = b.literal(2);
      sign_bias[2] = b.get(128);
      sign_bias[3] = b.get(128);
      if (refresh_golden) use(T_REFRESH_GOLDEN);
      if (refresh_altref) use(T_REFRESH_ALTREF);
      if (copy_golden == 1) use(T_GOLDEN_FROM_LAST);
      if (copy_golden == 2) use(T_GOLDEN_FROM_ALTREF);
      if (copy_altref == 1) use(T_ALTREF_FROM_LAST);
      if (copy_altref == 2) use(T_ALTREF_FROM_GOLDEN);
      if (sign_bias[2] || sign_bias[3]) use(T_SIGN_BIAS);
    }
    refresh_entropy = b.get(128);
    if (!refresh_entropy) {
      use(T_KEEP_ENTROPY);
      saved = probs;
    }
    refresh_last = key || b.get(128);
    if (!refresh_last) use(T_KEEP_LAST);
    // coefficient probability updates (13.4)
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 8; ++j)
        for (int k = 0; k < 3; ++k)
          for (int l = 0; l < 11; ++l)
            if (b.get(kCoefUpdateProbs[i][j][k][l])) {
              probs.coef[i][j][k][l] = uint8_t(b.literal(8));
              use(T_COEF_UPDATES);
            }
    skip_enabled = b.get(128);
    if (skip_enabled) skip_prob = b.literal(8);
    else use(T_NO_SKIP_FLAG);
    if (!key) {
      intra_prob = b.literal(8);
      last_prob = b.literal(8);
      golden_prob = b.literal(8);
      if (b.get(128)) {
        use(T_YMODE_UPDATE);
        for (int i = 0; i < 4; ++i) probs.ymode[i] = uint8_t(b.literal(8));
      }
      if (b.get(128)) {
        use(T_UV_MODE_UPDATE);
        for (int i = 0; i < 3; ++i) probs.uvmode[i] = uint8_t(b.literal(8));
      }
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 19; ++j)
          if (b.get(kMvUpdateProbs[i][j])) {
            use(T_MV_UPDATES);
            const int v = b.literal(7) << 1;
            probs.mv[i][j] = uint8_t(v ? v : 1);
          }
    }
  }

  bool refresh_golden = false, refresh_altref = false, refresh_entropy = true, refresh_last = true;
  int copy_golden = 0, copy_altref = 0;

  // --------------------------------------------------- modes and vectors --

  int read_mv_component(const uint8_t* p) {
    Bool& b = hdr;
    int x = 0;
    if (b.get(p[0])) {
      use(T_MV_LONG);
      for (int i = 0; i < 3; ++i) x += b.get(p[9 + i]) << i;
      for (int i = 9; i > 3; --i) x += b.get(p[9 + i]) << i;
      if (!(x & 0xFFF0) || b.get(p[12])) x += 8;
    } else {
      x = b.tree(kSmallMvTree, p + 2);
    }
    return (x && b.get(p[1])) ? -x : x;
  }

  Mv read_mv(Mv base) {
    base.y = int16_t(base.y + read_mv_component(probs.mv[0]));
    base.x = int16_t(base.x + read_mv_component(probs.mv[1]));
    return base;
  }

  void clamp_mv(Mv* mv, int x, int y) const {
    mv->x = int16_t(clampi(mv->x, -64 * (x + 1), 64 * (mbw - x)));
    mv->y = int16_t(clampi(mv->y, -64 * (y + 1), 64 * (mbh - y)));
  }

  // 16.3 (ffmpeg's vp8_decode_mvs): the near vectors of the above, left and
  // above-left macroblocks, then the mode tree with their counts as contexts
  void read_inter_modes(MbInfo& m, int x, int y) {
    Bool& b = hdr;
    const MbInfo* edge[3] = {&mb(x, y - 1), &mb(x - 1, y), &mb(x - 1, y - 1)};
    Mv near[4];
    int cnt[4] = {0, 0, 0, 0};
    int idx = 0;
    for (int n = 0; n < 3; ++n) {
      const MbInfo& e = *edge[n];
      if (!e.ref) continue;
      Mv mv = e.mv;
      if (!mv.zero()) {
        if (sign_bias[m.ref] != sign_bias[e.ref]) {
          mv.x = int16_t(-mv.x);
          mv.y = int16_t(-mv.y);
        }
        if (!n || mv != near[idx]) near[++idx] = mv;
        cnt[idx] += 1 + (n != 2);
      } else {
        cnt[0] += 1 + (n != 2);
      }
    }
    m.split = SPLIT_NONE;
    m.is_split = false;
    if (!b.get(kModeContexts[cnt[0]][0])) {
      use(T_ZERO);
      m.mv = Mv();
      m.bmv[0] = m.mv;
      m.ymode = 1;  // ZEROMV, for the loop filter's mode delta
      return;
    }
    if (cnt[3] && near[1] == near[3]) cnt[1] += 1;
    if (cnt[2] > cnt[1]) {
      std::swap(cnt[1], cnt[2]);
      std::swap(near[1], near[2]);
    }
    m.ymode = 2;  // NEAREST, NEAR or NEW
    if (!b.get(kModeContexts[cnt[1]][1])) {
      use(T_NEAREST);
      m.mv = near[1];
      clamp_mv(&m.mv, x, y);
      m.bmv[0] = m.mv;
      return;
    }
    if (!b.get(kModeContexts[cnt[2]][2])) {
      use(T_NEAR);
      m.mv = near[2];
      clamp_mv(&m.mv, x, y);
      m.bmv[0] = m.mv;
      return;
    }
    m.mv = near[cnt[1] >= cnt[0] ? 1 : 0];
    clamp_mv(&m.mv, x, y);
    const int splits = (edge[1]->is_split + edge[0]->is_split) * 2 + edge[2]->is_split;
    if (b.get(kModeContexts[splits][3])) {
      m.ymode = 3;  // SPLITMV
      m.is_split = true;
      read_split(m, x, y);
      return;
    }
    use(T_NEW);
    m.mv = read_mv(m.mv);
    m.bmv[0] = m.mv;
  }

  void read_split(MbInfo& m, int x, int y) {
    Bool& b = hdr;
    const MbInfo& left = mb(x - 1, y);
    const MbInfo& top = mb(x, y - 1);
    int part;
    if (b.get(kSplitProbs[0])) part = b.get(kSplitProbs[1]) ? SPLIT_16x8 + b.get(kSplitProbs[2]) : SPLIT_8x8;
    else part = SPLIT_4x4;
    use(Tool(part == SPLIT_16x8 ? T_SPLIT_16x8 : part == SPLIT_8x16 ? T_SPLIT_8x16
             : part == SPLIT_8x8 ? T_SPLIT_8x8 : T_SPLIT_4x4));
    m.split = uint8_t(part);
    const uint8_t* cur = kSplits[part];
    const int num = kSplitCount[part];
    for (int n = 0; n < num; ++n) {
      const int k = kSplitFirst[part][n];
      const Mv l = (k & 3) ? m.bmv[cur[k - 1]] : left.bmv[kSplits[left.split][k + 3]];
      const Mv a = k > 3 ? m.bmv[cur[k - 4]] : top.bmv[kSplits[top.split][k + 12]];
      const uint8_t* p = l == a ? kSubMvProbs[4 - !l.zero()]
                         : a.zero() ? kSubMvProbs[2] : kSubMvProbs[1 - !l.zero()];
      if (!b.get(p[0])) {
        use(T_SUB_LEFT);
        m.bmv[n] = l;
      } else if (!b.get(p[1])) {
        use(T_SUB_ABOVE);
        m.bmv[n] = a;
      } else if (!b.get(p[2])) {
        use(T_SUB_ZERO);
        m.bmv[n] = Mv();
      } else {
        use(T_SUB_NEW);
        m.bmv[n] = read_mv(m.mv);
      }
    }
    m.mv = m.bmv[num - 1];
  }

  void read_modes(MbInfo& m, int x, int y) {
    Bool& b = hdr;
    uint8_t& seg = seg_map[size_t(y) * mbw + x];
    if (seg_update_map) seg = uint8_t(b.tree(kSegmentTree, seg_probs));
    m.segment = seg_enabled ? seg : 0;
    m.skip = skip_enabled ? uint8_t(b.get(skip_prob)) : 0;
    m.is_split = false;
    m.split = SPLIT_NONE;
    m.mv = Mv();
    m.bmv[0] = Mv();
    if (key) {
      m.ref = 0;
      m.ymode = uint8_t(b.tree(kKfYmodeTree, kKfYmodeProbs));
      uint8_t* top = &above_bmodes[size_t(x) * 4];
      if (m.ymode == B_PRED) {
        use(T_B_PRED_KEY);
        for (int by = 0; by < 4; ++by)
          for (int bx = 0; bx < 4; ++bx) {
            const int mode = b.tree(kBmodeTree, kKfBmodeProbs[top[bx]][left_bmodes[by]]);
            m.bmodes[4 * by + bx] = top[bx] = left_bmodes[by] = uint8_t(mode);
          }
      } else {
        std::memset(top, kImpliedBmode[m.ymode], 4);
        std::memset(left_bmodes, kImpliedBmode[m.ymode], 4);
      }
      m.uvmode = uint8_t(b.tree(kUvModeTree, kKfUvModeProbs));
      return;
    }
    if (b.get(intra_prob)) {
      m.ref = b.get(last_prob) ? (b.get(golden_prob) ? 3 : 2) : 1;
      if (m.ref == 2) use(T_REF_GOLDEN);
      if (m.ref == 3) use(T_REF_ALTREF);
      read_inter_modes(m, x, y);
      return;
    }
    m.ref = 0;
    m.ymode = uint8_t(b.tree(kYmodeTree, probs.ymode));
    if (m.ymode == B_PRED) {
      use(T_B_PRED_INTER);
      for (int i = 0; i < 16; ++i) m.bmodes[i] = uint8_t(b.tree(kBmodeTree, kBmodeProbs));
    } else {
      use(T_I16_INTER);
    }
    m.uvmode = uint8_t(b.tree(kUvModeTree, probs.uvmode));
  }

  // --------------------------------------------------------------- tokens --

  // 13: one block's tokens from position i; the position after the last
  // token read (0 when the first is the end of block)
  int read_block(Bool& b, const uint8_t (*p)[3][11], int i, int ctx, const int16_t* q, int16_t* out) {
    const uint8_t* pr = p[kBands[i]][ctx];
    if (!b.get(pr[0])) return 0;
    while (true) {
      if (!b.get(pr[1])) {  // a zero: the next token cannot end the block
        if (++i == 16) return 16;
        pr = p[kBands[i]][0];
        continue;
      }
      int v, next;
      if (!b.get(pr[2])) {
        v = 1;
        next = 1;
      } else {
        next = 2;
        if (!b.get(pr[3])) {
          v = !b.get(pr[4]) ? 2 : 3 + b.get(pr[5]);
        } else if (!b.get(pr[6])) {
          v = !b.get(pr[7]) ? 5 + b.get(159) : 7 + 2 * b.get(165) + b.get(145);
        } else {
          const int hi = b.get(pr[8]);
          const int cat = 2 * hi + b.get(pr[9 + hi]);  // categories 3-6
          static const uint8_t* const kCats[4] = {kCat3, kCat4, kCat5, kCat6};
          static const int kBits[4] = {3, 4, 5, 11}, kBase[4] = {11, 19, 35, 67};
          if (cat == 3) use(T_TOKEN_CAT6);
          int e = 0;
          for (int k = 0; k < kBits[cat]; ++k) e = (e << 1) | b.get(kCats[cat][k]);
          v = kBase[cat] + e;
        }
      }
      out[kZigzag[i]] = int16_t((b.get(128) ? -v : v) * q[i > 0]);
      if (++i == 16) return 16;
      pr = p[kBands[i]][next];
      if (!b.get(pr[0])) return i;
    }
  }

  // the macroblock's coefficients; false when it codes none
  bool read_coefficients(Bool& b, const MbInfo& m, int x) {
    uint8_t* top = &above_nz[size_t(x) * 9];
    uint8_t* left = left_nz;
    std::memset(coef, 0, sizeof(coef));
    std::memset(nz, 0, sizeof(nz));
    const int s = m.segment;
    int total = 0, first = 0, type = 3;
    const bool has_y2 = m.ymode != B_PRED && !m.is_split;
    if (has_y2) {
      const int n = read_block(b, probs.coef[1], 0, top[8] + left[8], qy2[s], coef[24]);
      top[8] = left[8] = n > 0;
      total += n;
      if (n) inverse_wht(coef[24], coef);
      first = 1;
      type = 0;
    }
    for (int by = 0; by < 4; ++by)
      for (int bx = 0; bx < 4; ++bx) {
        const int n = read_block(b, probs.coef[type], first, top[bx] + left[by], qy[s], coef[4 * by + bx]);
        top[bx] = left[by] = n > 0;
        total += n;
      }
    for (int c = 0; c < 2; ++c)
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
          uint8_t& t = top[4 + 2 * c + bx];
          uint8_t& l = left[4 + 2 * c + by];
          const int n = read_block(b, probs.coef[2], 0, t + l, quv[s], coef[16 + 4 * c + 2 * by + bx]);
          t = l = n > 0;
          total += n;
        }
    for (int i = 0; i < 24; ++i)
      for (int k = 0; k < 16 && !nz[i]; ++k) nz[i] = coef[i][k] != 0;
    return total > 0;
  }

  // ------------------------------------------------------- reconstruction --

  void reconstruct(Frame& f, const MbInfo& m, int x, int y, bool coded) {
    Plane& Y = f.p[0];
    uint8_t* dy = Y.at(16 * x, 16 * y);
    uint8_t* du = f.p[1].at(8 * x, 8 * y);
    uint8_t* dv = f.p[2].at(8 * x, 8 * y);
    const int ys = Y.stride, cs = f.p[1].stride;
    if (!m.ref) {
      if (m.ymode == B_PRED) {
        // the macroblock's above-right: the row above; the last column repeats
        // that row's last sample, the top row reads the border's 127
        uint8_t ar[4];
        const uint8_t* above_right = dy - ys + 16;
        if (y && x == mbw - 1) {
          std::memset(ar, dy[-ys + 15], 4);
          above_right = ar;
        }
        for (int by = 0; by < 4; ++by)
          for (int bx = 0; bx < 4; ++bx) {
            uint8_t* d = dy + 4 * by * ys + 4 * bx;
            uint8_t A[9], L[4];
            A[0] = d[-ys - 1];
            std::memcpy(A + 1, d - ys, 4);
            std::memcpy(A + 5, bx == 3 ? above_right : d - ys + 4, 4);
            if (bx == 3 && !y) std::memset(A + 5, 127, 4);
            for (int i = 0; i < 4; ++i) L[i] = d[i * ys - 1];
            predict_sub(d, ys, m.bmodes[4 * by + bx], A + 1, L);
            if (coded && nz[4 * by + bx]) idct_add(coef[4 * by + bx], d, ys);
          }
      } else {
        predict_mb(dy, ys, 16, m.ymode, y > 0, x > 0);
      }
      predict_mb(du, cs, 8, m.uvmode, y > 0, x > 0);
      predict_mb(dv, cs, 8, m.uvmode, y > 0, x > 0);
    } else {
      const Frame& r = *(m.ref == 1 ? last : m.ref == 2 ? golden : altref);
      const bool six = version == 0;
      bool edge[2] = {false, false};
      if (!m.is_split) {
        predict_inter(r.p[0], dy, ys, 16 * x, 16 * y, 16, 16, m.mv.x * 2, m.mv.y * 2, six, edge);
        Mv uv = m.mv;
        if (version == 3) {
          uv.x = int16_t(uv.x & ~7);
          uv.y = int16_t(uv.y & ~7);
        }
        predict_inter(r.p[1], du, cs, 8 * x, 8 * y, 8, 8, uv.x, uv.y, six, edge);
        predict_inter(r.p[2], dv, cs, 8 * x, 8 * y, 8, 8, uv.x, uv.y, six, edge);
      } else {
        const uint8_t* part = kSplits[m.split];
        for (int k = 0; k < 16; ++k) {
          const Mv& mv = m.bmv[part[k]];
          predict_inter(r.p[0], dy + 4 * (k >> 2) * ys + 4 * (k & 3), ys, 16 * x + 4 * (k & 3),
                        16 * y + 4 * (k >> 2), 4, 4, mv.x * 2, mv.y * 2, six, edge);
        }
        for (int by = 0; by < 2; ++by)
          for (int bx = 0; bx < 2; ++bx) {
            int sx = 0, sy = 0;
            for (int k : {8 * by + 2 * bx, 8 * by + 2 * bx + 1, 8 * by + 2 * bx + 4, 8 * by + 2 * bx + 5}) {
              sx += m.bmv[part[k]].x;
              sy += m.bmv[part[k]].y;
            }
            sx = (sx + 2 + (sx >> 31)) >> 2;
            sy = (sy + 2 + (sy >> 31)) >> 2;
            if (version == 3) {
              sx &= ~7;
              sy &= ~7;
            }
            for (int c = 1; c < 3; ++c)
              predict_inter(r.p[c], f.p[c].at(8 * x + 4 * bx, 8 * y + 4 * by), cs, 8 * x + 4 * bx,
                            8 * y + 4 * by, 4, 4, sx, sy, six, edge);
          }
      }
      if (edge[0]) use(T_EDGE_MC);
      if (edge[1]) use(T_FAR_MC);
    }
    if (!coded) return;
    if (m.ref || m.ymode != B_PRED)
      for (int k = 0; k < 16; ++k)
        if (nz[k]) idct_add(coef[k], dy + 4 * (k >> 2) * ys + 4 * (k & 3), ys);
    for (int k = 0; k < 8; ++k)
      if (nz[16 + k]) idct_add(coef[16 + k], (k < 4 ? du : dv) + 4 * ((k & 3) >> 1) * cs + 4 * (k & 1), cs);
  }

  // ---------------------------------------------------------- loop filter --

  void set_filter(const MbInfo& m, MbFilter& f, bool coded) {
    int lvl = level;
    if (seg_enabled) lvl = seg_absolute ? seg_lf[m.segment] : level + seg_lf[m.segment];
    if (lf_delta_enabled) {
      lvl += ref_delta[m.ref];
      if (m.ref) lvl += mode_delta[m.ymode];            // 1 ZERO, 2 NEAREST/NEAR/NEW, 3 SPLIT
      else if (m.ymode == B_PRED) lvl += mode_delta[0];
    }
    lvl = clampi(lvl, 0, 63);
    int interior = lvl;
    if (sharpness) {
      interior >>= (sharpness + 3) >> 2;
      interior = std::min(interior, 9 - sharpness);
    }
    f.level = uint8_t(lvl);
    f.interior = uint8_t(std::max(interior, 1));
    f.inner = coded || (!m.ref && m.ymode == B_PRED) || m.is_split;
  }

  void loop_filter(Frame& f) {
    Plane& Y = f.p[0];
    Plane& U = f.p[1];
    Plane& V = f.p[2];
    const int ys = Y.stride, cs = U.stride;
    for (int y = 0; y < mbh; ++y)
      for (int x = 0; x < mbw; ++x) {
        const MbFilter& m = lf[size_t(y) * mbw + x];
        if (!m.level) continue;
        const int lvl = m.level, I = m.interior;
        const int mbe = 2 * (lvl + 2) + I, sbe = 2 * lvl + I;
        const int hev = key ? (lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0)
                            : (lvl >= 40 ? 3 : lvl >= 20 ? 2 : lvl >= 15 ? 1 : 0);
        uint8_t* py = Y.at(16 * x, 16 * y);
        uint8_t* pu = U.at(8 * x, 8 * y);
        uint8_t* pv = V.at(8 * x, 8 * y);
        if (simple) {
          if (x) edge_simple(py, 1, ys, 16, mbe);
          if (m.inner)
            for (int i = 4; i < 16; i += 4) edge_simple(py + i, 1, ys, 16, sbe);
          if (y) edge_simple(py, ys, 1, 16, mbe);
          if (m.inner)
            for (int i = 4; i < 16; i += 4) edge_simple(py + i * ys, ys, 1, 16, sbe);
          continue;
        }
        if (x) {
          edge_normal(py, 1, ys, 16, mbe, I, hev, true);
          edge_normal(pu, 1, cs, 8, mbe, I, hev, true);
          edge_normal(pv, 1, cs, 8, mbe, I, hev, true);
        }
        if (m.inner) {
          for (int i = 4; i < 16; i += 4) edge_normal(py + i, 1, ys, 16, sbe, I, hev, false);
          edge_normal(pu + 4, 1, cs, 8, sbe, I, hev, false);
          edge_normal(pv + 4, 1, cs, 8, sbe, I, hev, false);
        }
        if (y) {
          edge_normal(py, ys, 1, 16, mbe, I, hev, true);
          edge_normal(pu, cs, 1, 8, mbe, I, hev, true);
          edge_normal(pv, cs, 1, 8, mbe, I, hev, true);
        }
        if (m.inner) {
          for (int i = 4; i < 16; i += 4) edge_normal(py + i * ys, ys, 1, 16, sbe, I, hev, false);
          edge_normal(pu + 4 * cs, cs, 1, 8, sbe, I, hev, false);
          edge_normal(pv + 4 * cs, cs, 1, 8, sbe, I, hev, false);
        }
      }
  }

  // ---------------------------------------------------------- frame decode --

  // One sample (a frame). True when it shows a picture (`shown`).
  bool decode(const uint8_t* d, size_t n) {
    const Peek pk = peek(d, n);
    key = pk.key;
    if (!key && !last) fail("an inter frame before the first key frame");
    // versions 4-7 are reserved; ffmpeg decodes them as 1 and 2 (bilinear,
    // libvpx as 0): so does this decoder
    version = pk.version;
    use(Tool(version > 3 ? T_VERSION_RESERVED : T_VERSION_0 + version));
    use(key ? T_KEY_FRAME : T_INTER_FRAME);
    if (!pk.show) use(T_HIDDEN_FRAME);
    size_t pos = key ? 10 : 3;
    if (size_t(pk.first) > n - pos)
      fail("the first partition (" + std::to_string(pk.first) + " bytes) runs past the sample (" +
           std::to_string(n) + " bytes)");
    if (key) {
      if ((d[7] >> 6) || (d[9] >> 6)) use(T_SCALING_BITS);
      if (pk.width != width || pk.height != height || !mbw) resize(pk.width, pk.height);
      if ((width | height) & 1) use(T_ODD_SIZE);
      // 9.11: the probabilities' defaults, and no segmentation or deltas
      std::memcpy(probs.coef, kDefaultCoefProbs, sizeof(probs.coef));
      std::memcpy(probs.ymode, kYmodeProbs, 4);
      std::memcpy(probs.uvmode, kUvModeProbs, 3);
      std::memcpy(probs.mv, kMvDefaultProbs, sizeof(probs.mv));
      seg_enabled = seg_absolute = false;
      std::memset(seg_quant, 0, sizeof(seg_quant));
      std::memset(seg_lf, 0, sizeof(seg_lf));
      lf_delta_enabled = false;
      std::memset(ref_delta, 0, sizeof(ref_delta));
      std::memset(mode_delta, 0, sizeof(mode_delta));
      sign_bias[2] = sign_bias[3] = 0;
    }
    hdr.init(d + pos, size_t(pk.first));
    read_header();
    // token partitions (9.5): 3-byte sizes, the last takes the rest
    pos += size_t(pk.first);
    const size_t np = parts.size();
    if (3 * (np - 1) > n - pos) fail("the token partition sizes run past the sample");
    const uint8_t* sizes = d + pos;
    pos += 3 * (np - 1);
    for (size_t i = 0; i < np; ++i) {
      size_t sz = n - pos;
      if (i + 1 < np) {
        sz = sizes[3 * i] | (sizes[3 * i + 1] << 8) | (sizes[3 * i + 2] << 16);
        if (sz > n - pos)
          fail("token partition " + std::to_string(i) + " (" + std::to_string(sz) +
               " bytes) runs past the sample");
      }
      parts[i].init(d + pos, sz);
      pos += sz;
    }
    auto f = std::make_shared<Frame>();
    f->width = width;
    f->height = height;
    f->full_range = key && clamping;
    f->p[0].alloc(16 * mbw, 16 * mbh, 48);
    f->p[1].alloc(8 * mbw, 8 * mbh, 32);
    f->p[2].alloc(8 * mbw, 8 * mbh, 32);
    // the intra edges: 127 above (the corner too), 129 to the left
    for (int c = 0; c < 3; ++c) {
      Plane& P = f->p[c];
      std::memset(P.at(-1, -1), 127, P.w + 1 + P.border);
      for (int yy = 0; yy < P.h; ++yy) *P.at(-1, yy) = 129;
    }
    std::fill(above_bmodes.begin(), above_bmodes.end(), uint8_t(B_DC));
    std::fill(above_nz.begin(), above_nz.end(), uint8_t(0));
    for (int y = 0; y < mbh; ++y) {
      Bool& tb = parts[size_t(y) % np];
      std::memset(left_bmodes, B_DC, 4);
      std::memset(left_nz, 0, sizeof(left_nz));
      for (int x = 0; x < mbw; ++x) {
        MbInfo& m = mb(x, y);
        read_modes(m, x, y);
        bool coded = false;
        if (!m.skip) {
          coded = read_coefficients(tb, m, x);
        } else {
          use(T_SKIP);
          uint8_t* top = &above_nz[size_t(x) * 9];
          std::memset(top, 0, 8);
          std::memset(left_nz, 0, 8);
          if (!m.is_split && (m.ref || m.ymode != B_PRED)) top[8] = left_nz[8] = 0;  // its Y2
        }
        reconstruct(*f, m, x, y, coded);
        set_filter(m, lf[size_t(y) * mbw + x], coded);
      }
    }
    if (level) loop_filter(*f);
    for (int c = 0; c < 3; ++c) f->p[c].extend();
    // 9.7-9.8: the copies read the buffers as they stood before this frame
    FramePtr old_golden = golden, old_altref = altref, old_last = last;
    if (key || refresh_golden) golden = f;
    else if (copy_golden == 1) golden = old_last;
    else if (copy_golden == 2) golden = old_altref;
    if (key || refresh_altref) altref = f;
    else if (copy_altref == 1) altref = old_last;
    else if (copy_altref == 2) altref = old_golden;
    if (refresh_last) last = f;
    if (!refresh_entropy) probs = saved;
    if (!pk.show) return false;
    shown = f;
    return true;
  }
};

}  // namespace vp8
}  // namespace

extern "C" {

// A decoder of one VP8 track. Returns null and fills err on failure.
void* c4d_vp8_open(char* err, int err_cap) {
  try {
    return new vp8::Decoder();
  } catch (const std::exception& e) {
    std::snprintf(err, err_cap, "%s", e.what());
    return nullptr;
  }
}

// Decode one sample (a frame). info[0..4] receive: whether it shows a
// picture, its width and height, the last key frame's color_space, and
// whether the picture is a key frame whose clamping_type is 1 (cv2 then
// converts it as full range: see Frame::full_range). Returns 0,
// or -1 with the reason in err (after which the decoder holds no references).
int c4d_vp8_decode(void* dec, const uint8_t* sample, long n, int* info, char* err, int err_cap) {
  auto* d = static_cast<vp8::Decoder*>(dec);
  try {
    const bool shown = d->decode(sample, size_t(n));
    info[0] = shown;
    info[1] = shown ? d->shown->width : 0;
    info[2] = shown ? d->shown->height : 0;
    info[3] = d->color_space;
    info[4] = shown ? d->shown->full_range : 0;
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, err_cap, "%s", e.what());
    d->reset();
    return -1;
  }
}

// Copy the last shown picture into caller-owned planes (width x height luma,
// ceil(width/2) x ceil(height/2) chroma). Returns 0, or -1 when there is none.
int c4d_vp8_output(void* dec, uint8_t* y, uint8_t* u, uint8_t* v) {
  auto* d = static_cast<vp8::Decoder*>(dec);
  if (!d->shown) return -1;
  const vp8::Frame& f = *d->shown;
  uint8_t* out[3] = {y, u, v};
  for (int p = 0; p < 3; ++p) {
    const int w = p ? (f.width + 1) >> 1 : f.width, h = p ? (f.height + 1) >> 1 : f.height;
    for (int j = 0; j < h; ++j) std::memcpy(out[p] + size_t(j) * w, f.p[p].at(0, j), w);
  }
  return 0;
}

// The frame tag of a sample, without decoding: info[0..4] receive whether it
// is a key frame, whether it shows a picture, its version, and a key frame's
// width and height (0 for an inter frame). Returns 0, or -1 with the reason in err.
int c4d_vp8_scan(const uint8_t* sample, long n, int* info, char* err, int err_cap) {
  try {
    const vp8::Peek p = vp8::peek(sample, size_t(n));
    info[0] = p.key;
    info[1] = p.show;
    info[2] = p.version;
    info[3] = p.width;
    info[4] = p.height;
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, err_cap, "%s", e.what());
    return -1;
  }
}

// The Tool bits (the enum above, in order) of everything decoded since open, in two words.
void c4d_vp8_tools(void* dec, unsigned long long* out) {
  out[0] = static_cast<vp8::Decoder*>(dec)->tools[0];
  out[1] = static_cast<vp8::Decoder*>(dec)->tools[1];
}

// Forget every reference (before decoding from a key frame).
void c4d_vp8_reset(void* dec) { static_cast<vp8::Decoder*>(dec)->reset(); }

void c4d_vp8_close(void* dec) { delete static_cast<vp8::Decoder*>(dec); }

}  // extern "C"
