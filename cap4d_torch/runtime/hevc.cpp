// HEVC decoder (ITU-T H.265 (v4+), clauses 7-9, Main and Main Still Picture
// profiles): the port's counterpart of the host decode that the JAX package
// gets from cv2 (ffmpeg's hevc decoder). Built into the runtime's library
// with cap4d_runtime.cpp.
//
// Scope: 8-bit 4:2:0 pictures of I, P and B slices: VPS/SPS/PPS (VUI with
// HRD, scaling lists default/signalled/predicted, sub-layers), SEI skipped,
// slice segment headers with dependent segments and entry points, CABAC
// (initType 0-2, cabac_init_flag), the coding quadtree (CTB 16/32/64), PCM,
// cu_transquant_bypass, transform_skip, residual coding with sign data
// hiding, cu_qp_delta, chroma QP offsets, dequantisation with scaling lists
// (matrixId 3-5 for inter blocks), inverse DCT 4-32 and DST 4 (intra luma),
// the 35 intra modes with reference substitution, filtering and strong
// intra smoothing, constrained_intra_pred (inter-coded neighbours
// unavailable), tiles (uniform and explicit), wavefront parallel
// processing, several slices a picture, deblocking and SAO. Inter
// prediction: cu_skip_flag, the eight part modes (AMP), merge (spatial,
// temporal, combined bi-predictive and zero candidates, Log2ParMrgLevel
// with the shared list of 8x8 CUs, the 8x4/4x8 bi-to-uni rule), AMVP
// (spatial with scaling, temporal, zero fill, the 16-bit wrap of mvp +
// mvd), TMVP (the collocated picture's motion at 16x16 granularity, its
// slices' lists, long-term checks, POC-distance scaling), luma 8-tap and
// chroma 4-tap interpolation with edge replication, default and explicit
// weighted (bi-)prediction, rqt_root_cbf, interSplitFlag and the inferred
// cbf_luma, boundary strength 1 from coefficients and motion. The DPB:
// short- and long-term RPS (inter RPS prediction, delta_poc_msb_cycle_lt),
// reference marking, list construction with ref_pic_lists_modification.
// POC with IDR/CRA/BLA and NoRaslOutputFlag; a RASL picture of the CRA or
// BLA picture that began decoding gives no picture, as ffmpeg discards it.
// decode() returns each picture in decode order; the reader owns output
// order, which the header scan (scan_picture) gives as ffmpeg's output
// process does, its discards included.
//
// Refused by name (a ValueError on the Python side): profiles other than
// Main / Main Still Picture, chroma formats other than 4:2:0, bit depths
// other than 8 (Main 10), the range, multilayer, 3D and screen content
// extensions, field coding (field_seq_flag), tiles and wavefronts together
// (Main profile forbids them), a slice segment under another PPS than its
// picture's first slice found (ffmpeg's "PPS changed between slices"), P
// and B slices in an IRAP picture (ffmpeg's "Inter slices in an IRAP
// frame"), a P or B slice whose RPS holds no picture it may use, a slice
// whose RPS names another count of such pictures than its picture's first
// slice (ffmpeg builds every slice's lists from the first slice's), a
// list_entry past the initial list (ffmpeg's "Invalid reference index"), a
// reference picture of another size than the current picture, and a
// non-IRAP picture that would predict from a picture the DPB does not hold.
// A repeated parameter set keeps the one held, as in ffmpeg; a picture
// decodes under copies of the sets its first slice found.
//
// Where ffmpeg departs from the standard the decoder does as ffmpeg does:
// - a slice whose header overrides deblocking to disabled keeps the beta and
//   tC offsets of the slice header parsed before it (ffmpeg sets none), which
//   the deblocking of a neighbouring CTB's edges can read;
// - the in-loop filters run in ffmpeg's per-CTB schedule, so SAO reads the
//   chroma samples of a CTB 16 picture's next column before their
//   horizontal deblocking where ffmpeg does, and the deblocking offsets
//   follow ffmpeg's loop variables at CTB boundaries;
// - SAO across a slice boundary follows the slice_loop_filter_across_
//   slices_enabled_flag of the CTB being filtered, on all four sides (the
//   standard takes the later slice's flag for its right and lower
//   neighbours);
// - the chroma deblocking QP index clips qPi to 0..57 before Table 8-10;
// - SAO leaves the chroma samples of PCM (pcm_loop_filter_disabled_flag) and
//   transquant-bypass blocks unfiltered only within the CTB's top-left
//   quarter (ffmpeg's restore_tqb_pixels takes the chroma CTB's width and
//   height in luma units); elsewhere it filters them;
// - with constrained_intra_pred_flag and a minimum CB of 16, a 4x4 luma
//   block on an 8-sample column takes its left and bottom-left samples as
//   unavailable (ffmpeg's prediction-unit scan of the left column);
// - the POC's previous MSB and LSB come from a C remainder (negative for a
//   negative prevTid0Pic order count);
// - a picture the RPS names and the DPB does not hold is generated (every
//   sample 1 << (bit depth - 1), never output) for an IRAP picture, and a
//   non-IRAP picture that would predict from one is refused (ffmpeg 8:
//   "Could not find ref with POC", "Error constructing the frame RPS");
//   ffmpeg refuses a non-IRAP picture whose Foll sets name one too, which
//   the port generates instead, since it changes no sample and the reader
//   skips pictures nothing refers to;
// - an RPS predicted from another derives its deltas as ffmpeg does (sorted,
//   the negative ones turned round), and counts a delta of 0 as a positive
//   picture (the standard drops it; the writer never codes one);
// - the boundary strength of a prediction edge compares the reference
//   pictures' POCs, each side's through its own slice's lists, and motion
//   is kept per minimum prediction block (ffmpeg's tab_mvf);
// - a generated picture's motion is whatever ffmpeg's buffer pool held: the
//   port reads it as intra (no temporal candidate), and the writer never
//   makes one the collocated picture;
// - output (the header scan): at an IRAP picture with NoRaslOutputFlag the
//   pictures waiting for output are output, or discarded with
//   no_output_of_prior_pics_flag or at a CRA (ffmpeg infers the flag after
//   an end of sequence), then pictures are bumped while more than
//   sps_max_num_reorder_pics wait or the DPB holds more than
//   sps_max_dec_pic_buffering (ffmpeg's ff_hevc_output_frames);
//   sps_max_latency_increase_plus1 plays no part, as in ffmpeg;
// - a picture that activates another SPS than the last picture's (a set sent
//   anew with other bytes, or another id) drops every reference picture and
//   starts a sequence, though a CRA's RASL pictures still decode (from
//   generated pictures), and at an IRAP picture other than a CRA a new size
//   or DPB size outputs the
//   pictures still waiting whatever its no_output_of_prior_pics_flag
//   (ffmpeg's hls_slice_header; the standard changes the SPS only at an IRAP
//   picture that starts a coded video sequence).
//
// Layout: bit reader, parameter sets, slice header, CABAC, coding tree,
// residuals and transforms, intra prediction, the DPB, motion data and
// sample prediction, in-loop filters, decoder, C API.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {
namespace hevc {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Error(what); }

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline uint8_t clip1(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// The tools a decode used (hevc.py's TOOLS, in this order).
enum Tool : int {
  T_IDR, T_CRA, T_BLA, T_TRAIL, T_RADL, T_RASL_SKIPPED, T_CTB16, T_CTB32, T_CTB64, T_TILES_UNIFORM,
  T_TILES_EXPLICIT, T_WPP, T_DEPENDENT_SLICES, T_SLICES, T_SCALING_DEFAULT, T_SCALING_SPS,
  T_SCALING_PPS, T_SCALING_PRED, T_PCM, T_PCM_NO_FILTER, T_BYPASS, T_TRANSFORM_SKIP, T_SIGN_HIDING,
  T_CU_QP_DELTA, T_CHROMA_QP_OFFSET, T_SLICE_CHROMA_QP_OFFSET, T_SAO_BAND, T_SAO_EDGE, T_SAO_MERGE,
  T_DEBLOCK, T_DEBLOCK_DISABLED, T_DEBLOCK_OVERRIDE, T_NO_FILTER_ACROSS_SLICES,
  T_NO_FILTER_ACROSS_TILES, T_CONSTRAINED_INTRA, T_STRONG_SMOOTHING, T_INTRA_NXN, T_TU4, T_TU8,
  T_TU16, T_TU32, T_CONFORMANCE_WINDOW, T_VUI, T_FULL_RANGE, T_RPS_SYNTAX, T_LONG_TERM_SYNTAX,
  T_ENTRY_POINTS, T_HEADER_EXTENSION, T_POC_REORDER, T_MIN_CB16, T_HRD, T_OUTPUT_FLAG,
  T_PLANAR, T_DC, T_ANGULAR, T_CHROMA_DM,
  // inter pictures
  T_P_SLICE, T_B_SLICE, T_SKIP, T_MERGE, T_AMVP, T_TMVP, T_AMP, T_INTER_NXN, T_BI_PRED,
  T_BI_TO_UNI, T_PARALLEL_MERGE, T_NO_RESIDUAL, T_WEIGHTED_PRED, T_WEIGHTED_BIPRED, T_LONG_TERM_REF,
  T_LIST_MODIFICATION, T_MISSING_REF, T_TEMPORAL_LAYERS, T_CABAC_INIT_FLAG, T_MVD_L1_ZERO,
  T_MV_OUTSIDE, T_CIP_INTER, T_DISCARD_PRIOR, T_COUNT
};
using Tools = unsigned __int128;
inline Tools bit(int t) { return Tools(1) << t; }
static_assert(T_COUNT <= 128, "the tool bits fit 128");

enum Nal : int {
  TRAIL_N = 0, TRAIL_R = 1, TSA_N = 2, TSA_R = 3, STSA_N = 4, STSA_R = 5, RADL_N = 6, RADL_R = 7,
  RASL_N = 8, RASL_R = 9, BLA_W_LP = 16, BLA_W_RADL = 17, BLA_N_LP = 18, IDR_W_RADL = 19,
  IDR_N_LP = 20, CRA_NUT = 21, VPS_NUT = 32, SPS_NUT = 33, PPS_NUT = 34, EOS_NUT = 36, EOB_NUT = 37
};

inline bool is_irap(int t) { return t >= 16 && t <= 23; }
inline bool is_idr(int t) { return t == IDR_W_RADL || t == IDR_N_LP; }
inline bool is_bla(int t) { return t >= BLA_W_LP && t <= BLA_N_LP; }

// ------------------------------------------------------------------ tables --

// Table 8-12 / 8-13: intraPredAngle and invAngle by mode
const int kAngle[35] = {0,   0,   32,  26,  21,  17,  13,  9,  5,  2,  0,  -2, -5, -9, -13, -17, -21, -26,
                        -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5,  9,  13, 17, 21,  26,  32};
const int kInvAngle[35] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -4096, -1638, -910, -630, -482, -390, -315,
                           -256, -315, -390, -482, -630, -910, -1638, -4096, 0, 0, 0, 0, 0, 0, 0, 0, 0};
const int kLevelScale[6] = {40, 45, 51, 57, 64, 72};
// Table 8-10 (ChromaArrayType 1): QpC for qPi 30..43
const int kQpC[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37};
// Table 8-12: beta' and tC'
const uint8_t kBeta[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  6,  7,
                           8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
                           34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64};
const uint8_t kTc[54] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,  1,  1,  1,  1, 1,
                         2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24};
// Table 7-6: the default 8x8 lists in up-right diagonal order
const uint8_t kDefaultIntra[64] = {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 16, 17, 16, 17, 18,
                                   17, 18, 18, 17, 18, 21, 19, 20, 21, 20, 19, 21, 24, 22, 22, 24,
                                   24, 22, 22, 24, 25, 25, 27, 30, 27, 25, 25, 29, 31, 35, 35, 31,
                                   29, 36, 41, 44, 41, 36, 47, 54, 54, 47, 65, 70, 65, 88, 88, 115};
const uint8_t kDefaultInter[64] = {16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 17, 17, 17, 17, 17, 18,
                                   18, 18, 18, 18, 18, 20, 20, 20, 20, 20, 20, 20, 24, 24, 24, 24,
                                   24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 28, 28, 28, 28, 28,
                                   28, 33, 33, 33, 33, 33, 41, 41, 41, 41, 54, 54, 54, 71, 71, 91};
// DST 4x4 (8.6.4.2)
const int kDst[4][4] = {{29, 55, 74, 84}, {74, 74, 0, -74}, {84, -29, -74, 55}, {55, -84, 74, -29}};
// Table 9-... : ctxIdxMap of sig_coeff_flag in 4x4 blocks
const uint8_t kCtxIdxMap[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};

// rangeTabLPS and transIdxLps (Tables 9-52, 9-53)
const uint8_t kRangeLps[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216}, {123, 150, 178, 205},
    {116, 142, 169, 195}, {111, 135, 160, 185}, {105, 128, 152, 175}, {100, 122, 144, 166},
    {95, 116, 137, 158},  {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},   {66, 80, 95, 110},
    {62, 76, 90, 104},    {59, 72, 86, 99},     {56, 69, 81, 94},     {53, 65, 77, 89},
    {51, 62, 73, 85},     {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},     {35, 43, 51, 59},
    {33, 41, 48, 56},     {32, 39, 46, 53},     {30, 37, 43, 50},     {29, 35, 41, 48},
    {27, 33, 39, 45},     {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},     {19, 23, 27, 31},
    {18, 22, 26, 30},     {17, 21, 25, 28},     {16, 20, 23, 27},     {15, 19, 22, 25},
    {14, 18, 21, 24},     {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},     {10, 12, 15, 17},
    {10, 12, 14, 16},     {9, 11, 13, 15},      {9, 11, 12, 14},      {8, 10, 12, 14},
    {8, 9, 11, 13},       {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},         {2, 2, 2, 2}};
const uint8_t kTransLps[64] = {0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12,
                               13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
                               24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
                               33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};

// Context layout and the init values of Tables 9-5 to 9-37 for initType 0
// (I slices), 1 and 2 (P and B slices; cabac_init_flag swaps them). The
// inter contexts follow the I-slice ones; 154 (CNU) where a type has none.
enum Ctx : int {
  C_SAO_MERGE = 0, C_SAO_TYPE = 1, C_SPLIT_CU = 2, C_BYPASS = 5, C_PART = 6, C_PREV_INTRA = 7,
  C_CHROMA_MODE = 8, C_SPLIT_TU = 9, C_CBF_LUMA = 12, C_CBF_CHROMA = 14, C_QP_DELTA = 18,
  C_TS = 20, C_LAST_X = 22, C_LAST_Y = 40, C_CSBF = 58, C_SIG = 62, C_GT1 = 104, C_GT2 = 128,
  C_SKIP = 134, C_PRED_MODE = 137, C_PART_INTER = 138, C_MERGE_FLAG = 141, C_MERGE_IDX = 142,
  C_INTER_PRED = 143, C_REF_IDX = 148, C_MVD_GT0 = 150, C_MVD_GT1 = 151, C_MVP = 152,
  C_RQT_ROOT = 153, C_COUNT = 154
};
const uint8_t kInit[3][C_COUNT] = {
    {153, 200, 139, 141, 157, 154, 184, 184, 63, 153, 138, 138, 111, 141, 94, 138, 182, 154, 154,
     154, 139, 139,
     // last_sig_coeff_x_prefix, y_prefix
     110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63,
     110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63,
     // coded_sub_block_flag
     91, 171, 134, 141,
     // sig_coeff_flag
     111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179,
     153, 125, 107, 125, 141, 179, 153, 125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139,
     111, 136, 139, 111,
     // coeff_abs_level_greater1_flag
     140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152, 140, 179, 166,
     182, 140, 227, 122, 197,
     // coeff_abs_level_greater2_flag
     138, 153, 136, 167, 152, 152,
     // cu_skip_flag .. rqt_root_cbf
     154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154, 154,
     154},
    {153, 185, 107, 139, 126, 154, 154, 154, 152, 124, 138, 94, 153, 111, 149, 107, 167, 154, 154,
     154, 139, 139,
     125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108,
     125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108,
     121, 140, 61, 154,
     155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136,
     153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183,
     140, 151, 183, 140,
     154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137, 169, 194, 166,
     167, 154, 167, 137, 182,
     107, 167, 91, 122, 107, 167,
     // cu_skip_flag (3), pred_mode_flag, part_mode bins 1-3, merge_flag, merge_idx,
     // inter_pred_idc (5), ref_idx (2), abs_mvd_greater0/1, mvp_flag, rqt_root_cbf
     197, 185, 201, 149, 139, 154, 154, 110, 122, 95, 79, 63, 31, 31, 153, 153, 140, 198, 168, 79},
    {153, 160, 107, 139, 126, 154, 154, 183, 152, 224, 167, 122, 153, 111, 149, 92, 167, 154, 154,
     154, 139, 139,
     125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93,
     125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93,
     121, 140, 61, 154,
     170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136,
     153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183,
     140, 151, 183, 140,
     154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122, 169, 208, 166,
     167, 154, 152, 167, 182,
     107, 167, 91, 107, 107, 167,
     197, 185, 201, 134, 139, 154, 154, 154, 137, 95, 79, 63, 31, 31, 153, 153, 169, 198, 168, 79}};

// 8.5.3.3.3: luma 8-tap (quarter sample) and chroma 4-tap (eighth sample) filters
const int kLumaFilter[4][8] = {{0, 0, 0, 64, 0, 0, 0, 0},
                               {-1, 4, -10, 58, 17, -5, 1, 0},
                               {-1, 4, -11, 40, 40, -11, 4, -1},
                               {0, 1, -5, 17, 58, -10, 4, -1}};
const int kChromaFilter[8][4] = {{0, 64, 0, 0},     {-2, 58, 10, -2}, {-4, 54, 16, -2},
                                 {-6, 46, 28, -4},  {-4, 36, 36, -4}, {-4, 28, 46, -6},
                                 {-2, 16, 54, -4},  {-2, 10, 58, -2}};

// ScanOrder[log2 block size][scanIdx][sPos] = (x, y), for sizes 1x1..8x8
struct Scans {
  uint8_t xy[4][3][64][2];
  Scans() {
    for (int l = 0; l < 4; ++l) {
      const int n = 1 << l;
      int i = 0, x = 0, y = 0;
      while (i < n * n) {            // up-right diagonal
        while (y >= 0) {
          if (x < n && y < n) {
            xy[l][0][i][0] = uint8_t(x);
            xy[l][0][i][1] = uint8_t(y);
            ++i;
          }
          --y;
          ++x;
        }
        y = x;
        x = 0;
      }
      for (int j = 0; j < n * n; ++j) {
        xy[l][1][j][0] = uint8_t(j % n);   // horizontal
        xy[l][1][j][1] = uint8_t(j / n);
        xy[l][2][j][0] = uint8_t(j / n);   // vertical
        xy[l][2][j][1] = uint8_t(j % n);
      }
    }
  }
};
const Scans kScans;

// The 32-point DCT matrix (8.6.4.2): every entry is +-one magnitude per cosine index
struct Dct {
  int8_t m[32][32];
  Dct() {
    int c[33] = {0};
    const int odd32[16] = {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4};
    const int odd16[8] = {90, 87, 80, 70, 57, 43, 25, 9};
    const int odd8[4] = {89, 75, 50, 18};
    for (int i = 0; i < 16; ++i) c[2 * i + 1] = odd32[i];
    for (int i = 0; i < 8; ++i) c[4 * i + 2] = odd16[i];
    for (int i = 0; i < 4; ++i) c[8 * i + 4] = odd8[i];
    c[8] = 83;
    c[24] = 36;
    c[0] = c[16] = 64;
    for (int k = 0; k < 32; ++k)
      for (int n = 0; n < 32; ++n) {
        int a = ((2 * n + 1) * k) % 128;
        if (a > 64) a = 128 - a;
        m[k][n] = int8_t(a > 32 ? -c[64 - a] : c[a]);
      }
  }
};
const Dct kDct;

// ------------------------------------------------------------- bit reader --

class Bits {
 public:
  Bits(const uint8_t* d, size_t n) : d_(d), n_(n) {}
  uint32_t u(int k, const char* what) {
    if (pos_ + size_t(k) > 8 * n_) fail(std::string("the stream ends inside ") + what);
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++pos_) v = (v << 1) | ((d_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1u);
    return v;
  }
  bool flag(const char* what) { return u(1, what) != 0; }
  uint32_t ue(const char* what) {
    int zeros = 0;
    while (!u(1, what))
      if (++zeros > 31) fail(std::string("a malformed Exp-Golomb code in ") + what);
    return zeros ? ((1u << zeros) - 1 + u(zeros, what)) : 0;
  }
  int32_t se(const char* what) {
    const uint32_t k = ue(what);
    return (k & 1) ? int32_t((k >> 1) + 1) : -int32_t(k >> 1);
  }
  // ue bounded to [lo, hi]
  int ue_in(const char* what, int lo, int hi) {
    const uint32_t v = ue(what);
    if (v < uint32_t(lo) || v > uint32_t(hi))
      fail(std::string(what) + " = " + std::to_string(v) + " is outside " + std::to_string(lo) +
           ".." + std::to_string(hi));
    return int(v);
  }
  int se_in(const char* what, int lo, int hi) {
    const int v = se(what);
    if (v < lo || v > hi)
      fail(std::string(what) + " = " + std::to_string(v) + " is outside " + std::to_string(lo) +
           ".." + std::to_string(hi));
    return v;
  }
  void skip(size_t k, const char* what) {
    if (pos_ + k > 8 * n_) fail(std::string("the stream ends inside ") + what);
    pos_ += k;
  }
  size_t pos() const { return pos_; }
  size_t bits() const { return 8 * n_; }
  void align() { pos_ = (pos_ + 7) & ~size_t(7); }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
};

// A NAL unit's payload after its 2-byte header, emulation prevention removed.
std::vector<uint8_t> unescape(const uint8_t* p, size_t n) {
  std::vector<uint8_t> out;
  out.reserve(n);
  int zeros = 0;
  for (size_t i = 0; i < n; ++i) {
    if (zeros >= 2 && p[i] == 3) {
      zeros = 0;
      continue;
    }
    out.push_back(p[i]);
    zeros = p[i] == 0 ? zeros + 1 : 0;
  }
  return out;
}

// ---------------------------------------------------------- parameter sets --

struct ScalingList {
  uint8_t sl[4][6][64];   // sizeId 0: 16 entries; others 64 (8x8), up-right diagonal order
  uint8_t dc[2][6];       // sizeId 2, 3
  void set_default() {
    for (int m = 0; m < 6; ++m) {
      std::memset(sl[0][m], 16, 16);
      for (int s = 1; s < 4; ++s) std::memcpy(sl[s][m], m < 3 ? kDefaultIntra : kDefaultInter, 64);
      dc[0][m] = dc[1][m] = 16;
    }
  }
};

void parse_scaling_list(Bits& b, ScalingList& sl, Tools& tools) {
  sl.set_default();
  for (int size = 0; size < 4; ++size)
    for (int m = 0; m < 6; m += (size == 3) ? 3 : 1) {
      if (!b.flag("scaling_list_pred_mode_flag")) {
        int delta = int(b.ue("scaling_list_pred_matrix_id_delta"));
        if (delta) {
          tools |= bit(T_SCALING_PRED);
          delta *= (size == 3) ? 3 : 1;
          if (m < delta) fail("scaling_list_pred_matrix_id_delta points before the first matrix");
          std::memcpy(sl.sl[size][m], sl.sl[size][m - delta], size ? 64 : 16);
          if (size > 1) sl.dc[size - 2][m] = sl.dc[size - 2][m - delta];
        } else {
          if (size == 0)
            std::memset(sl.sl[0][m], 16, 16);
          else
            std::memcpy(sl.sl[size][m], m < 3 ? kDefaultIntra : kDefaultInter, 64);
          if (size > 1) sl.dc[size - 2][m] = 16;
        }
      } else {
        int next = 8;
        const int n = std::min(64, 1 << (4 + (size << 1)));
        if (size > 1) {
          next = b.se_in("scaling_list_dc_coef_minus8", -7, 247) + 8;
          sl.dc[size - 2][m] = uint8_t(next);
        }
        for (int i = 0; i < n; ++i) {
          const int delta = b.se_in("scaling_list_delta_coef", -128, 127);
          next = (next + delta + 256) % 256;
          sl.sl[size][m][i] = uint8_t(next);
        }
      }
    }
}

// A short-term reference picture set: DeltaPoc and UsedByCurrPic, the
// negative pictures first (closest first), then the positive ones.
struct StRps {
  int num_negative = 0, num_delta = 0;
  int delta[32] = {0};
  bool used[32] = {false};
};

struct Vps {
  bool present = false;
};

struct Sps {
  bool present = false;
  int vps_id = 0, max_sub_layers = 1, profile = 0, chroma_format = 1;
  int width = 0, height = 0;             // pic_width/height_in_luma_samples
  int conf_left = 0, conf_right = 0, conf_top = 0, conf_bottom = 0;   // luma samples
  int log2_max_poc_lsb = 4;
  int max_dec_pic_buffering = 1, num_reorder = 0;
  int log2_min_cb = 3, log2_ctb = 4, log2_min_tb = 2, log2_max_tb = 5;
  int max_th_depth_intra = 0, max_th_depth_inter = 0;
  bool amp = false;
  bool scaling_list_enabled = false, scaling_data = false;
  ScalingList scaling;
  bool sao = false, pcm = false;
  int pcm_bits_luma = 8, pcm_bits_chroma = 8, log2_min_pcm = 3, log2_max_pcm = 3;
  bool pcm_loop_filter_disabled = false;
  int num_st_rps = 0;
  std::vector<StRps> st_rps;
  bool long_term_present = false;
  int num_lt_sps = 0;
  int lt_poc_lsb[32] = {0};
  bool lt_used[32] = {false};
  bool temporal_mvp = false, strong_intra_smoothing = false;
  // VUI
  bool vui = false, full_range = false;
  int matrix = 2, chroma_loc = -1;
  // derived
  int ctb_w = 0, ctb_h = 0;
  std::vector<uint8_t> raw;   // the RBSP, to tell a repeat from a new set
};

struct Pps {
  bool present = false;
  int sps_id = 0;
  bool dependent_slices = false, output_flag_present = false, sign_hiding = false;
  int extra_slice_header_bits = 0;
  int init_qp = 26;
  bool constrained_intra = false, transform_skip = false, cu_qp_delta = false;
  int diff_cu_qp_delta_depth = 0, cb_qp_offset = 0, cr_qp_offset = 0;
  bool slice_chroma_qp_offsets = false, transquant_bypass = false;
  bool tiles = false, wpp = false, uniform = true, lf_across_tiles = true;
  std::vector<int> col_explicit, row_explicit;
  int num_cols = 1, num_rows = 1;
  bool lf_across_slices = false, deblock_override = false, deblock_disabled = false;
  int beta_offset = 0, tc_offset = 0;   // *2
  bool scaling_present = false;
  ScalingList scaling;
  bool header_extension = false;
  int num_ref_idx_default[2] = {1, 1};
  bool cabac_init_present = false, weighted_pred = false, weighted_bipred = false;
  bool lists_modification = false;
  int log2_par_mrg = 2;
  std::vector<uint8_t> raw;
};

void parse_ptl(Bits& b, int sub_layers_minus1, int& profile) {
  b.u(2, "general_profile_space");
  b.u(1, "general_tier_flag");
  profile = int(b.u(5, "general_profile_idc"));
  const uint32_t compat = b.u(32, "general_profile_compatibility_flag");
  if (profile == 0) {    // take the profile a compatibility flag names
    for (int j = 1; j < 32; ++j)
      if (compat >> (31 - j) & 1) {
        profile = j;
        break;
      }
  }
  b.skip(48, "general constraint flags");
  b.u(8, "general_level_idc");
  int prof[8] = {0}, lev[8] = {0};
  for (int i = 0; i < sub_layers_minus1; ++i) {
    prof[i] = b.flag("sub_layer_profile_present_flag");
    lev[i] = b.flag("sub_layer_level_present_flag");
  }
  if (sub_layers_minus1 > 0)
    for (int i = sub_layers_minus1; i < 8; ++i) b.u(2, "reserved_zero_2bits");
  for (int i = 0; i < sub_layers_minus1; ++i) {
    if (prof[i]) b.skip(88, "sub_layer profile");
    if (lev[i]) b.skip(8, "sub_layer_level_idc");
  }
}

void parse_sub_layer_hrd(Bits& b, int cpb_cnt, bool sub_pic) {
  for (int i = 0; i < cpb_cnt; ++i) {
    b.ue("bit_rate_value_minus1");
    b.ue("cpb_size_value_minus1");
    if (sub_pic) {
      b.ue("cpb_size_du_value_minus1");
      b.ue("bit_rate_du_value_minus1");
    }
    b.u(1, "cbr_flag");
  }
}

void parse_hrd(Bits& b, bool common, int max_sub_layers_minus1) {
  bool nal = false, vcl = false, sub_pic = false;
  if (common) {
    nal = b.flag("nal_hrd_parameters_present_flag");
    vcl = b.flag("vcl_hrd_parameters_present_flag");
    if (nal || vcl) {
      sub_pic = b.flag("sub_pic_hrd_params_present_flag");
      if (sub_pic) {
        b.u(8, "tick_divisor_minus2");
        b.u(5, "du_cpb_removal_delay_increment_length_minus1");
        b.u(1, "sub_pic_cpb_params_in_pic_timing_sei_flag");
        b.u(5, "dpb_output_delay_du_length_minus1");
      }
      b.u(4, "bit_rate_scale");
      b.u(4, "cpb_size_scale");
      if (sub_pic) b.u(4, "cpb_size_du_scale");
      b.u(5, "initial_cpb_removal_delay_length_minus1");
      b.u(5, "au_cpb_removal_delay_length_minus1");
      b.u(5, "dpb_output_delay_length_minus1");
    }
  }
  for (int i = 0; i <= max_sub_layers_minus1; ++i) {
    bool fixed = b.flag("fixed_pic_rate_general_flag");
    if (!fixed) fixed = b.flag("fixed_pic_rate_within_cvs_flag");
    bool low_delay = false;
    if (fixed)
      b.ue("elemental_duration_in_tc_minus1");
    else
      low_delay = b.flag("low_delay_hrd_flag");
    int cpb_cnt = 1;
    if (!low_delay) cpb_cnt = b.ue_in("cpb_cnt_minus1", 0, 31) + 1;
    if (nal) parse_sub_layer_hrd(b, cpb_cnt, sub_pic);
    if (vcl) parse_sub_layer_hrd(b, cpb_cnt, sub_pic);
  }
}

// st_ref_pic_set(idx) (7.3.7, 7.4.8): ``sets`` are the SPS's sets parsed
// so far (all of them in a slice header, where idx is their count). A set
// predicted from another is derived as ffmpeg derives it (the deltas
// sorted, the negative ones closest first; a delta of 0 counts as
// positive).
void parse_st_rps(Bits& b, int idx, int num_sps_sets, const std::vector<StRps>& sets, StRps& rps,
                  bool& predicted) {
  rps = StRps();
  predicted = idx != 0 && b.flag("inter_ref_pic_set_prediction_flag");
  if (predicted) {
    int delta_idx = 1;
    if (idx == num_sps_sets) delta_idx = b.ue_in("delta_idx_minus1", 0, idx - 1) + 1;
    const int sign = int(b.u(1, "delta_rps_sign"));
    const int delta_rps = (1 - 2 * sign) * (b.ue_in("abs_delta_rps_minus1", 0, 32767) + 1);
    const StRps& ref = sets[size_t(idx - delta_idx)];
    int k = 0, k0 = 0;
    for (int j = 0; j <= ref.num_delta; ++j) {
      const bool used = b.flag("used_by_curr_pic_flag");
      const bool use_delta = used || b.flag("use_delta_flag");
      if (!use_delta) continue;
      if (k >= 32) fail("an inter-predicted reference picture set of more than 32 pictures");
      const int d = j < ref.num_delta ? delta_rps + ref.delta[j] : delta_rps;
      rps.delta[k] = d;
      rps.used[k] = used;
      k0 += d < 0;
      ++k;
    }
    rps.num_delta = k;
    rps.num_negative = k0;
    // ascending, the flags with their deltas (ffmpeg's insertion sort), then
    // the negative ones turned round: closest first
    std::pair<int, bool> v[32];
    for (int i = 0; i < k; ++i) v[i] = {rps.delta[i], rps.used[i]};
    std::stable_sort(v, v + k, [](const std::pair<int, bool>& x, const std::pair<int, bool>& y) {
      return x.first < y.first;
    });
    std::reverse(v, v + k0);
    for (int i = 0; i < k; ++i) {
      rps.delta[i] = v[i].first;
      rps.used[i] = v[i].second;
    }
    return;
  }
  const int neg = b.ue_in("num_negative_pics", 0, 16);
  const int pos = b.ue_in("num_positive_pics", 0, 16);
  if (neg + pos > 16) fail("num_negative_pics + num_positive_pics exceeds 16");
  int prev = 0;
  for (int i = 0; i < neg; ++i) {
    prev -= b.ue_in("delta_poc_s0_minus1", 0, 32767) + 1;
    rps.delta[i] = prev;
    rps.used[i] = b.flag("used_by_curr_pic_s0_flag");
  }
  prev = 0;
  for (int i = 0; i < pos; ++i) {
    prev += b.ue_in("delta_poc_s1_minus1", 0, 32767) + 1;
    rps.delta[neg + i] = prev;
    rps.used[neg + i] = b.flag("used_by_curr_pic_s1_flag");
  }
  rps.num_negative = neg;
  rps.num_delta = neg + pos;
}

void parse_vps(Bits& b, std::vector<Vps>& vpss) {
  const int id = int(b.u(4, "vps_video_parameter_set_id"));
  vpss[size_t(id)].present = true;
}

// Parses an SPS into `s`; returns its id.
int parse_sps(Bits& b, Sps& s, const std::vector<Vps>& vpss, Tools& tools) {
  s.vps_id = int(b.u(4, "sps_video_parameter_set_id"));
  s.max_sub_layers = int(b.u(3, "sps_max_sub_layers_minus1")) + 1;
  if (s.max_sub_layers > 7) fail("sps_max_sub_layers_minus1 is 7 (reserved)");
  b.u(1, "sps_temporal_id_nesting_flag");
  parse_ptl(b, s.max_sub_layers - 1, s.profile);
  const int id = b.ue_in("sps_seq_parameter_set_id", 0, 15);
  if (!vpss[size_t(s.vps_id)].present)
    fail("the SPS refers to VPS " + std::to_string(s.vps_id) + ", which the stream has not sent");
  s.chroma_format = b.ue_in("chroma_format_idc", 0, 3);
  if (s.chroma_format != 1) {
    const char* fmt[] = {"4:0:0 (monochrome)", "4:2:0", "4:2:2", "4:4:4"};
    fail(std::string("chroma_format_idc ") + std::to_string(s.chroma_format) + " (" +
         fmt[s.chroma_format] + ") is not supported; the port decodes 4:2:0");
  }
  s.width = b.ue_in("pic_width_in_luma_samples", 1, 16888);
  s.height = b.ue_in("pic_height_in_luma_samples", 1, 16888);
  if (b.flag("conformance_window_flag")) {
    tools |= bit(T_CONFORMANCE_WINDOW);
    s.conf_left = 2 * b.ue_in("conf_win_left_offset", 0, 8192);
    s.conf_right = 2 * b.ue_in("conf_win_right_offset", 0, 8192);
    s.conf_top = 2 * b.ue_in("conf_win_top_offset", 0, 8192);
    s.conf_bottom = 2 * b.ue_in("conf_win_bottom_offset", 0, 8192);
    if (s.conf_left + s.conf_right >= s.width || s.conf_top + s.conf_bottom >= s.height)
      fail("the conformance window leaves no picture");
  }
  const int bd_luma = b.ue_in("bit_depth_luma_minus8", 0, 8) + 8;
  const int bd_chroma = b.ue_in("bit_depth_chroma_minus8", 0, 8) + 8;
  if (bd_luma != 8 || bd_chroma != 8)
    fail("a bit depth of " + std::to_string(bd_luma) + " (luma) and " + std::to_string(bd_chroma) +
         " (chroma) is not supported; the port decodes 8-bit HEVC (Main 10 is not ported)");
  if (s.profile != 1 && s.profile != 3) {
    const char* names[] = {"", "Main", "Main 10", "Main Still Picture", "format range extensions",
                           "high throughput", "multiview Main", "scalable Main", "3D Main",
                           "screen content coding", "scalable format range extensions"};
    fail(std::string("HEVC profile ") + std::to_string(s.profile) +
         (s.profile < 11 ? std::string(" (") + names[s.profile] + ")" : std::string()) +
         " is not supported; the port decodes Main and Main Still Picture");
  }
  s.log2_max_poc_lsb = b.ue_in("log2_max_pic_order_cnt_lsb_minus4", 0, 12) + 4;
  const bool ordering = b.flag("sps_sub_layer_ordering_info_present_flag");
  for (int i = ordering ? 0 : s.max_sub_layers - 1; i < s.max_sub_layers; ++i) {
    s.max_dec_pic_buffering = b.ue_in("sps_max_dec_pic_buffering_minus1", 0, 15) + 1;
    s.num_reorder = b.ue_in("sps_max_num_reorder_pics", 0, 15);
    b.ue("sps_max_latency_increase_plus1");
  }
  s.log2_min_cb = b.ue_in("log2_min_luma_coding_block_size_minus3", 0, 3) + 3;
  s.log2_ctb = s.log2_min_cb + b.ue_in("log2_diff_max_min_luma_coding_block_size", 0, 3);
  s.log2_min_tb = b.ue_in("log2_min_luma_transform_block_size_minus2", 0, 3) + 2;
  s.log2_max_tb = s.log2_min_tb + b.ue_in("log2_diff_max_min_luma_transform_block_size", 0, 3);
  if (s.log2_ctb < 4 || s.log2_ctb > 6) fail("a CTB of " + std::to_string(1 << s.log2_ctb) +
                                              " samples (the standard allows 16, 32 and 64)");
  if (s.log2_min_tb >= s.log2_min_cb || s.log2_max_tb > std::min(s.log2_ctb, 5))
    fail("transform block sizes that do not fit the coding block sizes");
  s.max_th_depth_inter = b.ue_in("max_transform_hierarchy_depth_inter", 0, s.log2_ctb - s.log2_min_tb);
  s.max_th_depth_intra = b.ue_in("max_transform_hierarchy_depth_intra", 0, s.log2_ctb - s.log2_min_tb);
  if (s.width % (1 << s.log2_min_cb) || s.height % (1 << s.log2_min_cb))
    fail("a picture size that is not a multiple of the minimum coding block");
  s.scaling_list_enabled = b.flag("scaling_list_enabled_flag");
  if (s.scaling_list_enabled) {
    s.scaling.set_default();
    s.scaling_data = b.flag("sps_scaling_list_data_present_flag");
    if (s.scaling_data) {
      tools |= bit(T_SCALING_SPS);
      parse_scaling_list(b, s.scaling, tools);
    }
  }
  s.amp = b.flag("amp_enabled_flag");
  s.sao = b.flag("sample_adaptive_offset_enabled_flag");
  s.pcm = b.flag("pcm_enabled_flag");
  if (s.pcm) {
    s.pcm_bits_luma = int(b.u(4, "pcm_sample_bit_depth_luma_minus1")) + 1;
    s.pcm_bits_chroma = int(b.u(4, "pcm_sample_bit_depth_chroma_minus1")) + 1;
    if (s.pcm_bits_luma > 8 || s.pcm_bits_chroma > 8) fail("a PCM bit depth above the bit depth");
    s.log2_min_pcm = b.ue_in("log2_min_pcm_luma_coding_block_size_minus3", 0, 2) + 3;
    s.log2_max_pcm = s.log2_min_pcm + b.ue_in("log2_diff_max_min_pcm_luma_coding_block_size", 0, 2);
    if (s.log2_max_pcm > std::min(s.log2_ctb, 5)) fail("a PCM block larger than 32 or the CTB");
    s.pcm_loop_filter_disabled = b.flag("pcm_loop_filter_disabled_flag");
  }
  s.num_st_rps = b.ue_in("num_short_term_ref_pic_sets", 0, 64);
  if (s.num_st_rps) tools |= bit(T_RPS_SYNTAX);
  s.st_rps.resize(size_t(s.num_st_rps));
  for (int i = 0; i < s.num_st_rps; ++i) {
    bool predicted;
    parse_st_rps(b, i, s.num_st_rps, s.st_rps, s.st_rps[size_t(i)], predicted);
  }
  s.long_term_present = b.flag("long_term_ref_pics_present_flag");
  if (s.long_term_present) {
    tools |= bit(T_LONG_TERM_SYNTAX);
    s.num_lt_sps = b.ue_in("num_long_term_ref_pics_sps", 0, 32);
    for (int i = 0; i < s.num_lt_sps; ++i) {
      s.lt_poc_lsb[i] = int(b.u(s.log2_max_poc_lsb, "lt_ref_pic_poc_lsb_sps"));
      s.lt_used[i] = b.flag("used_by_curr_pic_lt_sps_flag");
    }
  }
  s.temporal_mvp = b.flag("sps_temporal_mvp_enabled_flag");
  s.strong_intra_smoothing = b.flag("strong_intra_smoothing_enabled_flag");
  if (b.flag("vui_parameters_present_flag")) {
    s.vui = true;
    tools |= bit(T_VUI);
    if (b.flag("aspect_ratio_info_present_flag")) {
      if (b.u(8, "aspect_ratio_idc") == 255) {
        b.u(16, "sar_width");
        b.u(16, "sar_height");
      }
    }
    if (b.flag("overscan_info_present_flag")) b.u(1, "overscan_appropriate_flag");
    if (b.flag("video_signal_type_present_flag")) {
      b.u(3, "video_format");
      s.full_range = b.flag("video_full_range_flag");
      if (s.full_range) tools |= bit(T_FULL_RANGE);
      if (b.flag("colour_description_present_flag")) {
        b.u(8, "colour_primaries");
        b.u(8, "transfer_characteristics");
        s.matrix = int(b.u(8, "matrix_coeffs"));
      }
    }
    if (b.flag("chroma_loc_info_present_flag")) {
      s.chroma_loc = b.ue_in("chroma_sample_loc_type_top_field", 0, 5);
      b.ue_in("chroma_sample_loc_type_bottom_field", 0, 5);
    }
    b.u(1, "neutral_chroma_indication_flag");
    if (b.flag("field_seq_flag"))
      fail("field coding (field_seq_flag 1) is not supported; the port decodes frames");
    b.u(1, "frame_field_info_present_flag");
    if (b.flag("default_display_window_flag"))
      for (int i = 0; i < 4; ++i) b.ue("def_disp_win_offset");
    if (b.flag("vui_timing_info_present_flag")) {
      b.u(32, "vui_num_units_in_tick");
      b.u(32, "vui_time_scale");
      if (b.flag("vui_poc_proportional_to_timing_flag")) b.ue("vui_num_ticks_poc_diff_one_minus1");
      if (b.flag("vui_hrd_parameters_present_flag")) {
        tools |= bit(T_HRD);
        parse_hrd(b, true, s.max_sub_layers - 1);
      }
    }
    if (b.flag("bitstream_restriction_flag")) {
      b.u(3, "tiles_fixed_structure_flag .. restricted_ref_pic_lists_flag");
      b.ue("min_spatial_segmentation_idc");
      b.ue("max_bytes_per_pic_denom");
      b.ue("max_bits_per_min_cu_denom");
      b.ue("log2_max_mv_length_horizontal");
      b.ue("log2_max_mv_length_vertical");
    }
  }
  if (b.flag("sps_extension_present_flag")) {
    const bool range = b.flag("sps_range_extension_flag");
    const bool multilayer = b.flag("sps_multilayer_extension_flag");
    const bool ext3d = b.flag("sps_3d_extension_flag");
    const bool scc = b.flag("sps_scc_extension_flag");
    b.u(4, "sps_extension_4bits");
    if (range) {
      static const char* names[9] = {
          "transform_skip_rotation_enabled_flag", "transform_skip_context_enabled_flag",
          "implicit_rdpcm_enabled_flag", "explicit_rdpcm_enabled_flag",
          "extended_precision_processing_flag", "intra_smoothing_disabled_flag",
          "high_precision_offsets_enabled_flag", "persistent_rice_adaptation_enabled_flag",
          "cabac_bypass_alignment_enabled_flag"};
      for (const char* n : names)
        if (b.flag(n))
          fail(std::string("the range extension (") + n + " 1) is not supported; the port decodes "
               "Main and Main Still Picture");
    }
    if (multilayer) fail("the multilayer extension (sps_multilayer_extension_flag) is not supported");
    if (ext3d) fail("the 3D extension (sps_3d_extension_flag) is not supported");
    if (scc)
      fail("the screen content coding extension (sps_scc_extension_flag) is not supported");
  }
  s.ctb_w = (s.width + (1 << s.log2_ctb) - 1) >> s.log2_ctb;
  s.ctb_h = (s.height + (1 << s.log2_ctb) - 1) >> s.log2_ctb;
  s.present = true;
  return id;
}

// Parses a PPS into `p`; returns its id.
int parse_pps(Bits& b, Pps& p, const std::vector<Sps>& spss, Tools& tools) {
  const int id = b.ue_in("pps_pic_parameter_set_id", 0, 63);
  p.sps_id = b.ue_in("pps_seq_parameter_set_id", 0, 15);
  if (!spss[size_t(p.sps_id)].present)
    fail("PPS " + std::to_string(id) + " refers to SPS " + std::to_string(p.sps_id) +
         ", which the stream has not sent");
  const Sps& s = spss[size_t(p.sps_id)];
  p.dependent_slices = b.flag("dependent_slice_segments_enabled_flag");
  p.output_flag_present = b.flag("output_flag_present_flag");
  p.extra_slice_header_bits = int(b.u(3, "num_extra_slice_header_bits"));
  p.sign_hiding = b.flag("sign_data_hiding_enabled_flag");
  p.cabac_init_present = b.flag("cabac_init_present_flag");
  p.num_ref_idx_default[0] = b.ue_in("num_ref_idx_l0_default_active_minus1", 0, 14) + 1;
  p.num_ref_idx_default[1] = b.ue_in("num_ref_idx_l1_default_active_minus1", 0, 14) + 1;
  p.init_qp = 26 + b.se_in("init_qp_minus26", -26, 25);
  p.constrained_intra = b.flag("constrained_intra_pred_flag");
  p.transform_skip = b.flag("transform_skip_enabled_flag");
  p.cu_qp_delta = b.flag("cu_qp_delta_enabled_flag");
  if (p.cu_qp_delta)
    p.diff_cu_qp_delta_depth = b.ue_in("diff_cu_qp_delta_depth", 0, s.log2_ctb - s.log2_min_cb);
  p.cb_qp_offset = b.se_in("pps_cb_qp_offset", -12, 12);
  p.cr_qp_offset = b.se_in("pps_cr_qp_offset", -12, 12);
  p.slice_chroma_qp_offsets = b.flag("pps_slice_chroma_qp_offsets_present_flag");
  p.weighted_pred = b.flag("weighted_pred_flag");
  p.weighted_bipred = b.flag("weighted_bipred_flag");
  p.transquant_bypass = b.flag("transquant_bypass_enabled_flag");
  p.tiles = b.flag("tiles_enabled_flag");
  p.wpp = b.flag("entropy_coding_sync_enabled_flag");
  if (p.tiles) {
    p.num_cols = b.ue_in("num_tile_columns_minus1", 0, s.ctb_w - 1) + 1;
    p.num_rows = b.ue_in("num_tile_rows_minus1", 0, s.ctb_h - 1) + 1;
    p.uniform = b.flag("uniform_spacing_flag");
    if (!p.uniform) {
      for (int i = 0; i < p.num_cols - 1; ++i)
        p.col_explicit.push_back(b.ue_in("column_width_minus1", 0, s.ctb_w - 1) + 1);
      for (int i = 0; i < p.num_rows - 1; ++i)
        p.row_explicit.push_back(b.ue_in("row_height_minus1", 0, s.ctb_h - 1) + 1);
    }
    p.lf_across_tiles = b.flag("loop_filter_across_tiles_enabled_flag");
  }
  if (p.tiles && p.wpp)
    fail("tiles and wavefront parallel processing together (Main profile forbids them)");
  p.lf_across_slices = b.flag("pps_loop_filter_across_slices_enabled_flag");
  if (b.flag("deblocking_filter_control_present_flag")) {
    p.deblock_override = b.flag("deblocking_filter_override_enabled_flag");
    p.deblock_disabled = b.flag("pps_deblocking_filter_disabled_flag");
    if (!p.deblock_disabled) {
      p.beta_offset = 2 * b.se_in("pps_beta_offset_div2", -6, 6);
      p.tc_offset = 2 * b.se_in("pps_tc_offset_div2", -6, 6);
    }
  }
  p.scaling_present = b.flag("pps_scaling_list_data_present_flag");
  if (p.scaling_present) {
    tools |= bit(T_SCALING_PPS);
    parse_scaling_list(b, p.scaling, tools);
  }
  p.lists_modification = b.flag("lists_modification_present_flag");
  p.log2_par_mrg = b.ue_in("log2_parallel_merge_level_minus2", 0, s.log2_ctb - 2) + 2;
  p.header_extension = b.flag("slice_segment_header_extension_present_flag");
  if (b.flag("pps_extension_present_flag")) {
    const bool range = b.flag("pps_range_extension_flag");
    const bool multilayer = b.flag("pps_multilayer_extension_flag");
    const bool ext3d = b.flag("pps_3d_extension_flag");
    const bool scc = b.flag("pps_scc_extension_flag");
    b.u(4, "pps_extension_4bits");
    if (range) fail("the range extension (pps_range_extension_flag) is not supported");
    if (multilayer) fail("the multilayer extension (pps_multilayer_extension_flag) is not supported");
    if (ext3d) fail("the 3D extension (pps_3d_extension_flag) is not supported");
    if (scc)
      fail("the screen content coding extension (pps_scc_extension_flag) is not supported");
  }
  p.present = true;
  return id;
}

// ----------------------------------------------------------------- CABAC --

class Cabac {
 public:
  void start(const uint8_t* d, size_t n, size_t byte) {
    d_ = d;
    n_ = n;
    next_ = byte;
    cache_ = 0;
    cached_ = 0;
    used_ = 8 * byte;
    overrun_ = 0;
    range_ = 510;
    offset_ = bits(9);
  }
  int decision(uint8_t& st) {
    int state = st >> 1, mps = st & 1;
    const uint32_t lps = kRangeLps[state][(range_ >> 6) & 3];
    range_ -= lps;
    int bin;
    if (offset_ >= range_) {
      bin = !mps;
      offset_ -= range_;
      range_ = lps;
      if (state == 0) mps = 1 - mps;
      state = kTransLps[state];
    } else {
      bin = mps;
      if (state < 62) ++state;
    }
    st = uint8_t((state << 1) | mps);
    if (range_ < 256) {
      const int shift = __builtin_clz(range_) - 23;   // to bring range to 9 bits
      range_ <<= shift;
      offset_ = (offset_ << shift) | bits(shift);
    }
    return bin;
  }
  int bypass() {
    offset_ = (offset_ << 1) | bits(1);
    if (offset_ >= range_) {
      offset_ -= range_;
      return 1;
    }
    return 0;
  }
  uint32_t bypass_bits(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v = (v << 1) | uint32_t(bypass());
    return v;
  }
  int terminate() {
    range_ -= 2;
    if (offset_ >= range_) return 1;   // the last bit read is the stop bit
    if (range_ < 256) {
      range_ <<= 1;
      offset_ = (offset_ << 1) | bits(1);
    }
    return 0;
  }
  // the byte after the one holding the last bit read (after a terminate of 1)
  size_t next_byte() const { return (used_ + 7) >> 3; }
  bool zero_alignment() const {     // the bits from the stop bit to the byte boundary are 0
    for (size_t p = used_; p & 7; ++p)
      if (p >> 3 >= n_ || (d_[p >> 3] >> (7 - (p & 7))) & 1) return false;
    return true;
  }

 private:
  // the next k (<= 24) bits of the slice data; past its end, zeros (a few
  // bytes of them: CABAC reads ahead), then an error
  uint32_t bits(int k) {
    while (cached_ < k) {
      uint64_t byte = 0;
      if (next_ < n_) {
        byte = d_[next_];
      } else if (++overrun_ > 8) {
        fail("the slice data end inside a CABAC-coded syntax element");
      }
      ++next_;
      cache_ = (cache_ << 8) | byte;
      cached_ += 8;
    }
    cached_ -= k;
    used_ += size_t(k);
    return uint32_t(cache_ >> cached_) & ((1u << k) - 1);
  }
  const uint8_t* d_ = nullptr;
  size_t n_ = 0, next_ = 0, used_ = 0;
  uint64_t cache_ = 0;
  int cached_ = 0;
  uint32_t range_ = 510, offset_ = 0;
  int overrun_ = 0;
};

void init_contexts(uint8_t* st, int qp, int init_type) {
  const int q = clip3(0, 51, qp);
  const uint8_t* init = kInit[init_type];
  for (int i = 0; i < C_COUNT; ++i) {
    const int m = (init[i] >> 4) * 5 - 45, n = ((init[i] & 15) << 3) - 16;
    const int pre = clip3(1, 126, ((m * q) >> 4) + n);
    st[i] = pre <= 63 ? uint8_t((63 - pre) << 1) : uint8_t(((pre - 64) << 1) | 1);
  }
}

// ---------------------------------------------------------------- picture --

struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  uint8_t& at(int x, int y) { return px[size_t(y) * size_t(w) + size_t(x)]; }
  uint8_t at(int x, int y) const { return px[size_t(y) * size_t(w) + size_t(x)]; }
};

struct Slice {
  int nal_type = 0, temporal_id = 0;
  bool first = true, dependent = false;
  int pps_id = 0, address = 0, slice_addr = 0;   // segment's CTB (raster), the slice's
  int type = 2;
  bool output = true;
  int poc_lsb = 0;
  bool sao_luma = false, sao_chroma = false;
  int qp = 26, cb_offset = 0, cr_offset = 0;
  bool deblock_disabled = false;
  int beta_offset = 0, tc_offset = 0;
  bool lf_across_slices = false;
  size_t data_byte = 0;   // where the slice data start in the unescaped NAL payload
  // inter slices
  int init_type = 0;
  bool no_output_prior = false;
  StRps st;                                   // the picture's short-term set
  int num_lt = 0;                             // long-term entries: POC (or LSB), used, MSB given
  int lt_poc[32] = {0};
  bool lt_used[32] = {false}, lt_msb[32] = {false};
  bool tmvp = false, mvd_l1_zero = false, col_from_l0 = true;
  int num_ref[2] = {0, 0}, col_ref_idx = 0, max_merge = 5;
  int total = 0;                              // NumPicTotalCurr of the slice's own RPS
  bool modified[2] = {false, false};
  int list_entry[2][16] = {{0}};
  bool weighted = false;                      // explicit weighted prediction
  int luma_denom = 0, chroma_denom = 0;
  int lw[2][16] = {{0}}, lo[2][16] = {{0}}, cw[2][16][2] = {{{0}}}, co[2][16][2] = {{{0}}};
};

// Motion of a prediction block (8.5.3), as ffmpeg's MvField
struct Mv {
  int16_t x = 0, y = 0;
  bool operator==(const Mv& o) const { return x == o.x && y == o.y; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
};
enum Pred : uint8_t { PF_L0 = 1, PF_L1 = 2, PF_BI = 3, PF_INTRA = 4 };
struct MvField {
  Mv mv[2];
  int8_t ref_idx[2] = {-1, -1};
  uint8_t pred = 0;
};

// A slice's reference picture list as later pictures read it: POCs and
// whether each was long-term then
struct RefList {
  int n = 0;
  int poc[16] = {0};
  bool lt[16] = {false};
};

// A decoded picture in the DPB: its planes (coded size), POC, marking and
// motion field at the minimum prediction block's granularity, with each
// CTB's slice lists (TMVP reads them)
struct Frame {
  Plane px[3];
  int poc = 0, ref = 0;        // ref: 1 short-term, 2 long-term, 0 unused
  bool generated = false;      // made for a missing reference (8.3.3)
  int sequence = 0;
  int lpu = 2, pu_w = 0, pu_h = 0, log2_ctb = 4, ctb_w = 0;
  std::vector<MvField> mvf;
  std::vector<int> ctb_slice;                    // by raster CTB address
  std::vector<std::array<RefList, 2>> lists;     // by slice index
  const MvField& at(int x, int y) const { return mvf[size_t(y >> lpu) * size_t(pu_w) + size_t(x >> lpu)]; }
  const RefList* lists_at(int x, int y) const {
    const int k = ctb_slice[size_t((y >> log2_ctb) * ctb_w + (x >> log2_ctb))];
    return k < 0 ? nullptr : lists[size_t(k)].data();
  }
};

struct SaoParams {
  int type[3] = {0, 0, 0};   // 0 none, 1 band, 2 edge
  int band[3] = {0, 0, 0};
  int eo_class[3] = {0, 0, 0};
  int offset[3][5] = {{0}};
};

struct CtbInfo {
  int slice_addr = -1;   // -1: not decoded in this picture
  bool lf_across_slices = true, deblock = true;
  int beta_offset = 0, tc_offset = 0;
  SaoParams sao;
};

class Decoder {
 public:
  Decoder() : vps_(16), sps_(16), pps_(64) {}

  Tools tools = 0;
  bool shown = false;        // the last sample gave a picture
  int poc = 0, nal_type = -1, temporal_id = 0, out_w = 0, out_h = 0;
  Plane out[3];
  const Sps* active = nullptr;

  void reset() {
    poc_tid0_ = 0;
    max_ra_ = kMaxRa;
    eos_ = true;
    pic_started_ = false;
    shown = false;
    dpb_.clear();
    cur_.reset();
    ++seq_;
  }

  void set_length_size(int n) { length_size_ = n; }

  // Parameter sets given as Annex-B NAL units (the container's configuration).
  void parameters(const uint8_t* d, size_t n) {
    size_t i = 0;
    std::vector<std::pair<size_t, size_t>> nals;
    while (i + 3 <= n) {
      if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) {
        const size_t start = i + 3;
        size_t j = start;
        while (j + 3 <= n && !(d[j] == 0 && d[j + 1] == 0 && (d[j + 2] == 1 || d[j + 2] == 0)))
          ++j;
        if (j + 3 > n) j = n;
        nals.push_back({start, j - start});
        i = j;
      } else {
        ++i;
      }
    }
    for (auto& s : nals) nal(d + s.first, s.second, false);
  }

  // One sample: length-prefixed NAL units. Returns whether it gave a picture.
  bool decode(const uint8_t* d, size_t n, bool scan_only = false) {
    shown = false;
    pic_started_ = false;
    scan_only_ = scan_only;
    got_slice_ = false;
    size_t i = 0;
    while (i < n) {
      if (i + size_t(length_size_) > n) fail("a NAL length runs past the end of the sample");
      size_t len = 0;
      for (int k = 0; k < length_size_; ++k) len = (len << 8) | d[i + size_t(k)];
      i += size_t(length_size_);
      if (len > n - i) fail("a NAL unit of " + std::to_string(len) + " bytes overruns its sample");
      if (len) nal(d + i, len, true);
      i += len;
      if (scan_only_ && got_slice_) break;
    }
    if (pic_started_ && !scan_only_) finish_picture();
    return shown;
  }

  // Header scan results
  bool scan_irap = false, scan_output = false;

 private:
  static constexpr int kMaxRa = 0x7fffffff;
  std::vector<Vps> vps_;
  std::vector<Sps> sps_;
  std::vector<Pps> pps_;
  int length_size_ = 4;
  int last_beta_ = 0, last_tc_ = 0;   // the deblocking offsets of the last slice header
  int poc_tid0_ = 0;
  int max_ra_ = kMaxRa;
  bool eos_ = true, pic_started_ = false, scan_only_ = false, got_slice_ = false;
  bool skip_picture_ = false, output_ = true;
  Slice sh_;      // the current independent slice segment's header
  std::vector<uint32_t> pps_gen_ = std::vector<uint32_t>(64);   // each PPS id's count of new sets
  std::vector<uint32_t> sps_gen_ = std::vector<uint32_t>(16);   // each SPS id's count of new sets
  int act_sps_id_ = -1;            // the SPS the last picture activated (id, count of new sets)
  uint32_t act_sps_gen_ = 0;
  int act_w_ = 0, act_h_ = 0, act_dpb_ = 0;
  Pps pic_pps_;   // the picture's parameter sets, as its first slice segment found them
  Sps pic_sps_;
  int pic_pps_id_ = 0;
  uint32_t pic_pps_gen_ = 0;
  const Pps* pps = nullptr;
  const Sps* sps = nullptr;
  Plane pic_[3];
  // picture maps
  std::vector<int> rs2ts_, ts2rs_, tile_id_;   // tile_id_ by ts
  std::vector<int> col_bd_, row_bd_, col_of_ctb_, row_of_ctb_;
  std::vector<int> zs_;                          // MinTbAddrZs by min TB (x + y * w)
  int min_tb_w_ = 0, min_tb_h_ = 0;
  std::vector<CtbInfo> ctb_;
  // 4x4 luma unit maps
  int u4w_ = 0, u4h_ = 0;
  std::vector<int8_t> ipm_;       // IntraPredModeY (DC for PCM)
  std::vector<int8_t> depth_;     // CtDepth
  std::vector<int8_t> qp_;        // QpY
  std::vector<uint8_t> nofilter_; // PCM with pcm_loop_filter_disabled, or transquant bypass
  std::vector<uint8_t> bs_v_, bs_h_;   // edge flags at 4x4 units: left / top edge of the unit
  int decoded_ctbs_ = 0;
  std::vector<uint8_t> sao_h_[3], sao_v_[3], applied_[3];   // SAO border lines, filtered CTBs
  int sao_src_[66 * 66];                                     // a CTB and its border, as SAO reads it
  // CTU-level state
  uint8_t ctx_[C_COUNT];
  uint8_t ctx_wpp_[C_COUNT];
  Cabac cabac_;
  const std::vector<uint8_t>* data_ = nullptr;
  int qp_y_ = 26, qp_prev_ = 26;      // QpY of the current CU, of the last CU
  bool first_qg_ = true;
  bool cu_qp_delta_coded_ = false;
  int cur_slice_addr_ = 0, cur_ctb_rs_ = 0;
  bool bypass_ = false;
  int16_t coeffs_[32 * 32];
  int res_[32 * 32];
  // inter prediction: the DPB (reference pictures only: the reader owns the
  // output order), the picture being decoded, the slice's lists
  std::vector<std::shared_ptr<Frame>> dpb_;
  std::shared_ptr<Frame> cur_, col_;
  std::shared_ptr<Frame> refs_[2][16];
  RefList rpl_[2];
  int seq_ = 0;                        // ffmpeg's seq_decode: IDR, BLA and EOS start a sequence
  int slice_idx_ = -1;
  bool no_rasl_ = true;                // NoRaslOutputFlag of the last IRAP picture
  std::vector<uint8_t> skip_, cbf_;    // cu_skip_flag and cbf_luma at 4x4 units
  bool cu_intra_ = true;
  int cu_part_ = 0;
  int pred_[2][64 * 64];               // a prediction block's samples of each list (14 bits)

  // ------------------------------------------------------------- NAL units --
  void nal(const uint8_t* p, size_t n, bool in_sample) {
    if (n < 2) fail("a NAL unit shorter than its header");
    if (p[0] & 0x80) fail("a NAL unit whose forbidden_zero_bit is 1");
    const int type = (p[0] >> 1) & 0x3F;
    const int layer = ((p[0] & 1) << 5) | (p[1] >> 3);
    const int tid = (p[1] & 7) - 1;
    if (tid < 0) fail("a NAL unit with nuh_temporal_id_plus1 0");
    if (layer > 0) return;    // ffmpeg decodes the base layer only
    if (type <= 31 && in_sample) {
      if (type > 21 || (type > 9 && type < 16)) return;   // reserved VCL types: ffmpeg skips them
    }
    std::vector<uint8_t> rbsp = unescape(p + 2, n - 2);
    Bits b(rbsp.data(), rbsp.size());
    switch (type) {
      case VPS_NUT:
        parse_vps(b, vps_);
        break;
      // As ffmpeg: a repeated set keeps the one held; a new SPS drops the
      // PPSs on its id. A picture decodes under the copies start_picture took.
      case SPS_NUT: {
        Sps s;
        const int id = parse_sps(b, s, vps_, tools);
        s.raw = rbsp;
        Sps& held = sps_[size_t(id)];
        if (held.present && held.raw == s.raw) break;
        for (Pps& p : pps_)
          if (p.sps_id == id) p.present = false;
        held = std::move(s);
        ++sps_gen_[size_t(id)];
        break;
      }
      case PPS_NUT: {
        Pps p;
        const int id = parse_pps(b, p, sps_, tools);
        p.raw = rbsp;
        Pps& held = pps_[size_t(id)];
        if (held.present && held.raw == p.raw) break;
        held = std::move(p);
        ++pps_gen_[size_t(id)];
        break;
      }
      case EOS_NUT:
      case EOB_NUT:
        if (pic_started_ && !scan_only_) finish_picture();
        pic_started_ = false;
        eos_ = true;
        max_ra_ = kMaxRa;
        ++seq_;
        break;
      default:
        if (type <= 21) slice_segment(type, tid, rbsp, b);
        break;   // SEI, AUD, filler and the rest carry nothing the picture needs
    }
  }

  // ---------------------------------------------------------- slice header --
  void slice_segment(int type, int tid, const std::vector<uint8_t>& rbsp, Bits& b) {
    Slice s;
    s.nal_type = type;
    s.temporal_id = tid;
    s.first = b.flag("first_slice_segment_in_pic_flag");
    if (type >= BLA_W_LP && type <= 23) s.no_output_prior = b.flag("no_output_of_prior_pics_flag");
    s.pps_id = b.ue_in("slice_pic_parameter_set_id", 0, 63);
    if (!pps_[size_t(s.pps_id)].present)
      fail("a slice refers to PPS " + std::to_string(s.pps_id) +
           ", which the stream has not sent or whose SPS a new one has replaced");
    const Pps& p = pps_[size_t(s.pps_id)];
    const Sps& q = sps_[size_t(p.sps_id)];
    if (!s.first) {
      if (!pic_started_ && !scan_only_)
        fail("a slice segment that continues a picture whose first slice segment is missing");
      if (!scan_only_ && (s.pps_id != pic_pps_id_ || pps_gen_[size_t(s.pps_id)] != pic_pps_gen_))
        fail("a slice segment under another PPS than its picture's first (ffmpeg: \"PPS changed "
             "between slices\")");
      if (p.dependent_slices) s.dependent = b.flag("dependent_slice_segment_flag");
      int bits = 0;
      while ((1 << bits) < q.ctb_w * q.ctb_h) ++bits;
      s.address = int(b.u(bits, "slice_segment_address"));
      if (s.address >= q.ctb_w * q.ctb_h) fail("slice_segment_address past the last CTB");
    } else if (pic_started_ && !scan_only_) {
      fail("a second picture in one sample (first_slice_segment_in_pic_flag 1 twice)");
    }
    if (s.dependent) {
      if (s.pps_id != sh_.pps_id) fail("a dependent slice segment under another PPS");
      const int address = s.address;
      const bool first = s.first;
      s = sh_;
      s.first = first;
      s.dependent = true;
      s.address = address;
      tools |= bit(T_DEPENDENT_SLICES);
    } else {
      s.slice_addr = s.address;
      b.skip(size_t(p.extra_slice_header_bits), "slice_reserved_flag");
      s.type = b.ue_in("slice_type", 0, 2);
      if (s.type != 2 && is_irap(type))
        fail(std::string(s.type == 1 ? "P slices" : "B slices") + " in an IRAP picture (NAL type " +
             std::to_string(type) + "), which holds I slices only (ffmpeg: \"Inter slices in an "
             "IRAP frame\")");
      if (p.output_flag_present) {
        s.output = b.flag("pic_output_flag");
        tools |= bit(T_OUTPUT_FLAG);
      }
      if (!is_idr(type)) s.poc_lsb = int(b.u(q.log2_max_poc_lsb, "slice_pic_order_cnt_lsb"));
      if (s.first) {
        activate_sps(s, p.sps_id, q);
        header_poc(s, q);
      }
      if (!is_idr(type)) {
        bool predicted = false;
        if (!b.flag("short_term_ref_pic_set_sps_flag")) {
          tools |= bit(T_RPS_SYNTAX);
          parse_st_rps(b, q.num_st_rps, q.num_st_rps, q.st_rps, s.st, predicted);
        } else {
          if (q.num_st_rps == 0) fail("short_term_ref_pic_set_sps_flag 1 with no set in the SPS");
          int bits = 0;
          while ((1 << bits) < q.num_st_rps) ++bits;
          const int idx = int(b.u(bits, "short_term_ref_pic_set_idx"));
          if (idx >= q.num_st_rps) fail("short_term_ref_pic_set_idx past the SPS's sets");
          s.st = q.st_rps[size_t(idx)];
        }
        if (q.long_term_present) {
          tools |= bit(T_LONG_TERM_SYNTAX);
          int num_sps = 0;
          if (q.num_lt_sps > 0) num_sps = b.ue_in("num_long_term_sps", 0, q.num_lt_sps);
          const int num_pics = b.ue_in("num_long_term_pics", 0, 32 - num_sps);
          s.num_lt = num_sps + num_pics;
          const int max_lsb = 1 << q.log2_max_poc_lsb;
          int64_t prev_msb = 0;
          for (int i = 0; i < s.num_lt; ++i) {
            if (i < num_sps) {
              int bits = 0;
              while ((1 << bits) < q.num_lt_sps) ++bits;
              const int k = q.num_lt_sps > 1 ? int(b.u(bits, "lt_idx_sps")) : 0;
              if (k >= q.num_lt_sps) fail("lt_idx_sps past the SPS's long-term pictures");
              s.lt_poc[i] = q.lt_poc_lsb[k];
              s.lt_used[i] = q.lt_used[k];
            } else {
              s.lt_poc[i] = int(b.u(q.log2_max_poc_lsb, "poc_lsb_lt"));
              s.lt_used[i] = b.flag("used_by_curr_pic_lt_flag");
            }
            s.lt_msb[i] = b.flag("delta_poc_msb_present_flag");
            if (s.lt_msb[i]) {
              int64_t delta = b.ue_in("delta_poc_msb_cycle_lt", 0, 1 << 24);
              if (i && i != num_sps) delta += prev_msb;   // DeltaPocMsbCycleLt accumulates
              const int64_t v = int64_t(s.lt_poc[i]) + poc - delta * max_lsb - s.poc_lsb;
              if (v != int64_t(int32_t(v))) fail("a long-term picture's order count overflows");
              s.lt_poc[i] = int(v);
              prev_msb = delta;
            }
          }
        }
        if (q.temporal_mvp) s.tmvp = b.flag("slice_temporal_mvp_enabled_flag");
      }
      if (q.sao) {
        s.sao_luma = b.flag("slice_sao_luma_flag");
        s.sao_chroma = b.flag("slice_sao_chroma_flag");
      }
      if (s.type != 2) {
        int total = 0;   // NumPicTotalCurr
        for (int i = 0; i < s.st.num_delta; ++i) total += s.st.used[i];
        for (int i = 0; i < s.num_lt; ++i) total += s.lt_used[i];
        if (!total) fail("a P or B slice whose reference picture set holds no picture it may use");
        s.total = total;
        const int lists = s.type == 0 ? 2 : 1;
        s.num_ref[0] = p.num_ref_idx_default[0];
        s.num_ref[1] = s.type == 0 ? p.num_ref_idx_default[1] : 0;
        if (b.flag("num_ref_idx_active_override_flag"))
          for (int l = 0; l < lists; ++l)
            s.num_ref[l] = b.ue_in(l ? "num_ref_idx_l1_active_minus1" : "num_ref_idx_l0_active_minus1",
                                   0, 14) + 1;
        if (p.lists_modification && total > 1) {
          int bits = 0;
          while ((1 << bits) < total) ++bits;
          for (int l = 0; l < lists; ++l) {
            s.modified[l] = b.flag("ref_pic_list_modification_flag");
            if (!s.modified[l]) continue;
            tools |= bit(T_LIST_MODIFICATION);
            for (int i = 0; i < s.num_ref[l]; ++i) {
              s.list_entry[l][i] = int(b.u(bits, "list_entry"));
              if (s.list_entry[l][i] >= total) fail("list_entry past NumPicTotalCurr");
            }
          }
        }
        if (s.type == 0) {
          s.mvd_l1_zero = b.flag("mvd_l1_zero_flag");
          if (s.mvd_l1_zero) tools |= bit(T_MVD_L1_ZERO);
        }
        bool cabac_init = false;
        if (p.cabac_init_present) cabac_init = b.flag("cabac_init_flag");
        if (cabac_init) tools |= bit(T_CABAC_INIT_FLAG);
        s.init_type = s.type == 1 ? (cabac_init ? 2 : 1) : (cabac_init ? 1 : 2);
        if (s.tmvp) {
          if (s.type == 0) s.col_from_l0 = b.flag("collocated_from_l0_flag");
          const int l = s.col_from_l0 ? 0 : 1;
          if (s.num_ref[l] > 1)
            s.col_ref_idx = b.ue_in("collocated_ref_idx", 0, s.num_ref[l] - 1);
        }
        if ((p.weighted_pred && s.type == 1) || (p.weighted_bipred && s.type == 0))
          pred_weight_table(b, s);
        s.max_merge = 5 - b.ue_in("five_minus_max_num_merge_cand", 0, 4);
      }
      s.qp = p.init_qp + b.se_in("slice_qp_delta", -87, 77);
      if (s.qp < 0 || s.qp > 51) fail("SliceQpY " + std::to_string(s.qp) + " is outside 0..51");
      if (p.slice_chroma_qp_offsets) {
        s.cb_offset = b.se_in("slice_cb_qp_offset", -12, 12);
        s.cr_offset = b.se_in("slice_cr_qp_offset", -12, 12);
        if (s.cb_offset || s.cr_offset) tools |= bit(T_SLICE_CHROMA_QP_OFFSET);
        if (p.cb_qp_offset + s.cb_offset < -12 || p.cb_qp_offset + s.cb_offset > 12 ||
            p.cr_qp_offset + s.cr_offset < -12 || p.cr_qp_offset + s.cr_offset > 12)
          fail("a chroma QP offset outside -12..12");
      }
      bool override = false;
      if (p.deblock_override) override = b.flag("deblocking_filter_override_flag");
      if (override) {
        tools |= bit(T_DEBLOCK_OVERRIDE);
        s.deblock_disabled = b.flag("slice_deblocking_filter_disabled_flag");
        if (!s.deblock_disabled) {
          last_beta_ = 2 * b.se_in("slice_beta_offset_div2", -6, 6);
          last_tc_ = 2 * b.se_in("slice_tc_offset_div2", -6, 6);
        }   // else ffmpeg keeps the offsets of the slice header before
      } else {
        s.deblock_disabled = p.deblock_disabled;
        last_beta_ = p.beta_offset;
        last_tc_ = p.tc_offset;
      }
      s.beta_offset = last_beta_;
      s.tc_offset = last_tc_;
      s.lf_across_slices = p.lf_across_slices;
      if (p.lf_across_slices && (s.sao_luma || s.sao_chroma || !s.deblock_disabled))
        s.lf_across_slices = b.flag("slice_loop_filter_across_slices_enabled_flag");
    }
    if (p.tiles || p.wpp) {
      const int entry_points = b.ue_in("num_entry_point_offsets", 0, q.ctb_w * q.ctb_h);
      if (entry_points > 0) {
        tools |= bit(T_ENTRY_POINTS);
        const int bits = b.ue_in("offset_len_minus1", 0, 31) + 1;
        for (int i = 0; i < entry_points; ++i) b.u(bits, "entry_point_offset_minus1");
      }
    }
    if (p.header_extension) {
      tools |= bit(T_HEADER_EXTENSION);
      const int len = b.ue_in("slice_segment_header_extension_length", 0, 256);
      b.skip(size_t(8 * len), "slice_segment_header_extension_data_byte");
    }
    // byte_alignment()
    if (!b.flag("alignment_bit_equal_to_one")) fail("the slice header's alignment bit is not 1");
    while (b.pos() & 7)
      if (b.flag("alignment_bit_equal_to_zero")) fail("a slice header alignment bit is not 0");
    s.data_byte = b.pos() >> 3;
    if (!s.dependent) sh_ = s;
    if (s.first) {
      if (scan_only_) {
        got_slice_ = true;
        if (!skip_picture_) scan_picture(s, q);
        return;
      }
      start_picture(s, p, q);
    }
    if (scan_only_ || skip_picture_) return;
    if (!s.first) tools |= bit(T_SLICES);
    if (s.type != 2) tools |= bit(s.type == 1 ? T_P_SLICE : T_B_SLICE);
    got_slice_ = true;
    if (!s.dependent) slice_lists(s);
    slice_data(s, rbsp);
  }

  // ffmpeg's output process, on order counts alone (the header scan): at an
  // IRAP picture with NoRaslOutputFlag the pictures waiting for output are
  // output, or discarded with no_output_of_prior_pics_flag (a CRA's is 1);
  // then the RPS marks the DPB, the picture joins it, and pictures are
  // output (bumped) while more than sps_max_num_reorder_pics wait or the DPB
  // holds more than sps_max_dec_pic_buffering
  struct ScanPic {
    int poc, id, ref, seq;
    bool out;
  };
  std::vector<ScanPic> scan_dpb_;

  void scan_picture(const Slice& s, const Sps& q) {
    const int type = s.nal_type;
    if (is_irap(type) && no_rasl_) {
      const bool discard = s.no_output_prior || type == CRA_NUT;
      for (auto& f : scan_dpb_)
        if (f.out) {
          if (discard) {
            discarded.push_back(f.id);
            tools |= bit(T_DISCARD_PRIOR);
          }
          f.out = false;
        }
    }
    if (is_idr(type) || is_bla(type)) ++seq_;
    int generated = 0;
    for (auto& f : scan_dpb_) f.ref = 0;
    if (!is_idr(type))
      rps_entries(s, q, [&](int want, int mask, bool, int subset) {
        for (auto& f : scan_dpb_)
          if (rps_names(f.poc, f.seq, want, mask)) {
            f.ref = subset == 2 ? 2 : 1;
            return;
          }
        ++generated;
      });
    scan_dpb_.erase(std::remove_if(scan_dpb_.begin(), scan_dpb_.end(),
                                   [](const ScanPic& f) { return !f.ref && !f.out; }),
                    scan_dpb_.end());
    scan_dpb_.push_back({poc, scan_id_, 1, seq_, s.output});
    for (;;) {
      int waiting = 0;
      for (const auto& f : scan_dpb_) waiting += f.out;
      const int held = int(scan_dpb_.size()) + generated;
      if (!(waiting > q.num_reorder || (waiting && held > q.max_dec_pic_buffering))) break;
      size_t first = 0;
      bool found = false;
      for (size_t i = 0; i < scan_dpb_.size(); ++i)
        if (scan_dpb_[i].out && (!found || scan_dpb_[i].poc < scan_dpb_[first].poc)) {
          first = i;
          found = true;
        }
      scan_dpb_[first].out = false;
      if (!scan_dpb_[first].ref) scan_dpb_.erase(scan_dpb_.begin() + long(first));
    }
  }

  // As ffmpeg (hls_slice_header): a picture under another SPS than the last
  // picture's (a new set, or another id) drops every reference picture and
  // starts a sequence (ffmpeg 8 keeps max_ra: a CRA's RASL pictures decode);
  // at an IRAP picture other than a CRA, a new size or DPB size outputs the
  // pictures still waiting instead of discarding them
  void activate_sps(Slice& s, int id, const Sps& q) {
    if (id == act_sps_id_ && sps_gen_[size_t(id)] == act_sps_gen_) return;
    if (act_sps_id_ >= 0 && is_irap(s.nal_type) && s.nal_type != CRA_NUT &&
        (q.width != act_w_ || q.height != act_h_ || q.max_dec_pic_buffering != act_dpb_))
      s.no_output_prior = false;
    act_sps_id_ = id;
    act_sps_gen_ = sps_gen_[size_t(id)];
    act_w_ = q.width;
    act_h_ = q.height;
    act_dpb_ = q.max_dec_pic_buffering;
    dpb_.clear();
    for (auto& f : scan_dpb_) f.ref = 0;
    scan_dpb_.erase(std::remove_if(scan_dpb_.begin(), scan_dpb_.end(),
                                   [](const ScanPic& f) { return !f.out; }),
                    scan_dpb_.end());
    ++seq_;
  }

  // POC (8.3.1, as ffmpeg computes it) and whether the picture shows
  void header_poc(const Slice& s, const Sps& q) {
    const int type = s.nal_type;
    active = &q;
    if (is_irap(type)) {
      no_rasl_ = is_idr(type) || is_bla(type) || eos_;
      if (no_rasl_) max_ra_ = kMaxRa;
    }
    int value = 0;
    if (!is_idr(type)) {
      const int max_lsb = 1 << q.log2_max_poc_lsb;
      const int prev_lsb = poc_tid0_ % max_lsb;
      const int prev_msb = poc_tid0_ - prev_lsb;
      int msb;
      if (s.poc_lsb < prev_lsb && prev_lsb - s.poc_lsb >= max_lsb / 2)
        msb = prev_msb + max_lsb;
      else if (s.poc_lsb > prev_lsb && s.poc_lsb - prev_lsb > max_lsb / 2)
        msb = prev_msb - max_lsb;
      else
        msb = prev_msb;
      if (is_bla(type)) msb = 0;
      value = msb + s.poc_lsb;
    }
    if (!is_irap(type) && !is_idr(type) && value < poc) tools |= bit(T_POC_REORDER);
    poc = value;
    nal_type = type;
    temporal_id = s.temporal_id;
    if (s.temporal_id == 0 && type != TRAIL_N && type != TSA_N && type != STSA_N && type != RADL_N &&
        type != RADL_R && type != RASL_N && type != RASL_R)
      poc_tid0_ = value;
    // ffmpeg's RASL rule: after a (re)start at a CRA or BLA, its RASL pictures are skipped
    if (max_ra_ == kMaxRa) {
      if (type == CRA_NUT || is_bla(type))
        max_ra_ = value;
      else if (is_idr(type))
        max_ra_ = INT32_MIN;
    }
    skip_picture_ = false;
    if ((type == RASL_N || type == RASL_R) && value <= max_ra_) {
      skip_picture_ = true;
      tools |= bit(T_RASL_SKIPPED);
    } else if (type == RASL_R && value > max_ra_) {
      max_ra_ = INT32_MIN;
    }
    if (is_irap(type)) eos_ = false;
    scan_irap = is_irap(type);
    scan_output = s.output && !skip_picture_;
    output_ = scan_output;
  }

  // ------------------------------------------------------------- picture --
  void start_picture(const Slice& s, const Pps& p, const Sps& q) {
    pic_pps_ = p;
    pic_sps_ = q;
    pps = &pic_pps_;
    sps = &pic_sps_;
    pic_pps_id_ = s.pps_id;
    pic_pps_gen_ = pps_gen_[size_t(s.pps_id)];
    active = &q;
    pic_started_ = true;
    if (skip_picture_) return;
    const int type = s.nal_type;
    if (is_idr(type)) tools |= bit(T_IDR);
    else if (type == CRA_NUT) tools |= bit(T_CRA);
    else if (is_bla(type)) tools |= bit(T_BLA);
    else if (type == RADL_N || type == RADL_R) tools |= bit(T_RADL);
    else tools |= bit(T_TRAIL);
    tools |= bit(q.log2_ctb == 4 ? T_CTB16 : q.log2_ctb == 5 ? T_CTB32 : T_CTB64);
    if (q.log2_min_cb >= 4) tools |= bit(T_MIN_CB16);
    if (q.scaling_list_enabled && !q.scaling_data && !p.scaling_present)
      tools |= bit(T_SCALING_DEFAULT);
    if (q.pcm && q.pcm_loop_filter_disabled) tools |= bit(T_PCM_NO_FILTER);
    if (q.strong_intra_smoothing) tools |= bit(T_STRONG_SMOOTHING);
    if (p.constrained_intra) tools |= bit(T_CONSTRAINED_INTRA);
    if (p.sign_hiding) tools |= bit(T_SIGN_HIDING);
    if (p.cb_qp_offset || p.cr_qp_offset) tools |= bit(T_CHROMA_QP_OFFSET);
    if (p.tiles) tools |= bit(p.uniform ? T_TILES_UNIFORM : T_TILES_EXPLICIT);
    if (p.wpp) tools |= bit(T_WPP);
    if (p.tiles && !p.lf_across_tiles) tools |= bit(T_NO_FILTER_ACROSS_TILES);
    pic_[0].w = q.width;
    pic_[0].h = q.height;
    pic_[1].w = pic_[2].w = q.width / 2;
    pic_[1].h = pic_[2].h = q.height / 2;
    for (auto& pl : pic_) pl.px.assign(size_t(pl.w) * size_t(pl.h), 0);
    tile_layout(p, q);
    u4w_ = q.width >> 2;
    u4h_ = q.height >> 2;
    const size_t n4 = size_t(u4w_) * size_t(u4h_);
    ipm_.assign(n4, 1);
    depth_.assign(n4, 0);
    qp_.assign(n4, 0);
    nofilter_.assign(n4, 0);
    bs_v_.assign(n4, 0);
    bs_h_.assign(n4, 0);
    ctb_.assign(size_t(q.ctb_w) * size_t(q.ctb_h), CtbInfo());
    decoded_ctbs_ = 0;
    skip_.assign(n4, 0);
    cbf_.assign(n4, 0);
    if (s.temporal_id > 0) tools |= bit(T_TEMPORAL_LAYERS);
    if (is_irap(type) && no_rasl_ && s.no_output_prior) tools |= bit(T_DISCARD_PRIOR);
    if (is_idr(type) || is_bla(type)) ++seq_;
    cur_ = std::make_shared<Frame>();
    Frame& f = *cur_;
    f.poc = poc;
    f.sequence = seq_;
    f.lpu = q.log2_min_cb - 1;
    f.pu_w = q.width >> f.lpu;
    f.pu_h = q.height >> f.lpu;
    f.mvf.assign(size_t(f.pu_w) * size_t(f.pu_h), MvField());
    f.log2_ctb = q.log2_ctb;
    f.ctb_w = q.ctb_w;
    f.ctb_slice.assign(size_t(q.ctb_w) * size_t(q.ctb_h), -1);
    slice_idx_ = -1;
    frame_rps(s, q);
  }

  // ------------------------------------------------------------- the DPB --
  // 8.3.2 as ffmpeg's ff_hevc_frame_rps: every picture unmarked, then those
  // the RPS names marked again, a missing one generated (grey, never output:
  // ffmpeg's generate_missing_ref, for the Foll sets too); IDR pictures name
  // none. Pictures nothing names leave the DPB.
  std::vector<std::shared_ptr<Frame>> st_curr_[2], lt_curr_;   // PocStCurrBefore/After, PocLtCurr

  // The RPS's entries in ffmpeg's order, for the decode's DPB (frame_rps)
  // and the header scan's (scan_picture): fn(order count, -1 for a full
  // count or the mask of its LSBs, used by the current picture, subset: 0
  // short-term before, 1 short-term after, 2 long-term)
  template <class F>
  void rps_entries(const Slice& s, const Sps& q, F&& fn) const {
    for (int i = 0; i < s.st.num_delta; ++i)
      fn(poc + s.st.delta[i], -1, s.st.used[i], i < s.st.num_negative ? 0 : 1);
    for (int i = 0; i < s.num_lt; ++i)
      fn(s.lt_poc[i], s.lt_msb[i] ? -1 : (1 << q.log2_max_poc_lsb) - 1, s.lt_used[i], 2);
  }

  // whether the DPB picture (order count, sequence) is the one an RPS entry
  // names: the sequence being decoded (never a generated picture), the full
  // count, or its LSBs in a picture other than the current one
  bool rps_names(int f_poc, int f_seq, int want, int mask) const {
    return f_seq == seq_ && (f_poc & mask) == want && (mask == -1 || f_poc != poc);
  }

  std::shared_ptr<Frame> generate(int poc_value) {
    const Sps& q = *sps;
    auto f = std::make_shared<Frame>();
    f->poc = poc_value;
    f->generated = true;
    f->sequence = -1;
    f->px[0].w = q.width;
    f->px[0].h = q.height;
    f->px[1].w = f->px[2].w = q.width / 2;
    f->px[1].h = f->px[2].h = q.height / 2;
    for (auto& pl : f->px) pl.px.assign(size_t(pl.w) * size_t(pl.h), 128);
    f->lpu = q.log2_min_cb - 1;
    f->pu_w = q.width >> f->lpu;
    f->pu_h = q.height >> f->lpu;
    MvField intra;
    intra.pred = PF_INTRA;   // ffmpeg's motion here is whatever its pool held: no TMVP reads it
    f->mvf.assign(size_t(f->pu_w) * size_t(f->pu_h), intra);
    f->log2_ctb = q.log2_ctb;
    f->ctb_w = q.ctb_w;
    f->ctb_slice.assign(size_t(q.ctb_w) * size_t(q.ctb_h), -1);
    tools |= bit(T_MISSING_REF);
    dpb_.push_back(f);
    return f;
  }

  // a picture the RPS names and the DPB does not hold: generated for an IRAP
  // picture (its leading pictures' references) and for a Foll entry; a
  // non-IRAP picture that would predict from one is refused, as ffmpeg
  // refuses it ("Could not find ref with POC", "Error constructing the frame
  // RPS") and drops the picture
  std::shared_ptr<Frame> missing(const Slice& s, int want, bool used) {
    if (used && !is_irap(s.nal_type))
      fail("the picture's reference picture set names POC " + std::to_string(want) +
           " for prediction, which the DPB does not hold (ffmpeg refuses such a picture: \"Error "
           "constructing the frame RPS\")");
    return generate(want);
  }

  void frame_rps(const Slice& s, const Sps& q) {
    for (auto& l : st_curr_) l.clear();
    lt_curr_.clear();
    dpb_.erase(std::remove_if(dpb_.begin(), dpb_.end(),
                              [](const std::shared_ptr<Frame>& f) { return f->generated; }),
               dpb_.end());
    for (auto& f : dpb_) f->ref = 0;
    if (is_idr(s.nal_type)) {
      dpb_.clear();
      return;
    }
    rps_entries(s, q, [&](int want, int mask, bool used, int subset) {
      if (subset == 2 && mask == -1 && want == poc)
        fail("a long-term reference picture with the current picture's order count");
      std::shared_ptr<Frame> f;
      for (auto& g : dpb_)
        if (rps_names(g->poc, g->sequence, want, mask)) {
          f = g;
          break;
        }
      if (!f) f = missing(s, want, used);
      f->ref = subset == 2 ? 2 : 1;
      if (subset == 2) tools |= bit(T_LONG_TERM_REF);
      if (used) {
        auto& l = subset == 2 ? lt_curr_ : st_curr_[subset];
        if (l.size() >= 16) fail("more than 16 pictures in one reference picture subset");
        l.push_back(f);
      }
    });
    dpb_.erase(std::remove_if(dpb_.begin(), dpb_.end(),
                              [](const std::shared_ptr<Frame>& f) { return f->ref == 0; }),
               dpb_.end());
    if (dpb_.size() > 32) fail("more than 32 pictures in the DPB");
  }

  // 8.3.4 as ffmpeg's ff_hevc_slice_rpl: the slice's lists, the collocated
  // picture, and the lists kept with the picture for TMVP and deblocking
  void slice_lists(const Slice& s) {
    slice_idx_ = int(cur_->lists.size());
    cur_->lists.push_back({});
    rpl_[0] = rpl_[1] = RefList();
    col_.reset();
    if (s.type == 2) return;
    // the lists come from the picture's RPS, which its first slice gave
    // (ffmpeg's frame RPS); a slice whose own RPS counts other pictures
    // would index past them
    const size_t total = st_curr_[0].size() + st_curr_[1].size() + lt_curr_.size();
    if (!total)
      fail("a P or B slice in a picture whose reference picture set holds no picture it may use "
           "(ffmpeg: \"Zero refs in the frame RPS\")");
    if (int(total) != s.total)
      fail("a slice whose reference picture set names " + std::to_string(s.total) +
           " pictures for prediction where its picture's first slice names " + std::to_string(total));
    for (int l = 0; l < (s.type == 0 ? 2 : 1); ++l) {
      const std::vector<std::shared_ptr<Frame>>* order[3] = {&st_curr_[l], &st_curr_[1 - l], &lt_curr_};
      std::vector<std::pair<std::shared_ptr<Frame>, bool>> tmp;
      while (int(tmp.size()) < s.num_ref[l])
        for (int k = 0; k < 3; ++k)
          for (auto& f : *order[k])
            if (tmp.size() < 16) tmp.push_back({f, k == 2});
      for (int i = 0; i < s.num_ref[l]; ++i) {
        const size_t at = size_t(s.modified[l] ? s.list_entry[l][i] : i);
        if (at >= tmp.size())
          fail("list_entry " + std::to_string(at) + " past the " + std::to_string(tmp.size()) +
               " pictures of the initial list (ffmpeg: \"Invalid reference index\")");
        const auto& e = tmp[at];
        const Frame& g = *e.first;
        if (g.px[0].w != pic_[0].w || g.px[0].h != pic_[0].h || g.lpu != cur_->lpu ||
            g.log2_ctb != cur_->log2_ctb)
          fail("a reference picture of another size than the current picture's");
        refs_[l][i] = e.first;
        rpl_[l].poc[i] = e.first->poc;
        rpl_[l].lt[i] = e.second;
      }
      rpl_[l].n = s.num_ref[l];
      cur_->lists.back()[size_t(l)] = rpl_[l];
    }
    if (s.tmvp) col_ = refs_[s.col_from_l0 ? 0 : 1][s.col_ref_idx];
  }

  void pred_weight_table(Bits& b, Slice& s) {
    s.weighted = true;
    tools |= bit(s.type == 1 ? T_WEIGHTED_PRED : T_WEIGHTED_BIPRED);
    s.luma_denom = b.ue_in("luma_log2_weight_denom", 0, 7);
    s.chroma_denom = s.luma_denom + b.se("delta_chroma_log2_weight_denom");
    if (s.chroma_denom < 0 || s.chroma_denom > 7) fail("ChromaLog2WeightDenom outside 0..7");
    for (int l = 0; l < (s.type == 0 ? 2 : 1); ++l) {
      bool luma[16], chroma[16];
      for (int i = 0; i < s.num_ref[l]; ++i) luma[i] = b.flag("luma_weight_flag");
      for (int i = 0; i < s.num_ref[l]; ++i) chroma[i] = b.flag("chroma_weight_flag");
      for (int i = 0; i < s.num_ref[l]; ++i) {
        s.lw[l][i] = 1 << s.luma_denom;
        s.lo[l][i] = 0;
        if (luma[i]) {
          s.lw[l][i] += b.se_in("delta_luma_weight", -128, 127);
          s.lo[l][i] = b.se_in("luma_offset", -128, 127);
        }
        for (int j = 0; j < 2; ++j) {
          s.cw[l][i][j] = 1 << s.chroma_denom;
          s.co[l][i][j] = 0;
          if (!chroma[i]) continue;
          s.cw[l][i][j] += b.se_in("delta_chroma_weight", -128, 127);
          const int d = b.se_in("delta_chroma_offset", -512, 511);
          s.co[l][i][j] = clip3(-128, 127, d - ((128 * s.cw[l][i][j]) >> s.chroma_denom) + 128);
        }
      }
    }
  }

  void tile_layout(const Pps& p, const Sps& q) {
    const int W = q.ctb_w, H = q.ctb_h;
    col_bd_.assign(size_t(p.num_cols) + 1, 0);
    row_bd_.assign(size_t(p.num_rows) + 1, 0);
    std::vector<int> cw(size_t(p.num_cols)), rh(size_t(p.num_rows));
    if (p.uniform) {
      for (int i = 0; i < p.num_cols; ++i) cw[size_t(i)] = ((i + 1) * W) / p.num_cols - (i * W) / p.num_cols;
      for (int j = 0; j < p.num_rows; ++j) rh[size_t(j)] = ((j + 1) * H) / p.num_rows - (j * H) / p.num_rows;
    } else {
      int sum = 0;
      for (int i = 0; i < p.num_cols - 1; ++i) sum += cw[size_t(i)] = p.col_explicit[size_t(i)];
      if (sum >= W) fail("tile column widths that exceed the picture");
      cw[size_t(p.num_cols - 1)] = W - sum;
      sum = 0;
      for (int j = 0; j < p.num_rows - 1; ++j) sum += rh[size_t(j)] = p.row_explicit[size_t(j)];
      if (sum >= H) fail("tile row heights that exceed the picture");
      rh[size_t(p.num_rows - 1)] = H - sum;
    }
    for (int i = 0; i < p.num_cols; ++i) col_bd_[size_t(i) + 1] = col_bd_[size_t(i)] + cw[size_t(i)];
    for (int j = 0; j < p.num_rows; ++j) row_bd_[size_t(j) + 1] = row_bd_[size_t(j)] + rh[size_t(j)];
    const int n = W * H;
    rs2ts_.assign(size_t(n), 0);
    ts2rs_.assign(size_t(n), 0);
    tile_id_.assign(size_t(n), 0);
    for (int rs = 0; rs < n; ++rs) {
      const int tbx = rs % W, tby = rs / W;
      int tx = 0, ty = 0;
      for (int i = 0; i < p.num_cols; ++i)
        if (tbx >= col_bd_[size_t(i)]) tx = i;
      for (int j = 0; j < p.num_rows; ++j)
        if (tby >= row_bd_[size_t(j)]) ty = j;
      int v = 0;
      for (int i = 0; i < tx; ++i) v += rh[size_t(ty)] * cw[size_t(i)];
      for (int j = 0; j < ty; ++j) v += W * rh[size_t(j)];
      v += (tby - row_bd_[size_t(ty)]) * cw[size_t(tx)] + tbx - col_bd_[size_t(tx)];
      rs2ts_[size_t(rs)] = v;
      ts2rs_[size_t(v)] = rs;
    }
    for (int j = 0, id = 0; j < p.num_rows; ++j)
      for (int i = 0; i < p.num_cols; ++i, ++id)
        for (int y = row_bd_[size_t(j)]; y < row_bd_[size_t(j) + 1]; ++y)
          for (int x = col_bd_[size_t(i)]; x < col_bd_[size_t(i) + 1]; ++x)
            tile_id_[size_t(rs2ts_[size_t(y * W + x)])] = id;
    const int shift = q.log2_ctb - q.log2_min_tb;
    min_tb_w_ = W << shift;
    min_tb_h_ = H << shift;
    zs_.assign(size_t(min_tb_w_) * size_t(min_tb_h_), 0);
    for (int y = 0; y < min_tb_h_; ++y)
      for (int x = 0; x < min_tb_w_; ++x) {
        const int rs = W * (y >> shift) + (x >> shift);
        int v = rs2ts_[size_t(rs)] << (shift * 2);
        for (int i = 0; i < shift; ++i) {
          const int m = 1 << i;
          v += (m & x ? m * m : 0) + (m & y ? 2 * m * m : 0);
        }
        zs_[size_t(y) * size_t(min_tb_w_) + size_t(x)] = v;
      }
  }

  int tile_of_rs(int rs) const { return tile_id_[size_t(rs2ts_[size_t(rs)])]; }
  int ctb_rs_of(int x, int y) const { return (y >> sps->log2_ctb) * sps->ctb_w + (x >> sps->log2_ctb); }

  // 6.4.1: z-scan availability of luma location (xn, yn) from (xc, yc)
  bool avail(int xc, int yc, int xn, int yn) const {
    if (xn < 0 || yn < 0 || xn >= sps->width || yn >= sps->height) return false;
    const int t = sps->log2_min_tb;
    if (zs_[size_t(yn >> t) * size_t(min_tb_w_) + size_t(xn >> t)] >
        zs_[size_t(yc >> t) * size_t(min_tb_w_) + size_t(xc >> t)])
      return false;
    const int nb = ctb_rs_of(xn, yn), cur = ctb_rs_of(xc, yc);
    if (ctb_[size_t(nb)].slice_addr != ctb_[size_t(cur)].slice_addr) return false;
    return tile_of_rs(nb) == tile_of_rs(cur);
  }

  size_t u4(int x, int y) const { return size_t(y >> 2) * size_t(u4w_) + size_t(x >> 2); }

  // ---------------------------------------------------------- slice data --
  void slice_data(const Slice& s, const std::vector<uint8_t>& rbsp) {
    const Pps& p = *pps;
    const Sps& q = *sps;
    data_ = &rbsp;
    int ts = rs2ts_[size_t(s.address)];
    if (s.dependent && ctb_[size_t(ts2rs_[size_t(ts > 0 ? ts - 1 : 0)])].slice_addr != s.slice_addr)
      fail("a dependent slice segment that does not follow its slice");
    if (ctb_[size_t(s.address)].slice_addr >= 0) fail("two slice segments code the same CTB");
    cabac_.start(rbsp.data(), rbsp.size(), s.data_byte);
    cur_slice_addr_ = s.slice_addr;
    const int W = q.ctb_w;
    // contexts at the segment's first CTB (9.3.1, as ffmpeg orders the cases)
    const bool tile_start = p.tiles && ts > 0 && tile_id_[size_t(ts)] != tile_id_[size_t(ts - 1)];
    if (!s.dependent || tile_start) init_contexts(ctx_, s.qp, s.init_type);
    if (p.wpp && s.address % W == 0) {
      if (W == 1)
        init_contexts(ctx_, s.qp, s.init_type);
      else if (s.dependent)
        std::memcpy(ctx_, ctx_wpp_, C_COUNT);
    }
    if (!s.dependent) {
      first_qg_ = true;
      qp_prev_ = s.qp;
    }
    if (p.wpp && s.address % W == 0) {
      first_qg_ = true;
      qp_prev_ = s.qp;
    }
    if (tile_start) {
      first_qg_ = true;
      qp_prev_ = s.qp;
    }
    qp_y_ = qp_prev_;
    const int n = W * q.ctb_h;
    for (;;) {
      const int rs = ts2rs_[size_t(ts)];
      if (ctb_[size_t(rs)].slice_addr >= 0) fail("two slice segments code the same CTB");
      CtbInfo& c = ctb_[size_t(rs)];
      c.slice_addr = s.slice_addr;
      c.lf_across_slices = s.lf_across_slices;
      c.deblock = !s.deblock_disabled;
      c.beta_offset = s.beta_offset;
      c.tc_offset = s.tc_offset;
      cur_->ctb_slice[size_t(rs)] = slice_idx_;
      cur_ctb_rs_ = rs;
      coding_tree_unit(s, rs);
      ++decoded_ctbs_;
      const int end = cabac_.terminate();   // end_of_slice_segment_flag
      ++ts;
      // WPP storage after the row's second CTB (ffmpeg: also after the first when W is 2)
      if (p.wpp && (ts % W == 2 || (W == 2 && ts % W == 0))) std::memcpy(ctx_wpp_, ctx_, C_COUNT);
      if (end) break;
      if (ts >= n) fail("slice data run past the last CTB");
      const int nrs = ts2rs_[size_t(ts)];
      const bool new_tile = p.tiles && tile_id_[size_t(ts)] != tile_id_[size_t(ts - 1)];
      const bool new_row = p.wpp && nrs % W == 0;
      if (new_tile || new_row) {
        if (!cabac_.terminate()) fail("end_of_subset_one_bit is 0");
        if (!cabac_.zero_alignment()) fail("a byte_alignment() bit after a substream is not 0");
        cabac_.start(rbsp.data(), rbsp.size(), cabac_.next_byte());
        if (new_tile) {
          init_contexts(ctx_, s.qp, s.init_type);
          first_qg_ = true;
          qp_prev_ = s.qp;
        }
        if (new_row) {
          if (W == 1)
            init_contexts(ctx_, s.qp, s.init_type);
          else
            std::memcpy(ctx_, ctx_wpp_, C_COUNT);
          first_qg_ = true;
          qp_prev_ = s.qp;
        }
      }
    }
  }

  // -------------------------------------------------------------- CTU, SAO --
  void coding_tree_unit(const Slice& s, int rs) {
    const Sps& q = *sps;
    const int W = q.ctb_w;
    const int rx = rs % W, ry = rs / W;
    if (s.sao_luma || s.sao_chroma) sao_syntax(s, rs, rx, ry);
    coding_quadtree(rx << q.log2_ctb, ry << q.log2_ctb, q.log2_ctb, 0);
  }

  void sao_syntax(const Slice& s, int rs, int rx, int ry) {
    const int W = sps->ctb_w;
    SaoParams& sp = ctb_[size_t(rs)].sao;
    bool merge_left = false, merge_up = false;
    if (rx > 0) {
      const bool in_slice = rs > s.slice_addr;
      const bool in_tile = tile_of_rs(rs) == tile_of_rs(rs - 1);
      if (in_slice && in_tile) merge_left = cabac_.decision(ctx_[C_SAO_MERGE]);
    }
    if (ry > 0 && !merge_left) {
      const bool in_slice = rs - W >= s.slice_addr;
      const bool in_tile = tile_of_rs(rs) == tile_of_rs(rs - W);
      if (in_slice && in_tile) merge_up = cabac_.decision(ctx_[C_SAO_MERGE]);
    }
    if (merge_left || merge_up) {
      tools |= bit(T_SAO_MERGE);
      sp = ctb_[size_t(merge_left ? rs - 1 : rs - W)].sao;
      // a component the slice does not filter stays unfiltered
      if (!s.sao_luma) sp.type[0] = 0;
      if (!s.sao_chroma) sp.type[1] = sp.type[2] = 0;
      return;
    }
    for (int c = 0; c < 3; ++c) {
      if ((c == 0 && !s.sao_luma) || (c > 0 && !s.sao_chroma)) {
        sp.type[c] = 0;
        continue;
      }
      if (c == 2) {
        sp.type[2] = sp.type[1];
        sp.eo_class[2] = sp.eo_class[1];
      } else {
        int t = 0;
        if (cabac_.decision(ctx_[C_SAO_TYPE])) t = cabac_.bypass() ? 2 : 1;
        sp.type[c] = t;
      }
      if (!sp.type[c]) continue;
      int abs[4];
      for (int i = 0; i < 4; ++i) {
        int v = 0;
        while (v < 7 && cabac_.bypass()) ++v;
        abs[i] = v;
      }
      if (sp.type[c] == 1) {
        tools |= bit(T_SAO_BAND);
        for (int i = 0; i < 4; ++i)
          sp.offset[c][i + 1] = (abs[i] && cabac_.bypass()) ? -abs[i] : abs[i];
        sp.band[c] = int(cabac_.bypass_bits(5));
      } else {
        tools |= bit(T_SAO_EDGE);
        sp.offset[c][1] = abs[0];
        sp.offset[c][2] = abs[1];
        sp.offset[c][3] = -abs[2];
        sp.offset[c][4] = -abs[3];
        if (c == 0) sp.eo_class[0] = int(cabac_.bypass_bits(2));
        if (c == 1) sp.eo_class[1] = int(cabac_.bypass_bits(2));
      }
      sp.offset[c][0] = 0;
    }
  }

  // --------------------------------------------------------- coding tree --
  void coding_quadtree(int x0, int y0, int log2, int depth) {
    const Sps& q = *sps;
    const Pps& p = *pps;
    const int size = 1 << log2;
    int split;
    if (x0 + size <= q.width && y0 + size <= q.height && log2 > q.log2_min_cb) {
      int inc = 0;
      if (avail(x0, y0, x0 - 1, y0) && depth_[u4(x0 - 1, y0)] > depth) ++inc;
      if (avail(x0, y0, x0, y0 - 1) && depth_[u4(x0, y0 - 1)] > depth) ++inc;
      split = cabac_.decision(ctx_[C_SPLIT_CU + inc]);
    } else {
      split = log2 > q.log2_min_cb;
    }
    if (p.cu_qp_delta && log2 >= q.log2_ctb - p.diff_cu_qp_delta_depth) {
      cu_qp_delta_coded_ = false;
      qg_start(x0, y0);
    }
    if (split) {
      const int h = size >> 1;
      coding_quadtree(x0, y0, log2 - 1, depth + 1);
      if (x0 + h < q.width) coding_quadtree(x0 + h, y0, log2 - 1, depth + 1);
      if (y0 + h < q.height) coding_quadtree(x0, y0 + h, log2 - 1, depth + 1);
      if (x0 + h < q.width && y0 + h < q.height) coding_quadtree(x0 + h, y0 + h, log2 - 1, depth + 1);
    } else {
      coding_unit(x0, y0, log2, depth);
    }
  }

  // 8.6.1: qPY_PRED of the quantization group at (xq, yq)
  int qg_pred_ = 26;
  void qg_start(int xq, int yq) {
    const int prev = first_qg_ ? sh_.qp : qp_prev_;
    first_qg_ = false;
    const int ctb_mask = (1 << sps->log2_ctb) - 1;
    int a = prev, b = prev;
    if ((xq & ctb_mask) && avail(xq, yq, xq - 1, yq)) a = qp_[u4(xq - 1, yq)];
    if ((yq & ctb_mask) && avail(xq, yq, xq, yq - 1)) b = qp_[u4(xq, yq - 1)];
    qg_pred_ = (a + b + 1) >> 1;
    qp_y_ = qg_pred_;
  }

  void fill4(std::vector<int8_t>& m, int x0, int y0, int size, int v) {
    for (int y = y0; y < y0 + size && y < sps->height; y += 4)
      for (int x = x0; x < x0 + size && x < sps->width; x += 4) m[u4(x, y)] = int8_t(v);
  }

  enum Part { P_2Nx2N, P_2NxN, P_Nx2N, P_NxN, P_2NxnU, P_2NxnD, P_nLx2N, P_nRx2N };

  void coding_unit(int x0, int y0, int log2, int depth) {
    const Sps& q = *sps;
    const Pps& p = *pps;
    const int size = 1 << log2;
    bypass_ = false;
    if (p.transquant_bypass) {
      bypass_ = cabac_.decision(ctx_[C_BYPASS]);
      if (bypass_) {
        tools |= bit(T_BYPASS);
        fill4_u8(nofilter_, x0, y0, size, 1);
      }
    }
    if (!p.cu_qp_delta) {
      // without cu_qp_delta, every CU takes the slice QP
      qp_y_ = sh_.qp;
    } else if (!cu_qp_delta_coded_) {
      qp_y_ = qg_pred_;
    }
    fill4(depth_, x0, y0, size, depth);
    bool skip = false;
    if (sh_.type != 2) {
      int inc = 0;
      if (avail(x0, y0, x0 - 1, y0) && skip_[u4(x0 - 1, y0)]) ++inc;
      if (avail(x0, y0, x0, y0 - 1) && skip_[u4(x0, y0 - 1)]) ++inc;
      skip = cabac_.decision(ctx_[C_SKIP + inc]);
    }
    fill4_u8(skip_, x0, y0, size, skip);
    cu_intra_ = sh_.type == 2;
    cu_part_ = P_2Nx2N;
    if (skip) {
      tools |= bit(T_SKIP);
      cu_intra_ = false;
      fill4(ipm_, x0, y0, size, 1);
      prediction_unit(x0, y0, size, x0, y0, size, size, 0, depth, true);
      boundary_strengths(x0, y0, size);
      fill4(qp_, x0, y0, size, qp_y_);
      qp_prev_ = qp_y_;
      return;
    }
    if (sh_.type != 2) cu_intra_ = cabac_.decision(ctx_[C_PRED_MODE]);
    bool nxn = false;
    if (cu_intra_) {
      mark_intra(x0, y0, size);
      if (log2 == q.log2_min_cb) nxn = !cabac_.decision(ctx_[C_PART]);
      if (nxn && log2 <= q.log2_min_tb) fail("an NxN intra CU whose blocks are below the minimum TB");
      cu_part_ = nxn ? P_NxN : P_2Nx2N;
    } else {
      cu_part_ = part_mode(log2);
      fill4(ipm_, x0, y0, size, 1);
      const int h = size / 2, qs = size / 4;
      switch (cu_part_) {
        case P_2Nx2N:
          prediction_unit(x0, y0, size, x0, y0, size, size, 0, depth, false);
          break;
        case P_2NxN:
          prediction_unit(x0, y0, size, x0, y0, size, h, 0, depth, false);
          prediction_unit(x0, y0, size, x0, y0 + h, size, h, 1, depth, false);
          break;
        case P_Nx2N:
          prediction_unit(x0, y0, size, x0, y0, h, size, 0, depth, false);
          prediction_unit(x0, y0, size, x0 + h, y0, h, size, 1, depth, false);
          break;
        case P_2NxnU:
          prediction_unit(x0, y0, size, x0, y0, size, qs, 0, depth, false);
          prediction_unit(x0, y0, size, x0, y0 + qs, size, size - qs, 1, depth, false);
          break;
        case P_2NxnD:
          prediction_unit(x0, y0, size, x0, y0, size, size - qs, 0, depth, false);
          prediction_unit(x0, y0, size, x0, y0 + size - qs, size, qs, 1, depth, false);
          break;
        case P_nLx2N:
          prediction_unit(x0, y0, size, x0, y0, qs, size, 0, depth, false);
          prediction_unit(x0, y0, size, x0 + qs, y0, size - qs, size, 1, depth, false);
          break;
        case P_nRx2N:
          prediction_unit(x0, y0, size, x0, y0, size - qs, size, 0, depth, false);
          prediction_unit(x0, y0, size, x0 + size - qs, y0, qs, size, 1, depth, false);
          break;
        default:
          prediction_unit(x0, y0, size, x0, y0, h, h, 0, depth, false);
          prediction_unit(x0, y0, size, x0 + h, y0, h, h, 1, depth, false);
          prediction_unit(x0, y0, size, x0, y0 + h, h, h, 2, depth, false);
          prediction_unit(x0, y0, size, x0 + h, y0 + h, h, h, 3, depth, false);
          break;
      }
      bool root = true;
      if (!(cu_part_ == P_2Nx2N && merge_flag_)) root = cabac_.decision(ctx_[C_RQT_ROOT]);
      if (!root) {
        tools |= bit(T_NO_RESIDUAL);
        boundary_strengths(x0, y0, size);
        fill4(qp_, x0, y0, size, qp_y_);
        qp_prev_ = qp_y_;
        return;
      }
      transform_tree(x0, y0, x0, y0, log2, 0, 0, q.max_th_depth_inter, false, x0, y0, log2, true,
                     true);
      fill4(qp_, x0, y0, size, qp_y_);
      qp_prev_ = qp_y_;
      return;
    }
    bool pcm = false;
    if (!nxn && q.pcm && log2 >= q.log2_min_pcm && log2 <= q.log2_max_pcm) pcm = cabac_.terminate();
    if (pcm) {
      tools |= bit(T_PCM);
      fill4(ipm_, x0, y0, size, 1);
      pcm_sample(x0, y0, log2);
      if (q.pcm_loop_filter_disabled) fill4_u8(nofilter_, x0, y0, size, 1);
      fill4(qp_, x0, y0, size, qp_y_);
      boundary_strengths(x0, y0, size);
      qp_prev_ = qp_y_;
      return;
    }
    // intra modes
    const int pb = nxn ? size / 2 : size;
    const int parts = nxn ? 4 : 1;
    int prev_flag[4];
    for (int i = 0; i < parts; ++i) prev_flag[i] = cabac_.decision(ctx_[C_PREV_INTRA]);
    for (int i = 0; i < parts; ++i) {
      const int xp = x0 + (i & 1) * pb, yp = y0 + (i >> 1) * pb;
      int cand[3];
      mpm(xp, yp, cand);
      int mode;
      if (prev_flag[i]) {
        int idx = 0;
        if (cabac_.bypass()) idx = cabac_.bypass() ? 2 : 1;
        mode = cand[idx];
      } else {
        mode = int(cabac_.bypass_bits(5));
        std::sort(cand, cand + 3);
        for (int k = 0; k < 3; ++k)
          if (mode >= cand[k]) ++mode;
      }
      fill4(ipm_, xp, yp, pb, mode);
      tools |= bit(mode == 0 ? T_PLANAR : mode == 1 ? T_DC : T_ANGULAR);
    }
    if (nxn) tools |= bit(T_INTRA_NXN);
    int chroma_mode;
    const int luma0 = ipm_[u4(x0, y0)];
    if (!cabac_.decision(ctx_[C_CHROMA_MODE])) {
      chroma_mode = luma0;
      tools |= bit(T_CHROMA_DM);
    } else {
      const int v = int(cabac_.bypass_bits(2));
      const int modes[4] = {0, 26, 10, 1};
      chroma_mode = modes[v] == luma0 ? 34 : modes[v];
    }
    chroma_mode_ = chroma_mode;
    const int max_depth = q.max_th_depth_intra + (nxn ? 1 : 0);
    transform_tree(x0, y0, x0, y0, log2, 0, 0, max_depth, nxn, x0, y0, log2, true, true);
    fill4(qp_, x0, y0, size, qp_y_);
    qp_prev_ = qp_y_;
  }

  // the CU's minimum prediction blocks read as intra (ffmpeg: at least one)
  void mark_intra(int x0, int y0, int size) {
    Frame& f = *cur_;
    const int n = std::max(1, size >> f.lpu), xp = x0 >> f.lpu, yp = y0 >> f.lpu;
    for (int j = 0; j < n && yp + j < f.pu_h; ++j)
      for (int i = 0; i < n && xp + i < f.pu_w; ++i) f.mvf[size_t(yp + j) * size_t(f.pu_w) + size_t(xp + i)].pred = PF_INTRA;
  }

  // part_mode of an inter CU (Table 9-43, with ffmpeg's context for the AMP bin)
  int part_mode(int log2) {
    const Sps& q = *sps;
    if (cabac_.decision(ctx_[C_PART])) return P_2Nx2N;
    if (log2 == q.log2_min_cb) {
      if (cabac_.decision(ctx_[C_PART_INTER])) return P_2NxN;
      if (log2 == 3) return P_Nx2N;
      if (cabac_.decision(ctx_[C_PART_INTER + 1])) return P_Nx2N;
      tools |= bit(T_INTER_NXN);
      return P_NxN;
    }
    if (!q.amp) return cabac_.decision(ctx_[C_PART_INTER]) ? P_2NxN : P_Nx2N;
    if (cabac_.decision(ctx_[C_PART_INTER])) {
      if (cabac_.decision(ctx_[C_PART_INTER + 2])) return P_2NxN;
      tools |= bit(T_AMP);
      return cabac_.bypass() ? P_2NxnD : P_2NxnU;
    }
    if (cabac_.decision(ctx_[C_PART_INTER + 2])) return P_Nx2N;
    tools |= bit(T_AMP);
    return cabac_.bypass() ? P_nRx2N : P_nLx2N;
  }

  // ----------------------------------------------------- prediction unit --
  bool merge_flag_ = false;

  const MvField& mvf_at(int x, int y) const { return cur_->at(x, y); }

  // 6.4.2: the prediction block at (xn, yn) is available to the one at
  // (xp, yp) of the CB at (xc, yc), and not intra
  bool avail_pb(int xc, int yc, int ncs, int xp, int yp, int w, int h, int part, int xn, int yn) const {
    bool ok;
    const bool same_cb = xc <= xn && xn < xc + ncs && yc <= yn && yn < yc + ncs;
    if (!same_cb)
      ok = avail(xp, yp, xn, yn);
    else
      ok = !((w << 1) == ncs && (h << 1) == ncs && part == 1 && yc + h <= yn && xc + w > xn);
    return ok && mvf_at(xn, yn).pred != PF_INTRA;
  }

  static bool same_motion(const MvField& a, const MvField& b) {
    if (a.pred != b.pred) return false;
    if (a.pred == PF_BI)
      return a.mv[0] == b.mv[0] && a.mv[1] == b.mv[1] && a.ref_idx[0] == b.ref_idx[0] &&
             a.ref_idx[1] == b.ref_idx[1];
    if (a.pred == PF_L0) return a.mv[0] == b.mv[0] && a.ref_idx[0] == b.ref_idx[0];
    if (a.pred == PF_L1) return a.mv[1] == b.mv[1] && a.ref_idx[1] == b.ref_idx[1];
    return false;
  }

  static Mv scale_mv(Mv mv, int td, int tb) {
    td = clip3(-128, 127, td);
    tb = clip3(-128, 127, tb);
    const int tx = (16384 + std::abs(td / 2)) / td;
    const int f = clip3(-4096, 4095, (tb * tx + 32) >> 6);
    auto one = [&](int v) {
      const int p = f * v;
      return int16_t(clip3(-32768, 32767, (p + 127 + (p < 0)) >> 8));
    };
    return Mv{one(mv.x), one(mv.y)};
  }

  // 8.5.3.2.8 as ffmpeg's temporal_luma_motion_vector
  bool temporal_mv(int x0, int y0, int w, int h, int ref_idx, int X, Mv& out) {
    out = Mv();
    if (!col_) return false;
    const Frame& col = *col_;
    const Sps& q = *sps;
    int x = x0 + w, y = y0 + h;
    bool ok = false;
    if ((y0 >> q.log2_ctb) == (y >> q.log2_ctb) && y < q.height && x < q.width)
      ok = collocated(col, x & ~15, y & ~15, ref_idx, X, out);
    if (!ok) ok = collocated(col, (x0 + (w >> 1)) & ~15, (y0 + (h >> 1)) & ~15, ref_idx, X, out);
    if (ok) tools |= bit(T_TMVP);
    return ok;
  }

  bool collocated(const Frame& col, int x, int y, int ref_idx, int X, Mv& out) {
    const MvField& t = col.at(x, y);
    if (t.pred == PF_INTRA || !t.pred) return false;
    const RefList* lc = col.lists_at(x, y);
    if (!lc) return false;
    int l;
    if (!(t.pred & PF_L0)) {
      l = 1;
    } else if (t.pred == PF_L0) {
      l = 0;
    } else {
      bool later = false;   // a picture of either list after the current one (NoBackwardPredFlag 0)
      for (int j = 0; j < 2; ++j)
        for (int i = 0; i < rpl_[j].n; ++i) later |= rpl_[j].poc[i] > poc;
      l = !later ? X : (sh_.col_from_l0 ? 1 : 0);
    }
    const int ri = t.ref_idx[l];
    if (ri < 0 || ri >= lc[l].n) return false;
    const bool cur_lt = rpl_[X].lt[ref_idx], col_lt = lc[l].lt[ri];
    if (cur_lt != col_lt) {
      out = Mv();
      return false;
    }
    const int col_diff = col.poc - lc[l].poc[ri], cur_diff = poc - rpl_[X].poc[ref_idx];
    if (cur_lt || col_diff == cur_diff || !col_diff)
      out = t.mv[l];
    else
      out = scale_mv(t.mv[l], col_diff, cur_diff);
    return true;
  }

  // 8.5.3.2.2-5: the merge candidate merge_idx, as ffmpeg builds the list
  MvField merge(int xc, int yc, int ncs, int x0, int y0, int w, int h, int part, int idx) {
    const int ow = w, oh = h;
    const int pm = pps->log2_par_mrg;
    const bool single = pm > 2 && ncs == 8;
    if (single) {
      x0 = xc;
      y0 = yc;
      w = h = ncs;
      part = 0;
      tools |= bit(T_PARALLEL_MERGE);
    }
    auto diff_mer = [&](int xn, int yn) { return (x0 >> pm) == (xn >> pm) && (y0 >> pm) == (yn >> pm); };
    auto av = [&](int xn, int yn) { return avail_pb(xc, yc, ncs, x0, y0, w, h, part, xn, yn); };
    MvField cand[5];
    int n = 0;
    const int max = sh_.max_merge;
    const int xa1 = x0 - 1, ya1 = y0 + h - 1, xb1 = x0 + w - 1, yb1 = y0 - 1;
    const bool vertical = cu_part_ == P_Nx2N || cu_part_ == P_nLx2N || cu_part_ == P_nRx2N;
    const bool horizontal = cu_part_ == P_2NxN || cu_part_ == P_2NxnU || cu_part_ == P_2NxnD;
    const bool a1 = !((!single && part == 1 && vertical) || diff_mer(xa1, ya1)) && av(xa1, ya1);
    if (a1) cand[n++] = mvf_at(xa1, ya1);
    const bool b1 = !((!single && part == 1 && horizontal) || diff_mer(xb1, yb1)) && av(xb1, yb1);
    if (b1 && !(a1 && same_motion(mvf_at(xb1, yb1), mvf_at(xa1, ya1)))) cand[n++] = mvf_at(xb1, yb1);
    const int xb0 = x0 + w, yb0 = y0 - 1;
    const bool b0 = av(xb0, yb0) && !diff_mer(xb0, yb0);
    if (b0 && !(b1 && same_motion(mvf_at(xb0, yb0), mvf_at(xb1, yb1)))) cand[n++] = mvf_at(xb0, yb0);
    const int xa0 = x0 - 1, ya0 = y0 + h;
    const bool a0 = av(xa0, ya0) && !diff_mer(xa0, ya0);
    if (a0 && !(a1 && same_motion(mvf_at(xa0, ya0), mvf_at(xa1, ya1)))) cand[n++] = mvf_at(xa0, ya0);
    const int xb2 = x0 - 1, yb2 = y0 - 1;
    const bool b2 = av(xb2, yb2) && !diff_mer(xb2, yb2);
    if (b2 && !(a1 && same_motion(mvf_at(xb2, yb2), mvf_at(xa1, ya1))) &&
        !(b1 && same_motion(mvf_at(xb2, yb2), mvf_at(xb1, yb1))) && n != 4)
      cand[n++] = mvf_at(xb2, yb2);
    n = std::min(n, max);
    if (sh_.tmvp && n < max && n <= idx) {
      MvField t;
      const bool l0 = temporal_mv(x0, y0, w, h, 0, 0, t.mv[0]);
      const bool l1 = sh_.type == 0 && temporal_mv(x0, y0, w, h, 0, 1, t.mv[1]);
      if (l0 || l1) {
        t.pred = uint8_t(l0 + (l1 << 1));
        t.ref_idx[0] = t.ref_idx[1] = 0;
        cand[n++] = t;
      }
    }
    const int orig = n;
    if (sh_.type == 0 && orig > 1 && orig < max && n <= idx) {
      static const int kComb[12][2] = {{0, 1}, {1, 0}, {0, 2}, {2, 0}, {1, 2}, {2, 1},
                                       {0, 3}, {3, 0}, {1, 3}, {3, 1}, {2, 3}, {3, 2}};
      for (int c = 0; n < max && c < orig * (orig - 1); ++c) {
        const MvField& p0 = cand[kComb[c][0]];
        const MvField& p1 = cand[kComb[c][1]];
        if ((p0.pred & PF_L0) && (p1.pred & PF_L1) &&
            (rpl_[0].poc[p0.ref_idx[0]] != rpl_[1].poc[p1.ref_idx[1]] || p0.mv[0] != p1.mv[1])) {
          MvField m;
          m.pred = PF_BI;
          m.ref_idx[0] = p0.ref_idx[0];
          m.ref_idx[1] = p1.ref_idx[1];
          m.mv[0] = p0.mv[0];
          m.mv[1] = p1.mv[1];
          cand[n++] = m;
        }
      }
    }
    const int refs = sh_.type == 1 ? sh_.num_ref[0] : std::min(sh_.num_ref[0], sh_.num_ref[1]);
    for (int zero = 0; n < max; ++zero) {
      MvField m;
      m.pred = sh_.type == 0 ? PF_BI : PF_L0;
      m.ref_idx[0] = int8_t(zero < refs ? zero : 0);
      m.ref_idx[1] = sh_.type == 0 ? m.ref_idx[0] : int8_t(-1);
      cand[n++] = m;
    }
    MvField out = cand[idx];
    if (out.pred == PF_BI && ow + oh == 12) {
      out.pred = PF_L0;
      tools |= bit(T_BI_TO_UNI);
    }
    return out;
  }

  // 8.5.3.2.6-7: the motion vector predictor mvp_flag of list X, as ffmpeg
  // derives it (spatial A and B with scaling, then the temporal one)
  Mv amvp(int xc, int yc, int ncs, int x0, int y0, int w, int h, int part, int X, int ref_idx,
          int mvp_flag) {
    auto av = [&](int xn, int yn) { return avail_pb(xc, yc, ncs, x0, y0, w, h, part, xn, yn); };
    const int target = rpl_[X].poc[ref_idx];
    const bool target_lt = rpl_[X].lt[ref_idx];
    auto mx = [&](const MvField& f, int l, Mv& out) {
      if ((f.pred & (1 << l)) && rpl_[l].poc[f.ref_idx[l]] == target) {
        out = f.mv[l];
        return true;
      }
      return false;
    };
    auto mx_lt = [&](const MvField& f, int l, Mv& out) {
      if (!(f.pred & (1 << l))) return false;
      if (rpl_[l].lt[f.ref_idx[l]] != target_lt) return false;
      out = f.mv[l];
      const int rp = rpl_[l].poc[f.ref_idx[l]];
      if (!target_lt && rp != target) {
        int td = poc - rp;
        if (!td) td = 1;
        out = scale_mv(out, td, poc - target);
      }
      return true;
    };
    const int xa0 = x0 - 1, ya0 = y0 + h, xa1 = x0 - 1, ya1 = y0 + h - 1;
    const bool a0 = av(xa0, ya0), a1 = av(xa1, ya1);
    const bool scaled = a0 || a1;
    Mv ma, mb;
    bool fa = false, fb = false;
    const MvField* A[2] = {a0 ? &mvf_at(xa0, ya0) : nullptr, a1 ? &mvf_at(xa1, ya1) : nullptr};
    for (int k = 0; k < 2 && !fa; ++k)
      if (A[k]) fa = mx(*A[k], X, ma) || mx(*A[k], 1 - X, ma);
    for (int k = 0; k < 2 && !fa; ++k)
      if (A[k]) fa = mx_lt(*A[k], X, ma) || mx_lt(*A[k], 1 - X, ma);
    const int xb0 = x0 + w, yb0 = y0 - 1, xb1 = x0 + w - 1, yb1 = y0 - 1, xb2 = x0 - 1, yb2 = y0 - 1;
    const MvField* B[3] = {av(xb0, yb0) ? &mvf_at(xb0, yb0) : nullptr,
                           av(xb1, yb1) ? &mvf_at(xb1, yb1) : nullptr,
                           av(xb2, yb2) ? &mvf_at(xb2, yb2) : nullptr};
    for (int k = 0; k < 3 && !fb; ++k)
      if (B[k]) fb = mx(*B[k], X, mb) || mx(*B[k], 1 - X, mb);
    if (!scaled) {
      if (fb) {
        fa = true;
        ma = mb;
      }
      fb = false;
      for (int k = 0; k < 3 && !fb; ++k)
        if (B[k]) fb = mx_lt(*B[k], X, mb) || mx_lt(*B[k], 1 - X, mb);
    }
    Mv list[2];
    int n = 0;
    if (fa) list[n++] = ma;
    if (fb && (!fa || ma != mb)) list[n++] = mb;
    if (n < 2 && sh_.tmvp && mvp_flag == n) {
      Mv t;
      if (temporal_mv(x0, y0, w, h, ref_idx, X, t)) list[n++] = t;
    }
    return mvp_flag < n ? list[mvp_flag] : Mv();
  }

  void mvd(int& dx, int& dy) {
    int v[2];
    v[0] = cabac_.decision(ctx_[C_MVD_GT0]);
    v[1] = cabac_.decision(ctx_[C_MVD_GT0]);
    for (int k = 0; k < 2; ++k)
      if (v[k]) v[k] += cabac_.decision(ctx_[C_MVD_GT1]);
    int out[2];
    for (int k = 0; k < 2; ++k) {
      if (!v[k]) {
        out[k] = 0;
        continue;
      }
      int a = 1;
      if (v[k] == 2) {   // abs_mvd_minus2: EG1
        a = 2;
        int e = 1;
        while (cabac_.bypass()) {
          a += 1 << e;
          if (++e > 30) fail("a malformed abs_mvd_minus2");
        }
        a += int(cabac_.bypass_bits(e));
      }
      out[k] = cabac_.bypass() ? -a : a;
    }
    dx = out[0];
    dy = out[1];
  }

  int ref_idx(int num) {
    int i = 0;
    const int max = num - 1, max_ctx = std::min(max, 2);
    while (i < max_ctx && cabac_.decision(ctx_[C_REF_IDX + i])) ++i;
    if (i == 2)
      while (i < max && cabac_.bypass()) ++i;
    return i;
  }

  // prediction_unit (7.3.8.6): its motion, stored as ffmpeg stores it (whole
  // minimum prediction blocks), then its samples
  void prediction_unit(int xc, int yc, int ncs, int x0, int y0, int w, int h, int part, int depth,
                       bool skip) {
    MvField mv;
    merge_flag_ = skip || cabac_.decision(ctx_[C_MERGE_FLAG]);
    if (merge_flag_) {
      int idx = 0;
      if (sh_.max_merge > 1 && cabac_.decision(ctx_[C_MERGE_IDX])) {
        idx = 1;
        while (idx < sh_.max_merge - 1 && cabac_.bypass()) ++idx;
      }
      tools |= bit(T_MERGE);
      mv = merge(xc, yc, ncs, x0, y0, w, h, part, idx);
    } else {
      tools |= bit(T_AMVP);
      int idc = 0;   // PRED_L0, PRED_L1, PRED_BI
      if (sh_.type == 0) {
        if (w + h == 12)
          idc = cabac_.decision(ctx_[C_INTER_PRED + 4]);
        else if (cabac_.decision(ctx_[C_INTER_PRED + depth]))
          idc = 2;
        else
          idc = cabac_.decision(ctx_[C_INTER_PRED + 4]);
      }
      for (int X = 0; X < 2; ++X) {
        if (idc == 1 - X) continue;   // PRED_L1 skips list 0, PRED_L0 list 1
        mv.ref_idx[X] = int8_t(sh_.num_ref[X] > 1 ? ref_idx(sh_.num_ref[X]) : 0);
        int dx = 0, dy = 0;
        if (X == 1 && sh_.mvd_l1_zero && idc == 2)
          ;   // MvdL1 is zero
        else
          mvd(dx, dy);
        const int flag = cabac_.decision(ctx_[C_MVP]);
        mv.pred |= uint8_t(1 << X);
        const Mv p = amvp(xc, yc, ncs, x0, y0, w, h, part, X, mv.ref_idx[X], flag);
        mv.mv[X].x = int16_t(uint16_t(p.x + dx));   // the 16-bit wrap of mvpLX + mvdLX
        mv.mv[X].y = int16_t(uint16_t(p.y + dy));
      }
    }
    if (mv.pred == PF_BI) tools |= bit(T_BI_PRED);
    for (int X = 0; X < 2; ++X)
      if ((mv.pred & (1 << X)) && (mv.ref_idx[X] >= sh_.num_ref[X] || !refs_[X][mv.ref_idx[X]]))
        fail("a prediction block refers to a reference index past its list");
    Frame& f = *cur_;
    const int xp = x0 >> f.lpu, yp = y0 >> f.lpu;
    for (int j = 0; j < (h >> f.lpu); ++j)
      for (int i = 0; i < (w >> f.lpu); ++i) f.mvf[size_t(yp + j) * size_t(f.pu_w) + size_t(xp + i)] = mv;
    motion_compensate(mv, x0, y0, w, h);
  }

  // ----------------------------------------------- sample prediction ----
  // 8.5.3.3.3: the luma and chroma samples of one list at 14 bits, the
  // reference read with its edges replicated (xInt, yInt clipped)
  void predict(const Frame& ref, int c, int x0, int y0, int w, int h, Mv mv, int* dst) {
    const Plane& pl = ref.px[c];
    const int W = pl.w, H = pl.h;
    int fx, fy, xi, yi, taps;
    const int* fh;
    const int* fv;
    if (c == 0) {
      fx = mv.x & 3;
      fy = mv.y & 3;
      xi = x0 + (mv.x >> 2);
      yi = y0 + (mv.y >> 2);
      taps = 8;
      fh = kLumaFilter[fx];
      fv = kLumaFilter[fy];
    } else {
      fx = mv.x & 7;
      fy = mv.y & 7;
      xi = x0 + (mv.x >> 3);
      yi = y0 + (mv.y >> 3);
      taps = 4;
      fh = kChromaFilter[fx];
      fv = kChromaFilter[fy];
    }
    const int before = taps / 2 - 1;   // 3 (luma) or 1 (chroma)
    const int xs = xi - before, ys = yi - before;
    const int bw = w + taps - 1, bh = h + taps - 1;
    if (xs < 0 || ys < 0 || xs + bw > W || ys + bh > H) tools |= bit(T_MV_OUTSIDE);
    // the block and its filter margin, edges replicated
    static thread_local std::vector<int> src;
    src.resize(size_t(bw) * size_t(bh));
    for (int y = 0; y < bh; ++y) {
      const int sy = clip3(0, H - 1, ys + y);
      const uint8_t* row = &pl.px[size_t(sy) * size_t(W)];
      int* out = &src[size_t(y) * size_t(bw)];
      if (xs >= 0 && xs + bw <= W) {
        for (int x = 0; x < bw; ++x) out[x] = row[xs + x];
      } else {
        for (int x = 0; x < bw; ++x) out[x] = row[clip3(0, W - 1, xs + x)];
      }
    }
    auto S = [&](int x, int y) { return src[size_t(y) * size_t(bw) + size_t(x)]; };
    if (!fx && !fy) {
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) dst[y * w + x] = S(x + before, y + before) << 6;
    } else if (!fy) {
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          int v = 0;
          for (int k = 0; k < taps; ++k) v += fh[k] * S(x + k, y + before);
          dst[y * w + x] = v;
        }
    } else if (!fx) {
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          int v = 0;
          for (int k = 0; k < taps; ++k) v += fv[k] * S(x + before, y + k);
          dst[y * w + x] = v;
        }
    } else {
      static thread_local std::vector<int> tmp;
      tmp.resize(size_t(w) * size_t(bh));
      for (int y = 0; y < bh; ++y)
        for (int x = 0; x < w; ++x) {
          int v = 0;
          for (int k = 0; k < taps; ++k) v += fh[k] * S(x + k, y);
          tmp[size_t(y) * size_t(w) + size_t(x)] = v;
        }
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          int v = 0;
          for (int k = 0; k < taps; ++k) v += fv[k] * tmp[size_t(y + k) * size_t(w) + size_t(x)];
          dst[y * w + x] = v >> 6;
        }
    }
  }

  // 8.5.3.3.4: default or explicit weighting of the lists' samples into the picture
  void motion_compensate(const MvField& mv, int x0, int y0, int w, int h) {
    const Slice& s = sh_;
    for (int c = 0; c < 3; ++c) {
      const int sh = c ? 1 : 0;
      const int xc = x0 >> sh, yc = y0 >> sh, wc = w >> sh, hc = h >> sh;
      for (int X = 0; X < 2; ++X)
        if (mv.pred & (1 << X)) predict(*refs_[X][mv.ref_idx[X]], c, xc, yc, wc, hc, mv.mv[X], pred_[X]);
      Plane& pl = pic_[c];
      const bool bi = mv.pred == PF_BI;
      const int X = mv.pred == PF_L1 ? 1 : 0;
      if (!s.weighted) {
        for (int y = 0; y < hc; ++y)
          for (int x = 0; x < wc; ++x) {
            const int k = y * wc + x;
            pl.at(xc + x, yc + y) = bi ? clip1((pred_[0][k] + pred_[1][k] + 64) >> 7)
                                       : clip1((pred_[X][k] + 32) >> 6);
          }
        continue;
      }
      const int denom = (c ? s.chroma_denom : s.luma_denom) + 6;   // log2WD
      auto weight = [&](int l) { return c ? s.cw[l][mv.ref_idx[l]][c - 1] : s.lw[l][mv.ref_idx[l]]; };
      auto offset = [&](int l) { return c ? s.co[l][mv.ref_idx[l]][c - 1] : s.lo[l][mv.ref_idx[l]]; };
      if (bi) {
        const int w0 = weight(0), w1 = weight(1), o = (offset(0) + offset(1) + 1) * (1 << denom);
        for (int y = 0; y < hc; ++y)
          for (int x = 0; x < wc; ++x) {
            const int k = y * wc + x;
            pl.at(xc + x, yc + y) = clip1((pred_[0][k] * w0 + pred_[1][k] * w1 + o) >> (denom + 1));
          }
      } else {
        const int w0 = weight(X), o = offset(X), round = 1 << (denom - 1);
        for (int y = 0; y < hc; ++y)
          for (int x = 0; x < wc; ++x)
            pl.at(xc + x, yc + y) = clip1(((pred_[X][y * wc + x] * w0 + round) >> denom) + o);
      }
    }
  }

  // --------------------------------------------------------- deblocking --
  // ffmpeg's ff_hevc_deblocking_boundary_strengths for the block (a
  // transform block, or a CU without residual) at (x0, y0): its top and left
  // edges on the 8x8 grid (2 by an intra side, 1 by a coded luma block on
  // either side, else by the motion), and inside an inter block the edges
  // of the 8x8 grid by the motion
  static int motion_bs(const MvField& cur, const RefList* cl, const MvField& nb, const RefList* nl) {
    auto far = [](Mv a, Mv b) { return std::abs(a.x - b.x) >= 4 || std::abs(a.y - b.y) >= 4; };
    if (!cl || !nl) return 1;
    if (cur.pred == PF_BI && nb.pred == PF_BI) {
      const int c0 = cl[0].poc[cur.ref_idx[0]], c1 = cl[1].poc[cur.ref_idx[1]];
      const int n0 = nl[0].poc[nb.ref_idx[0]], n1 = nl[1].poc[nb.ref_idx[1]];
      if (c0 == n0 && c0 == c1 && n0 == n1)
        return (far(nb.mv[0], cur.mv[0]) || far(nb.mv[1], cur.mv[1])) &&
               (far(nb.mv[1], cur.mv[0]) || far(nb.mv[0], cur.mv[1]));
      if (n0 == c0 && n1 == c1) return far(nb.mv[0], cur.mv[0]) || far(nb.mv[1], cur.mv[1]);
      if (n1 == c0 && n0 == c1) return far(nb.mv[1], cur.mv[0]) || far(nb.mv[0], cur.mv[1]);
      return 1;
    }
    if (cur.pred != PF_BI && nb.pred != PF_BI) {
      const int lc = cur.pred & PF_L0 ? 0 : 1, ln = nb.pred & PF_L0 ? 0 : 1;
      if (cl[lc].poc[cur.ref_idx[lc]] != nl[ln].poc[nb.ref_idx[ln]]) return 1;
      return far(cur.mv[lc], nb.mv[ln]);
    }
    return 1;
  }

  void boundary_strengths(int x0, int y0, int n) {
    if (!ctb_[size_t(cur_ctb_rs_)].deblock) return;
    const Pps& p = *pps;
    const int ctb_mask = (1 << sps->log2_ctb) - 1;
    bool left = x0 > 0 && !(x0 & 7), top = y0 > 0 && !(y0 & 7);
    if (left && !(x0 & ctb_mask)) {
      const int nb = ctb_rs_of(x0 - 1, y0);
      if (!sh_cur_lf_across() && ctb_[size_t(nb)].slice_addr != cur_slice_addr_) left = false;
      if (!p.lf_across_tiles && tile_of_rs(nb) != tile_of_rs(cur_ctb_rs_)) left = false;
    }
    if (top && !(y0 & ctb_mask)) {
      const int nb = ctb_rs_of(x0, y0 - 1);
      if (!sh_cur_lf_across() && ctb_[size_t(nb)].slice_addr != cur_slice_addr_) top = false;
      if (!p.lf_across_tiles && tile_of_rs(nb) != tile_of_rs(cur_ctb_rs_)) top = false;
    }
    const Frame& f = *cur_;
    auto edge = [&](int xq, int yq, int xp, int yp) -> uint8_t {
      const MvField& q = f.at(xq, yq);
      const MvField& pp = f.at(xp, yp);
      if (q.pred == PF_INTRA || pp.pred == PF_INTRA) return 2;
      if (cbf_[u4(xq, yq)] || cbf_[u4(xp, yp)]) return 1;
      return uint8_t(motion_bs(q, f.lists_at(xq, yq), pp, f.lists_at(xp, yp)));
    };
    for (int k = 0; k < n; k += 4) {
      if (top && x0 + k < sps->width) bs_h_[u4(x0 + k, y0)] = edge(x0 + k, y0, x0 + k, y0 - 1);
      if (left && y0 + k < sps->height) bs_v_[u4(x0, y0 + k)] = edge(x0, y0 + k, x0 - 1, y0 + k);
    }
    if (f.at(x0, y0).pred == PF_INTRA || n <= (1 << f.lpu)) return;
    const RefList* l = f.lists_at(x0, y0);
    for (int j = 8; j < n; j += 8)
      for (int i = 0; i < n; i += 4)
        bs_h_[u4(x0 + i, y0 + j)] =
            uint8_t(motion_bs(f.at(x0 + i, y0 + j), l, f.at(x0 + i, y0 + j - 1), l));
    for (int j = 0; j < n; j += 4)
      for (int i = 8; i < n; i += 8)
        bs_v_[u4(x0 + i, y0 + j)] =
            uint8_t(motion_bs(f.at(x0 + i, y0 + j), l, f.at(x0 + i - 1, y0 + j), l));
  }
  int chroma_mode_ = 0;

  void fill4_u8(std::vector<uint8_t>& m, int x0, int y0, int size, int v) {
    for (int y = y0; y < y0 + size && y < sps->height; y += 4)
      for (int x = x0; x < x0 + size && x < sps->width; x += 4) m[u4(x, y)] = uint8_t(v);
  }

  // 8.4.2: the three most probable modes of the PB at (xp, yp)
  void mpm(int xp, int yp, int cand[3]) {
    int a = 1, b = 1;
    if (avail(xp, yp, xp - 1, yp)) a = ipm_[u4(xp - 1, yp)];
    if (avail(xp, yp, xp, yp - 1) && yp - 1 >= ((yp >> sps->log2_ctb) << sps->log2_ctb))
      b = ipm_[u4(xp, yp - 1)];
    if (a == b) {
      if (a < 2) {
        cand[0] = 0;
        cand[1] = 1;
        cand[2] = 26;
      } else {
        cand[0] = a;
        cand[1] = 2 + ((a + 29) % 32);
        cand[2] = 2 + ((a - 2 + 1) % 32);
      }
    } else {
      cand[0] = a;
      cand[1] = b;
      cand[2] = (a != 0 && b != 0) ? 0 : (a != 1 && b != 1) ? 1 : 26;
    }
  }

  void pcm_sample(int x0, int y0, int log2) {
    const Sps& q = *sps;
    // the PCM samples start at the byte after pcm_flag's stop bit
    if (!cabac_.zero_alignment()) fail("a pcm_alignment_zero_bit is not 0");
    size_t pos = 8 * cabac_.next_byte();
    const std::vector<uint8_t>& d = *data_;
    auto read = [&](int bits) {
      if (pos + size_t(bits) > 8 * d.size()) fail("the slice data end inside PCM samples");
      int v = 0;
      for (int i = 0; i < bits; ++i, ++pos) v = (v << 1) | ((d[pos >> 3] >> (7 - (pos & 7))) & 1);
      return v;
    };
    const int size = 1 << log2;
    for (int y = 0; y < size; ++y)
      for (int x = 0; x < size; ++x)
        pic_[0].at(x0 + x, y0 + y) = uint8_t(read(q.pcm_bits_luma) << (8 - q.pcm_bits_luma));
    for (int c = 1; c < 3; ++c)
      for (int y = 0; y < size / 2; ++y)
        for (int x = 0; x < size / 2; ++x)
          pic_[c].at(x0 / 2 + x, y0 / 2 + y) =
              uint8_t(read(q.pcm_bits_chroma) << (8 - q.pcm_bits_chroma));
    cabac_.start(d.data(), d.size(), (pos + 7) >> 3);
  }

  bool sh_cur_lf_across() const { return ctb_[size_t(cur_ctb_rs_)].lf_across_slices; }

  // ------------------------------------------------------ transform tree --
  void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk, int max_depth,
                      bool nxn, int xcu, int ycu, int log2cu, bool parent_cb, bool parent_cr) {
    const Sps& q = *sps;
    int split;
    if (log2 <= q.log2_max_tb && log2 > q.log2_min_tb && depth < max_depth && !(nxn && depth == 0))
      split = cabac_.decision(ctx_[C_SPLIT_TU + 5 - log2]);
    else   // interSplitFlag: an inter CU of several blocks without a transform depth of its own
      split = log2 > q.log2_max_tb || (nxn && depth == 0) ||
              (q.max_th_depth_inter == 0 && !cu_intra_ && cu_part_ != P_2Nx2N && depth == 0);
    bool cb = false, cr = false;
    if (log2 > 2) {
      if (depth == 0 || parent_cb) cb = cabac_.decision(ctx_[C_CBF_CHROMA + depth]);
      if (depth == 0 || parent_cr) cr = cabac_.decision(ctx_[C_CBF_CHROMA + depth]);
    } else {
      cb = parent_cb;   // 4x4 luma: the chroma block is the parent's
      cr = parent_cr;
    }
    if (split) {
      const int h = 1 << (log2 - 1);
      transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, max_depth, nxn, xcu, ycu, log2cu, cb, cr);
      transform_tree(x0 + h, y0, x0, y0, log2 - 1, depth + 1, 1, max_depth, nxn, xcu, ycu, log2cu, cb, cr);
      transform_tree(x0, y0 + h, x0, y0, log2 - 1, depth + 1, 2, max_depth, nxn, xcu, ycu, log2cu, cb, cr);
      transform_tree(x0 + h, y0 + h, x0, y0, log2 - 1, depth + 1, 3, max_depth, nxn, xcu, ycu, log2cu, cb, cr);
      return;
    }
    int cbf_luma = 1;   // inferred in an inter CU's undivided tree without chroma
    if (cu_intra_ || depth != 0 || cb || cr) cbf_luma = cabac_.decision(ctx_[C_CBF_LUMA + (depth == 0 ? 1 : 0)]);
    transform_unit(x0, y0, xb, yb, log2, blk, cbf_luma, cb, cr);
  }

  void transform_unit(int x0, int y0, int xb, int yb, int log2, int blk, int cbf_luma, bool cb,
                      bool cr) {
    const Pps& p = *pps;
    tools |= bit(T_TU4 + log2 - 2);
    const bool chroma_here = log2 > 2;
    const bool chroma_blk3 = log2 == 2 && blk == 3;
    const bool cbf_chroma = cb || cr;
    if ((cbf_luma || cbf_chroma) && p.cu_qp_delta && !cu_qp_delta_coded_) {
      int v = 0;
      if (cabac_.decision(ctx_[C_QP_DELTA])) {
        v = 1;
        while (v < 5 && cabac_.decision(ctx_[C_QP_DELTA + 1])) ++v;
        if (v == 5) {
          int k = 0;
          while (cabac_.bypass()) {
            v += 1 << k;
            if (++k > 30) fail("a malformed cu_qp_delta_abs");
          }
          v += int(cabac_.bypass_bits(k));
        }
      }
      if (v && cabac_.bypass()) v = -v;
      if (v < -26 || v > 25) fail("CuQpDeltaVal " + std::to_string(v) + " is outside -26..25");
      cu_qp_delta_coded_ = true;
      if (v) tools |= bit(T_CU_QP_DELTA);
      qp_y_ = ((qg_pred_ + v + 52) % 52);
    }
    // luma: predict (intra; an inter CU's prediction is in place), then add the residual
    const int mode = cu_intra_ ? ipm_[u4(x0, y0)] : -1;
    const int n = 1 << log2;
    if (cu_intra_) intra_predict(0, x0, y0, n, mode);
    if (cbf_luma) {
      residual(log2, 0, mode);
      add_residual(0, x0, y0, n);
      fill4_u8(cbf_, x0, y0, n, 1);
    }
    boundary_strengths(x0, y0, n);
    if (chroma_here || chroma_blk3) {
      const int xc = (chroma_here ? x0 : xb) / 2, yc = (chroma_here ? y0 : yb) / 2;
      const int nc = chroma_here ? n / 2 : 4;
      for (int c = 1; c < 3; ++c) {
        if (cu_intra_) intra_predict(c, xc, yc, nc, chroma_mode_);
        if (c == 1 ? cb : cr) {
          residual(chroma_here ? log2 - 1 : 2, c, cu_intra_ ? chroma_mode_ : -1);
          add_residual(c, xc, yc, nc);
        }
      }
    }
  }

  // ------------------------------------------------------------ residuals --
  int chroma_qp(int c) const {
    const int off = c == 1 ? pps->cb_qp_offset + sh_.cb_offset : pps->cr_qp_offset + sh_.cr_offset;
    const int qpi = clip3(0, 57, qp_y_ + off);
    return qpi < 30 ? qpi : qpi > 43 ? qpi - 6 : kQpC[qpi - 30];
  }

  void residual(int log2, int c, int pred_mode) {
    const Pps& p = *pps;
    const Sps& q = *sps;
    const int n = 1 << log2;
    std::memset(coeffs_, 0, sizeof(int16_t) * size_t(n * n));
    bool ts = false;
    if (p.transform_skip && !bypass_ && log2 == 2) {
      ts = cabac_.decision(ctx_[C_TS + (c ? 1 : 0)]);
      if (ts) tools |= bit(T_TRANSFORM_SKIP);
    }
    // last significant position
    int ctx_off, ctx_shift;
    if (c == 0) {
      ctx_off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
      ctx_shift = (log2 + 1) >> 2;
    } else {
      ctx_off = 15;
      ctx_shift = log2 - 2;
    }
    const int max_prefix = (log2 << 1) - 1;
    int px = 0, py = 0;
    while (px < max_prefix && cabac_.decision(ctx_[C_LAST_X + ctx_off + (px >> ctx_shift)])) ++px;
    while (py < max_prefix && cabac_.decision(ctx_[C_LAST_Y + ctx_off + (py >> ctx_shift)])) ++py;
    int lx = px, ly = py;
    if (px > 3) {
      const int k = (px >> 1) - 1;
      lx = (1 << k) * (2 + (px & 1)) + int(cabac_.bypass_bits(k));
    }
    if (py > 3) {
      const int k = (py >> 1) - 1;
      ly = (1 << k) * (2 + (py & 1)) + int(cabac_.bypass_bits(k));
    }
    int scan = 0;
    if (pred_mode >= 0 && (log2 == 2 || (log2 == 3 && c == 0))) {
      if (pred_mode >= 6 && pred_mode <= 14) scan = 2;
      else if (pred_mode >= 22 && pred_mode <= 30) scan = 1;
    }
    if (scan == 2) std::swap(lx, ly);
    const int lsb = log2 - 2;          // sub-blocks per side: 1 << lsb
    const auto& sub = kScans.xy[lsb][scan];
    const auto& pos = kScans.xy[2][scan];
    int last_sub = (1 << (2 * lsb)) - 1, last_pos = 16;
    do {
      if (last_pos == 0) {
        last_pos = 16;
        --last_sub;
        if (last_sub < 0) fail("the last significant coefficient lies outside its block");
      }
      --last_pos;
    } while ((sub[last_sub][0] << 2) + pos[last_pos][0] != lx ||
             (sub[last_sub][1] << 2) + pos[last_pos][1] != ly);
    uint8_t csbf[8][8] = {{0}};
    int greater1_ctx = 1;
    const bool sdh_allowed = p.sign_hiding && !bypass_;
    bool first_sub = true;
    for (int i = last_sub; i >= 0; --i) {
      const int xs = sub[i][0], ys = sub[i][1];
      bool infer_dc = false;
      if (i < last_sub && i > 0) {
        int csbf_ctx = 0;
        if (xs < (1 << lsb) - 1) csbf_ctx += csbf[xs + 1][ys];
        if (ys < (1 << lsb) - 1) csbf_ctx += csbf[xs][ys + 1];
        csbf[xs][ys] = uint8_t(cabac_.decision(ctx_[C_CSBF + std::min(csbf_ctx, 1) + (c ? 2 : 0)]));
        infer_dc = true;
      } else {
        csbf[xs][ys] = 1;
      }
      int prev_csbf = 0;
      if (xs < (1 << lsb) - 1) prev_csbf += csbf[xs + 1][ys];
      if (ys < (1 << lsb) - 1) prev_csbf += csbf[xs][ys + 1] << 1;
      int nsig = 0;
      int sig_pos[16];
      const int start = (i == last_sub) ? last_pos - 1 : 15;
      if (i == last_sub) {
        sig_pos[nsig++] = last_pos;
      }
      for (int k = start; k >= 0; --k) {
        const int xc = (xs << 2) + pos[k][0], yc = (ys << 2) + pos[k][1];
        if (csbf[xs][ys] && (k > 0 || !infer_dc)) {
          int sctx;
          if (log2 == 2) {
            sctx = kCtxIdxMap[(yc << 2) + xc];
          } else if (xc + yc == 0) {
            sctx = 0;
          } else {
            const int xp = xc & 3, yp = yc & 3;
            if (prev_csbf == 0) sctx = (xp + yp == 0) ? 2 : (xp + yp < 3) ? 1 : 0;
            else if (prev_csbf == 1) sctx = (yp == 0) ? 2 : (yp == 1) ? 1 : 0;
            else if (prev_csbf == 2) sctx = (xp == 0) ? 2 : (xp == 1) ? 1 : 0;
            else sctx = 2;
            if (c == 0 && (xs + ys > 0)) sctx += 3;
            if (log2 == 3) sctx += (scan == 0) ? 9 : 15;
            else sctx += c == 0 ? 21 : 12;
          }
          const int inc = c == 0 ? sctx : 27 + sctx;
          if (cabac_.decision(ctx_[C_SIG + inc])) {
            sig_pos[nsig++] = k;
            infer_dc = false;
          }
        } else if (k == 0 && infer_dc && csbf[xs][ys]) {
          sig_pos[nsig++] = 0;
        }
      }
      if (!nsig) continue;
      // levels (sig_pos is in decreasing scan position)
      int ctx_set = (i == 0 || c > 0) ? 0 : 2;
      if (!first_sub && greater1_ctx == 0) ++ctx_set;
      first_sub = false;
      greater1_ctx = 1;
      int g1[16] = {0}, first_g1 = -1;
      const int ng1 = std::min(nsig, 8);
      for (int m = 0; m < ng1; ++m) {
        const int inc = (ctx_set << 2) + greater1_ctx + (c ? 16 : 0);
        g1[m] = cabac_.decision(ctx_[C_GT1 + inc]);
        if (g1[m]) {
          greater1_ctx = 0;
          if (first_g1 < 0) first_g1 = m;
        } else if (greater1_ctx > 0 && greater1_ctx < 3) {
          ++greater1_ctx;
        }
      }
      int g2 = 0;
      if (first_g1 >= 0) g2 = cabac_.decision(ctx_[C_GT2 + ctx_set + (c ? 4 : 0)]);
      const bool hidden = sdh_allowed && (sig_pos[0] - sig_pos[nsig - 1] > 3);
      int signs[16];
      for (int m = 0; m < nsig; ++m)
        signs[m] = (m == nsig - 1 && hidden) ? 0 : cabac_.bypass();
      int rice = 0, sum = 0;
      for (int m = 0; m < nsig; ++m) {
        const int base = 1 + (m < 8 ? g1[m] : 0) + (m == first_g1 ? g2 : 0);
        int level = base;
        if (base == ((m < 8) ? ((m == first_g1) ? 3 : 2) : 1)) {
          int prefix = 0;
          while (prefix < 32 && cabac_.bypass()) ++prefix;
          int rem;
          if (prefix < 3) {
            rem = (prefix << rice) + int(cabac_.bypass_bits(rice));
          } else {
            const int k = prefix - 3;
            if (prefix == 32 || k + rice > 22) fail("a malformed coeff_abs_level_remaining");
            rem = (((1 << k) + 3 - 1) << rice) + int(cabac_.bypass_bits(k + rice));
          }
          level = base + rem;
          if (level > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
        }
        if (level > 32768) fail("a coefficient level beyond 16 bits");
        int v = signs[m] ? -level : level;
        if (hidden) {
          sum += level;
          if (m == nsig - 1 && (sum & 1)) v = -v;
        }
        const int k = sig_pos[m];
        const int xc = (xs << 2) + pos[k][0], yc = (ys << 2) + pos[k][1];
        coeffs_[yc * n + xc] = int16_t(clip3(-32768, 32767, v));
      }
      if (hidden) tools |= bit(T_SIGN_HIDING);
    }
    // reconstruct the residual into res_
    if (bypass_) {
      for (int k = 0; k < n * n; ++k) res_[k] = coeffs_[k];
      return;
    }
    const int qp = c == 0 ? qp_y_ : chroma_qp(c);
    const int shift = 8 + log2 - 5;
    const int64_t scale = int64_t(kLevelScale[qp % 6]) << (qp / 6);
    const bool lists = q.scaling_list_enabled && !(ts && log2 > 2);
    const ScalingList& sl = p.scaling_present ? p.scaling : q.scaling;
    const int matrix = pred_mode >= 0 ? c : 3 + c;   // matrixId: cIdx, 3 + cIdx inter
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x) {
        const int lv = coeffs_[y * n + x];
        if (!lv) continue;
        int m = 16;
        if (lists) {
          if (log2 == 2) {
            m = list_value(sl, 0, matrix, x, y, 4);
          } else if (log2 >= 4 && x == 0 && y == 0) {
            m = sl.dc[log2 - 4][matrix];
          } else {
            const int r = n / 8;
            m = list_value(sl, log2 - 2, matrix, x / r, y / r, 8);
          }
        }
        int64_t v = (int64_t(lv) * scale * m + (int64_t(1) << (shift - 1))) >> shift;
        coeffs_[y * n + x] = int16_t(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
      }
    if (ts) {
      for (int k = 0; k < n * n; ++k) res_[k] = (coeffs_[k] + 16) >> 5;   // (d << 7) >> 12, rounded
      return;
    }
    inverse_transform(n, c == 0 && n == 4 && pred_mode >= 0);
  }

  // ScalingFactor: the list entry at (x, y) of a size x size list in diagonal order
  static int list_value(const ScalingList& sl, int size_id, int matrix, int x, int y, int size) {
    const int l = size == 4 ? 2 : 3;
    const auto& d = kScans.xy[l][0];
    for (int i = 0; i < size * size; ++i)
      if (d[i][0] == x && d[i][1] == y) return sl.sl[size_id][matrix][i];
    return 16;
  }

  // the two 1-D passes (columns, then rows) over the columns and rows that
  // hold a coefficient; every sum fits 32 bits (|d| <= 32768, 32 taps <= 90)
  void inverse_transform(int n, bool dst) {
    int tmp[32 * 32];
    const int step = 32 / n;
    int cols[32], ncols = 0, last_row = -1;
    for (int x = 0; x < n; ++x) {
      int top = -1;
      for (int k = 0; k < n; ++k)
        if (coeffs_[k * n + x]) top = k;
      if (top >= 0) {
        cols[ncols++] = x;
        last_row = std::max(last_row, top);
      }
    }
    std::memset(tmp, 0, sizeof(int) * size_t(n * n));
    for (int i = 0; i < ncols; ++i) {
      const int x = cols[i];
      for (int y = 0; y < n; ++y) {
        int s = 0;
        for (int k = 0; k <= last_row; ++k)
          s += (dst ? kDst[k][y] : kDct.m[k * step][y]) * coeffs_[k * n + x];
        tmp[y * n + x] = clip3(-32768, 32767, (s + 64) >> 7);
      }
    }
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x) {
        int s = 0;
        for (int i = 0; i < ncols; ++i) {
          const int k = cols[i];
          s += (dst ? kDst[k][x] : kDct.m[k * step][x]) * tmp[y * n + k];
        }
        res_[y * n + x] = (s + 2048) >> 12;
      }
  }

  void add_residual(int c, int x0, int y0, int n) {
    Plane& pl = pic_[c];
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x) {
        if (x0 + x >= pl.w || y0 + y >= pl.h) continue;
        uint8_t& s = pl.at(x0 + x, y0 + y);
        s = clip1(s + res_[y * n + x]);
      }
  }

  // ----------------------------------------------------- intra prediction --
  void intra_predict(int c, int x0, int y0, int n, int mode) {
    Plane& pl = pic_[c];
    const int sh = c ? 1 : 0;
    const int xl = x0 << sh, yl = y0 << sh;   // luma location of the block
    // reference samples: left[0..2n] is p[-1][-1 + i] (i = 0: the corner), top[0..2n] is p[-1 + i][-1]
    int left[129], top[129];
    bool al[129], at[129];
    int any = 0;
    // constrained_intra_pred: samples of inter-coded blocks are unavailable too
    const bool cip = pps->constrained_intra;
    auto usable = [&](int xn, int yn) {
      if (!avail(xl, yl, xn, yn)) return false;
      if (cip && cur_->at(xn, yn).pred != PF_INTRA) {
        tools |= bit(T_CIP_INTER);
        return false;
      }
      return true;
    };
    for (int i = 0; i <= 2 * n; ++i) {
      const int y = y0 - 1 + i;
      al[i] = usable((x0 - 1) * (1 << sh), y * (1 << sh));
      if (al[i]) {
        left[i] = pl.at(x0 - 1, y);
        ++any;
      }
      const int x = x0 - 1 + i;
      at[i] = i == 0 ? al[0] : usable(x * (1 << sh), (y0 - 1) * (1 << sh));
      if (at[i]) {
        top[i] = pl.at(x, y0 - 1);
        ++any;
      }
    }
    if (al[0]) top[0] = left[0];
    // ffmpeg's constrained_intra_pred path counts 8x8 prediction units (minimum
    // CB 16) over the left column in steps that a 4x4 luma block never takes:
    // on a PU edge, its left and bottom-left samples read as unavailable
    if (pps->constrained_intra && c == 0 && n == 4 && sps->log2_min_cb == 4 && !(x0 & 7))
      for (int i = 1; i <= 2 * n; ++i)
        if (al[i]) {
          al[i] = false;
          --any;
        }
    // substitution (8.4.4.2.2): the order p[-1][2n-1] .. p[-1][-1], p[0][-1] .. p[2n-1][-1]
    if (!any) {
      for (int i = 0; i <= 2 * n; ++i) left[i] = top[i] = 128;
    } else {
      // walk: left from bottom (i = 2n) up to the corner (i = 0), then top from i = 1 to 2n
      if (!al[2 * n]) {
        int v = -1;
        for (int i = 2 * n; i >= 0 && v < 0; --i)
          if (al[i]) v = left[i];
        for (int i = 1; i <= 2 * n && v < 0; ++i)
          if (at[i]) v = top[i];
        left[2 * n] = v;
      }
      for (int i = 2 * n - 1; i >= 0; --i)
        if (!al[i]) left[i] = left[i + 1];
      top[0] = left[0];
      for (int i = 1; i <= 2 * n; ++i)
        if (!at[i]) top[i] = top[i - 1];
    }
    // filtering (8.4.4.2.3), luma only
    if (c == 0 && mode != 1 && n != 4) {
      const int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
      const int thres = n == 8 ? 7 : n == 16 ? 1 : 0;
      if (dist > thres) {
        int fl[129], ft[129];
        const bool strong = sps->strong_intra_smoothing && n == 32 &&
                            std::abs(left[0] + top[2 * n] - 2 * top[n]) < 8 &&
                            std::abs(left[0] + left[2 * n] - 2 * left[n]) < 8;
        if (strong) {
          fl[0] = ft[0] = left[0];
          for (int i = 1; i < 2 * n; ++i) {
            fl[i] = ((64 - i) * left[0] + i * left[64] + 32) >> 6;
            ft[i] = ((64 - i) * top[0] + i * top[64] + 32) >> 6;
          }
          fl[2 * n] = left[2 * n];
          ft[2 * n] = top[2 * n];
        } else {
          fl[0] = ft[0] = (left[1] + 2 * left[0] + top[1] + 2) >> 2;
          for (int i = 1; i < 2 * n; ++i) {
            fl[i] = (left[i + 1] + 2 * left[i] + left[i - 1] + 2) >> 2;
            ft[i] = (top[i + 1] + 2 * top[i] + top[i - 1] + 2) >> 2;
          }
          fl[2 * n] = left[2 * n];
          ft[2 * n] = top[2 * n];
        }
        std::memcpy(left, fl, sizeof(int) * size_t(2 * n + 1));
        std::memcpy(top, ft, sizeof(int) * size_t(2 * n + 1));
      }
    }
    // p[-1][y] = left[y + 1], p[x][-1] = top[x + 1], p[-1][-1] = left[0]
    auto P = [&](int x, int y) { return x < 0 ? left[y + 1] : top[x + 1]; };
    const int log2n = n == 4 ? 2 : n == 8 ? 3 : n == 16 ? 4 : 5;
    auto put = [&](int x, int y, int v) {
      if (x0 + x < pl.w && y0 + y < pl.h) pl.at(x0 + x, y0 + y) = uint8_t(v);
    };
    if (mode == 0) {
      for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x)
          put(x, y, ((n - 1 - x) * P(-1, y) + (x + 1) * P(n, -1) + (n - 1 - y) * P(x, -1) +
                     (y + 1) * P(-1, n) + n) >> (log2n + 1));
      return;
    }
    if (mode == 1) {
      int sum = n;
      for (int i = 0; i < n; ++i) sum += P(i, -1) + P(-1, i);
      const int dc = sum >> (log2n + 1);
      for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x) put(x, y, dc);
      if (c == 0 && n < 32) {
        put(0, 0, (P(-1, 0) + 2 * dc + P(0, -1) + 2) >> 2);
        for (int x = 1; x < n; ++x) put(x, 0, (P(x, -1) + 3 * dc + 2) >> 2);
        for (int y = 1; y < n; ++y) put(0, y, (P(-1, y) + 3 * dc + 2) >> 2);
      }
      return;
    }
    const int angle = kAngle[mode];
    int refbuf[3 * 64 + 1];
    int* ref = refbuf + 64;     // ref[-n .. 2n]
    const bool vertical = mode >= 18;
    for (int x = 0; x <= n; ++x) ref[x] = vertical ? P(-1 + x, -1) : P(-1, -1 + x);
    if (angle < 0) {
      if (((n * angle) >> 5) < -1)
        for (int x = (n * angle) >> 5; x <= -1; ++x) {
          const int k = -1 + ((x * kInvAngle[mode] + 128) >> 8);
          ref[x] = vertical ? P(-1, k) : P(k, -1);
        }
    } else {
      for (int x = n + 1; x <= 2 * n; ++x) ref[x] = vertical ? P(-1 + x, -1) : P(-1, -1 + x);
    }
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x) {
        const int a = vertical ? y : x, b = vertical ? x : y;
        const int idx = ((a + 1) * angle) >> 5, fact = ((a + 1) * angle) & 31;
        const int v = fact ? ((32 - fact) * ref[b + idx + 1] + fact * ref[b + idx + 2] + 16) >> 5
                           : ref[b + idx + 1];
        put(x, y, v);
      }
    if (c == 0 && n < 32) {
      if (mode == 26)
        for (int y = 0; y < n; ++y) put(0, y, clip1(P(0, -1) + ((P(-1, y) - P(-1, -1)) >> 1)));
      if (mode == 10)
        for (int x = 0; x < n; ++x) put(x, 0, clip1(P(-1, 0) + ((P(x, -1) - P(-1, -1)) >> 1)));
    }
  }

  // ------------------------------------------------------ in-loop filters --
  void finish_picture() {
    pic_started_ = false;
    if (skip_picture_) return;
    const Sps& q = *sps;
    if (decoded_ctbs_ != q.ctb_w * q.ctb_h)
      fail("the picture's slices cover " + std::to_string(decoded_ctbs_) + " of its " +
           std::to_string(q.ctb_w * q.ctb_h) + " CTBs");
    bool any_edge = false;
    for (uint8_t v : bs_v_) any_edge |= v != 0;
    for (uint8_t v : bs_h_) any_edge |= v != 0;
    bool any_disabled = false;
    for (const auto& c : ctb_) any_disabled |= !c.deblock;
    if (any_disabled) tools |= bit(T_DEBLOCK_DISABLED);
    for (const auto& c : ctb_)
      if (!c.lf_across_slices) tools |= bit(T_NO_FILTER_ACROSS_SLICES);
    if (any_edge) tools |= bit(T_DEBLOCK);
    filter_schedule();
    if (output_) {
      out_w = q.width - q.conf_left - q.conf_right;
      out_h = q.height - q.conf_top - q.conf_bottom;
      for (int c = 0; c < 3; ++c) {
        const int sh = c ? 1 : 0;
        Plane& o = out[c];
        o.w = out_w >> sh;
        o.h = out_h >> sh;
        o.px.resize(size_t(o.w) * size_t(o.h));
        for (int y = 0; y < o.h; ++y)
          std::memcpy(&o.px[size_t(y) * size_t(o.w)],
                      &pic_[c].at(q.conf_left >> sh, (q.conf_top >> sh) + y), size_t(o.w));
      }
      shown = true;
    }
    // the picture joins the DPB as a short-term reference
    Frame& f = *cur_;
    for (int c = 0; c < 3; ++c) f.px[c] = std::move(pic_[c]);
    f.ref = 1;
    dpb_.push_back(cur_);
    if (dpb_.size() > 32) fail("more than 32 pictures in the DPB");
  }

  int qp_at(int x, int y) const { return qp_[u4(x, y)]; }
  bool nofilter_at(int x, int y) const { return nofilter_[u4(x, y)] != 0; }
  const CtbInfo& ctb_at(int x, int y) const { return ctb_[size_t(ctb_rs_of(x, y))]; }

  // ---- ffmpeg's in-loop filter schedule (libavcodec hevc filter.c), replayed
  // after the picture: after each CTB in decoding order, the CTB up-left of it
  // is deblocked and the one up-left of that gets SAO (with the shortcuts
  // at the last column and row). SAO reads a neighbour CTB's samples as they
  // stand then (partly deblocked, for chroma at CTB 16) unless that CTB has
  // been SAO-filtered, whose border lines were saved before its filtering.
  void filter_schedule() {
    const Sps& q = *sps;
    const int ctb = 1 << q.log2_ctb, n = q.ctb_w * q.ctb_h;
    for (int c = 0; c < 3; ++c) {
      sao_h_[c].assign(size_t(2 * q.ctb_h) * size_t(pic_[c].w), 0);
      sao_v_[c].assign(size_t(2 * q.ctb_w) * size_t(pic_[c].h), 0);
      applied_[c].assign(size_t(n), 0);
    }
    for (int ts = 0; ts < n; ++ts) {
      const int rs = ts2rs_[size_t(ts)];
      const int x = (rs % q.ctb_w) * ctb, y = (rs / q.ctb_w) * ctb;
      const bool x_end = x >= q.width - ctb, y_end = y >= q.height - ctb;
      if (y && x) hls_filter(x - ctb, y - ctb);
      if (y && x_end) hls_filter(x, y - ctb);
      if (x && y_end) hls_filter(x - ctb, y);
      if (x_end && y_end) hls_filter(x, y);
    }
  }

  void hls_filter(int x, int y) {
    const Sps& q = *sps;
    const int ctb = 1 << q.log2_ctb;
    const bool x_end = x >= q.width - ctb, y_end = y >= q.height - ctb;
    deblock_ctb(x, y);
    if (!q.sao) return;
    if (y && x) sao_ctb(x - ctb, y - ctb);
    if (x && y_end) sao_ctb(x - ctb, y);
    if (y && x_end) sao_ctb(x, y - ctb);
    if (x_end && y_end) sao_ctb(x, y);
  }

  int chroma_tc(int qp, int c, int tc_offset) const {
    const int off = c == 1 ? pps->cb_qp_offset : pps->cr_qp_offset;
    const int qi = clip3(0, 57, qp + off);
    const int qpc = qi < 30 ? qi : qi > 43 ? qi - 6 : kQpC[qi - 30];
    return kTc[clip3(0, 53, qpc + 2 + tc_offset)];
  }

  uint8_t bsv(int x, int y) const {
    return x < sps->width && y < sps->height ? bs_v_[u4(x, y)] : 0;
  }
  uint8_t bsh(int x, int y) const {
    return x < sps->width && y < sps->height ? bs_h_[u4(x, y)] : 0;
  }

  // deblocking_filter_CTB: its loops, ranges and offset variables as ffmpeg has them
  void deblock_ctb(int x0, int y0) {
    const Sps& q = *sps;
    const int ctb = 1 << q.log2_ctb;
    const int rs = ctb_rs_of(x0, y0);
    const int cur_tc = ctb_[size_t(rs)].tc_offset, cur_beta = ctb_[size_t(rs)].beta_offset;
    const int left_tc = x0 ? ctb_[size_t(rs - 1)].tc_offset : 0;
    const int left_beta = x0 ? ctb_[size_t(rs - 1)].beta_offset : 0;
    const int x_end = std::min(x0 + ctb, q.width), y_end = std::min(y0 + ctb, q.height);
    int tc_offset = cur_tc, beta_offset = cur_beta;
    Plane& Y = pic_[0];
    const int x_end2 = x_end != q.width ? x_end - 8 : x_end;
    for (int y = y0; y < y_end; y += 8) {
      for (int x = x0 ? x0 : 8; x < x_end; x += 8) {
        const int bs0 = bsv(x, y), bs1 = bsv(x, y + 4);
        if (!(bs0 || bs1)) continue;
        const int qp = (qp_at(x - 1, y) + qp_at(x, y) + 1) >> 1;
        const int beta = kBeta[clip3(0, 51, qp + beta_offset)];
        for (int k = 0; k < 2; ++k) {
          const int bs = k ? bs1 : bs0;
          if (!bs || y + 4 * k >= q.height) continue;
          const int tc = kTc[clip3(0, 53, qp + 2 * (bs - 1) + tc_offset)];
          luma_edge(Y, x, y + 4 * k, true, beta, tc, nofilter_at(x - 1, y + 4 * k),
                    nofilter_at(x, y + 4 * k));
        }
      }
      if (!y) continue;
      for (int x = x0 ? x0 - 8 : 0; x < x_end2; x += 8) {
        const int bs0 = bsh(x, y), bs1 = bsh(x + 4, y);
        if (!(bs0 || bs1)) continue;
        const int qp = (qp_at(x, y - 1) + qp_at(x, y) + 1) >> 1;
        tc_offset = x >= x0 ? cur_tc : left_tc;
        beta_offset = x >= x0 ? cur_beta : left_beta;
        const int beta = kBeta[clip3(0, 51, qp + beta_offset)];
        for (int k = 0; k < 2; ++k) {
          const int bs = k ? bs1 : bs0;
          if (!bs || x + 4 * k >= q.width) continue;
          const int tc = kTc[clip3(0, 53, qp + 2 * (bs - 1) + tc_offset)];
          luma_edge(Y, x + 4 * k, y, false, beta, tc, nofilter_at(x + 4 * k, y - 1),
                    nofilter_at(x + 4 * k, y));
        }
      }
    }
    for (int c = 1; c < 3; ++c) {
      Plane& C = pic_[c];
      for (int y = y0; y < y_end; y += 16) {
        for (int x = x0 ? x0 : 16; x < x_end; x += 16) {
          const int bs0 = bsv(x, y), bs1 = bsv(x, y + 8);
          if (bs0 != 2 && bs1 != 2) continue;
          for (int k = 0; k < 2; ++k) {
            const int yy = y + 8 * k;
            if ((k ? bs1 : bs0) != 2 || yy >= q.height) continue;
            const int qp = (qp_at(x - 1, yy) + qp_at(x, yy) + 1) >> 1;
            chroma_edge(C, x / 2, yy / 2, true, chroma_tc(qp, c, tc_offset),
                        nofilter_at(x - 1, yy), nofilter_at(x, yy));
          }
        }
        if (!y) continue;
        tc_offset = x0 ? left_tc : cur_tc;
        const int x_end2c = x_end != q.width ? x_end - 16 : x_end;
        for (int x = x0 ? x0 - 16 : 0; x < x_end2c; x += 16) {
          const int bs0 = bsh(x, y), bs1 = bsh(x + 8, y);
          if (bs0 != 2 && bs1 != 2) continue;
          for (int k = 0; k < 2; ++k) {
            const int xx = x + 8 * k;
            if ((k ? bs1 : bs0) != 2 || xx >= q.width) continue;
            const int qp = (qp_at(xx, y - 1) + qp_at(xx, y) + 1) >> 1;
            chroma_edge(C, xx / 2, y / 2, false, chroma_tc(qp, c, k ? cur_tc : tc_offset),
                        nofilter_at(xx, y - 1), nofilter_at(xx, y));
          }
        }
      }
    }
  }

  // a chroma edge segment of 4 samples from (cx, cy) along the edge
  static void chroma_edge(Plane& C, int cx, int cy, bool vertical, int tc, bool no_p, bool no_q) {
    const int dx = vertical ? 1 : 0, dy = vertical ? 0 : 1;
    for (int k = 0; k < 4; ++k) {
      const int x = vertical ? cx : cx + k, y = vertical ? cy + k : cy;
      if (x >= C.w || y >= C.h) continue;
      uint8_t& p0 = C.at(x - dx, y - dy);
      uint8_t& q0 = C.at(x, y);
      const int p1 = C.at(x - 2 * dx, y - 2 * dy), q1 = C.at(x + dx, y + dy);
      const int d = clip3(-tc, tc, ((((q0 - p0) * 4) + p1 - q1 + 4) >> 3));
      const int np = clip1(p0 + d), nq = clip1(q0 - d);
      if (!no_p) p0 = uint8_t(np);
      if (!no_q) q0 = uint8_t(nq);
    }
  }

  static void luma_edge(Plane& Y, int x, int y, bool vertical, int beta, int tc, bool no_p,
                        bool no_q) {
    const int dx = vertical ? 1 : 0, dy = vertical ? 0 : 1;   // across the edge
    const int sx = vertical ? 0 : 1, sy = vertical ? 1 : 0;   // along the edge
    auto S = [&](int k, int i) -> uint8_t& {   // line k, sample i (i < 0: p side)
      return Y.at(x + sx * k + dx * i, y + sy * k + dy * i);
    };
    auto dp = [&](int k) { return std::abs(S(k, -3) - 2 * S(k, -2) + S(k, -1)); };
    auto dq = [&](int k) { return std::abs(S(k, 2) - 2 * S(k, 1) + S(k, 0)); };
    const int dp0 = dp(0), dp3 = dp(3), dq0 = dq(0), dq3 = dq(3);
    const int dpq0 = dp0 + dq0, dpq3 = dp3 + dq3;
    const int d = dpq0 + dpq3;
    if (d >= beta) return;
    auto dsam = [&](int k, int dpq) {
      return 2 * dpq < (beta >> 2) && std::abs(S(k, -4) - S(k, -1)) + std::abs(S(k, 0) - S(k, 3)) < (beta >> 3) &&
             std::abs(S(k, -1) - S(k, 0)) < ((5 * tc + 1) >> 1);
    };
    const bool strong = dsam(0, dpq0) && dsam(3, dpq3);
    const int side = (beta + (beta >> 1)) >> 3;
    const bool dep = dp0 + dp3 < side, deq = dq0 + dq3 < side;
    for (int k = 0; k < 4; ++k) {
      const int p0 = S(k, -1), p1 = S(k, -2), p2 = S(k, -3), p3 = S(k, -4);
      const int q0 = S(k, 0), q1 = S(k, 1), q2 = S(k, 2), q3 = S(k, 3);
      if (strong) {
        if (!no_p) {
          S(k, -1) = uint8_t(clip3(p0 - 2 * tc, p0 + 2 * tc, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3));
          S(k, -2) = uint8_t(clip3(p1 - 2 * tc, p1 + 2 * tc, (p2 + p1 + p0 + q0 + 2) >> 2));
          S(k, -3) = uint8_t(clip3(p2 - 2 * tc, p2 + 2 * tc, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3));
        }
        if (!no_q) {
          S(k, 0) = uint8_t(clip3(q0 - 2 * tc, q0 + 2 * tc, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3));
          S(k, 1) = uint8_t(clip3(q1 - 2 * tc, q1 + 2 * tc, (p0 + q0 + q1 + q2 + 2) >> 2));
          S(k, 2) = uint8_t(clip3(q2 - 2 * tc, q2 + 2 * tc, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3));
        }
      } else {
        int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
        if (std::abs(delta) >= tc * 10) continue;
        delta = clip3(-tc, tc, delta);
        if (!no_p) S(k, -1) = clip1(p0 + delta);
        if (!no_q) S(k, 0) = clip1(q0 - delta);
        if (dep && !no_p) {
          const int dpv = clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1);
          S(k, -2) = clip1(p1 + dpv);
        }
        if (deq && !no_q) {
          const int dqv = clip3(-(tc >> 1), tc >> 1, (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1);
          S(k, 1) = clip1(q1 + dqv);
        }
      }
    }
  }

  // sao_filter_CTB for the CTB at luma (x0l, y0l): every component whose SAO
  // type is set, the neighbour samples as they stand (or from the saved
  // border lines of a CTB already filtered), the slice and tile rule of the
  // module comment, PCM and bypass samples restored as ffmpeg restores them
  void sao_ctb(int x0l, int y0l) {
    const Sps& q = *sps;
    const int W = q.ctb_w;
    const int rx = x0l >> q.log2_ctb, ry = y0l >> q.log2_ctb, rs = ry * W + rx;
    const CtbInfo& ci = ctb_[size_t(rs)];
    static const int hpos[4][2] = {{-1, 1}, {0, 0}, {-1, 1}, {1, -1}};
    static const int vpos[4][2] = {{0, 0}, {-1, 1}, {-1, 1}, {-1, 1}};
    const int tile = tile_of_rs(rs);
    for (int c = 0; c < 3; ++c) {
      const int type = ci.sao.type[c];
      if (!type) continue;
      const int sh = c ? 1 : 0;
      const int ctb = (1 << q.log2_ctb) >> sh;
      Plane& pl = pic_[c];
      const int x0 = rx * ctb, y0 = ry * ctb;
      const int w = std::min(ctb, pl.w - x0), h = std::min(ctb, pl.h - y0);
      // copy_CTB_to_hv: the CTB's deblocked border lines
      std::vector<uint8_t>& H = sao_h_[c];
      std::vector<uint8_t>& V = sao_v_[c];
      for (int x = 0; x < w; ++x) {
        H[size_t(2 * ry) * size_t(pl.w) + size_t(x0 + x)] = pl.at(x0 + x, y0);
        H[size_t(2 * ry + 1) * size_t(pl.w) + size_t(x0 + x)] = pl.at(x0 + x, y0 + h - 1);
      }
      for (int y = 0; y < h; ++y) {
        V[size_t(2 * rx) * size_t(pl.h) + size_t(y0 + y)] = pl.at(x0, y0 + y);
        V[size_t(2 * rx + 1) * size_t(pl.h) + size_t(y0 + y)] = pl.at(x0 + w - 1, y0 + y);
      }
      // the block and its one-sample border as the filter reads them
      const int bw = w + 2;
      int* src = sao_src_;
      for (int y = -1; y <= h; ++y)
        for (int x = -1; x <= w; ++x) {
          const int px = x0 + x, py = y0 + y;
          if (px < 0 || py < 0 || px >= pl.w || py >= pl.h) continue;
          int v = pl.at(px, py);
          if (x < 0 || y < 0 || x >= w || y >= h) {
            const int nx = rx + (x < 0 ? -1 : x >= w ? 1 : 0), ny = ry + (y < 0 ? -1 : y >= h ? 1 : 0);
            if (applied_[c][size_t(ny * W + nx)]) {
              if (y < 0 || y >= h)
                v = H[size_t(2 * ny + (y < 0 ? 1 : 0)) * size_t(pl.w) + size_t(px)];
              else
                v = V[size_t(2 * nx + (x < 0 ? 1 : 0)) * size_t(pl.h) + size_t(py)];
            }
          }
          src[size_t(y + 1) * size_t(bw) + size_t(x + 1)] = v;
        }
      auto S = [&](int x, int y) { return src[size_t(y + 1) * size_t(bw) + size_t(x + 1)]; };
      const int* off = ci.sao.offset[c];
      int band_table[32] = {0};
      if (type == 1)
        for (int k = 0; k < 4; ++k) band_table[(k + ci.sao.band[c]) & 31] = k + 1;
      const int cls = ci.sao.eo_class[c];
      // ffmpeg restores PCM and bypass samples of a chroma CTB only where their
      // luma position lies within the chroma CTB's extent from the CTB's luma corner
      const int pu = q.log2_min_cb - 1;
      const int xmax = (x0l + w) >> pu, ymax = (y0l + h) >> pu;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const int px = x0 + x, py = y0 + y;
          if (nofilter_at(px << sh, py << sh) && ((px << sh) >> pu) < xmax && ((py << sh) >> pu) < ymax)
            continue;
          const int v = S(x, y);
          if (type == 1) {
            pl.at(px, py) = clip1(v + off[band_table[v >> 3]]);
            continue;
          }
          bool skip = false;
          int sum = 0;
          for (int k = 0; k < 2 && !skip; ++k) {
            const int xn = x + hpos[cls][k], yn = y + vpos[cls][k];
            if (px + hpos[cls][k] < 0 || py + vpos[cls][k] < 0 || px + hpos[cls][k] >= pl.w ||
                py + vpos[cls][k] >= pl.h) {
              skip = true;
              break;
            }
            if (xn < 0 || yn < 0 || xn >= w || yn >= h) {
              const int nrs = (ry + (yn < 0 ? -1 : yn >= h ? 1 : 0)) * W + rx + (xn < 0 ? -1 : xn >= w ? 1 : 0);
              if (!ci.lf_across_slices && ctb_[size_t(nrs)].slice_addr != ci.slice_addr) skip = true;
              if (!pps->lf_across_tiles && tile_of_rs(nrs) != tile) skip = true;
            }
            const int u = S(xn, yn);
            sum += (v > u) - (v < u);
          }
          if (skip) continue;
          int idx = 2 + sum;
          idx = idx == 2 ? 0 : (idx < 2 ? idx + 1 : idx);
          pl.at(px, py) = clip1(v + off[idx]);
        }
      applied_[c][size_t(rs)] = 1;
    }
  }

 public:
  // the POC scan of one sample: parse until the first slice header
  std::vector<int> discarded;   // earlier samples (scan indices) this one's IRAP picture discards
  int scan_id_ = -1;
  void scan(const uint8_t* d, size_t n) {
    scan_irap = false;
    scan_output = false;
    nal_type = -1;
    temporal_id = 0;
    discarded.clear();
    ++scan_id_;
    decode(d, n, true);
  }
};

}  // namespace hevc
}  // namespace

extern "C" {

// A decoder of one HEVC track: ``params`` are the configuration's NAL units
// (Annex B; may be empty), samples carry NAL lengths of ``length_size``
// bytes. Returns null and fills err on failure.
void* c4d_hevc_open(const uint8_t* params, long n, int length_size, char* err, int err_cap) {
  auto* d = new hevc::Decoder();
  try {
    if (length_size < 1 || length_size > 4) hevc::fail("a NAL length size outside 1..4");
    d->set_length_size(length_size);
    d->parameters(params, size_t(n));
    return d;
  } catch (const std::exception& e) {
    std::snprintf(err, size_t(err_cap), "%s", e.what());
    delete d;
    return nullptr;
  }
}

// Decode one sample (an access unit). info[0..9] receive: whether it gave a
// picture, its cropped width and height, its POC, its NAL type, whether it
// is an IRAP picture, matrix_coeffs, video_full_range_flag, the VUI's
// chroma_sample_loc_type_top_field (-1 without one) and its TemporalId.
// Returns 0, or -1 with the reason in err.
int c4d_hevc_decode(void* dec, const uint8_t* sample, long n, int* info, char* err, int err_cap) {
  auto* d = static_cast<hevc::Decoder*>(dec);
  try {
    const bool shown = d->decode(sample, size_t(n));
    info[0] = shown;
    info[1] = shown ? d->out_w : 0;
    info[2] = shown ? d->out_h : 0;
    info[3] = d->poc;
    info[4] = d->nal_type;
    info[5] = d->nal_type >= 16 && d->nal_type <= 23;
    info[6] = d->active ? d->active->matrix : 2;
    info[7] = d->active ? d->active->full_range : 0;
    info[8] = d->active ? d->active->chroma_loc : -1;
    info[9] = d->temporal_id;
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, size_t(err_cap), "%s", e.what());
    d->reset();
    return -1;
  }
}

// Copy the last picture into caller-owned planes (width x height luma,
// width/2 x height/2 chroma). Returns 0, or -1 when there is none.
int c4d_hevc_output(void* dec, uint8_t* y, uint8_t* u, uint8_t* v) {
  auto* d = static_cast<hevc::Decoder*>(dec);
  if (!d->shown) return -1;
  uint8_t* out[3] = {y, u, v};
  for (int p = 0; p < 3; ++p) std::memcpy(out[p], d->out[p].px.data(), d->out[p].px.size());
  return 0;
}

// The sample's first slice header, without decoding: info[0..5] receive its
// NAL type, whether it is an IRAP picture, its POC, whether it shows
// (pic_output_flag, and not a RASL picture ffmpeg discards), its TemporalId
// and the number of earlier samples whose pictures it discards before their
// output (c4d_hevc_discarded names them). Feed every sample in decode
// order: the POC and DPB state carries over. Returns 0, or -1 with the
// reason in err.
int c4d_hevc_scan(void* dec, const uint8_t* sample, long n, int* info, char* err, int err_cap) {
  auto* d = static_cast<hevc::Decoder*>(dec);
  try {
    d->scan(sample, size_t(n));
    info[0] = d->nal_type;
    info[1] = d->scan_irap;
    info[2] = d->poc;
    info[3] = d->nal_type >= 0 && d->scan_output;
    info[4] = d->temporal_id;
    info[5] = int(d->discarded.size());
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, size_t(err_cap), "%s", e.what());
    return -1;
  }
}

// The scan indices (0 for the first sample scanned) of the pictures the last
// scanned sample discards; returns how many were written.
int c4d_hevc_discarded(void* dec, int* out, int cap) {
  auto* d = static_cast<hevc::Decoder*>(dec);
  int n = 0;
  for (int id : d->discarded)
    if (n < cap) out[n++] = id;
  return n;
}

// sps_max_dec_pic_buffering and sps_max_num_reorder_pics of the active SPS
// (-1 before one is active).
void c4d_hevc_buffering(void* dec, int* dpb, int* reorder) {
  auto* d = static_cast<hevc::Decoder*>(dec);
  *dpb = d->active ? d->active->max_dec_pic_buffering : -1;
  *reorder = d->active ? d->active->num_reorder : -1;
}

// The Tool bits of everything decoded since open: bits 0-63 in out[0], 64-127 in out[1].
void c4d_hevc_tools(void* dec, unsigned long long* out) {
  const hevc::Tools t = static_cast<hevc::Decoder*>(dec)->tools;
  out[0] = static_cast<unsigned long long>(t);
  out[1] = static_cast<unsigned long long>(t >> 64);
}

// Forget the POC and RASL state (before decoding from an IRAP sample).
void c4d_hevc_reset(void* dec) { static_cast<hevc::Decoder*>(dec)->reset(); }

void c4d_hevc_close(void* dec) { delete static_cast<hevc::Decoder*>(dec); }

}  // extern "C"
