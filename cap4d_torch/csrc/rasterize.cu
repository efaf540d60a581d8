// K3: forward z-buffer triangle rasterizer in pytorch3d screen NDC, one face
// per pixel, testing each pixel only against the faces whose screen box can
// hold it.
//
// Replaces cap4d_tpu/ops/rasterize.py:233 `_raster_kernel` (reached through
// `rasterize_meshes_pallas` from `rasterize_meshes`).
//
// Contract (that of `_rasterize_single`, rasterize.py:47-113): pixel (i, j)
// sits at the NDC centre 1 - (2k+1)/S per axis, computed here in float32 as
// the host's `pixel_centers_ndc` computes it; coverage is the sign-agnostic
// barycentric test b >= 0 on all three edges with b = edge / area, so there
// is no culling; the nearest z wins and, on equal z, the lowest face index.
// Empty pixels keep z = +inf, face -1, bary 0.
//
// What bounds it on an H100: the function needs only the pixel-face tests
// inside each face's screen box (about 1.7 a pixel for a 10k-face head at
// 128², a few for a UV chart at 256²), ~18 flops each, so its floor is the
// bytes it moves (vertices in, 20 bytes a pixel out). The first version of
// this kernel tested every pixel against every face, ~240x that floor. This
// one culls by screen tile, in two launches of one C call:
//   1. raster_setup_kernel, a thread a (frame, face): gathers the vertices,
//      computes area and 1/area as the plain version does and writes the
//      face's record (coordinates, 1/area and the three edge vectors, 64
//      bytes; staged in shared memory so that a block writes its records
//      coalesced), its conservative pixel box (four int16) and, a warp's
//      shuffle later, the union box of each 32 consecutive faces (a group);
//   2. raster_tile_kernel, a block a (frame, 16x16 tile), a warp an 8x4
//      sub-tile, kSplit threads a pixel. The block sweeps its frame's group
//      boxes, kThreads a round, keeps the groups that overlap its tile (in
//      order, ballot and popc), then reads the boxes of their faces, 32
//      groups a sub-round, and keeps those that overlap the tile, in face
//      order (ballot, popc and a warp scan of the per-warp counts), in
//      shared memory. When the stage holds more than kStage - kRound faces,
//      or the sweep ends, it is tested kBatch faces at a time: the batch's
//      records are staged; each warp scans the batch's 32-face chunks of its
//      part (its pixel's thread p takes chunks p, p + kSplit, ...), keeps
//      the faces whose box overlaps its sub-tile and, for boxes larger than
//      a sub-tile, that the sub-tile rule below does not rule out (a lane a
//      face: one edge's b at one corner centre), and tests its 32 pixels
//      against them in ascending order, two a loop iteration, with a strict
//      < on z, which reproduces the lowest-index tie rule; then the kSplit
//      candidates of a pixel are merged by (z, face). No capacity is fixed
//      per tile and nothing is truncated.
// Measured on the H100 (PERF.md §6), what bounds it is not the floor but
// instruction issue and latency: the 8x4 sub-tiles that a box of a few pixels touches
// cost ~30 lane-tests for its ~2 real ones (10k-face head), and a tile
// under thousands of large faces (the fan-triangulated template) is one
// block's serial work on one SM, which sets the kernel's time. Face order
// in the meshes is local, so a tile reads the boxes of 5-15x fewer faces
// through the group boxes. kSplit = 2 halves a heavy tile's serial chain;
// 1 and 4, and a thread-block cluster of 2-4 blocks a tile, were measured
// and lose on the meshes users rasterize (PERF.md).
//
// Exactness: every product and sum uses the round-to-nearest intrinsics
// (and the file is built with -fmad=false), in the plain version's order, so
// nothing is contracted into an FMA and the kernel rounds exactly as
// `rasterize_meshes_plain` does: pixels on shared edges pick the same face.
//
// The boxes are conservative. Let a face have float vertices v0, v1, v2,
// exact area a (of those floats), computed area A, NDC bounding box of
// widths wx, wy, c = max |x|, |y| of its vertices; u = 2^-24. Its box is
// trusted (class BOX) only where every x and y lies within 2^60, 2^-100 <=
// |A| <= 2^100 and
//     |A| >= max(W wx, H wy) (2^-19 (wx + wy)(1 + c) + 2^-120),      (T)
// for images of at most 16384 a side; else the face is EMPTY where A is 0
// or NaN (a NaN x or y makes it NaN; then 1/A and every b are NaN or the
// plain version's `area != 0` fails, and no pixel passes), and WHOLE (the
// box is the whole image) otherwise: a coordinate that is not finite or an
// area that overflows makes 1/A zero and every b +-0, which passes, and an
// |A| below (T) lets edge * (1/A) round to -0.0, which passes too.
// Argument for a BOX face: for a pixel centre p, each computed edge value E
// of the exact value e = (xa - xb)(py - yb) - (ya - yb)(px - xb) has
// |E - e| <= D = 4.0002 u S + 2^-148 with S = (wx + wy)(1 + c) (three
// roundings on each product, one on the difference, subnormal products),
// since |py| < 1. The exact barycentrics of p sum to 1, so if p lies a
// distance m beyond xmax, m < px - xmax = sum_i b_i (x_i - xmax) <=
// wx sum_{b_i < 0} |b_i|, and one b_i = e_i / a < -m / (2 wx). The box
// widened by one pixel holds every centre within m = 1.9 / W of the NDC box
// (its float conversion errs by < 2^-6 pixel for sides <= 16384), so that
// e_i sign(a) < -|a| 0.95 / (W wx) <= -2 D by (T) (whose factor 2^-19 = 32u
// covers 4 * 4.0002 u / 0.95 / (7/8), with |a| >= 7/8 |A| because |a - A|
// <= 8.0004 u wx wy <= |A| / 8 under (T)). Then E has the wrong sign and
// |E| > |a| 0.47 / (W wx), so b = E * (1/A) is negative and, as 1/A lies in
// [2^-100, 2^100], at least 0.41 / (W wx) >= 2^-77 in magnitude: it cannot
// round to -0.0 and the pixel fails. Likewise for x below xmin and for y.
//
// The sub-tile rule (cannot_pass), for any face whose x and y lie within
// 2^60 and 2^-99 <= |1/A| <= 2^99: the exact edge e_i times s = sign(1/A)
// is affine, so over the rectangle of a sub-tile's pixel centres it is
// largest at the corner c* that the signs of the edge vector pick (exact,
// as fl(xa - xb) keeps the sign of xa - xb). With E = computed edge and
// |E - e| <= D everywhere, if b = E(c*) * (1/A) < -beta, beta =
// (2^-20 S + 2^-140) |1/A| + 2^-99 (2^-20 = 16u covers 3 D's 12.0006 u S
// and the roundings), then E(c*) s < -(3D + |A| 2^-100), so e s < -(2D +
// |A| 2^-100) on the whole rectangle, and at every centre p, E(p) s <
// -(D + |A| 2^-100): b(p) is negative and at least 2^-100 (1 - u)^2 in
// magnitude, so no pixel of the sub-tile passes.

#include <cassert>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 16;              // tile side in pixels
constexpr int kSplit = 2;              // threads a pixel, each on every kSplit-th staged face
constexpr int kThreads = kTile * kTile * kSplit;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 32 / kWarps;      // boxes a thread reads a round
constexpr int kRound = kPer * kThreads;  // faces swept a round
constexpr int kStage = 2 * kRound;     // staged faces at most
constexpr int kBatch = 256;            // staged records tested at a time
constexpr int kGroup = 32;             // faces a group (one warp of the setup)
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPer * kWarps == 32, "one warp scans the per-(box, warp) counts");
static_assert(kBatch <= kThreads, "a thread stages at most one record of a batch");

constexpr float kCoordMax = 0x1p60f;
constexpr float kAreaMin = 0x1p-100f;
constexpr float kAreaMax = 0x1p100f;
constexpr float kErrScale = 0x1p-19f;
constexpr float kErrFloor = 0x1p-120f;
constexpr float kInvMin = 0x1p-99f;
constexpr float kInvMax = 0x1p99f;
constexpr float kCornerScale = 0x1p-20f;
constexpr float kCornerFloor = 0x1p-140f;

// x0 y0 z0 x1 | y1 z1 x2 y2 | z2 1/area (x2-x1) (y2-y1) | (x0-x2) (y0-y2) (x1-x0) (y1-y0):
// edge i runs from vertex i+1 to vertex i+2 (mod 3), as the plain version's b_i
struct __align__(16) Rec {
  float4 a, b, c, d;
};

__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// 1 - (2k+1)/n, as pixel_centers_ndc computes it in float32
__device__ __forceinline__ float pixel_ndc(int k, int n) {
  return sub(1.f, __fdiv_rn(static_cast<float>(2 * k + 1), static_cast<float>(n)));
}

// first and last pixel index whose centre lies in [lo, hi], widened by one
// and clamped: ceil(((1 - hi) n - 1) / 2) - 1 .. floor(((1 - lo) n - 1) / 2) + 1
__device__ __forceinline__ void pixel_range(float lo, float hi, int n, float& k0, float& k1) {
  const float fn = static_cast<float>(n);
  const float first = mul(sub(mul(sub(1.f, hi), fn), 1.f), 0.5f);
  const float last = mul(sub(mul(sub(1.f, lo), fn), 1.f), 0.5f);
  k0 = fminf(fmaxf(sub(ceilf(first), 1.f), 0.f), fn);
  k1 = fminf(fmaxf(add(floorf(last), 1.f), -1.f), fn - 1.f);
}

__device__ __forceinline__ bool live_box(short4 q) { return q.y >= q.x && q.w >= q.z; }

__global__ void __launch_bounds__(256)
raster_setup_kernel(const float* __restrict__ verts, const int* __restrict__ faces, int V,
                    int F, int H, int W, Rec* __restrict__ recs, short4* __restrict__ boxes,
                    short4* __restrict__ groups) {
  __shared__ Rec s_out[256];  // the block's records, written out coalesced
  const int f = blockIdx.x * 256 + threadIdx.x;
  const int b = blockIdx.y;
  short4 box = make_short4(0, -1, 0, -1);
  if (f < F) {
    const float* vb = verts + static_cast<long long>(b) * V * 3;
    float c[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int vi = faces[f * 3 + k];
      assert(vi >= 0 && vi < V);  // face index out of range
      const float* p = vb + static_cast<long long>(vi) * 3;
      c[3 * k] = p[0];
      c[3 * k + 1] = p[1];
      c[3 * k + 2] = p[2];
    }
    const float x0 = c[0], y0 = c[1], x1 = c[3], y1 = c[4], x2 = c[6], y2 = c[7];
    // area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    const float area = sub(mul(sub(x1, x0), sub(y2, y0)), mul(sub(y1, y0), sub(x2, x0)));
    const float inv = area != 0.f ? __frcp_rn(area) : 0.f;
    const long long o = static_cast<long long>(b) * F + f;
    Rec r;
    r.a = make_float4(x0, y0, c[2], x1);
    r.b = make_float4(y1, c[5], x2, y2);
    r.c = make_float4(c[8], inv, sub(x2, x1), sub(y2, y1));
    r.d = make_float4(sub(x0, x2), sub(y0, y2), sub(x1, x0), sub(y1, y0));
    s_out[threadIdx.x] = r;

    const float xmin = fminf(fminf(x0, x1), x2), xmax = fmaxf(fmaxf(x0, x1), x2);
    const float ymin = fminf(fminf(y0, y1), y2), ymax = fmaxf(fmaxf(y0, y1), y2);
    const float ax0 = fabsf(x0), ay0 = fabsf(y0), ax1 = fabsf(x1), ay1 = fabsf(y1);
    const float ax2 = fabsf(x2), ay2 = fabsf(y2);
    const float cmax = fmaxf(fmaxf(fmaxf(fmaxf(fmaxf(ax0, ay0), ax1), ay1), ax2), ay2);
    const bool finite = ax0 <= kCoordMax && ay0 <= kCoordMax && ax1 <= kCoordMax &&
                        ay1 <= kCoordMax && ax2 <= kCoordMax && ay2 <= kCoordMax;
    const float wx = sub(xmax, xmin), wy = sub(ymax, ymin);
    const float spread = mul(add(wx, wy), add(1.f, cmax));
    const float thr = mul(fmaxf(mul(wx, static_cast<float>(W)), mul(wy, static_cast<float>(H))),
                          add(mul(spread, kErrScale), kErrFloor));
    const float aa = fabsf(area);
    const bool empty = area == 0.f || area != area;
    const bool trusted = finite && aa >= kAreaMin && aa <= kAreaMax && aa >= thr;
    float kx0, kx1, ky0, ky1;
    pixel_range(xmin, xmax, W, kx0, kx1);
    pixel_range(ymin, ymax, H, ky0, ky1);
    if (!empty && !trusted) {
      box = make_short4(0, static_cast<short>(W - 1), 0, static_cast<short>(H - 1));
    } else if (!empty && kx0 <= kx1 && ky0 <= ky1) {
      box = make_short4(static_cast<short>(kx0), static_cast<short>(kx1),
                        static_cast<short>(ky0), static_cast<short>(ky1));
    }
    boxes[o] = box;
  }
  __syncthreads();
  const int nf = min(256, F - static_cast<int>(blockIdx.x) * 256);
  float4* dst = reinterpret_cast<float4*>(recs + static_cast<long long>(b) * F + blockIdx.x * 256);
  const float4* src = reinterpret_cast<const float4*>(s_out);
  for (int i = threadIdx.x; i < nf * 4; i += 256) dst[i] = src[i];
  // the union of the boxes of 32 consecutive faces (one warp), which the
  // tile sweep tests before it reads theirs
  const bool live = live_box(box);
  int gx0 = live ? box.x : 32767, gx1 = live ? box.y : -1;
  int gy0 = live ? box.z : 32767, gy1 = live ? box.w : -1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    gx0 = min(gx0, __shfl_xor_sync(kFull, gx0, off));
    gx1 = max(gx1, __shfl_xor_sync(kFull, gx1, off));
    gy0 = min(gy0, __shfl_xor_sync(kFull, gy0, off));
    gy1 = max(gy1, __shfl_xor_sync(kFull, gy1, off));
  }
  if ((threadIdx.x & 31) == 0 && f < F) {
    const int G = (F + kGroup - 1) / kGroup;
    groups[static_cast<long long>(b) * G + f / kGroup] =
        gx1 >= 0 ? make_short4(gx0, gx1, gy0, gy1) : make_short4(0, -1, 0, -1);
  }
}

__device__ __forceinline__ bool overlaps(short4 q, int x0, int x1, int y0, int y1) {
  return q.x <= x1 && q.y >= x0 && q.z <= y1 && q.w >= y0;
}

struct Hit {
  bool in;
  float z, b0, b1, b2;
};

// b_i = ((xa - xb) * (py - yb) - (ya - yb) * (px - xb)) * inv, edge i from
// vertex i+1 (xb, yb) to vertex i+2 (xa, ya), and z, as the plain version orders them
__device__ __forceinline__ Hit test_face(const Rec& r, float px, float py) {
  Hit h;
  h.b0 = mul(sub(mul(r.c.z, sub(py, r.b.x)), mul(r.c.w, sub(px, r.a.w))), r.c.y);
  h.b1 = mul(sub(mul(r.d.x, sub(py, r.b.w)), mul(r.d.y, sub(px, r.b.z))), r.c.y);
  h.b2 = mul(sub(mul(r.d.z, sub(py, r.a.y)), mul(r.d.w, sub(px, r.a.x))), r.c.y);
  h.in = h.b0 >= 0.f && h.b1 >= 0.f && h.b2 >= 0.f;
  h.z = add(add(mul(h.b0, r.a.z), mul(h.b1, r.b.y)), mul(h.b2, r.c.x));
  return h;
}

// One edge's b at the corner centre (px, py) of a sub-tile that maximises
// the exact edge value times sign(1/area): the dx (py) and -dy (px) terms
// each pick the end of their range their sign favours.
__device__ __forceinline__ float corner_b(float dx, float dy, float xb, float yb, float inv,
                                          float px_lo, float px_hi, float py_lo, float py_hi) {
  const bool pos = inv > 0.f;
  const float py = (dx > 0.f) == pos ? py_hi : py_lo;
  const float px = (dy > 0.f) == pos ? px_lo : px_hi;
  return mul(sub(mul(dx, sub(py, yb)), mul(dy, sub(px, xb))), inv);
}

// True where no pixel centre of the rectangle [px_lo, px_hi] x [py_lo,
// py_hi] can pass the face's test: one edge's b at its best corner lies
// below -beta (the note's sub-tile argument). Only for coordinates within
// kCoordMax and 2^-99 <= |1/area| <= 2^99; false otherwise.
__device__ __forceinline__ bool cannot_pass(const Rec& r, float px_lo, float px_hi, float py_lo,
                                            float py_hi) {
  const float x0 = r.a.x, y0 = r.a.y, x1 = r.a.w, y1 = r.b.x, x2 = r.b.z, y2 = r.b.w;
  const float inv = r.c.y, ai = fabsf(inv);
  const float ax0 = fabsf(x0), ay0 = fabsf(y0), ax1 = fabsf(x1), ay1 = fabsf(y1);
  const float ax2 = fabsf(x2), ay2 = fabsf(y2);
  if (!(ax0 <= kCoordMax && ay0 <= kCoordMax && ax1 <= kCoordMax && ay1 <= kCoordMax &&
        ax2 <= kCoordMax && ay2 <= kCoordMax && ai >= kInvMin && ai <= kInvMax))
    return false;
  const float cmax = fmaxf(fmaxf(fmaxf(fmaxf(fmaxf(ax0, ay0), ax1), ay1), ax2), ay2);
  const float wx = sub(fmaxf(fmaxf(x0, x1), x2), fminf(fminf(x0, x1), x2));
  const float wy = sub(fmaxf(fmaxf(y0, y1), y2), fminf(fminf(y0, y1), y2));
  const float spread = mul(add(wx, wy), add(1.f, cmax));
  const float beta = add(mul(add(mul(spread, kCornerScale), kCornerFloor), ai), kInvMin);
  return corner_b(r.c.z, r.c.w, x1, y1, inv, px_lo, px_hi, py_lo, py_hi) < -beta ||
         corner_b(r.d.x, r.d.y, x2, y2, inv, px_lo, px_hi, py_lo, py_hi) < -beta ||
         corner_b(r.d.z, r.d.w, x0, y0, inv, px_lo, px_hi, py_lo, py_hi) < -beta;
}

__global__ void __launch_bounds__(kThreads)
raster_tile_kernel(const Rec* __restrict__ recs, const short4* __restrict__ boxes,
                   const short4* __restrict__ groups, int F, int H, int W, int tiles_x,
                   float* __restrict__ zbuf, int* __restrict__ p2f, float* __restrict__ bary) {
  __shared__ Rec s_rec[kBatch];
  __shared__ short4 s_box[kStage];
  __shared__ int s_face[kStage];
  __shared__ int s_hit[kThreads];            // groups of a round that overlap the tile
  __shared__ int s_count[2][kPer * kWarps];  // per (box of a thread, warp), by sub-round parity
  __shared__ int s_gcount[kWarps];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int tx0 = (blockIdx.x % tiles_x) * kTile, ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx1 = min(tx0 + kTile, W) - 1, ty1 = min(ty0 + kTile, H) - 1;
  // the warp's 8x4 sub-tile: two across, four down; clipped to the image.
  // part: which of the kSplit threads of its pixel this one is
  const int part = warp / (kWarps / kSplit), sub_tile = warp % (kWarps / kSplit);
  const int sx0 = tx0 + (sub_tile & 1) * 8, sy0 = ty0 + (sub_tile >> 1) * 4;
  const int sx1 = min(sx0 + 7, W - 1), sy1 = min(sy0 + 3, H - 1);
  const bool warp_live = sx0 < W && sy0 < H;
  const int x = sx0 + (lane & 7), y = sy0 + (lane >> 3);
  const float px = pixel_ndc(x, W), py = pixel_ndc(y, H);
  // the sub-tile's pixel centres span [px_lo, px_hi] x [py_lo, py_hi]
  // (NDC falls as the index grows)
  const float px_hi = pixel_ndc(sx0, W), px_lo = pixel_ndc(sx1, W);
  const float py_hi = pixel_ndc(sy0, H), py_lo = pixel_ndc(sy1, H);

  const int G = (F + kGroup - 1) / kGroup;
  const short4* bb = boxes + static_cast<long long>(b) * F;
  const short4* gb = groups + static_cast<long long>(b) * G;
  const Rec* rb = recs + static_cast<long long>(b) * F;
  const short4 none = make_short4(0, -1, 0, -1);

  float best_z = CUDART_INF_F, bb0 = 0.f, bb1 = 0.f, bb2 = 0.f;
  int best_f = -1;

  // test the n staged faces, kBatch at a time, and empty the stage
  auto flush = [&](int n) {
    __syncthreads();  // the stage is complete
    for (int k0 = 0; k0 < n; k0 += kBatch) {
      const int m = min(kBatch, n - k0);
      if (threadIdx.x < m) s_rec[threadIdx.x] = rb[s_face[k0 + threadIdx.x]];
      __syncthreads();
      if (warp_live) {
        // part p scans the batch's 32-face chunks p, p + kSplit, ...
        for (int j0 = 32 * part; j0 < m; j0 += 32 * kSplit) {
          const int j = j0 + lane;
          bool hit = false;
          if (j < m) {
            // the corner rule only for boxes larger than a sub-tile: a box of
            // a few pixels seldom lies outside an edge over a whole sub-tile
            const short4 q = s_box[k0 + j];
            const bool small = q.y - q.x < 8 && q.w - q.z < 4;
            hit = overlaps(q, sx0, sx1, sy0, sy1) &&
                  (small || !cannot_pass(s_rec[j], px_lo, px_hi, py_lo, py_hi));
          }
          unsigned todo = __ballot_sync(kFull, hit);
          // two faces an iteration where two are left, tested independently,
          // taken in order
          while (todo) {
            const int ka = j0 + __ffs(todo) - 1;
            todo &= todo - 1u;
            const Hit ha = test_face(s_rec[ka], px, py);
            if (todo) {
              const int kb = j0 + __ffs(todo) - 1;
              todo &= todo - 1u;
              const Hit hb = test_face(s_rec[kb], px, py);
              if (ha.in && ha.z < best_z) {
                best_z = ha.z;
                best_f = s_face[k0 + ka];
                bb0 = ha.b0;
                bb1 = ha.b1;
                bb2 = ha.b2;
              }
              if (hb.in && hb.z < best_z) {
                best_z = hb.z;
                best_f = s_face[k0 + kb];
                bb0 = hb.b0;
                bb1 = hb.b1;
                bb2 = hb.b2;
              }
            } else if (ha.in && ha.z < best_z) {
              best_z = ha.z;
              best_f = s_face[k0 + ka];
              bb0 = ha.b0;
              bb1 = ha.b1;
              bb2 = ha.b2;
            }
          }
        }
      }
      __syncthreads();  // the batch is consumed
    }
  };

  int n = 0, sub = 0;  // staged faces and sub-rounds so far (uniform over the block)
  for (int g0 = 0; g0 < G; g0 += kThreads) {
    // the round's groups whose union box overlaps the tile, in order
    const int g = g0 + threadIdx.x;
    const bool ghit = g < G && overlaps(gb[g], tx0, tx1, ty0, ty1);
    const unsigned gmask = __ballot_sync(kFull, ghit);
    if (lane == 0) s_gcount[warp] = __popc(gmask);
    __syncthreads();
    int gbase = 0, nh = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_gcount[w];
      gbase += w < warp ? c : 0;
      nh += c;
    }
    if (ghit) s_hit[gbase + __popc(gmask & below)] = g;
    __syncthreads();
    // their faces, kPer * kWarps groups a sub-round: box j of warp w is face
    // lane of hit group h0 + j * kWarps + w, so (j, warp, lane) is face order
    for (int h0 = 0; h0 < nh; h0 += kPer * kWarps, ++sub) {
      short4 cur[kPer];
      int fid[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int gi = h0 + j * kWarps + warp;
        fid[j] = gi < nh ? s_hit[gi] * kGroup + lane : F;
        cur[j] = fid[j] < F ? bb[fid[j]] : none;
      }
      int* cnt = s_count[sub & 1];
      unsigned mask[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        mask[j] = __ballot_sync(kFull, overlaps(cur[j], tx0, tx1, ty0, ty1));
        if (lane == 0) cnt[j * kWarps + warp] = __popc(mask[j]);
      }
      __syncthreads();
      // exclusive scan of the kPer * kWarps counts, in face order
      const int c = cnt[lane];
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      const int total = __shfl_sync(kFull, incl, 31);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int base = __shfl_sync(kFull, incl - c, j * kWarps + warp);
        if (mask[j] >> lane & 1u) {
          const int slot = n + base + __popc(mask[j] & below);
          s_face[slot] = fid[j];
          s_box[slot] = cur[j];
        }
      }
      n += total;
      if (n > kStage - kRound) {
        flush(n);
        n = 0;
      }
    }
  }
  if (n > 0) flush(n);

  // the kSplit candidates of a pixel: the least (z, face), which is what the
  // ascending scan with a strict < keeps (z is never NaN where a face is
  // taken). They pass through the stage's memory, free after the last flush.
  static_assert((kSplit - 1) * kTile * kTile * 16 <= sizeof(s_box) &&
                (kSplit - 1) * kTile * kTile * 4 <= sizeof(s_face), "candidates fit the stage");
  float(*s_cand)[kTile * kTile][4] = reinterpret_cast<float(*)[kTile * kTile][4]>(s_box);
  int(*s_cand_f)[kTile * kTile] = reinterpret_cast<int(*)[kTile * kTile]>(s_face);
  const int pix = threadIdx.x % (kTile * kTile);
  if (part > 0) {
    s_cand[part - 1][pix][0] = best_z;
    s_cand[part - 1][pix][1] = bb0;
    s_cand[part - 1][pix][2] = bb1;
    s_cand[part - 1][pix][3] = bb2;
    s_cand_f[part - 1][pix] = best_f;
  }
  __syncthreads();
  if (part > 0) return;
#pragma unroll
  for (int q = 0; q < kSplit - 1; ++q) {
    const int f = s_cand_f[q][pix];
    const float z = s_cand[q][pix][0];
    if (f >= 0 && (z < best_z || (z == best_z && f < best_f))) {
      best_z = z;
      best_f = f;
      bb0 = s_cand[q][pix][1];
      bb1 = s_cand[q][pix][2];
      bb2 = s_cand[q][pix][3];
    }
  }
  if (x >= W || y >= H) return;
  const long long o = (static_cast<long long>(b) * H + y) * W + x;
  zbuf[o] = best_z;
  p2f[o] = best_f;
  bary[o * 3] = bb0;
  bary[o * 3 + 1] = bb1;
  bary[o * 3 + 2] = bb2;
}

}  // namespace

extern "C" {

// verts (B, V, 3) float32 NDC; faces (F, 3) int32 (an index outside [0, V)
// trips a device-side assert). Workspace: recs (B, F, 16) float32, boxes
// (B, F, 4) int16, groups (B, ceil(F / 32), 4) int16; the first step writes
// them (face_setup_plain's records, boxes and group boxes).
int c4d_rasterize_setup(const void* verts, const void* faces, int B, int V, int F, int H, int W,
                        void* recs, void* boxes, void* groups, void* stream) {
  if (F == 0) return 0;
  dim3 grid((F + 255) / 256, B);
  raster_setup_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(verts), static_cast<const int*>(faces), V, F, H, W,
      static_cast<Rec*>(recs), static_cast<short4*>(boxes), static_cast<short4*>(groups));
  return static_cast<int>(cudaGetLastError());
}

// Both steps. Outputs zbuf (B, H, W) float32, pix_to_face (B, H, W) int32,
// bary (B, H, W, 3) float32. Returns cudaGetLastError().
int c4d_rasterize(const void* verts, const void* faces, int B, int V, int F, int H, int W,
                  void* recs, void* boxes, void* groups, void* zbuf, void* p2f, void* bary,
                  void* stream) {
  const int rc = c4d_rasterize_setup(verts, faces, B, V, F, H, W, recs, boxes, groups, stream);
  if (rc != 0) return rc;
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  dim3 grid(tiles_x * tiles_y, B);
  raster_tile_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Rec*>(recs), static_cast<const short4*>(boxes),
      static_cast<const short4*>(groups), F, H, W, tiles_x,
      static_cast<float*>(zbuf), static_cast<int*>(p2f), static_cast<float*>(bary));
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
