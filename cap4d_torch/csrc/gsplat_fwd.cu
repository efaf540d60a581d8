// K4: 3D Gaussian splatting tile compositing, forward.
//
// Replaces cap4d_tpu/ops/gsplat_pallas.py:197 `_fwd_kernel` (pallas_call at
// :557 in `_make_composite`, driven by `rasterize_gaussians_pallas`).
//
// Contract (ops/gsplat.py, the plain version `rasterize_gaussians_plain`):
// per 16x16 tile, the tile's pairs pair_gauss[bounds[t] : bounds[t+1]] are
// already sorted front to back (depth rank, ties by gaussian index). For each
// pixel centre (x + 0.5, y + 0.5) and pair: sigma = 0.5 (a dx^2 + c dy^2) +
// b dx dy; the pair is kept where sigma >= 0 and opac e^-sigma >= 1/255;
// alpha = min(opac e^-sigma, 0.999); w = alpha T; T *= 1 - alpha. Outputs per
// pixel: sum w rgb, sum w, sum w depth and ln T = sum log1p(-alpha). The tile
// stops at the first 256-pair batch boundary of its own segment at which every
// pixel has ln T < ln(1e-4); n_done[t] records the batches it ran, so the
// backward (K5) replays exactly those.
//
// What bounds it on an H100: the pair-pixel evaluations (about 11 fp32
// operations each, 13 more and an __expf where the pair is kept) against
// 67 TFLOP/s; the bytes (10 floats per gaussian, one int per pair, 24 bytes
// per pixel out, 24 per pixel and batch of state) are small beside that. What
// held the first design back was balance, not arithmetic: one block walked a
// tile's whole segment, so the deepest tile (tens of batches where the mean
// tile holds one or two) set the time.
//
// The design: the work items are (tile, 256-pair batch), 256 being the stop
// rule's own granularity (gsplat_items.cuh). Whether a pair is kept does not
// depend on T, so a batch composited from T = 1 gives the tile's sums once
// scaled by the transmittance in front of it. Three launches:
//   1. scan: one block enumerates the items from `bounds` on the device;
//   2. items: one block per item, one thread per pixel, the batch staged in
//      shared memory, composites front to back from T = 1 and writes its
//      sums and its ln T into the item's state row. ln T comes from the
//      running product of (1 - alpha), renormalised by 2^64 when it falls
//      below 2^-64, and one logf at the end, not a log1pf per kept pair;
//   3. merge: one block per tile walks its items in order, applies the stop
//      rule at each batch boundary (__syncthreads_count), accumulates
//      exp(ln T before) times each batch's sums, and overwrites each item
//      that ran with what K5 starts from: ln T before the batch and the
//      prefix of the five sums. Items after the stop were computed by (2)
//      and are discarded here.
// State rows: (n_rows, 6, 256) float32, n_rows = n_tiles + M / 256.

#include "gsplat_items.cuh"

namespace {

using namespace gsplat;

__global__ void __launch_bounds__(kScanThreads)
gsplat_fwd_scan_kernel(const int* __restrict__ bounds, int n_tiles, int* item_start,
                       int* __restrict__ item_tile) {
  scan_items(bounds, nullptr, n_tiles, item_start, item_start, item_tile);
}

__global__ void __launch_bounds__(kBlock)
gsplat_fwd_items_kernel(const float* __restrict__ packed, const int* __restrict__ pair_gauss,
                        const int* __restrict__ bounds, const int* __restrict__ item_start,
                        const int* __restrict__ item_tile, int n_tiles, int tiles_x,
                        float* __restrict__ state) {
  __shared__ Pair s_pair[kBlock];

  const int item = blockIdx.x;
  if (item >= item_start[n_tiles]) return;
  int tile, batch;
  const int n = stage_item(packed, pair_gauss, bounds, item_start, item_tile, item, s_pair,
                           nullptr, tile, batch);
  __syncthreads();
  const float px = pixel_x(tile, tiles_x);
  const float py = pixel_y(tile, tiles_x);
  float wr = 0.f, wg = 0.f, wb = 0.f, wsum = 0.f, dsum = 0.f, T = 1.f;
  float tn = 1.f, ln_scale = 0.f;  // ln T = ln(tn) + ln_scale
  for (int k = 0; k < n; ++k) {
    const float4 A = s_pair[k].a;
    const float4 B = s_pair[k].b;
    const float dx = px - A.x;
    const float dy = py - A.y;
    const float sigma = 0.5f * (A.z * dx * dx + B.x * dy * dy) + A.w * dx * dy;
    if (sigma < 0.f) continue;
    const float raw = B.y * __expf(-sigma);
    if (raw < kAlphaMin) continue;
    const float4 C = s_pair[k].c;
    const float a = fminf(raw, kAlphaMax);
    const float w = a * T;
    wr += w * B.z;
    wg += w * B.w;
    wb += w * C.x;
    wsum += w;
    dsum += w * C.y;
    T *= 1.f - a;
    tn *= 1.f - a;
    if (tn < 0x1p-64f) {
      tn *= 0x1p64f;
      ln_scale -= 44.36141955583649f;  // 64 ln 2
    }
  }
  float* st = state + static_cast<size_t>(item) * kState * kBlock + threadIdx.x;
  st[0] = logf(tn) + ln_scale;
  st[1 * kBlock] = wr;
  st[2 * kBlock] = wg;
  st[3 * kBlock] = wb;
  st[4 * kBlock] = wsum;
  st[5 * kBlock] = dsum;
}

__global__ void __launch_bounds__(kBlock)
gsplat_fwd_merge_kernel(const int* __restrict__ item_start, float* __restrict__ state,
                        float* __restrict__ out, int* __restrict__ n_done) {
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int i0 = item_start[t];
  const int n = item_start[t + 1] - i0;
  float* base = state + static_cast<size_t>(i0) * kState * kBlock + tid;

  float p[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float ln_t = 0.f;
  float nxt[kState];
  if (n > 0) {
#pragma unroll
    for (int c = 0; c < kState; ++c) nxt[c] = base[c * kBlock];
  }
  int done = 0;
  for (int j = 0; j < n; ++j) {
    // a batch after the first runs only while some pixel has T >= 1e-4
    if (j > 0 && __syncthreads_count(ln_t >= kLnTStop) == 0) break;
    float cur[kState];
#pragma unroll
    for (int c = 0; c < kState; ++c) cur[c] = nxt[c];
    float* st = base + static_cast<size_t>(j) * kState * kBlock;
    if (j + 1 < n) {
#pragma unroll
      for (int c = 0; c < kState; ++c) nxt[c] = st[(kState + c) * kBlock];
    }
    st[0] = ln_t;
#pragma unroll
    for (int c = 0; c < 5; ++c) st[(1 + c) * kBlock] = p[c];
    const float tb = expf(ln_t);
#pragma unroll
    for (int c = 0; c < 5; ++c) p[c] += tb * cur[1 + c];
    ln_t += cur[0];
    done = j + 1;
  }
  float* o = out + (static_cast<size_t>(t) * kBlock + tid) * kOut;
#pragma unroll
  for (int c = 0; c < 5; ++c) o[c] = p[c];
  o[5] = ln_t;
  if (tid == 0) n_done[t] = done;
}

}  // namespace

extern "C" {

// packed (N, 10) float32; pair_gauss (M,) int32 gaussian of each sorted pair;
// bounds (n_tiles + 1,) int32 segment starts; n_rows = n_tiles + M / 256;
// workspace (n_tiles + 1 + n_rows,) int32 scratch. Outputs out (n_tiles, 256,
// 6) float32, n_done (n_tiles,) int32 and state (n_rows, 6, 256) float32
// (rows of items that did not run are left undefined). Returns
// cudaGetLastError().
int c4d_gsplat_fwd(const void* packed, const void* pair_gauss, const void* bounds,
                   int n_tiles, int tiles_x, int n_rows, void* workspace, void* out,
                   void* n_done, void* state, void* stream) {
  if (n_tiles > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int* item_start = static_cast<int*>(workspace);
    int* item_tile = item_start + n_tiles + 1;
    const int* bd = static_cast<const int*>(bounds);
    gsplat_fwd_scan_kernel<<<1, kScanThreads, 0, s>>>(bd, n_tiles, item_start, item_tile);
    gsplat_fwd_items_kernel<<<n_rows, kBlock, 0, s>>>(
        static_cast<const float*>(packed), static_cast<const int*>(pair_gauss), bd, item_start,
        item_tile, n_tiles, tiles_x, static_cast<float*>(state));
    gsplat_fwd_merge_kernel<<<n_tiles, kBlock, 0, s>>>(
        item_start, static_cast<float*>(state), static_cast<float*>(out),
        static_cast<int*>(n_done));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
