// K5: 3D Gaussian splatting tile compositing, backward.
//
// Replaces cap4d_tpu/ops/gsplat_pallas.py:266 `_bwd_kernel` (pallas_call at
// :585) and, because it accumulates per gaussian itself, the unsort gather
// and window reductions of `_gather_pairs_t_bwd` (:503).
//
// It replays the n_done[t] batches the forward (K4) ran of each tile and
// computes exact per-pair gradients with the suffix-sum identity of
// gsplat_pallas.py:340-371:
//   q_k  = g_rgb . rgb_k + g_wsum + g_dsum depth_k       (per pixel)
//   dL/dalpha_k = T_k q_k - (sum_{j>k} w_j q_j + g_lnT) / (1 - alpha_k)
// where the suffix sum is the forward's totals (sum w rgb, sum w, sum w depth
// dotted with the cotangent) minus a running inclusive prefix. The gradient
// is zero where alpha is clamped at 0.999. From dL/dalpha: the mean x/y,
// conic a/b/c and opacity gradients through sigma and e^-sigma, and the rgb
// and depth gradients from w.
//
// The design: one block per work item, a (tile, 256-pair batch) that the
// forward ran (gsplat_items.cuh), one thread per pixel. K4's state row gives
// the batch's starting point, so nothing before it is recomputed: T =
// exp(ln T before the batch), and the prefix of w q is g_rgb . (sum w rgb) +
// g_wsum (sum w) + g_dsum (sum w depth) over the saved prefix sums, since q is
// linear in the pair's colour and depth.
//
// Reduction: each pair's ten gradients are summed over the block's 256
// pixels. A warp in which some lane kept the pair sums its ten values in one
// transposed butterfly (warp_sum10: 12 shuffles, where ten separate 5-step
// sums take 50; Hopper retires one warp shuffle per clock per SM, against
// four warp instructions of fp32 arithmetic), and the ten lanes that end up
// holding a sum add it to a per-batch shared accumulator in one shared
// atomic instruction. After the batch one thread per pair adds the sums into
// the per-gaussian gradient with global atomicAdd. The order of those
// atomics varies between runs, so the result is reproducible only to a
// tolerance.
//
// What bounds it on an H100: as K4, the pair-pixel work (here ~45 more fp32
// operations for a kept pair, and its share of the reduction) against
// 67 TFLOP/s; the bytes are the forward's plus the (n_tiles, 256, 6)
// cotangent, the state rows read once and 40 bytes per gaussian out.

#include "gsplat_items.cuh"

namespace {

using namespace gsplat;

// Sums v[0..9] over the warp. On return lane l holds the warp sum of value
// warp_sum10_slot(l), or 0 where that is -1; lanes l and l ^ 1 hold the same
// value. Each step halves the values a lane carries: it keeps one half,
// sends the other to its partner and adds what the partner sent.
__device__ __forceinline__ float warp_sum10(const float (&v)[kPacked], int lane) {
  const bool h = lane & 16, g = lane & 8, f = lane & 4, e = lane & 2;
  float b[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    b[i] = (h ? v[5 + i] : v[i]) + __shfl_xor_sync(kFull, h ? v[i] : v[5 + i], 16);
  }
  float c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float upper = i < 2 ? b[3 + i] : 0.f;
    c[i] = (g ? upper : b[i]) + __shfl_xor_sync(kFull, g ? b[i] : upper, 8);
  }
  const float d0 = (f ? c[2] : c[0]) + __shfl_xor_sync(kFull, f ? c[0] : c[2], 4);
  const float d1 = (f ? 0.f : c[1]) + __shfl_xor_sync(kFull, f ? c[1] : 0.f, 4);
  float x = (e ? d1 : d0) + __shfl_xor_sync(kFull, e ? d0 : d1, 2);
  return x + __shfl_xor_sync(kFull, x, 1);
}

// The value whose warp sum warp_sum10 leaves in lane l (bits h g f e of
// l >> 1 choose it), or -1.
__device__ __forceinline__ int warp_sum10_slot(int lane) {
  const int h = (lane >> 4) & 1, g = (lane >> 3) & 1, f = (lane >> 2) & 1, e = (lane >> 1) & 1;
  if (f && e) return -1;
  const int ci = f ? 2 : e;
  if (g && ci == 2) return -1;
  return 5 * h + (g ? 3 + ci : ci);
}

__global__ void __launch_bounds__(kScanThreads)
gsplat_bwd_scan_kernel(const int* __restrict__ bounds, const int* __restrict__ n_done,
                       int n_tiles, int* __restrict__ row_start, int* __restrict__ work_start,
                       int* __restrict__ work_tile) {
  scan_items(bounds, n_done, n_tiles, row_start, work_start, work_tile);
}

__global__ void __launch_bounds__(kBlock)
gsplat_bwd_items_kernel(const float* __restrict__ packed, const int* __restrict__ pair_gauss,
                        const int* __restrict__ bounds, const int* __restrict__ row_start,
                        const int* __restrict__ work_start, const int* __restrict__ work_tile,
                        int n_tiles, int tiles_x, const float* __restrict__ out,
                        const float* __restrict__ grad_out, const float* __restrict__ state,
                        float* __restrict__ dpacked) {
  __shared__ Pair s_pair[kBlock];
  __shared__ int s_gid[kBlock];
  __shared__ float s_acc[kBlock][kPacked];

  const int item = blockIdx.x;
  if (item >= work_start[n_tiles]) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int slot = (lane & 1) ? -1 : warp_sum10_slot(lane);
  int t, batch;
  const int n = stage_item(packed, pair_gauss, bounds, work_start, work_tile, item, s_pair, s_gid,
                           t, batch);
  if (tid < n) {
#pragma unroll
    for (int c = 0; c < kPacked; ++c) s_acc[tid][c] = 0.f;
  }
  const float px = pixel_x(t, tiles_x);
  const float py = pixel_y(t, tiles_x);
  const size_t pix = static_cast<size_t>(t) * kBlock + tid;
  const float* o = out + pix * kOut;
  const float* go = grad_out + pix * kOut;
  const float g_r = go[0], g_g = go[1], g_b = go[2], g_w = go[3], g_d = go[4], g_l = go[5];
  const float s_total = o[0] * g_r + o[1] * g_g + o[2] * g_b + o[3] * g_w + o[4] * g_d;
  const float* st = state + static_cast<size_t>(row_start[t] + batch) * kState * kBlock + tid;
  float T = expf(st[0]);
  float prefix = g_r * st[1 * kBlock] + g_g * st[2 * kBlock] + g_b * st[3 * kBlock] +
                 g_w * st[4 * kBlock] + g_d * st[5 * kBlock];
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const float4 A = s_pair[k].a;
    const float4 B = s_pair[k].b;
    const float dx = px - A.x;
    const float dy = py - A.y;
    const float ca = A.z, cb = A.w, cc = B.x;
    const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
    float v[kPacked];
#pragma unroll
    for (int c = 0; c < kPacked; ++c) v[c] = 0.f;
    bool kept = false;
    if (sigma >= 0.f) {
      const float expneg = __expf(-sigma);
      const float raw = B.y * expneg;
      if (raw >= kAlphaMin) {
        kept = true;
        const float4 C = s_pair[k].c;
        const float a = fminf(raw, kAlphaMax);
        const float w = a * T;
        const float q = g_r * B.z + g_g * B.w + g_b * C.x + g_w + g_d * C.y;
        prefix += w * q;
        const float suffix = s_total - prefix;
        const float d_alpha = T * q - (suffix + g_l) / (1.f - a);
        const float d_pre = raw < kAlphaMax ? d_alpha : 0.f;
        const float d_sigma = -d_pre * a;
        v[0] = -d_sigma * (ca * dx + cb * dy);
        v[1] = -d_sigma * (cc * dy + cb * dx);
        v[2] = d_sigma * 0.5f * dx * dx;
        v[3] = d_sigma * dx * dy;
        v[4] = d_sigma * 0.5f * dy * dy;
        v[5] = d_pre * expneg;
        v[6] = g_r * w;
        v[7] = g_g * w;
        v[8] = g_b * w;
        v[9] = g_d * w;
        T *= 1.f - a;
      }
    }
    if (__any_sync(kFull, kept)) {
      const float sum = warp_sum10(v, lane);
      if (slot >= 0) atomicAdd(&s_acc[k][slot], sum);
    }
  }
  __syncthreads();
  if (tid < n) {
    float* dst = dpacked + static_cast<size_t>(s_gid[tid]) * kPacked;
#pragma unroll
    for (int c = 0; c < kPacked; ++c) {
      const float val = s_acc[tid][c];
      if (val != 0.f) atomicAdd(dst + c, val);
    }
  }
}

}  // namespace

extern "C" {

// packed (N, 10), pair_gauss (M,), bounds (n_tiles + 1,) and n_rows as for
// K4; out (n_tiles, 256, 6), n_done (n_tiles,) and state (n_rows, 6, 256)
// from K4; grad_out (n_tiles, 256, 6) the cotangent of out; workspace
// (2 n_tiles + 2 + n_rows,) int32 scratch. Accumulates into dpacked (N, 10)
// float32, which the caller zeroes. Returns cudaGetLastError().
int c4d_gsplat_bwd(const void* packed, const void* pair_gauss, const void* bounds,
                   const void* out, const void* n_done, const void* state,
                   const void* grad_out, int n_tiles, int tiles_x, int n_rows,
                   void* workspace, void* dpacked, void* stream) {
  if (n_tiles > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int* row_start = static_cast<int*>(workspace);
    int* work_start = row_start + n_tiles + 1;
    int* work_tile = work_start + n_tiles + 1;
    const int* bd = static_cast<const int*>(bounds);
    gsplat_bwd_scan_kernel<<<1, kScanThreads, 0, s>>>(bd, static_cast<const int*>(n_done),
                                                      n_tiles, row_start, work_start, work_tile);
    gsplat_bwd_items_kernel<<<n_rows, kBlock, 0, s>>>(
        static_cast<const float*>(packed), static_cast<const int*>(pair_gauss), bd, row_start,
        work_start, work_tile, n_tiles, tiles_x, static_cast<const float*>(out),
        static_cast<const float*>(grad_out), static_cast<const float*>(state),
        static_cast<float*>(dpacked));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
