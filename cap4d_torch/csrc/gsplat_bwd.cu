// K5: 3D Gaussian splatting tile compositing, backward.
//
// Replaces cap4d_tpu/ops/gsplat_pallas.py:266 `_bwd_kernel` (pallas_call at
// :585) and, because it accumulates per gaussian itself, the unsort gather
// and window reductions of `_gather_pairs_t_bwd` (:503).
//
// For each tile it replays the n_done[t] batches the forward (K4) ran, front
// to back, and computes exact per-pair gradients with the suffix-sum
// identity of gsplat_pallas.py:340-371:
//   q_k  = g_rgb . rgb_k + g_wsum + g_dsum depth_k       (per pixel)
//   dL/dalpha_k = T_k q_k - (sum_{j>k} w_j q_j + g_lnT) / (1 - alpha_k)
// where the suffix sum is the forward's totals (sum w rgb, sum w, sum w depth
// dotted with the cotangent) minus a running inclusive prefix. The gradient
// is zero where alpha is clamped at 0.999. From dL/dalpha: the mean x/y,
// conic a/b/c and opacity gradients through sigma and e^-sigma, and the rgb
// and depth gradients from w.
//
// Reduction: each pair's ten gradients are summed over the tile's 256 pixels
// -- warp shuffles, then one shared-memory atomic per warp into a per-batch
// accumulator (skipped where no lane of the warp kept the pair) -- and after
// the batch one thread per pair adds the tile's sums into the per-gaussian
// gradient with global atomicAdd. The order of those atomics varies between
// runs, so the result is reproducible only to a tolerance.
//
// What bounds it on an H100: as K4, the pair-pixel work (here ~60 fp32
// operations with the warp reduction) against 67 TFLOP/s; the bytes are the
// forward's plus the (n_tiles, 256, 6) cotangent and 40 bytes per gaussian
// out.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr int kPacked = 10;
constexpr int kOut = 6;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kBlock)
gsplat_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ pair_gauss,
                  const int* __restrict__ bounds, const float* __restrict__ out,
                  const int* __restrict__ n_done, const float* __restrict__ grad_out,
                  int tiles_x, float* __restrict__ dpacked) {
  __shared__ float s_mx[kBlock], s_my[kBlock], s_ca[kBlock], s_cb[kBlock], s_cc[kBlock];
  __shared__ float s_op[kBlock], s_r[kBlock], s_g[kBlock], s_b[kBlock], s_d[kBlock];
  __shared__ int s_gid[kBlock];
  __shared__ float s_acc[kBlock][kPacked];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int start = bounds[t];
  const int len = bounds[t + 1] - start;
  const int n_batches = n_done[t];
  const float px = static_cast<float>((t % tiles_x) * kTile + tid % kTile) + 0.5f;
  const float py = static_cast<float>((t / tiles_x) * kTile + tid / kTile) + 0.5f;

  const size_t pix = static_cast<size_t>(t) * kBlock + tid;
  const float* o = out + pix * kOut;
  const float* go = grad_out + pix * kOut;
  const float g_r = go[0], g_g = go[1], g_b = go[2], g_w = go[3], g_d = go[4], g_l = go[5];
  const float s_total = o[0] * g_r + o[1] * g_g + o[2] * g_b + o[3] * g_w + o[4] * g_d;
  float prefix = 0.f, T = 1.f;

  for (int j = 0; j < n_batches; ++j) {
    const int k0 = j * kBlock;
    if (k0 + tid < len) {
      const int gid = pair_gauss[start + k0 + tid];
      const float* row = packed + static_cast<size_t>(gid) * kPacked;
      s_gid[tid] = gid;
      s_mx[tid] = row[0];
      s_my[tid] = row[1];
      s_ca[tid] = row[2];
      s_cb[tid] = row[3];
      s_cc[tid] = row[4];
      s_op[tid] = row[5];
      s_r[tid] = row[6];
      s_g[tid] = row[7];
      s_b[tid] = row[8];
      s_d[tid] = row[9];
    }
#pragma unroll
    for (int c = 0; c < kPacked; ++c) s_acc[tid][c] = 0.f;
    __syncthreads();
    const int cnt = min(kBlock, len - k0);
    for (int k = 0; k < cnt; ++k) {
      const float dx = px - s_mx[k];
      const float dy = py - s_my[k];
      const float ca = s_ca[k], cb = s_cb[k], cc = s_cc[k];
      const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
      float v[kPacked];
#pragma unroll
      for (int c = 0; c < kPacked; ++c) v[c] = 0.f;
      bool kept = false;
      if (sigma >= 0.f) {
        const float expneg = __expf(-sigma);
        const float raw = s_op[k] * expneg;
        if (raw >= kAlphaMin) {
          kept = true;
          const float a = fminf(raw, kAlphaMax);
          const float w = a * T;
          const float q = g_r * s_r[k] + g_g * s_g[k] + g_b * s_b[k] + g_w + g_d * s_d[k];
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
      if (__any_sync(0xffffffffu, kept)) {
#pragma unroll
        for (int c = 0; c < kPacked; ++c) v[c] = warp_sum(v[c]);
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < kPacked; ++c) atomicAdd(&s_acc[k][c], v[c]);
        }
      }
    }
    __syncthreads();
    if (tid < cnt) {
      float* dst = dpacked + static_cast<size_t>(s_gid[tid]) * kPacked;
#pragma unroll
      for (int c = 0; c < kPacked; ++c) {
        const float val = s_acc[tid][c];
        if (val != 0.f) atomicAdd(dst + c, val);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// packed (N, 10), pair_gauss (M,), bounds (n_tiles + 1,) as for K4; out
// (n_tiles, 256, 6) and n_done (n_tiles,) from K4; grad_out (n_tiles, 256, 6)
// the cotangent of out. Accumulates into dpacked (N, 10) float32, which the
// caller zeroes. Returns cudaGetLastError().
int c4d_gsplat_bwd(const void* packed, const void* pair_gauss, const void* bounds,
                   const void* out, const void* n_done, const void* grad_out, int n_tiles,
                   int tiles_x, void* dpacked, void* stream) {
  if (n_tiles > 0) {
    gsplat_bwd_kernel<<<n_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), static_cast<const int*>(pair_gauss),
        static_cast<const int*>(bounds), static_cast<const float*>(out),
        static_cast<const int*>(n_done), static_cast<const float*>(grad_out), tiles_x,
        static_cast<float*>(dpacked));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
