// K2: GroupNorm over NHWC activations with the affine folded into one FMA
// and an optional SiLU.
//
// Replaces cap4d_tpu/ops/norms.py:26 `_gn_silu_kernel` (reached through
// `fused_group_norm_silu`).
//
// Route: CUDA C++ rather than Triton, so that every kernel of the port builds
// the same way (one nvcc call per source, bound with ctypes) and the card
// needs no Triton compile at run time.
//
// What bounds it on an H100: memory. The work is a few flops per element
// against 2 bytes read (twice) and 2 written, far below the ridge, so the
// floor is the bytes over 3.35 TB/s. The design is the two-pass floor of an
// unfused-stats norm: pass 1 (one block per (sample, group)) reads the group
// once and reduces a shifted sum and sum of squares in fp32 (the shift by the
// group's first element keeps E[x^2] - E[x]^2 from cancelling when the mean
// is large next to the spread); pass 2 reads each element again, applies
// x * (rstd * scale) + (bias - mean * rstd * scale) and the SiLU in fp32 and
// writes it once, eight elements (16 bytes of bf16) per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStatThreads = 256;
constexpr int kApplyThreads = 256;
constexpr int kVec = 8;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kStatThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                float* __restrict__ rstd, int HW, int C, int G, float eps) {
  const int n = blockIdx.x / G, grp = blockIdx.x % G;
  const int gs = C / G;
  const T* base = x + static_cast<long long>(n) * HW * C + grp * gs;
  const long long count = static_cast<long long>(HW) * gs;
  const float shift = to_f(base[0]);
  float s1 = 0.f, s2 = 0.f;
  // thread -> (pixel lane, channel), no division inside the loop; kUnroll
  // independent loads in flight per thread hide the device-memory latency
  const int lanes = kStatThreads / gs;  // gs <= kStatThreads (checked by the wrapper)
  const int c = threadIdx.x % gs;
  if (static_cast<int>(threadIdx.x) < lanes * gs) {
    const T* col = base + c;
    const long long step = static_cast<long long>(lanes) * C;
    int p = threadIdx.x / gs;
    for (; p + (kUnroll - 1) * lanes < HW; p += kUnroll * lanes) {
      float v[kUnroll];
      const T* src = col + static_cast<long long>(p) * C;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = to_f(src[u * step]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float d = v[u] - shift;
        s1 += d;
        s2 += d * d;
      }
    }
    for (; p < HW; p += lanes) {
      const float d = to_f(col[static_cast<long long>(p) * C]) - shift;
      s1 += d;
      s2 += d * d;
    }
  }
  __shared__ float red1[kStatThreads / 32], red2[kStatThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red1[warp] = s1;
    red2[warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int w = 0; w < kStatThreads / 32; ++w) {
      t1 += red1[w];
      t2 += red2[w];
    }
    const float inv_n = 1.f / static_cast<float>(count);
    const float m = t1 * inv_n;
    const float var = fmaxf(t2 * inv_n - m * m, 0.f);
    mean[blockIdx.x] = shift + m;
    rstd[blockIdx.x] = rsqrtf(var + eps);
  }
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                const float* __restrict__ mean, const float* __restrict__ rstd,
                const float* __restrict__ scale, const float* __restrict__ bias,
                long long total, long long HWC, int C, int G) {
  const long long idx = (static_cast<long long>(blockIdx.x) * kApplyThreads + threadIdx.x) * kVec;
  if (idx >= total) return;
  const int n = static_cast<int>(idx / HWC);
  const int c0 = static_cast<int>(idx % C);
  const int gs = C / G;
  int ng = n * G + c0 / gs;  // group of channel c0, advanced as channels cross groups
  int cg = c0 % gs;
  alignas(16) T in[kVec];
  alignas(16) T out[kVec];
  // C % 8 == 0 (checked by the wrapper): the 8 elements are one pixel's
  // consecutive channels, and 8·sizeof(T) bytes are 16-byte aligned
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(in) = *reinterpret_cast<const uint4*>(x + idx);
  } else {
    reinterpret_cast<float4*>(in)[0] = reinterpret_cast<const float4*>(x + idx)[0];
    reinterpret_cast<float4*>(in)[1] = reinterpret_cast<const float4*>(x + idx)[1];
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = c0 + j;
    if (cg == gs) {
      ++ng;
      cg = 0;
    }
    ++cg;
    const float se = rstd[ng] * scale[c];
    const float be = bias[c] - mean[ng] * se;
    float r = to_f(in[j]) * se + be;
    if (kSilu) r = r / (1.f + __expf(-r));
    out[j] = from_f<T>(r);
  }
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(y + idx) = *reinterpret_cast<const uint4*>(out);
  } else {
    reinterpret_cast<float4*>(y + idx)[0] = reinterpret_cast<const float4*>(out)[0];
    reinterpret_cast<float4*>(y + idx)[1] = reinterpret_cast<const float4*>(out)[1];
  }
}

template <typename T>
int launch(const void* x, void* y, const float* scale, const float* bias,
           float* stats, int N, int HW, int C, int G, float eps, int silu,
           cudaStream_t stream) {
  float* mean = stats;
  float* rstd = stats + N * G;
  gn_stats_kernel<T><<<N * G, kStatThreads, 0, stream>>>(
      static_cast<const T*>(x), mean, rstd, HW, C, G, eps);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long total = static_cast<long long>(N) * HW * C;
  const long long threads = total / kVec;
  const unsigned blocks = static_cast<unsigned>((threads + kApplyThreads - 1) / kApplyThreads);
  if (silu)
    gn_apply_kernel<T, true><<<blocks, kApplyThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), mean, rstd, scale, bias,
        total, static_cast<long long>(HW) * C, C, G);
  else
    gn_apply_kernel<T, false><<<blocks, kApplyThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), mean, rstd, scale, bias,
        total, static_cast<long long>(HW) * C, C, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: contiguous (N, H·W, C); dtype 0 = float32, 1 = bfloat16. scale, bias:
// (C,) float32. stats: float32 scratch of 2·N·G. C % G == 0 and C % 8 == 0
// (checked by the Python wrapper). Returns cudaGetLastError().
int c4d_group_norm_silu(const void* x, void* y, const void* scale, const void* bias,
                        void* stats, int N, int HW, int C, int G, float eps,
                        int silu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* st = static_cast<float*>(stats);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, sc, bi, st, N, HW, C, G, eps, silu, s);
  return launch<float>(x, y, sc, bi, st, N, HW, C, G, eps, silu, s);
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
