// K2: GroupNorm over NHWC activations with the affine folded into one FMA
// and an optional SiLU, in one launch that reads x from device memory once.
//
// Replaces cap4d_tpu/ops/norms.py:26 `_gn_silu_kernel` (reached through
// `fused_group_norm_silu`).
//
// Route: CUDA C++ rather than Triton, so that every kernel of the port builds
// the same way (one nvcc call per source, bound with ctypes) and the card
// needs no Triton compile at run time.
//
// What bounds it on an H100: memory. The work is a few flops per element
// against 2 bytes read and 2 written (bf16), far below the ridge, so the
// floor is x read once and y written once over 3.35 TB/s.
//
// Design. A thread-block cluster owns one (sample, slab of whole groups);
// its `cluster` blocks split the slab's H·W rows between them. The slab is
// chosen by the wrapper (`plan_group_norm` in ops/norms.py) so that each
// block's rows fit its shared memory:
//   1. each thread owns one 16-byte vector position of a slab row (8 bf16 or
//      4 fp32 fixed channels) and every lanes-th row; it loads its channels'
//      scale and bias into registers, copies its vectors into shared memory
//      with cp.async in four commit groups and sums each group as it lands:
//      per channel, x - x[pixel 0] and its square in fp32 (the shift by a
//      sample of the channel keeps the sum of squares from cancelling when
//      the mean is large next to the spread);
//   2. the lanes of a warp that share a vector position add their partials
//      with shuffles; the block sums its warps' partials per channel; the
//      cluster meets at a barrier and each block adds the `cluster` blocks'
//      channel sums through distributed shared memory (mapa +
//      ld.shared::cluster), so every block holds the same statistics without
//      a second launch;
//   3. one warp per group merges its channels' means and centred sums of
//      squares (Chan's formula, equal counts) into the group's mean and rstd;
//   4. each thread folds its channels' affine into a = scale·rstd and
//      b = bias − mean·a and writes y = x·a + b (then x·sigmoid(x) with one
//      MUFU exp and a fast divide) from the copy in shared memory, 16 bytes
//      a store.
// A block signals the cluster when it has read the others' sums and waits
// for them only before it exits, so that no block's shared memory goes away
// while another reads it.
// Where even one slab does not fit the cluster's shared memory
// (`resident` = 0), step 1 reads x into registers and step 4 reads the
// block's rows again right after the cluster's barrier, from L2 while they
// are still there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;         // cp.async commit groups of a thread's rows
constexpr int kMaxCluster = 16;    // above 8 a non-portable cluster size
constexpr size_t kMaxSmem = 232448;

template <typename T> __device__ __forceinline__ void to_float(const uint4& v, float* f);
template <> __device__ __forceinline__ void to_float<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
template <> __device__ __forceinline__ void to_float<__nv_bfloat16>(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T> __device__ __forceinline__ uint4 from_float(const float* f);
template <> __device__ __forceinline__ uint4 from_float<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 from_float<__nv_bfloat16>(const float* f) {
  return make_uint4(hopper::pack_bf16(f[0], f[1]), hopper::pack_bf16(f[2], f[3]),
                    hopper::pack_bf16(f[4], f[5]), hopper::pack_bf16(f[6], f[7]));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// shared memory a block uses besides its rows: the warps' per-position
// partials, this block's channel sums, the channels' means and centred sums
// of squares, the groups' mean and rstd
__host__ __device__ constexpr int small_floats(int W, int V, int slab_groups, int ve) {
  return kWarps * (V < 32 ? V : 32) * 2 * ve + 4 * W + 2 * slab_groups;
}

template <typename T, bool kSilu, bool kResident>
__global__ void __launch_bounds__(kThreads)
gn_silu_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ scale,
               const float* __restrict__ bias, int HW, int C, int gs, int slab_groups,
               int rows_per_cta, float eps) {
  constexpr int kVE = 16 / sizeof(T);   // elements of a 16-byte vector
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = slab_groups * gs;       // channels of the slab
  const int V = W / kVE;                // vectors of a slab row
  const int lanes = kThreads / V;       // rows a pass of the block covers
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int l = tid / V, p = tid - l * V;
  const bool active = l < lanes;
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int cs = static_cast<int>(hopper::cluster_size());
  const int cluster = blockIdx.x / cs;
  const int n_slabs = C / W;
  const int n = cluster / n_slabs, slab = cluster - n * n_slabs;
  const int row0 = rank * rows_per_cta;
  const int rows = max(0, min(HW - row0, rows_per_cta));
  const int cbase = slab * W;
  const int slots = V < 32 ? V : 32;    // partials a warp keeps

  const size_t tile_bytes = kResident ? static_cast<size_t>(rows_per_cta) * W * sizeof(T) : 0;
  uint4* tile = reinterpret_cast<uint4*>(smem);
  float* red = reinterpret_cast<float*>(smem + tile_bytes);   // [kWarps][slots][2][kVE]
  float* csum = red + kWarps * slots * 2 * kVE;               // [2][W] this block's sums
  float* cstat = csum + 2 * W;                                // [2][W] mean, centred M2
  float* gstat = cstat + 2 * W;                               // [2][slab_groups] mean, rstd

  const T* xn = x + static_cast<size_t>(n) * HW * C;
  const size_t off = static_cast<size_t>(row0 + l) * C + cbase + p * kVE;
  const T* src = xn + off;
  T* dst = y + static_cast<size_t>(n) * HW * C + off;
  const size_t stride = static_cast<size_t>(lanes) * C;     // between a thread's rows
  const int count = active && l < rows ? (rows - l + lanes - 1) / lanes : 0;
  const int vstep = lanes * V;                               // the same in the tile, in vectors
  uint4* mine = tile + static_cast<size_t>(l) * V + p;

  // ---- 1. x into shared memory (or registers), per-channel shifted sums
  if constexpr (kResident) {
    const int per = (count + kChunks - 1) / kChunks;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      for (int k = c * per; k < min(count, (c + 1) * per); ++k)
        hopper::cp_async16(mine + static_cast<size_t>(k) * vstep, src + k * stride);
      hopper::cp_async_commit();
    }
  }
  float sh[kVE], s1[kVE], s2[kVE], sc[kVE], bi[kVE];
  {
    const int c0 = active ? cbase + p * kVE : 0;
    to_float<T>(__ldg(reinterpret_cast<const uint4*>(xn + c0)), sh);
#pragma unroll
    for (int j = 0; j < kVE; j += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(scale + c0 + j));
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias + c0 + j));
      sc[j] = a.x; sc[j + 1] = a.y; sc[j + 2] = a.z; sc[j + 3] = a.w;
      bi[j] = b.x; bi[j + 1] = b.y; bi[j + 2] = b.z; bi[j + 3] = b.w;
    }
  }
#pragma unroll
  for (int j = 0; j < kVE; ++j) s1[j] = s2[j] = 0.f;
  auto accumulate = [&](const uint4& v) {
    float f[kVE];
    to_float<T>(v, f);
#pragma unroll
    for (int j = 0; j < kVE; ++j) {
      const float d = f[j] - sh[j];
      s1[j] += d;
      s2[j] = fmaf(d, d, s2[j]);
    }
  };
  if constexpr (kResident) {
    const int per = (count + kChunks - 1) / kChunks;
    auto chunk = [&](int c) {
      for (int k = c * per; k < min(count, (c + 1) * per); ++k)
        accumulate(mine[static_cast<size_t>(k) * vstep]);
    };
    hopper::cp_async_wait<3>();
    chunk(0);
    hopper::cp_async_wait<2>();
    chunk(1);
    hopper::cp_async_wait<1>();
    chunk(2);
    hopper::cp_async_wait<0>();
    chunk(3);
  } else {
    int k = 0;
    for (; k + 4 <= count; k += 4) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = __ldg(reinterpret_cast<const uint4*>(src + (k + u) * stride));
#pragma unroll
      for (int u = 0; u < 4; ++u) accumulate(v[u]);
    }
    for (; k < count; ++k) accumulate(__ldg(reinterpret_cast<const uint4*>(src + k * stride)));
  }

  // ---- 2. per-channel sums: the warp's lanes of one position, the block's
  // warps, then the cluster's blocks
  if (V < 32) {   // lanes V apart share a position
    for (int o = V; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < kVE; ++j) {
        const float t1 = __shfl_down_sync(0xffffffffu, s1[j], o);
        const float t2 = __shfl_down_sync(0xffffffffu, s2[j], o);
        if (lane + o < 32) {
          s1[j] += t1;
          s2[j] += t2;
        }
      }
    }
  }
  if (lane < slots) {
    float4* r = reinterpret_cast<float4*>(red + (warp * slots + lane) * 2 * kVE);
#pragma unroll
    for (int j = 0; j < kVE / 4; ++j) {
      r[j] = make_float4(s1[4 * j], s1[4 * j + 1], s1[4 * j + 2], s1[4 * j + 3]);
      r[kVE / 4 + j] = make_float4(s2[4 * j], s2[4 * j + 1], s2[4 * j + 2], s2[4 * j + 3]);
    }
  }
  __syncthreads();
  for (int q = tid; q < W; q += kThreads) {
    const int pp = q / kVE, j = q - pp * kVE;
    float t1 = 0.f, t2 = 0.f;
    if (V < 32) {   // warp w keeps position pp in slot (pp - 32w) mod V
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int slot = ((pp - 32 * w) % V + V) % V;
        const float* r = red + (w * slots + slot) * 2 * kVE;
        t1 += r[j];
        t2 += r[kVE + j];
      }
    } else {        // one slot a thread
      for (int ll = 0; ll < lanes; ++ll) {
        const float* r = red + (ll * V + pp) * 2 * kVE;
        t1 += r[j];
        t2 += r[kVE + j];
      }
    }
    csum[q] = t1;
    csum[W + q] = t2;
  }
  hopper::cluster_arrive();
  hopper::cluster_wait();
  const float inv_hw = 1.f / static_cast<float>(HW);
  for (int q = tid; q < W; q += kThreads) {
    float v1[kMaxCluster], v2[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < cs) {
        v1[r] = hopper::ld_cluster_f32(csum + q, r);
        v2[r] = hopper::ld_cluster_f32(csum + W + q, r);
      }
    }
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < cs) {
        t1 += v1[r];
        t2 += v2[r];
      }
    }
    const float m = t1 * inv_hw;
    cstat[q] = to_f(xn[cbase + q]) + m;
    cstat[W + q] = fmaxf(t2 - t1 * m, 0.f);
  }
  __syncthreads();
  hopper::cluster_arrive();   // this block has read the other blocks' sums

  // ---- 3. group statistics, a warp a group
  for (int g = warp; g < slab_groups; g += kWarps) {
    const float* mc = cstat + g * gs;
    const float* m2 = cstat + W + g * gs;
    float a = 0.f;
    for (int c = lane; c < gs; c += 32) a += mc[c];
    const float mean = warp_sum(a) / static_cast<float>(gs);
    float b = 0.f;
    for (int c = lane; c < gs; c += 32) {
      const float d = mc[c] - mean;
      b += fmaf(static_cast<float>(HW) * d, d, m2[c]);
    }
    b = warp_sum(b);
    if (lane == 0) {
      gstat[g] = mean;
      gstat[slab_groups + g] = rsqrtf(b / (static_cast<float>(HW) * gs) + eps);
    }
  }
  __syncthreads();

  // ---- 4. the folded affine, y = x·a + b (+ SiLU), written once
  float fa[kVE], fb[kVE];
#pragma unroll
  for (int j = 0; j < kVE; ++j) {
    const int g = active ? (p * kVE + j) / gs : 0;
    fa[j] = sc[j] * gstat[slab_groups + g];
    fb[j] = fmaf(-gstat[g], fa[j], bi[j]);
  }
  auto apply = [&](const uint4& v) {
    float f[kVE];
    to_float<T>(v, f);
#pragma unroll
    for (int j = 0; j < kVE; ++j) {
      float r = fmaf(f[j], fa[j], fb[j]);
      if (kSilu) r = __fdividef(r, 1.f + __expf(-r));
      f[j] = r;
    }
    return from_float<T>(f);
  };
  if constexpr (kResident) {
    for (int k = 0; k < count; ++k)
      *reinterpret_cast<uint4*>(dst + k * stride) = apply(mine[static_cast<size_t>(k) * vstep]);
  } else {
    int k = 0;
    for (; k + 4 <= count; k += 4) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = *reinterpret_cast<const uint4*>(src + (k + u) * stride);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<uint4*>(dst + (k + u) * stride) = apply(v[u]);
    }
    for (; k < count; ++k)
      *reinterpret_cast<uint4*>(dst + k * stride) =
          apply(*reinterpret_cast<const uint4*>(src + k * stride));
  }
  hopper::cluster_wait();     // no block leaves while another may read its sums
}

template <typename T, bool kSilu, bool kResident>
int launch(const void* x, void* y, const float* scale, const float* bias, int N, int HW, int C,
           int G, float eps, int slab_groups, int cluster, cudaStream_t stream) {
  constexpr int kVE = 16 / sizeof(T);
  const int gs = C / G, W = slab_groups * gs;
  const int rows_per_cta = (HW + cluster - 1) / cluster;
  const size_t smem = (kResident ? static_cast<size_t>(rows_per_cta) * W * sizeof(T) : 0) +
                      sizeof(float) * small_floats(W, W / kVE, slab_groups, kVE);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gn_silu_kernel<T, kSilu, kResident>;
  static bool configured = false;   // all of a block's shared memory, clusters of 16
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kMaxSmem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(N) * (G / slab_groups) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                                             static_cast<T*>(y), scale, bias, HW, C, gs,
                                             slab_groups, rows_per_cta, eps);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* y, const float* scale, const float* bias, int N, int HW, int C,
             int G, float eps, int silu, int slab_groups, int cluster, int resident,
             cudaStream_t s) {
  constexpr int kVE = 16 / sizeof(T);
  if (N < 1 || HW < 1 || G < 1 || C % G || slab_groups < 1 || G % slab_groups ||
      C % kVE || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = slab_groups * (C / G);
  if (W % kVE || W / kVE > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (silu) {
    return resident ? launch<T, true, true>(x, y, scale, bias, N, HW, C, G, eps, slab_groups,
                                            cluster, s)
                    : launch<T, true, false>(x, y, scale, bias, N, HW, C, G, eps, slab_groups,
                                             cluster, s);
  }
  return resident ? launch<T, false, true>(x, y, scale, bias, N, HW, C, G, eps, slab_groups,
                                           cluster, s)
                  : launch<T, false, false>(x, y, scale, bias, N, HW, C, G, eps, slab_groups,
                                            cluster, s);
}

}  // namespace

extern "C" {

// x, y: contiguous (N, H·W, C), 16-byte aligned; dtype 0 = float32,
// 1 = bfloat16. scale, bias: (C,) float32. The plan (ops/norms.py
// `plan_group_norm`): slabs of `slab_groups` groups, `cluster` blocks a slab,
// `resident` = the slab's rows stay in shared memory. Returns
// cudaErrorInvalidValue for a plan the kernel cannot run, else
// cudaGetLastError() after the launch.
int c4d_group_norm_silu(const void* x, void* y, const void* scale, const void* bias, int N,
                        int HW, int C, int G, float eps, int silu, int dtype, int slab_groups,
                        int cluster, int resident, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, y, sc, bi, N, HW, C, G, eps, silu, slab_groups, cluster,
                                   resident, s);
  return dispatch<float>(x, y, sc, bi, N, HW, C, G, eps, silu, slab_groups, cluster, resident, s);
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
