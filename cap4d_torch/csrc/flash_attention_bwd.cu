// K6: non-causal multi-head attention backward (dQ, dK, dV), bf16 in and
// out, head dim 64.
//
// Replaces cap4d_tpu/ops/attention.py:42 `_flash_fn` (the library Pallas
// kernels of jax.experimental.pallas.ops.tpu.flash_attention: its dq and dkv
// pallas_calls), which the JAX package reaches from the custom VJP of its
// forward kernel, cap4d_tpu/ops/flash_attention.py:124 `_fwdopt_bwd`.
//
// Contract: given Q, K, V, the forward's output O, the output gradient dO
// (each (B, S, H, 64) bf16 with the head dim contiguous, any strides that are
// multiples of 8) and the forward's row log-sum-exp in base 2 (K1's lse2,
// fp32 (B, H, S)), compute with fp32 accumulation
//   P  = exp2(Q Kᵀ · scale·log2(e) − lse2)      (scale = 1/√64)
//   D  = rowsum(dO ∘ O)
//   dV = Pᵀ dO,   dS = P ∘ (dO Vᵀ − D),   dQ = scale · dS K,   dK = scale · dSᵀ Q
// and write dQ, dK, dV as bf16 (B, S, H, 64). Any S: the ragged key and query
// tiles are masked as in K1.
//
// What bounds it on an H100: five S×S×64 products per head (Q Kᵀ, dO Vᵀ,
// Pᵀ dO, dSᵀ Q, dS K), 10·S²·d flop, against ~9·S·d·2 bytes moved, so the
// tensor cores bound it (989 TFLOP/s bf16 dense).
//
// Design (FlashAttention-2's backward, simple and deterministic: no atomics):
//   1. bwd_dot_kernel: D = rowsum(dO ∘ O) in fp32, eight threads a row.
//   2. bwd_dkdv_kernel: one block of 4 warps owns 64 keys (16 a warp, K and V
//      rows held as mma A fragments) and walks every 64-row query tile. Q and
//      dO tiles stream through shared memory, double-buffered with cp.async,
//      with the tile's lse2 and D. Per tile it recomputes Pᵀ = exp2(K Qᵀ·c −
//      lse2) in registers, adds Pᵀ dO into dV, forms dPᵀ = V dOᵀ and dSᵀ, and
//      adds dSᵀ Q into dK; Pᵀ and dSᵀ go from the accumulator fragments
//      straight into bf16 A fragments, as K1 does with P.
//   3. bwd_dq_kernel: one block owns 64 query rows (Q and dO as A fragments,
//      their lse2 and D in registers) and walks every 64-key tile of K and V
//      (double-buffered), recomputing P and dS and adding dS K into dQ.
// So Q Kᵀ and dO Vᵀ are computed twice (14·S²·d flop in all). P and dS are
// rounded to bf16 before their products, as the forward rounds P.
// All products are mma.sync m16n8k16 (Ampere-style warp MMA); fragments come
// in through ldmatrix. wgmma, TMA and a single pass with an atomic dQ are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kB = 64;        // rows of a block's own tile and of a streamed tile
constexpr int kThreads = 128;
constexpr int kLds = kD + 8;  // padded row (bf16): 144-byte rows, conflict-free

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 2^x in one MUFU op (ex2.approx: ~2 ulp; 2^-inf = 0), as K1 forms P
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte global → shared copy that bypasses registers; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              long long row_stride, int row,
                                              int col, int S) {
  if (row >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * row_stride + col);
}

// the A fragments (16 rows x 64 of d) of rows row0 and row0 + 8
__device__ __forceinline__ void load_a_rows(uint32_t a[kD / 16][4], const __nv_bfloat16* base,
                                            long long row_stride, int row0, int t, int S) {
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    a[kc][0] = load_pair(base, row_stride, row0, c, S);
    a[kc][1] = load_pair(base, row_stride, row0 + 8, c, S);
    a[kc][2] = load_pair(base, row_stride, row0, c + 8, S);
    a[kc][3] = load_pair(base, row_stride, row0 + 8, c + 8, S);
  }
}

// c[nt] = A · Bᵀ for 16 rows x 64 columns, A in registers (k = d), B rows
// (the 64 columns) in shared memory as [col][d]
__device__ __forceinline__ void mma_abt(float c[kB / 8][4], uint32_t a[kD / 16][4],
                                        const __nv_bfloat16* bs, int lane) {
#pragma unroll
  for (int nt = 0; nt < kB / 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < kD / 32; ++kp) {
      uint32_t b4[4];
      ldmatrix_x4(b4, &bs[(nt * 8 + (lane & 7)) * kLds + kp * 32 + (lane >> 3) * 8]);
      mma_16816(c[nt], a[2 * kp], b4[0], b4[1]);
      mma_16816(c[nt], a[2 * kp + 1], b4[2], b4[3]);
    }
  }
}

// acc (16 rows x 64 of d) += X · B, X the 16 x 64 fp32 fragments `x` rounded
// to bf16 A fragments (k = the 64 tile rows), B in shared memory as [row][d]
__device__ __forceinline__ void mma_xb(float acc[kD / 8][4], float x[kB / 8][4],
                                       const __nv_bfloat16* bs, int lane) {
#pragma unroll
  for (int kc = 0; kc < kB / 16; ++kc) {
    uint32_t xa[4];
    xa[0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    xa[1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    xa[2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    xa[3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
    const int brow = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int dt = 0; dt < kD / 16; ++dt) {
      uint32_t b4[4];
      ldmatrix_x4_trans(b4, &bs[brow * kLds + dt * 16 + (lane >> 4) * 8]);
      mma_16816(acc[2 * dt], xa, b4[0], b4[1]);
      mma_16816(acc[2 * dt + 1], xa, b4[2], b4[3]);
    }
  }
}

// 16 rows x 64 of d, rows row0 and row0 + 8 below S, times `mul`, as bf16
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride,
                                           float acc[kD / 8][4], float mul,
                                           int row0, int t, int S) {
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(base + row0 * row_stride + c) =
          pack_bf16(acc[i][0] * mul, acc[i][1] * mul);
    if (row0 + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (row0 + 8) * row_stride + c) =
          pack_bf16(acc[i][2] * mul, acc[i][3] * mul);
  }
}

__global__ void __launch_bounds__(256)
bwd_dot_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
               float* __restrict__ dsum, int H, int S,
               long long o_sb, long long o_ss, long long o_sh,
               long long g_sb, long long g_ss, long long g_sh) {
  const int row = blockIdx.x * 32 + threadIdx.x / 8;
  const int c = (threadIdx.x % 8) * 8;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  float acc = 0.f;
  if (row < S) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * o_sb + h * o_sh + row * o_ss + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + b * g_sb + h * g_sh + row * g_ss + c);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(op[i]), g = __bfloat1622float2(gp[i]);
      acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < S && threadIdx.x % 8 == 0) dsum[static_cast<long long>(blockIdx.y) * S + row] = acc;
}

__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int S,
                long long q_sb, long long q_ss, long long q_sh,
                long long k_sb, long long k_ss, long long k_sh,
                long long v_sb, long long v_ss, long long v_sh,
                long long g_sb, long long g_ss, long long g_sh,
                long long r_sb, long long r_ss, long long r_sh,
                float scale_log2, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs_buf[2][kB * kLds];
  __shared__ __align__(16) __nv_bfloat16 gs_buf[2][kB * kLds];
  __shared__ float lse_buf[2][kB];
  __shared__ float dsum_buf[2][kB];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int key0 = blockIdx.x * kB + warp * 16 + g;  // this lane's keys: key0, key0 + 8

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* gb = dout + b * g_sb + h * g_sh;
  const float* lse_bh = lse + static_cast<long long>(blockIdx.y) * S;
  const float* dsum_bh = dsum + static_cast<long long>(blockIdx.y) * S;

  // this warp's 16 keys of K and V as A fragments (keys >= S load as zeros;
  // their dK, dV rows are computed but not stored)
  uint32_t ka[kD / 16][4], va[kD / 16][4];
  load_a_rows(ka, k + b * k_sb + h * k_sh, k_ss, key0, t, S);
  load_a_rows(va, v + b * v_sb + h * v_sh, v_ss, key0, t, S);

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  // query rows >= S load as zeros with lse2 = +inf, so their P is 0
  auto load_tile = [&](int q0, int buf) {
    for (int i = tid; i < kB * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      const bool valid = q0 + r < S;
      const long long row = valid ? q0 + r : 0;
      cp_async16(&qs_buf[buf][r * kLds + c], qb + row * q_ss + c, valid);
      cp_async16(&gs_buf[buf][r * kLds + c], gb + row * g_ss + c, valid);
    }
    if (tid < kB) {
      const bool valid = q0 + tid < S;
      lse_buf[buf][tid] = valid ? lse_bh[q0 + tid] : CUDART_INF_F;
      dsum_buf[buf][tid] = valid ? dsum_bh[q0 + tid] : 0.f;
    }
  };

  load_tile(0, 0);
  cp_async_commit();
  for (int q0 = 0, buf = 0; q0 < S; q0 += kB, buf ^= 1) {
    if (q0 + kB < S) load_tile(q0 + kB, buf ^ 1);  // prefetch the next tile
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest has landed: tile q0
    __syncthreads();
    const __nv_bfloat16* qs = qs_buf[buf];
    const __nv_bfloat16* gs = gs_buf[buf];
    const float* ls = lse_buf[buf];
    const float* ds = dsum_buf[buf];

    // Pᵀ (16 keys x 64 queries) = exp2(K Qᵀ·scale·log2(e) − lse2[query])
    float p[kB / 8][4];
    mma_abt(p, ka, qs, lane);
#pragma unroll
    for (int nt = 0; nt < kB / 8; ++nt) {
      const float l0 = ls[nt * 8 + 2 * t], l1 = ls[nt * 8 + 2 * t + 1];
      p[nt][0] = fast_exp2(fmaf(p[nt][0], scale_log2, -l0));
      p[nt][1] = fast_exp2(fmaf(p[nt][1], scale_log2, -l1));
      p[nt][2] = fast_exp2(fmaf(p[nt][2], scale_log2, -l0));
      p[nt][3] = fast_exp2(fmaf(p[nt][3], scale_log2, -l1));
    }
    mma_xb(dv_acc, p, gs, lane);  // dV += Pᵀ dO

    // dSᵀ = Pᵀ ∘ (V dOᵀ − D[query])
    float dp[kB / 8][4];
    mma_abt(dp, va, gs, lane);
#pragma unroll
    for (int nt = 0; nt < kB / 8; ++nt) {
      const float d0 = ds[nt * 8 + 2 * t], d1 = ds[nt * 8 + 2 * t + 1];
      dp[nt][0] = p[nt][0] * (dp[nt][0] - d0);
      dp[nt][1] = p[nt][1] * (dp[nt][1] - d1);
      dp[nt][2] = p[nt][2] * (dp[nt][2] - d0);
      dp[nt][3] = p[nt][3] * (dp[nt][3] - d1);
    }
    mma_xb(dk_acc, dp, qs, lane);  // dK += dSᵀ Q (scaled at the store)
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  store_rows(dk + b * r_sb + h * r_sh, r_ss, dk_acc, scale, key0, t, S);
  store_rows(dv + b * r_sb + h * r_sh, r_ss, dv_acc, 1.f, key0, t, S);
}

__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              __nv_bfloat16* __restrict__ dq, int H, int S,
              long long q_sb, long long q_ss, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh,
              long long v_sb, long long v_ss, long long v_sh,
              long long g_sb, long long g_ss, long long g_sh,
              long long r_sb, long long r_ss, long long r_sh,
              float scale_log2, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks_buf[2][kB * kLds];
  __shared__ __align__(16) __nv_bfloat16 vs_buf[2][kB * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row0 = blockIdx.x * kB + warp * 16 + g;  // this lane's rows: row0, row0 + 8

  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const float* lse_bh = lse + static_cast<long long>(blockIdx.y) * S;
  const float* dsum_bh = dsum + static_cast<long long>(blockIdx.y) * S;

  uint32_t qa[kD / 16][4], ga[kD / 16][4];
  load_a_rows(qa, q + b * q_sb + h * q_sh, q_ss, row0, t, S);
  load_a_rows(ga, dout + b * g_sb + h * g_sh, g_ss, row0, t, S);
  // rows >= S: zeros in, nothing stored
  const float l0 = row0 < S ? lse_bh[row0] : 0.f, l1 = row0 + 8 < S ? lse_bh[row0 + 8] : 0.f;
  const float d0 = row0 < S ? dsum_bh[row0] : 0.f, d1 = row0 + 8 < S ? dsum_bh[row0 + 8] : 0.f;

  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // keys >= S load as zeros (their scores are masked to -inf below)
  auto load_tile = [&](int k0, int buf) {
    for (int i = tid; i < kB * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      const bool valid = k0 + r < S;
      const long long row = valid ? k0 + r : 0;
      cp_async16(&ks_buf[buf][r * kLds + c], kb + row * k_ss + c, valid);
      cp_async16(&vs_buf[buf][r * kLds + c], vb + row * v_ss + c, valid);
    }
  };

  load_tile(0, 0);
  cp_async_commit();
  for (int k0 = 0, buf = 0; k0 < S; k0 += kB, buf ^= 1) {
    if (k0 + kB < S) load_tile(k0 + kB, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks = ks_buf[buf];
    const __nv_bfloat16* vs = vs_buf[buf];

    // P (16 rows x 64 keys) = exp2(Q Kᵀ·scale·log2(e) − lse2[row])
    float p[kB / 8][4];
    mma_abt(p, qa, ks, lane);
    if (k0 + kB > S) {  // the ragged last tile: keys >= S score -inf
#pragma unroll
      for (int nt = 0; nt < kB / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k0 + nt * 8 + 2 * t + (j & 1) >= S) p[nt][j] = -CUDART_INF_F;
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kB / 8; ++nt) {
      p[nt][0] = fast_exp2(fmaf(p[nt][0], scale_log2, -l0));
      p[nt][1] = fast_exp2(fmaf(p[nt][1], scale_log2, -l0));
      p[nt][2] = fast_exp2(fmaf(p[nt][2], scale_log2, -l1));
      p[nt][3] = fast_exp2(fmaf(p[nt][3], scale_log2, -l1));
    }

    // dS = P ∘ (dO Vᵀ − D[row])
    float dp[kB / 8][4];
    mma_abt(dp, ga, vs, lane);
#pragma unroll
    for (int nt = 0; nt < kB / 8; ++nt) {
      dp[nt][0] = p[nt][0] * (dp[nt][0] - d0);
      dp[nt][1] = p[nt][1] * (dp[nt][1] - d0);
      dp[nt][2] = p[nt][2] * (dp[nt][2] - d1);
      dp[nt][3] = p[nt][3] * (dp[nt][3] - d1);
    }
    mma_xb(acc, dp, ks, lane);  // dQ += dS K (scaled at the store)
    __syncthreads();
  }

  store_rows(dq + b * r_sb + h * r_sh, r_ss, acc, scale, row0, t, S);
}

}  // namespace

extern "C" {

// q, k, v, o, dout: (B, S, H, 64) bf16 with the head dim contiguous, strides
// in elements (multiples of 8, base pointers 16-byte aligned: checked by the
// Python wrapper). lse: K1's (B, H, S) fp32 base-2 log-sum-exp. dsum:
// (B, H, S) fp32 scratch for D. dq, dk, dv: (B, S, H, 64) bf16 sharing the
// strides r_*. Launches the three kernels on `stream`; returns the first
// cudaGetLastError() that is not cudaSuccess.
int c4d_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* dsum,
                            void* dq, void* dk, void* dv, int B, int S, int H,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long o_sb, long long o_ss, long long o_sh,
                            long long g_sb, long long g_ss, long long g_sh,
                            long long r_sb, long long r_ss, long long r_sh,
                            float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  const float kLog2e = 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* g_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* dsum_ = static_cast<float*>(dsum);

  bwd_dot_kernel<<<dim3((S + 31) / 32, B * H), 256, 0, st>>>(
      static_cast<const bf16*>(o), g_, dsum_, H, S, o_sb, o_ss, o_sh, g_sb, g_ss, g_sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((S + kB - 1) / kB, B * H);
  bwd_dkdv_kernel<<<grid, kThreads, 0, st>>>(
      q_, k_, v_, g_, lse_, dsum_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh,
      r_sb, r_ss, r_sh, scale * kLog2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  bwd_dq_kernel<<<grid, kThreads, 0, st>>>(
      q_, k_, v_, g_, lse_, dsum_, static_cast<bf16*>(dq), H, S,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh,
      r_sb, r_ss, r_sh, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
