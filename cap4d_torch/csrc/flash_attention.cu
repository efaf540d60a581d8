// K1: non-causal multi-head attention forward, bf16 in and out, head dim 64.
//
// Replaces cap4d_tpu/ops/flash_attention.py:45 `_fwd_kernel` (the Pallas
// d=64 forward reached through `flash_attention_fwdopt`).
//
// Contract: out = softmax(Q K^T / sqrt(d)) V per (batch, head), with the
// logits, the running max, the row sums and the P·V accumulator in fp32 and
// P rounded to bf16 before the P·V product (as the TPU kernel does).
//
// What bounds it on an H100: at the MMDM's shapes (S = 512 .. 8192, d = 64)
// the work is 4·S²·d flop per head against 4·S·d·2 bytes, far above the
// card's ~295 flop/byte ridge, so the tensor cores bound it (989 TFLOP/s
// bf16 dense). The design keeps everything but Q/K/V/O out of device memory:
// one block of 4 warps owns 64 query rows; K and V stream through shared
// memory in 64-key tiles; scores, probabilities and the output accumulator
// live in registers in the mma.sync m16n8k16 fragment layout, so the
// probabilities feed the P·V product without a trip through shared memory.
// An online softmax with a running max keeps any logit range finite. The
// ragged last key tile is masked (keys >= S score -inf and load as zeros)
// and rows >= S are not stored, so every S works.
//
// For training, the kernel can also write each row's log-sum-exp in base 2,
// lse2 = m·scale·log2(e) + log2(l) (fp32, (B, H, S)), from the final running
// max m of the raw scores and the row sum l. The backward (K6,
// flash_attention_bwd.cu) recomputes P = exp2(s·scale·log2(e) − lse2) with
// the same scale folding. A null lse pointer writes nothing, and O is the
// same either way.
//
// K/V tiles are double-buffered: cp.async fetches tile j+1 into shared memory
// while the warps compute on tile j; K and V fragments come in through
// ldmatrix, and the softmax takes one FFMA and one ex2.approx per score.
// This version uses mma.sync (Ampere-style warp MMA); wgmma and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // query rows per block (16 per warp)
constexpr int kBK = 64;       // keys per shared-memory tile
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

// 2^x in one MUFU op (ex2.approx: ~2 ulp; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int S,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks_buf[2][kBK * kLds];
  __shared__ __align__(16) __nv_bfloat16 vs_buf[2][kBK * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row0 = blockIdx.x * kBQ + warp * 16 + g;  // this lane's rows: row0, row0 + 8

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;

  // Q as A fragments, one per 16-wide slice of d
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    qa[kc][0] = load_pair(qb, q_ss, row0, c, S);
    qa[kc][1] = load_pair(qb, q_ss, row0 + 8, c, S);
    qa[kc][2] = load_pair(qb, q_ss, row0, c + 8, S);
    qa[kc][3] = load_pair(qb, q_ss, row0 + 8, c + 8, S);
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running max, rows row0 / row0+8
  float l0 = 0.f, l1 = 0.f;                      // this lane's partial row sums

  // keys >= S load as zeros (their scores are masked to -inf below)
  auto load_tile = [&](int k0, int buf) {
    for (int i = tid; i < kBK * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      const bool valid = k0 + r < S;
      const long long row = valid ? k0 + r : 0;
      cp_async16(&ks_buf[buf][r * kLds + c], kb + row * k_ss + c, valid);
      cp_async16(&vs_buf[buf][r * kLds + c], vb + row * v_ss + c, valid);
    }
  };

  load_tile(0, 0);
  cp_async_commit();
  for (int k0 = 0, buf = 0; k0 < S; k0 += kBK, buf ^= 1) {
    if (k0 + kBK < S) load_tile(k0 + kBK, buf ^ 1);  // prefetch the next tile
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest has landed: tile k0
    __syncthreads();
    const __nv_bfloat16* ks = ks_buf[buf];
    const __nv_bfloat16* vs = vs_buf[buf];

    // raw scores q·k for 16 rows x 64 keys: 8 n-tiles of 8 keys; one
    // ldmatrix.x4 brings the K fragments of two 16-wide slices of d
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < kD / 32; ++kp) {
        uint32_t kb4[4];
        ldmatrix_x4(kb4, &ks[(nt * 8 + (lane & 7)) * kLds + kp * 32 + (lane >> 3) * 8]);
        mma_16816(s[nt], qa[2 * kp], kb4[0], kb4[1]);
        mma_16816(s[nt], qa[2 * kp + 1], kb4[2], kb4[3]);
      }
    }

    if (k0 + kBK > S) {  // the ragged last tile: keys >= S score -inf
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (k0 + nt * 8 + 2 * t + (j & 1) >= S) s[nt][j] = -CUDART_INF_F;
        }
      }
    }
    // the max is taken on raw scores; scale·log2(e) > 0 is applied inside exp2
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key k0 < S is always valid, so mx0/mx1 are finite from the first tile on
    const float a0 = fast_exp2((m0 - mx0) * scale_log2);
    const float a1 = fast_exp2((m1 - mx1) * scale_log2);
    const float off0 = -mx0 * scale_log2, off1 = -mx1 * scale_log2;
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < kD / 8; ++i) {
      acc[i][0] *= a0;
      acc[i][1] *= a0;
      acc[i][2] *= a1;
      acc[i][3] *= a1;
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = fast_exp2(fmaf(s[nt][0], scale_log2, off0));
      s[nt][1] = fast_exp2(fmaf(s[nt][1], scale_log2, off0));
      s[nt][2] = fast_exp2(fmaf(s[nt][2], scale_log2, off1));
      s[nt][3] = fast_exp2(fmaf(s[nt][3], scale_log2, off1));
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }

    // acc += P V: the score fragments of n-tiles 2kc, 2kc+1 are the A
    // fragment of the 16-key slice kc; V comes in through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int vrow = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < kD / 16; ++dt) {
        uint32_t vb4[4];
        ldmatrix_x4_trans(vb4, &vs[vrow * kLds + dt * 16 + (lane >> 4) * 8]);
        mma_16816(acc[2 * dt], pa, vb4[0], vb4[1]);
        mma_16816(acc[2 * dt + 1], pa, vb4[2], vb4[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (lse != nullptr && t == 0) {  // the quad shares the row totals; one lane writes
    float* lrow = lse + static_cast<long long>(blockIdx.y) * S;
    if (row0 < S) lrow[row0] = m0 * scale_log2 + log2f(l0);
    if (row0 + 8 < S) lrow[row0 + 8] = m1 * scale_log2 + log2f(l1);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * o_ss + c) =
          pack_bf16(acc[i][0] * inv0, acc[i][1] * inv0);
    if (row0 + 8 < S)
      *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * o_ss + c) =
          pack_bf16(acc[i][2] * inv1, acc[i][3] * inv1);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (B, S, H, 64) bf16 with the head dim contiguous; strides in
// elements (each a multiple of 8, base pointers 16-byte aligned: checked by
// the Python wrapper). lse: (B, H, S) fp32, or null to skip it. Launches on
// `stream`; returns cudaGetLastError().
int c4d_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int S, int H,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long o_sb, long long o_ss, long long o_sh,
                            float scale, void* stream) {
  const float kLog2e = 1.4426950408889634f;
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, S,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
