// K1: non-causal multi-head attention forward, bf16 in and out, head dim 64.
//
// Replaces cap4d_tpu/ops/flash_attention.py:45 `_fwd_kernel` (the Pallas
// d=64 forward reached through `flash_attention_fwdopt`).
//
// Contract: out = softmax(Q K^T / sqrt(d)) V per (batch, head), with the
// logits, the running max, the row sums and the P·V accumulator in fp32 and
// P rounded to bf16 before the P·V product (as the TPU kernel does). Q, K,
// V, O are (B, S, H, 64) views with the head dim contiguous, other strides
// multiples of 8 elements and 16-byte aligned bases (what a TMA tensor map
// needs); any S >= 1.
//
// What bounds it on an H100: at the MMDM's shapes (S = 512 .. 8192, d = 64)
// the work is 4·S²·d flop per head against 4·S·d·2 bytes, far above the
// card's ~295 flop/byte ridge, so the tensor cores bound it (989 TFLOP/s
// bf16 dense). At d = 64 the softmax is as heavy as the products: per score
// the two products are 256 flop (1/16 of a clock of an SM's tensor cores)
// and the exp2 is one MUFU op (also 1/16 of a clock at 16 a clock), so the
// softmax has to run while the tensor cores work on other rows.
//
// Design (FlashAttention-3's forward for Hopper): one block of four
// warpgroups owns 192 query rows of one (batch, head).
//   - Warpgroup 0 is the producer: one thread issues TMA loads, Q once, then
//     K and V in 128-key tiles into a three-stage ring guarded by full/empty
//     mbarriers. It gives its registers up (setmaxnreg) to the consumers.
//   - Warpgroups 1-3 are consumers, 64 query rows each. S = Q·Kᵀ is a wgmma
//     with both operands in 128B-swizzled shared memory; O += P·V is a wgmma
//     with P taken from the fp32 score accumulator straight into bf16 A
//     fragments in registers, and V read from shared memory MN-major (the
//     transpose bit), so P never touches shared memory.
//   - Each consumer issues the Q·Kᵀ of tile j together with the P·V of tile
//     j-1 and waits for the first alone, so its softmax of tile j runs while
//     its own P·V is on the tensor cores (the intra-warpgroup overlap).
//   - The consumers take turns on named barriers (a ping-pong, round robin
//     over three): each issues its products only after the previous one
//     has issued its own, so one warpgroup's max, exp2 and rescale run while
//     the tensor cores work for the others.
//   Three consumers rather than two: 192-row blocks read each K/V tile for
//   1.5x the rows (a third less L2 traffic) and keep a third warpgroup's
//   products queued; on the H100 the two-consumer version of this kernel
//   was slower at every main-path shape of S >= 4096.
// The TMA tensor maps are built on the host for each call over the caller's
// strides (4-D: d, H, S, B), so the UNet's strided views are read in place.
// TMA zero-fills rows >= S; keys >= S still score -inf (a zero key would
// score 0). O leaves through shared memory and a TMA store, which writes
// rows < S only; lse2 is stored for rows < S.
//
// For training, the kernel can also write each row's log-sum-exp in base 2,
// lse2 = m·scale·log2(e) + log2(l) (fp32, (B, H, S)), from the final running
// max m of the raw scores and the row sum l. The backward (K6,
// flash_attention_bwd.cu) recomputes P = exp2(s·scale·log2(e) − lse2) with
// the same scale folding. A null lse pointer writes nothing, and O is the
// same either way.

#include <math_constants.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;           // head dim: one 128-byte row per key or query
constexpr int kConsumers = 3;    // consumer warpgroups, 64 query rows each
constexpr int kBM = 64 * kConsumers;  // query rows per block
constexpr int kBN = 128;         // keys per tile
constexpr int kStages = 3;       // K/V ring depth
constexpr int kThreads = 128 * (kConsumers + 1);  // producer + consumer warpgroups
constexpr int kTileBytes = kBN * kD * 2;
constexpr int kBarTurn = 1;      // named barriers 1 ..: the consumers' turns
constexpr int kBarEpilogue = 1 + kConsumers;  // then one per consumer's epilogue
// setmaxnreg: the producer keeps 32 registers, each consumer thread gets
// 160 (128·32 + 384·160 = 65,536, the register file)
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;

struct Smem {
  alignas(1024) __nv_bfloat16 q[kBM * kD];
  alignas(1024) __nv_bfloat16 k[kStages][kBN * kD];
  alignas(1024) __nv_bfloat16 v[kStages][kBN * kD];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + slack to align the base

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_o,
                 float* __restrict__ lse, int H, int S, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int m0 = blockIdx.x * kBM;
  const int n_tiles = (S + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------ producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kBM * kD * 2);
      tma_load_4d(sm.q, &map_q, &sm.q_full, 0, h, m0, b);
      for (int j = 0, st = 0, ph = 0; j < n_tiles; ++j) {
        mbar_wait(&sm.empty[st], ph ^ 1);  // both consumers released the stage
        mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes);
        tma_load_4d(sm.k[st], &map_k, &sm.full[st], 0, h, j * kBN, b);
        tma_load_4d(sm.v[st], &map_v, &sm.full[st], 0, h, j * kBN, b);
        if (++st == kStages) st = 0, ph ^= 1;
      }
    }
    return;
  }

  // -------------------------------------------------- consumers
  reg_alloc<kConsumerRegs>();
  const int c = wg - 1;               // this consumer: rows m0 + 64c .. m0 + 64c + 63
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;                // accumulator column pair
  const int r0 = warp * 16 + lane / 4;   // this thread's rows r0 and r0 + 8 of the 64
  const __nv_bfloat16* qs = sm.q + c * 64 * kD;
  const int my_turn = kBarTurn + c, next_turn = kBarTurn + (c + 1) % kConsumers;

  float o[kD / 2];   // O: 64 rows x 64, the m64n64 accumulator layout
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  float s[kBN / 2];         // S: 64 rows x 128 keys, the m64n128 accumulator layout
  uint32_t p[kBN / 16][4];  // P of the previous tile as bf16 A fragments, one per 16 keys
  float m_0 = -CUDART_INF_F, m_1 = -CUDART_INF_F;  // running max of rows r0, r0 + 8
  float l_0 = 0.f, l_1 = 0.f;                      // this thread's partial row sums

  // S = Q K_stᵀ: 16 of d per step, 32 bytes along the 128-byte rows
  auto issue_qk = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_m64n128<0, 0>(s, desc_sw128(qs + kk * 16), desc_sw128(sm.k[st] + kk * 16),
                             kk > 0);
  };
  // O += P V_st: 16 keys per step, 16 rows of V read MN-major
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc)
      wgmma_rs_m64n64<1>(o, p[kc], desc_sw128(sm.v[st] + kc * 16 * kD), 1);
  };
  // S of keys k0 .. k0 + 127 → exp2 in place, the running max and sums
  // updated; returns the factors (a0, a1) that rescale O's rows
  auto softmax = [&](int k0) {
    if (k0 + kBN > S) {  // the ragged last tile: keys >= S score -inf
#pragma unroll
      for (int jn = 0; jn < kBN / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + jn * 8 + 2 * t + (e & 1) >= S) s[4 * jn + e] = -CUDART_INF_F;
        }
      }
    }
    // the max is taken on raw scores; scale·log2(e) > 0 is applied inside exp2
    float mx0 = m_0, mx1 = m_1;
#pragma unroll
    for (int jn = 0; jn < kBN / 8; ++jn) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * jn], s[4 * jn + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * jn + 2], s[4 * jn + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // key k0 < S is always valid, so mx0/mx1 are finite from the first tile on
    const float a0 = fast_exp2((m_0 - mx0) * scale_log2);
    const float a1 = fast_exp2((m_1 - mx1) * scale_log2);
    const float off0 = -mx0 * scale_log2, off1 = -mx1 * scale_log2;
    m_0 = mx0;
    m_1 = mx1;
    l_0 *= a0;
    l_1 *= a1;
#pragma unroll
    for (int jn = 0; jn < kBN / 8; ++jn) {
      s[4 * jn] = fast_exp2(fmaf(s[4 * jn], scale_log2, off0));
      s[4 * jn + 1] = fast_exp2(fmaf(s[4 * jn + 1], scale_log2, off0));
      s[4 * jn + 2] = fast_exp2(fmaf(s[4 * jn + 2], scale_log2, off1));
      s[4 * jn + 3] = fast_exp2(fmaf(s[4 * jn + 3], scale_log2, off1));
      l_0 += s[4 * jn] + s[4 * jn + 1];
      l_1 += s[4 * jn + 2] + s[4 * jn + 3];
    }
    return make_float2(a0, a1);
  };
  // the accumulator's 8-key column blocks 2kc, 2kc+1 form the A fragment of
  // keys 16kc .. 16kc+15
  auto pack_p = [&]() {
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      p[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
      p[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
      p[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
      p[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
  };

  if (c == kConsumers - 1) named_arrive(kBarTurn, 256);  // consumer 0 issues first
  mbar_wait(&sm.q_full, 0);

  // tile 0: S alone
  mbar_wait(&sm.full[0], 0);
  named_sync(my_turn, 256);
  wgmma_fence();
  issue_qk(0);
  wgmma_commit();
  named_arrive(next_turn, 256);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0);
  pack_p();

  // tile j: S_j = Q K_jᵀ and O += P_{j-1} V_{j-1} issued together; the
  // softmax of S_j runs while P_{j-1} V_{j-1} (and the other consumer's
  // products) occupy the tensor cores
  int prev = 0, st = kStages > 1 ? 1 : 0, ph = kStages > 1 ? 0 : 1;
  for (int j = 1; j < n_tiles; ++j) {
    mbar_wait(&sm.full[st], ph);
    named_sync(my_turn, 256);
    wgmma_fence();
    fence_regs(o);
    issue_qk(st);
    wgmma_commit();
    issue_pv(prev);
    wgmma_commit();
    named_arrive(next_turn, 256);
    wgmma_wait<1>();   // S_j is in; P_{j-1} V_{j-1} may still run
    fence_regs(s);
    const float2 a = softmax(j * kBN);
    wgmma_wait<0>();
    fence_regs(o);
    if (tid == 0) mbar_arrive(&sm.empty[prev]);  // K and V of tile j-1 are done
#pragma unroll
    for (int jn = 0; jn < kD / 8; ++jn) {
      o[4 * jn] *= a.x;
      o[4 * jn + 1] *= a.x;
      o[4 * jn + 2] *= a.y;
      o[4 * jn + 3] *= a.y;
    }
    pack_p();
    prev = st;
    if (++st == kStages) st = 0, ph ^= 1;
  }

  // the last tile's P·V
  named_sync(my_turn, 256);
  wgmma_fence();
  fence_regs(o);
  issue_pv(prev);
  wgmma_commit();
  if (c != kConsumers - 1) named_arrive(next_turn, 256);  // the last issuer has no successor
  wgmma_wait<0>();
  fence_regs(o);
  if (tid == 0) mbar_arrive(&sm.empty[prev]);

  l_0 += __shfl_xor_sync(0xffffffffu, l_0, 1);
  l_0 += __shfl_xor_sync(0xffffffffu, l_0, 2);
  l_1 += __shfl_xor_sync(0xffffffffu, l_1, 1);
  l_1 += __shfl_xor_sync(0xffffffffu, l_1, 2);
  const int row = m0 + c * 64 + r0;
  if (lse != nullptr && t == 0) {  // the quad shares the row totals; one lane writes
    float* lrow = lse + static_cast<long long>(blockIdx.y) * S;
    if (row < S) lrow[row] = m_0 * scale_log2 + log2f(l_0);
    if (row + 8 < S) lrow[row + 8] = m_1 * scale_log2 + log2f(l_1);
  }
  // O through this consumer's Q rows (its last Q·Kᵀ has completed) and a TMA store
  const float inv0 = 1.f / l_0, inv1 = 1.f / l_1;
  uint8_t* stage = reinterpret_cast<uint8_t*>(sm.q + c * 64 * kD);
#pragma unroll
  for (int jn = 0; jn < kD / 8; ++jn) {
    const int col = jn * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(stage + sw128_offset(r0, col)) =
        pack_bf16(o[4 * jn] * inv0, o[4 * jn + 1] * inv0);
    *reinterpret_cast<uint32_t*>(stage + sw128_offset(r0 + 8, col)) =
        pack_bf16(o[4 * jn + 2] * inv1, o[4 * jn + 3] * inv1);
  }
  fence_proxy_async();
  named_sync(kBarEpilogue + c, 128);
  if (tid == 0) {
    tma_store_4d(&map_o, stage, 0, h, m0 + c * 64, b);
    bulk_commit();
    bulk_wait_read();
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (B, S, H, 64) bf16 with the head dim contiguous; strides in
// elements (each a multiple of 8, base pointers 16-byte aligned: checked by
// the Python wrapper). lse: (B, H, S) fp32, or null to skip it. Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue when a
// tensor map cannot be encoded.
int c4d_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int S, int H,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long o_sb, long long o_ss, long long o_sh,
                            float scale, void* stream) {
  const float kLog2e = 1.4426950408889634f;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map_bshd(&mq, q, B, S, H, q_sb, q_ss, q_sh, kBM) ||
      !make_map_bshd(&mk, k, B, S, H, k_sb, k_ss, k_sh, kBN) ||
      !make_map_bshd(&mv, v, B, S, H, v_sb, v_ss, v_sh, kBN) ||
      !make_map_bshd(&mo, o, B, S, H, o_sb, o_ss, o_sh, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  static cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + kBM - 1) / kBM, B * H);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mo, static_cast<float*>(lse), H, S, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
