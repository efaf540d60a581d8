// K6: non-causal multi-head attention backward (dQ, dK, dV), bf16 in and
// out, head dim 64.
//
// Replaces cap4d_tpu/ops/attention.py:42 `_flash_fn` (the library Pallas
// kernels of jax.experimental.pallas.ops.tpu.flash_attention: its dq and dkv
// pallas_calls), which the JAX package reaches from the custom VJP of its
// forward kernel, cap4d_tpu/ops/flash_attention.py:124 `_fwdopt_bwd`.
//
// Contract: given Q, K, V, the forward's output O, the output gradient dO
// (each (B, S, H, 64) bf16 with the head dim contiguous, other strides
// multiples of 8, 16-byte aligned bases) and the forward's row log-sum-exp
// in base 2 (K1's lse2, fp32 (B, H, S)), compute with fp32 accumulation
//   P  = exp2(Q Kᵀ · scale·log2(e) − lse2)      (scale = 1/√64)
//   D  = rowsum(dO ∘ O)
//   dV = Pᵀ dO,   dS = P ∘ (dO Vᵀ − D),   dQ = scale · dS K,   dK = scale · dSᵀ Q
// and write dQ, dK, dV as bf16 (B, S, H, 64). Any S >= 1.
//
// What bounds it on an H100: five S×S×64 products per head (Q Kᵀ, dO Vᵀ,
// Pᵀ dO, dSᵀ Q, dS K), 10·S²·d flop, against ~9·S·d·2 bytes moved, so the
// tensor cores bound it (989 TFLOP/s bf16 dense).
//
// Design (FlashAttention-2/3's single-pass backward for Hopper):
//   1. bwd_prep_kernel: D = rowsum(dO ∘ O) in fp32, lse2 and D copied into
//      workspace rows padded to a multiple of 64 (padding rows: lse2 = +inf,
//      so their P is 0, and D = 0), and the fp32 dQ accumulator zeroed.
//   2. bwd_main_kernel: one block of three warpgroups per 128 keys of one
//      (batch, head). The producer warpgroup's one thread loads the block's
//      K and V once by TMA, then streams 64-row tiles of Q and dO (TMA) with
//      their lse2 and D (bulk copies) through a three-stage ring of
//      full/empty mbarriers. Each of the two consumer warpgroups owns 64 keys
//      and per tile computes Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (wgmma, both operands
//      in shared memory), forms Pᵀ = exp2(Sᵀ·c − lse2) while dPᵀ is still on
//      the tensor cores and dSᵀ = Pᵀ ∘ (dPᵀ − D) while dV += Pᵀ dO runs,
//      rounds both to bf16 A fragments in registers and adds dV += Pᵀ dO and
//      dK += dSᵀ Q (dO and Q read MN-major). Its dSᵀ goes to shared memory,
//      and its dQ partial over its own 64 keys is dQᵀ = Kᵀ dSᵀ, Kᵀ held as
//      A fragments loaded once with ldmatrix.trans; the next tile's Sᵀ and
//      dPᵀ are queued behind it. The partial leaves through a staging buffer
//      in the accumulator's fragment order (conflict-free stores) as one
//      16 KB bulk reduce-add (cp.reduce.async.bulk .add.f32) into the fp32
//      accumulator. The two consumers are independent but take turns (a
//      ping-pong on named barriers) to issue the big batch of products, so
//      one warpgroup's exp2 and dS work runs under the other's products
//      (without the turns, on the H100, it was slower at every training
//      shape).
//   3. bwd_dq_kernel: dQ = scale · accumulator as bf16 (B, S, H, 64), each
//      block transposing one query tile through shared memory.
// That is 10·S²·d flop (the two-pass FlashAttention-2 backward recomputes
// Q Kᵀ and dO Vᵀ: 14·S²·d). P and dS are rounded to bf16 before their
// products, as the forward rounds P. dK and dV are deterministic; dQ's last
// bits vary from run to run with the order in which the key blocks' and the
// two consumers' partials reach the accumulator.

#include <math_constants.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;           // head dim
constexpr int kBN = 128;         // keys per block (64 per consumer warpgroup)
constexpr int kBM = 64;          // query rows per streamed tile
constexpr int kStages = 3;       // Q/dO ring depth
constexpr int kThreads = 384;    // producer + two consumer warpgroups
constexpr int kBarWg = 1;        // named barriers 1, 2: one consumer warpgroup's own
constexpr int kBarTurn = 3;      // named barriers 3, 4: the consumers' turns
constexpr int kDqBlock = kBM * kD;  // fp32 values of one query tile's dQ partial

struct Smem {
  alignas(1024) __nv_bfloat16 k[kBN * kD];
  alignas(1024) __nv_bfloat16 v[kBN * kD];
  alignas(1024) __nv_bfloat16 q[kStages][kBM * kD];
  alignas(1024) __nv_bfloat16 dout[kStages][kBM * kD];
  alignas(1024) __nv_bfloat16 ds[2][64 * kBM];  // each consumer's dSᵀ: 64 keys x 64 queries
  alignas(1024) float dq[2][2][kDqBlock];       // each consumer's dQᵀ partial, 2 buffers
  alignas(16) float lse[kStages][kBM];
  alignas(16) float dsum[kStages][kBM];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + slack to align the base

// dq_acc layout: (B·H, S_pad / 64, 4096) fp32. Block (bh, tile) holds the
// dQᵀ (64 of d x 64 queries) of one query tile in the wgmma accumulator's
// fragment order, as each consumer's staging buffer holds its partial:
// float4 i of thread tid (warp w, lane 4g + t) at i·128 + tid, its four
// values (d 16w + g, query 8i + 2t + {0, 1}) and (d 16w + g + 8, the same).
__device__ __forceinline__ long long dq_block(int bh, int n_tiles, int tile) {
  return (static_cast<long long>(bh) * n_tiles + tile) * kDqBlock;
}

__global__ void __launch_bounds__(256)
bwd_prep_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse_pad,
                float* __restrict__ dsum_pad, float* __restrict__ dq_acc, int H, int S,
                int s_pad, long long o_sb, long long o_ss, long long o_sh,
                long long g_sb, long long g_ss, long long g_sh) {
  const int row = blockIdx.x * 32 + threadIdx.x / 8;  // < s_pad: s_pad is a multiple of 32
  const int c = (threadIdx.x % 8) * 8;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  float acc = 0.f;
  if (row < S) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * o_sb + h * o_sh + row * o_ss + c);
    const uint4 gv =
        *reinterpret_cast<const uint4*>(dout + b * g_sb + h * g_sh + row * g_ss + c);
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
  if (threadIdx.x % 8 == 0) {
    const long long i = static_cast<long long>(bh) * s_pad + row;
    dsum_pad[i] = acc;
    lse_pad[i] = row < S ? lse[static_cast<long long>(bh) * S + row] : CUDART_INF_F;
  }
  // the accumulator is (B·H, S_pad, 64) fp32 in all: zero this row's 8 values
  float4* z =
      reinterpret_cast<float4*>(dq_acc + (static_cast<long long>(bh) * s_pad + row) * kD + c);
  z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__global__ void __launch_bounds__(kThreads, 1)
bwd_main_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_dout,
                const float* __restrict__ lse_pad, const float* __restrict__ dsum_pad,
                float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int H, int S, int s_pad,
                long long r_sb, long long r_ss, long long r_sh, float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kb0 = blockIdx.x * kBN;
  const int n_tiles = s_pad / kBM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------ producer
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&sm.kv_full, 2 * kBN * kD * 2);
      tma_load_4d(sm.k, &map_k, &sm.kv_full, 0, h, kb0, b);
      tma_load_4d(sm.v, &map_v, &sm.kv_full, 0, h, kb0, b);
      const float* lse_bh = lse_pad + static_cast<long long>(bh) * s_pad;
      const float* dsum_bh = dsum_pad + static_cast<long long>(bh) * s_pad;
      for (int j = 0, st = 0, ph = 0; j < n_tiles; ++j) {
        mbar_wait(&sm.empty[st], ph ^ 1);  // both consumers released the stage
        mbar_arrive_expect_tx(&sm.full[st], 2 * kBM * kD * 2 + 2 * kBM * 4);
        tma_load_4d(sm.q[st], &map_q, &sm.full[st], 0, h, j * kBM, b);
        tma_load_4d(sm.dout[st], &map_dout, &sm.full[st], 0, h, j * kBM, b);
        bulk_load(sm.lse[st], lse_bh + j * kBM, kBM * 4, &sm.full[st]);
        bulk_load(sm.dsum[st], dsum_bh + j * kBM, kBM * 4, &sm.full[st]);
        if (++st == kStages) st = 0, ph ^= 1;
      }
    }
    return;
  }

  // -------------------------------------------------- consumers
  reg_alloc<240>();
  const int c = wg - 1;               // this consumer: keys kb0 + 64c .. kb0 + 64c + 63
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;                // accumulator column pair
  const int r0 = warp * 16 + lane / 4;   // this thread's keys r0 and r0 + 8 of the 64
  const __nv_bfloat16* ks = sm.k + c * 64 * kD;
  const __nv_bfloat16* vs = sm.v + c * 64 * kD;
  const int my_bar = kBarWg + c;

  float dk_acc[kD / 2], dv_acc[kD / 2];  // 64 keys x 64 of d, m64n64 layout
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s[kBM / 2], dp[kBM / 2];  // Sᵀ and dPᵀ: 64 keys x 64 queries, d the reduction

  // Kᵀ of this consumer's keys as bf16 A fragments (64 of d x 16 keys each),
  // read transposed from shared memory once, for dQᵀ = Kᵀ dSᵀ
  uint32_t kta[64 / 16][4];
  mbar_wait(&sm.kv_full, 0);
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    const int key = kk * 16 + (lane / 16) * 8 + lane % 8;
    const int col = warp * 16 + ((lane / 8) % 2) * 8;
    ldmatrix_x4_trans(kta[kk], reinterpret_cast<const uint8_t*>(ks) + sw128_offset(key, col));
  }

  // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ of stage st, as two commit groups
  auto issue_s_dp = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_m64n64<0, 0>(s, desc_sw128(ks + kk * 16), desc_sw128(sm.q[st] + kk * 16), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_m64n64<0, 0>(dp, desc_sw128(vs + kk * 16), desc_sw128(sm.dout[st] + kk * 16),
                            kk > 0);
    wgmma_commit();
  };

  if (c == 1) named_arrive(kBarTurn, 256);  // consumer 0 takes the first turn
  mbar_wait(&sm.full[0], 0);
  wgmma_fence();
  issue_s_dp(0);
  for (int j = 0, st = 0, ph = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    // column (query) 8jn + 2t + (e & 1) of accumulator entry 4jn + e
    const float* ls = sm.lse[st];
    const float* dsv = sm.dsum[st];

    // Pᵀ = exp2(Sᵀ·c − lse2) while dPᵀ is still on the tensor cores
    wgmma_wait<1>();
    fence_regs(s);
    uint32_t pa[kBM / 16][4], dsa[kBM / 16][4];  // Pᵀ, dSᵀ as bf16 A fragments
#pragma unroll
    for (int jn = 0; jn < kBM / 8; ++jn) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + jn * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * jn + e] = fast_exp2(fmaf(s[4 * jn + e], scale_log2, (e & 1) ? -l2.y : -l2.x));
    }
#pragma unroll
    for (int kc = 0; kc < kBM / 16; ++kc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kc][i] = pack_bf16(s[8 * kc + 2 * i], s[8 * kc + 2 * i + 1]);
    }
    // dV += Pᵀ dO (dO read MN-major)
    wgmma_fence();
    fence_regs(dv_acc);
#pragma unroll
    for (int kc = 0; kc < kBM / 16; ++kc)
      wgmma_rs_m64n64<1>(dv_acc, pa[kc], desc_sw128(sm.dout[st] + kc * 16 * kD), 1);
    wgmma_commit();

    // dSᵀ = Pᵀ ∘ (dPᵀ − D) while dV runs
    wgmma_wait<1>();
    fence_regs(dp);
#pragma unroll
    for (int jn = 0; jn < kBM / 8; ++jn) {
      const float2 d2 = *reinterpret_cast<const float2*>(dsv + jn * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * jn + e] = s[4 * jn + e] * (dp[4 * jn + e] - ((e & 1) ? d2.y : d2.x));
    }
#pragma unroll
    for (int kc = 0; kc < kBM / 16; ++kc) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dsa[kc][i] = pack_bf16(dp[8 * kc + 2 * i], dp[8 * kc + 2 * i + 1]);
    }
    // dK += dSᵀ Q (Q read MN-major)
    wgmma_fence();
    fence_regs(dk_acc);
#pragma unroll
    for (int kc = 0; kc < kBM / 16; ++kc)
      wgmma_rs_m64n64<1>(dk_acc, dsa[kc], desc_sw128(sm.q[st] + kc * 16 * kD), 1);
    wgmma_commit();

    // dSᵀ into this consumer's shared tile (its last reader, the previous
    // tile's dQᵀ, has completed); 8-column block jn is fragment jn / 2,
    // registers 2(jn % 2) (row r0) and 2(jn % 2) + 1 (row r0 + 8)
    uint8_t* ds_tile = reinterpret_cast<uint8_t*>(sm.ds[c]);
#pragma unroll
    for (int jn = 0; jn < kBM / 8; ++jn) {
      const int col = jn * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(ds_tile + sw128_offset(r0, col)) = dsa[jn / 2][2 * (jn % 2)];
      *reinterpret_cast<uint32_t*>(ds_tile + sw128_offset(r0 + 8, col)) =
          dsa[jn / 2][2 * (jn % 2) + 1];
    }
    fence_proxy_async();
    // this tile's staging buffer was last reduced from two tiles ago
    if (tid == 0) bulk_wait_read<1>();
    named_sync(my_bar, 128);

    // dQᵀ partial (64 of d x 64 queries) = Kᵀ dSᵀ over this consumer's 64
    // keys: Kᵀ in registers, the dSᵀ tile read MN-major
    float dq[kBM / 2];
    named_sync(kBarTurn + c, 256);  // this consumer's turn to issue
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk)
      wgmma_rs_m64n64<1>(dq, kta[kk], desc_sw128(sm.ds[c] + kk * 16 * kBM), kk > 0);
    wgmma_commit();
    // the next tile's Sᵀ and dPᵀ go to the tensor cores behind dQᵀ
    const int st_next = st + 1 == kStages ? 0 : st + 1;
    const int ph_next = st + 1 == kStages ? ph ^ 1 : ph;
    if (j + 1 < n_tiles) {
      mbar_wait(&sm.full[st_next], ph_next);
      issue_s_dp(st_next);
      named_arrive(kBarTurn + 1 - c, 256);  // the other consumer's turn
      wgmma_wait<2>();   // dV, dK and dQᵀ of this tile are done
    } else {
      if (c == 0) named_arrive(kBarTurn + 1, 256);  // consumer 1 issues last
      wgmma_wait<0>();
    }
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(dq);
    if (tid == 0) mbar_arrive(&sm.empty[st]);  // Q, dO, lse2 and D of this tile are done

    // dQᵀ partial → staging in fragment order (float4 i of thread tid at
    // i·128 + tid: conflict-free) → one bulk reduce-add of 16 KB
    float4* stage = reinterpret_cast<float4*>(sm.dq[c][buf]);
#pragma unroll
    for (int i = 0; i < kBM / 8; ++i)
      stage[i * 128 + tid] = make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2], dq[4 * i + 3]);
    fence_proxy_async();
    named_sync(my_bar, 128);
    if (tid == 0) {
      bulk_reduce_add_f32(dq_acc + dq_block(bh, n_tiles, j), sm.dq[c][buf], kDqBlock * 4);
      bulk_commit();
    }
    st = st_next;
    ph = ph_next;
  }
  if (tid == 0) bulk_wait();

  // dK (scaled) and dV for keys < S
  const long long base = b * r_sb + h * r_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kb0 + c * 64 + r0 + 8 * half;
    if (key >= S) continue;
#pragma unroll
    for (int jn = 0; jn < kD / 8; ++jn) {
      const long long i = base + key * r_ss + jn * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + i) =
          pack_bf16(dk_acc[4 * jn + 2 * half] * scale, dk_acc[4 * jn + 2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + i) =
          pack_bf16(dv_acc[4 * jn + 2 * half], dv_acc[4 * jn + 2 * half + 1]);
    }
  }
}

// dQ = scale · the accumulator, bf16 (B, S, H, 64): one block per query
// tile transposes its dQᵀ block through shared memory
__global__ void __launch_bounds__(256)
bwd_dq_kernel(const float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq, int H, int S,
              int s_pad, long long r_sb, long long r_ss, long long r_sh, float scale) {
  __shared__ float tile[kBM][kD + 1];  // [query][d]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const float4* blk =
      reinterpret_cast<const float4*>(dq_acc + dq_block(bh, s_pad / kBM, blockIdx.x));
#pragma unroll
  for (int k = 0; k < kDqBlock / 4 / 256; ++k) {
    const int idx = k * 256 + threadIdx.x;        // float4 i of fragment thread ft
    const int i = idx / 128, ft = idx % 128;
    const int d = (ft / 32) * 16 + (ft % 32) / 4, q = i * 8 + 2 * (ft % 4);
    const float4 x = blk[idx];
    tile[q][d] = x.x * scale;
    tile[q + 1][d] = x.y * scale;
    tile[q][d + 8] = x.z * scale;
    tile[q + 1][d + 8] = x.w * scale;
  }
  __syncthreads();
  const int row = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;  // 16 of d per thread
  const int s = blockIdx.x * kBM + row;
  if (s >= S) return;
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = pack_bf16(tile[row][c + 2 * i], tile[row][c + 2 * i + 1]);
  uint4* dst = reinterpret_cast<uint4*>(dq + b * r_sb + h * r_sh + s * r_ss + c);
  dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
  dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

}  // namespace

extern "C" {

// q, k, v, o, dout: (B, S, H, 64) bf16 with the head dim contiguous, strides
// in elements (multiples of 8, base pointers 16-byte aligned: checked by the
// Python wrapper). lse: K1's (B, H, S) fp32 base-2 log-sum-exp. Workspace:
// lse_pad and dsum_pad (B·H, S_pad) fp32 and dq_acc (B·H, S_pad, 64) fp32,
// S_pad = S rounded up to a multiple of 64. dq, dk, dv: (B, S, H, 64) bf16
// sharing the strides r_*. Launches the three kernels on `stream`; returns
// the first cudaGetLastError() that is not cudaSuccess, or
// cudaErrorInvalidValue when a tensor map cannot be encoded.
int c4d_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* lse_pad, void* dsum_pad,
                            void* dq_acc, void* dq, void* dk, void* dv, int B, int S, int H,
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
  const int s_pad = (S + kBM - 1) / kBM * kBM;
  CUtensorMap mq, mk, mv, mg;
  if (!make_map_bshd(&mq, q, B, S, H, q_sb, q_ss, q_sh, kBM) ||
      !make_map_bshd(&mk, k, B, S, H, k_sb, k_ss, k_sh, kBN) ||
      !make_map_bshd(&mv, v, B, S, H, v_sb, v_ss, v_sh, kBN) ||
      !make_map_bshd(&mg, dout, B, S, H, g_sb, g_ss, g_sh, kBM))
    return static_cast<int>(cudaErrorInvalidValue);
  float* lse_p = static_cast<float*>(lse_pad);
  float* dsum_p = static_cast<float*>(dsum_pad);
  float* acc = static_cast<float*>(dq_acc);

  const dim3 rows_grid(s_pad / 32, B * H);
  bwd_prep_kernel<<<rows_grid, 256, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), lse_p, dsum_p, acc, H, S, s_pad,
      o_sb, o_ss, o_sh, g_sb, g_ss, g_sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  static cudaError_t attr = cudaFuncSetAttribute(
      bwd_main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  bwd_main_kernel<<<dim3((S + kBN - 1) / kBN, B * H), kThreads, kSmemBytes, st>>>(
      mq, mk, mv, mg, lse_p, dsum_p, acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      H, S, s_pad, r_sb, r_ss, r_sh, scale * kLog2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  bwd_dq_kernel<<<dim3(s_pad / kBM, B * H), 256, 0, st>>>(acc, static_cast<bf16*>(dq), H, S,
                                                          s_pad, r_sb, r_ss, r_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
