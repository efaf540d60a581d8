// K7: the op-mix micro-benchmark. Per case, acc <- body(acc, x) NITER times
// from acc = 0.5·x over one (rows, 256) float32 block; the kernel returns acc.
//
// Replaces tools/bench_vpu_ops.py:37 `make_loop` (its `pallas_call` at :52):
// one serial while-loop per case over a block resident in fast memory, no
// traffic to device memory inside the loop. The cases are the 15 bodies of
// that file's CASES table, in its order (case ids below).
//
// Semantics kept exactly, case by case:
//   - rolls follow jnp.roll: roll(a, s)[i] = a[(i - s) mod 256] along a row;
//   - the split-bf16 products: hi = bf16_rn(a), lo = bf16_rn(a - hi), products
//     of bf16 values (exact in fp32) accumulated in fp32;
//   - scan8's term p is the exclusive lane prefix product of acc, the
//     acc_matmul terms are the (row, 5) products with cmat = [x0, x1, x2, 1,
//     x3] (the block's first four rows), added at x1e-12;
//   - the tri cases are exclusive lane prefix sums of hi and lo, whole-row or
//     in segments of 128 / 64 lanes with the cascaded carries of the blocked
//     forms (carry = last prefix + last raw value of the previous segment).
//
// Design. Rows are independent in every case, so blocks never communicate.
//   - The elementwise cases (base, mul, exp, log1p, log, exp2, div, where)
//     keep one element a thread in blocks of 256 threads, one row a block:
//     65,536 independent chains, all in flight.
//   - The cross-lane cases (roll_sel_mul, scan8, acc_matmul3/2, tri_matmul2,
//     tri_blocked, tri_blocked4) run one row a warp, a block of 32 threads:
//     lane j holds elements 8j .. 8j + 7 in registers. A roll by s < 8 moves
//     the top s registers one lane up with a shuffle each and the rest
//     within the lane; a roll by 8m moves every register m lanes. scan8
//     runs the plain version's Hillis-Steele products in six shuffle rounds
//     (steps 1-4 within a window of the lane and the previous one, then
//     steps 8 to 128 by whole registers), so its term rounds as the plain
//     version's does. Prefix sums are an in-register scan, a scan of the
//     lane totals within groups of 8 lanes and the group totals; row sums
//     are in-register FMA chains, a butterfly within groups of 8 lanes and
//     the four group sums. No shared memory and no block barrier inside the
//     loop. The bf16 splits alternate between the conversion unit and the
//     integer pipe (the same round-to-nearest-even on the bits).
// Each case is its own template instance (the switch on the case runs once,
// outside the timed loop). The loop is unrolled kUnroll times (a remainder
// loop takes niter % kUnroll), so the counter, compare and branch are shared
// by kUnroll iterations. Products and sums go through the round-to-nearest
// intrinsics where the plain version rounds twice (no FMA contraction): the
// elementwise cases round as PyTorch's kernels do. The acc_matmul products
// are FMAs: a product of two bf16 values is exact in fp32, so
// fma(a, b, c) = round(a·b + c) equals add(mul(a, b), c).
//
// What bounds it on an H100: each lane runs one serial dependency chain. The
// elementwise cases have 15.5 warps an SM to hide it behind; the cross-lane
// cases have 256 warps for 528 schedulers, so their time is one warp's
// chain of shuffles and arithmetic an iteration. Its floor is the pipe each
// case loads (FP32, MUFU, shuffle, conversions) at its op count per element
// over its rate (cap4d_torch/tools/bench_ops.py counts it); the matmul cases
// run as FMA loops, not on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;  // CH: lanes of a row, threads of an elementwise block
constexpr int kPer = 8;      // elements a lane holds in the one-row-a-warp layout
constexpr int K = 4;         // extra-op repetitions of the elementwise cases
constexpr int kUnroll = 4;   // iterations of the timed loop per pass (ops/op_mix.py UNROLL)
constexpr unsigned kFull = 0xffffffffu;

enum Case {
  BASE = 0, MUL, EXP, LOG1P, ROLL_SEL_MUL, SCAN8, LOG, EXP2, DIV, WHERE,
  ACC_MATMUL3, ACC_MATMUL2, TRI_MATMUL2, TRI_BLOCKED, TRI_BLOCKED4, N_CASES
};

// the cases that run one row a warp
__host__ __device__ constexpr bool row_per_warp(int c) {
  return c == ROLL_SEL_MUL || c == SCAN8 || c >= ACC_MATMUL3;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float bf16r(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}
// the same rounding (to nearest, ties to even; a finite) on the integer pipe,
// so that the splits of one lane's 8 values share two pipes
__device__ __forceinline__ float bf16r_int(float a) {
  const unsigned u = __float_as_uint(a);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}
// register k's rounding: the conversion unit for even k, integers for odd k
__device__ __forceinline__ float bf16r_k(float a, int k) {
  return k % 2 ? bf16r_int(a) : bf16r(a);
}
// acc * 0.999999 + 1e-9, rounded after each op as the plain version does
__device__ __forceinline__ float tail(float acc) { return add(mul(acc, 0.999999f), 1e-9f); }

// ------------------------------------------------ one element a thread

// One application of elementwise case C's body to a lane's acc.
template <int C>
__device__ __forceinline__ float body_elem(float acc, float x) {
  if constexpr (C == BASE) {
    return tail(acc);
  } else if constexpr (C == MUL) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc = mul(acc, x);
    return tail(acc);
  } else if constexpr (C == EXP) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc = expf(-fabsf(acc));
    return tail(acc);
  } else if constexpr (C == LOG1P) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc = log1pf(fminf(fabsf(acc), 0.9f));
    return tail(acc);
  } else if constexpr (C == LOG) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc = logf(add(fabsf(acc), 0.5f));
    return tail(acc);
  } else if constexpr (C == EXP2) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc = exp2f(-fabsf(acc));
    return tail(acc);
  } else if constexpr (C == DIV) {
    const float den = add(fabsf(x), 1.001f);
#pragma unroll
    for (int i = 0; i < K; ++i) acc = __fdiv_rn(acc, den);
    return tail(acc);
  } else {
    static_assert(C == WHERE, "not an elementwise case");
    const bool keep = x > 0.5f;
#pragma unroll
    for (int i = 0; i < K; ++i) acc = keep ? acc : mul(acc, 0.5f);
    return tail(acc);
  }
}

// ------------------------------------------------ one row a warp

// What a lane holds for the whole loop besides acc: the bf16 split of its
// columns of cmat = [x0, x1, x2, 1, x3] (the acc_matmul cases only).
struct Cmat {
  float bh[5][kPer], bl[5][kPer];
};

// v from the lane m below, register by register (lanes < m get their own)
__device__ __forceinline__ void lanes_up(const float (&v)[kPer], float (&out)[kPer], int m) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) out[k] = __shfl_up_sync(kFull, v[k], m);
}

// a[k] *= roll(a, S)[k] where the element index 8·lane + k >= S:
// Hillis-Steele's step S, one shuffle round
template <int S>
__device__ __forceinline__ void roll_mul(float (&a)[kPer], int lane) {
  constexpr int m = S / kPer, s = S % kPer;   // S = 8m (m >= 1) or s < 8
  float r[kPer];
  if constexpr (s == 0) {
    lanes_up(a, r, m);
  } else {
#pragma unroll
    for (int k = 0; k < s; ++k) r[k] = __shfl_up_sync(kFull, a[kPer - s + k], 1);
#pragma unroll
    for (int k = s; k < kPer; ++k) r[k] = a[k - s];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const bool first = s == 0 ? lane < m : (k < s && lane == 0);
    a[k] = first ? a[k] : mul(a[k], r[k]);
  }
}

// scan8's p: the exclusive prefix product of a by the plain version's
// Hillis-Steele steps (p = roll(a, 1) with 1 at element 0, then p[e] *=
// p[e - s] for s = 1, 2, ..., 128 where e >= s), every product taken with
// the same operands as there, in six shuffle rounds instead of nine: a lane
// takes the previous lane's a (ones below element 0, which leave every
// product of a step unchanged where e < s) and runs steps 1-4 over a window
// of 15 elements, then steps 8m from the lane m below, whole registers;
// where the whole lane is below a step, its products are skipped.
__device__ __forceinline__ void prefix_product(const float (&a)[kPer], float (&p)[kPer],
                                               int lane) {
  float ap[kPer];
  lanes_up(a, ap, 1);                         // round 1
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) ap[k] = 1.f;
  }
  // window w = -7 .. 7 at index w + 7: p0[w] = a[w - 1] (element -1: the 1)
  float w0[15], w1[15], w2[15];
#pragma unroll
  for (int i = 0; i < 15; ++i) w0[i] = i - 8 < 0 ? ap[i - 8 + kPer] : a[i - 8];
#pragma unroll
  for (int i = 1; i < 15; ++i) w1[i] = mul(w0[i], w0[i - 1]);
#pragma unroll
  for (int i = 3; i < 15; ++i) w2[i] = mul(w1[i], w1[i - 2]);
#pragma unroll
  for (int k = 0; k < kPer; ++k) p[k] = mul(w2[k + 7], w2[k + 3]);
#pragma unroll
  for (int m = 1; m <= 16; m <<= 1) {         // steps 8m: rounds 2-6
    float r[kPer];
    lanes_up(p, r, m);
    if (lane >= m) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) p[k] = mul(p[k], r[k]);
    }
  }
}

// Sum over the row's 32 lanes, the same in every lane and in the same
// order: a butterfly within each group of 8 lanes, then the four group sums
// from lanes 0, 8, 16, 24 (four shuffle rounds)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) v = add(v, __shfl_xor_sync(kFull, v, off));
  const float g0 = __shfl_sync(kFull, v, 0), g1 = __shfl_sync(kFull, v, 8);
  const float g2 = __shfl_sync(kFull, v, 16), g3 = __shfl_sync(kFull, v, 24);
  return add(add(g0, g1), add(g2, g3));
}

// q[k] = dot(hi, u) + dot(lo, u) with u strictly upper triangular over
// segments of L elements, plus the blocked forms' cascaded carries: an
// inclusive scan of the lane totals within each group of 8 lanes (64
// elements, three shuffle rounds), the group totals from the lanes that end
// them (one round), then, for L < 256, each segment's last exclusive prefix
// and raw value (one round). A lane's exclusive offset is the groups before
// it in its segment plus its group scan less its own total.
template <int L>
__device__ __forceinline__ void tri_prefix(const float (&a)[kPer], float (&q)[kPer], int lane) {
  constexpr int kGroup = 8;                      // lanes of a group
  constexpr int kGroupsPerSeg = L / (kPer * kGroup);
  constexpr int kSegs = kLanes / L;
  float hi[kPer], lo[kPer], eh[kPer], el[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    hi[k] = bf16r_k(a[k], k);
    lo[k] = bf16r_k(sub(a[k], hi[k]), k + 1);
  }
  eh[0] = el[0] = 0.f;   // exclusive prefixes within the lane
#pragma unroll
  for (int k = 1; k < kPer; ++k) {
    eh[k] = add(eh[k - 1], hi[k - 1]);
    el[k] = add(el[k - 1], lo[k - 1]);
  }
  const float th = add(add(add(hi[0], hi[1]), add(hi[2], hi[3])),
                       add(add(hi[4], hi[5]), add(hi[6], hi[7])));
  const float tl = add(add(add(lo[0], lo[1]), add(lo[2], lo[3])),
                       add(add(lo[4], lo[5]), add(lo[6], lo[7])));
  const int gl = lane % kGroup, g = lane / kGroup;
  float ih = th, il = tl;                        // inclusive scan within the group
#pragma unroll
  for (int off = 1; off < kGroup; off <<= 1) {
    const float nh = __shfl_up_sync(kFull, ih, off, kGroup);
    const float nl = __shfl_up_sync(kFull, il, off, kGroup);
    if (gl >= off) {
      ih = add(ih, nh);
      il = add(il, nl);
    }
  }
  float oh = sub(ih, th), ol = sub(il, tl);
  if constexpr (kGroupsPerSeg > 1) {
    float gh[kGroupsPerSeg - 1], glo[kGroupsPerSeg - 1];   // the segment's earlier groups
    const int g0 = (g / kGroupsPerSeg) * kGroupsPerSeg;
#pragma unroll
    for (int j = 0; j < kGroupsPerSeg - 1; ++j) {
      gh[j] = __shfl_sync(kFull, ih, kGroup * (g0 + j) + kGroup - 1);
      glo[j] = __shfl_sync(kFull, il, kGroup * (g0 + j) + kGroup - 1);
    }
    float bh = 0.f, bl = 0.f;
#pragma unroll
    for (int j = 0; j < kGroupsPerSeg - 1; ++j) {
      if (g0 + j < g) {
        bh = add(bh, gh[j]);
        bl = add(bl, glo[j]);
      }
    }
    oh = add(bh, oh);
    ol = add(bl, ol);
  }
  const float o = add(oh, ol);
#pragma unroll
  for (int k = 0; k < kPer; ++k) q[k] = add(o, add(eh[k], el[k]));
  if constexpr (kSegs > 1) {
    // e_j = q_j + carry_j; carry_{j+1} = e_j[L - 1] + p_j[L - 1]
    const int seg = lane / (L / kPer);
    float carry = 0.f;
#pragma unroll
    for (int j = 0; j < kSegs - 1; ++j) {
      const float q_last = __shfl_sync(kFull, q[kPer - 1], (j + 1) * (L / kPer) - 1);
      const float p_last = __shfl_sync(kFull, a[kPer - 1], (j + 1) * (L / kPer) - 1);
      if (j < seg) carry = add(j == 0 ? q_last : add(q_last, carry), p_last);
    }
    if (seg > 0) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) q[k] = add(q[k], carry);
    }
  }
}

// One application of cross-lane case C's body to a lane's 8 elements. With
// kTerm, the extra term (scan8's p, the acc_matmul cases' (5,) row
// products) is written to `term` (the row's part).
template <int C, bool kTerm>
__device__ __forceinline__ void body_row(float (&a)[kPer], const Cmat& cm, int lane,
                                         float* term) {
  if constexpr (C == ROLL_SEL_MUL) {
    roll_mul<1>(a, lane);
    roll_mul<2>(a, lane);
    roll_mul<4>(a, lane);
    roll_mul<8>(a, lane);
#pragma unroll
    for (int k = 0; k < kPer; ++k) a[k] = tail(a[k]);
  } else if constexpr (C == SCAN8) {
    float p[kPer];
    prefix_product(a, p, lane);
    if constexpr (kTerm) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) term[kPer * lane + k] = p[k];
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) a[k] = add(mul(a[k], 0.999999f), mul(p[k], 1e-12f));
  } else if constexpr (C == ACC_MATMUL3 || C == ACC_MATMUL2) {
    // per column c: the lane's products accumulated by FMA in two chains
    // (even and odd elements): hi·b_hi + hi·b_lo + lo·b_hi (3 passes) or
    // hi·b_hi + lo·b_hi (2)
    float v0[5], v1[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) v0[c] = v1[c] = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float hi = bf16r_k(a[k], k);
      const float lo = bf16r_k(sub(a[k], hi), k + 1);
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        float& v = k % 2 ? v1[c] : v0[c];
        v = __fmaf_rn(hi, cm.bh[c][k], v);
        if constexpr (C == ACC_MATMUL3) v = __fmaf_rn(hi, cm.bl[c][k], v);
        v = __fmaf_rn(lo, cm.bh[c][k], v);
      }
    }
    float v[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) v[c] = row_sum(add(v0[c], v1[c]));
    if constexpr (kTerm) {
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 5; ++c) term[c] = v[c];
      }
    }
    const float s = add(add(add(add(v[0], v[1]), v[2]), v[3]), v[4]);
#pragma unroll
    for (int k = 0; k < kPer; ++k) a[k] = add(mul(a[k], 0.999999f), mul(s, 1e-12f));
  } else {
    static_assert(C == TRI_MATMUL2 || C == TRI_BLOCKED || C == TRI_BLOCKED4, "not a row case");
    constexpr int L = C == TRI_MATMUL2 ? 256 : C == TRI_BLOCKED ? 128 : 64;
    float q[kPer];
    tri_prefix<L>(a, q, lane);
#pragma unroll
    for (int k = 0; k < kPer; ++k) a[k] = add(mul(q[k], 1e-6f), 0.5f);
  }
}

// A lane's 8 elements of row `row` and, for the acc_matmul cases, its
// columns of cmat split in bf16.
template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ x, int row, int lane,
                                         float (&xv)[kPer], Cmat& cm) {
  const float4* src = reinterpret_cast<const float4*>(x + row * kLanes + kPer * lane);
  const float4 u = src[0], w = src[1];
  xv[0] = u.x; xv[1] = u.y; xv[2] = u.z; xv[3] = u.w;
  xv[4] = w.x; xv[5] = w.y; xv[6] = w.z; xv[7] = w.w;
  if constexpr (C == ACC_MATMUL3 || C == ACC_MATMUL2) {
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const int xr = c < 3 ? c : 3;   // cmat row c is x row xr; row 3 is ones
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float v = c == 3 ? 1.f : x[xr * kLanes + kPer * lane + k];
        cm.bh[c][k] = bf16r(v);
        cm.bl[c][k] = bf16r(sub(v, cm.bh[c][k]));
      }
    }
  }
}

// ------------------------------------------------ kernels

template <int C>
__global__ void __launch_bounds__(kLanes)
op_mix_loop(const float* __restrict__ x, float* __restrict__ out, int niter) {
  int j = 0;
  if constexpr (row_per_warp(C)) {
    const int lane = threadIdx.x, row = blockIdx.x;
    float a[kPer];
    Cmat cm;
    load_row<C>(x, row, lane, a, cm);
#pragma unroll
    for (int k = 0; k < kPer; ++k) a[k] = mul(a[k], 0.5f);
    for (; j + kUnroll <= niter; j += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) body_row<C, false>(a, cm, lane, nullptr);
    }
#pragma unroll 1
    for (; j < niter; ++j) body_row<C, false>(a, cm, lane, nullptr);
    float4* dst = reinterpret_cast<float4*>(out + row * kLanes + kPer * lane);
    dst[0] = make_float4(a[0], a[1], a[2], a[3]);
    dst[1] = make_float4(a[4], a[5], a[6], a[7]);
  } else {
    const int i = blockIdx.x * kLanes + threadIdx.x;
    const float xv = x[i];
    float acc = mul(xv, 0.5f);
    for (; j + kUnroll <= niter; j += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = body_elem<C>(acc, xv);
    }
#pragma unroll 1
    for (; j < niter; ++j) acc = body_elem<C>(acc, xv);
    out[i] = acc;
  }
}

// One body application from a given acc: the case's extra term, per row
// (scan8: 256 values, acc_matmul3/2: 5 values).
template <int C>
__global__ void __launch_bounds__(32)
op_mix_term(const float* __restrict__ x, const float* __restrict__ acc_in,
            float* __restrict__ term) {
  const int lane = threadIdx.x, row = blockIdx.x;
  float xv[kPer], a[kPer];
  Cmat cm;
  load_row<C>(x, row, lane, xv, cm);
  const float4* src = reinterpret_cast<const float4*>(acc_in + row * kLanes + kPer * lane);
  const float4 u = src[0], w = src[1];
  a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
  a[4] = w.x; a[5] = w.y; a[6] = w.z; a[7] = w.w;
  body_row<C, true>(a, cm, lane, term + row * (C == SCAN8 ? kLanes : 5));
}

template <int C>
void launch_loop(const float* x, float* out, int rows, int niter, cudaStream_t s) {
  op_mix_loop<C><<<rows, row_per_warp(C) ? 32 : kLanes, 0, s>>>(x, out, niter);
}

}  // namespace

extern "C" {

// x (rows, 256) float32 with rows >= 4 (the acc_matmul cases read rows 0-3);
// out (rows, 256) float32. case_id indexes CASES of tools/bench_vpu_ops.py in
// its order. Returns cudaGetLastError(), or cudaErrorInvalidValue for an
// unknown case.
int c4d_op_mix(int case_id, const void* x, void* out, int rows, int niter, void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (case_id) {
    case BASE: launch_loop<BASE>(xf, of, rows, niter, s); break;
    case MUL: launch_loop<MUL>(xf, of, rows, niter, s); break;
    case EXP: launch_loop<EXP>(xf, of, rows, niter, s); break;
    case LOG1P: launch_loop<LOG1P>(xf, of, rows, niter, s); break;
    case ROLL_SEL_MUL: launch_loop<ROLL_SEL_MUL>(xf, of, rows, niter, s); break;
    case SCAN8: launch_loop<SCAN8>(xf, of, rows, niter, s); break;
    case LOG: launch_loop<LOG>(xf, of, rows, niter, s); break;
    case EXP2: launch_loop<EXP2>(xf, of, rows, niter, s); break;
    case DIV: launch_loop<DIV>(xf, of, rows, niter, s); break;
    case WHERE: launch_loop<WHERE>(xf, of, rows, niter, s); break;
    case ACC_MATMUL3: launch_loop<ACC_MATMUL3>(xf, of, rows, niter, s); break;
    case ACC_MATMUL2: launch_loop<ACC_MATMUL2>(xf, of, rows, niter, s); break;
    case TRI_MATMUL2: launch_loop<TRI_MATMUL2>(xf, of, rows, niter, s); break;
    case TRI_BLOCKED: launch_loop<TRI_BLOCKED>(xf, of, rows, niter, s); break;
    case TRI_BLOCKED4: launch_loop<TRI_BLOCKED4>(xf, of, rows, niter, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The extra term of one body application from acc (rows, 256): scan8 writes
// term (rows, 256), acc_matmul3 / acc_matmul2 write term (rows, 5).
int c4d_op_mix_term(int case_id, const void* x, const void* acc, void* term, int rows,
                    void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(acc);
  float* tf = static_cast<float*>(term);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (case_id) {
    case SCAN8: op_mix_term<SCAN8><<<rows, 32, 0, s>>>(xf, af, tf); break;
    case ACC_MATMUL3: op_mix_term<ACC_MATMUL3><<<rows, 32, 0, s>>>(xf, af, tf); break;
    case ACC_MATMUL2: op_mix_term<ACC_MATMUL2><<<rows, 32, 0, s>>>(xf, af, tf); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
