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
// Design: one block of 256 threads per row, one lane per thread, the lane's
// acc and x in registers. Rows are independent in every case, so blocks never
// communicate. Cross-lane work goes through shared memory: a thread writes
// into one of two slots, the block meets at one barrier, and each thread
// reads what it needs; the slots alternate, so consecutive exchanges need one
// barrier each (a slot is written again only after a later barrier that every
// reader of its last contents has passed). Warp-level parts of the scans and
// row sums use shuffles. Each case is its own template instance (the switch on
// the case runs once, outside the timed loop) and the loop is not unrolled, so
// its SASS is one iteration's instructions. Products and sums go through the
// round-to-nearest intrinsics where the plain version rounds twice (no FMA
// contraction): the elementwise cases round as PyTorch's kernels do.
//
// What bounds it on an H100: each lane runs one serial dependency chain, and
// 256 blocks of 256 threads are 15.5 warps per SM, so latency and the pipe
// that each case loads (FP32, MUFU, shuffle/shared memory, conversions) set
// the time. Its floor is that pipe's op count per element over its rate
// (cap4d_torch/tools/bench_ops.py counts it); the matmul cases run as FMA
// loops, not on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 256;  // CH: lanes of a row, threads of a block
constexpr int kWarps = kLanes / 32;
constexpr int K = 4;         // extra-op repetitions of the elementwise cases
constexpr unsigned kFull = 0xffffffffu;

enum Case {
  BASE = 0, MUL, EXP, LOG1P, ROLL_SEL_MUL, SCAN8, LOG, EXP2, DIV, WHERE,
  ACC_MATMUL3, ACC_MATMUL2, TRI_MATMUL2, TRI_BLOCKED, TRI_BLOCKED4, N_CASES
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float bf16r(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}
// acc * 0.999999 + 1e-9, rounded after each op as the plain version does
__device__ __forceinline__ float tail(float acc) { return add(mul(acc, 0.999999f), 1e-9f); }

// Two alternating shared-memory slots of kLanes floats.
struct Exchange {
  float* base;
  int ph;
  __device__ __forceinline__ float* slot() {
    ph ^= 1;
    return base + ph * kLanes;
  }
};

// What a lane holds for the whole loop: its x, and the bf16 split of its
// column of cmat = [x0, x1, x2, 1, x3] for the acc_matmul cases.
struct Lane {
  int lane;
  float x;
  float bh[5], bl[5];
};

__device__ __forceinline__ float roll(float v, int s, Exchange& ex, int lane) {
  float* slot = ex.slot();
  slot[lane] = v;
  __syncthreads();
  return slot[(lane - s) & (kLanes - 1)];
}

// Sum of N values over the row's 256 lanes; every lane gets the sums.
template <int N>
__device__ __forceinline__ void row_sum(float (&v)[N], Exchange& ex, int lane) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] = add(v[k], __shfl_xor_sync(kFull, v[k], off));
  }
  float* slot = ex.slot();
  if ((lane & 31) == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) slot[(lane >> 5) * N + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = slot[k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = add(s, slot[w * N + k]);
    v[k] = s;
  }
}

// dot(hi, u) + dot(lo, u) with u strictly upper triangular over segments of
// L lanes, plus the blocked forms' cascaded carries.
template <int L>
__device__ __forceinline__ float tri_prefix(float acc, Exchange& ex, int lane) {
  const float hi = bf16r(acc);
  const float lo = bf16r(sub(acc, hi));
  const int wl = lane & 31, w = lane >> 5;
  float ih = hi, il = lo;  // inclusive warp scans
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float nh = __shfl_up_sync(kFull, ih, off);
    const float nl = __shfl_up_sync(kFull, il, off);
    if (wl >= off) {
      ih = add(ih, nh);
      il = add(il, nl);
    }
  }
  float eh = __shfl_up_sync(kFull, ih, 1);  // exclusive within the warp
  float el = __shfl_up_sync(kFull, il, 1);
  if (wl == 0) eh = el = 0.f;
  float* tot = ex.slot();
  if (wl == 31) {
    tot[2 * w] = ih;
    tot[2 * w + 1] = il;
  }
  __syncthreads();
  const int w0 = (lane / L) * (L / 32);  // first warp of this lane's segment
#pragma unroll
  for (int v = 0; v < kWarps - 1; ++v) {
    if (v >= w0 && v < w) {
      eh = add(eh, tot[2 * v]);
      el = add(el, tot[2 * v + 1]);
    }
  }
  float q = add(eh, el);
  if constexpr (L < kLanes) {
    const int seg = lane / L;
    float* last = ex.slot();
    if (lane % L == L - 1) {
      last[2 * seg] = q;
      last[2 * seg + 1] = acc;
    }
    __syncthreads();
    // e_j = q_j + carry_j; carry_{j+1} = e_j[L - 1] + p_j[L - 1]
    float carry = 0.f;
#pragma unroll
    for (int j = 0; j < kLanes / L - 1; ++j) {
      if (j < seg) {
        const float e_last = j == 0 ? last[0] : add(last[2 * j], carry);
        carry = add(e_last, last[2 * j + 1]);
      }
    }
    if (seg > 0) q = add(q, carry);
  }
  return q;
}

// One application of case C's body. With kTerm, the extra term (scan8's p,
// the acc_matmul cases' (5,) row products) is written to `term`.
template <int C, bool kTerm>
__device__ __forceinline__ float body(float acc, const Lane& d, Exchange& ex, float* term) {
  const int lane = d.lane;
  if constexpr (C == BASE) {
    return tail(acc);
  } else if constexpr (C == MUL) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc = mul(acc, d.x);
    return tail(acc);
  } else if constexpr (C == EXP) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc = expf(-fabsf(acc));
    return tail(acc);
  } else if constexpr (C == LOG1P) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc = log1pf(fminf(fabsf(acc), 0.9f));
    return tail(acc);
  } else if constexpr (C == ROLL_SEL_MUL) {
#pragma unroll
    for (int s = 1; s <= 8; s <<= 1) {
      const float r = roll(acc, s, ex, lane);
      acc = mul(acc, lane < s ? 1.f : r);
    }
    return tail(acc);
  } else if constexpr (C == SCAN8) {
    float p = roll(acc, 1, ex, lane);
    p = lane < 1 ? 1.f : p;
#pragma unroll
    for (int s = 1; s <= 128; s <<= 1) {
      const float r = roll(p, s, ex, lane);
      p = mul(p, lane < s ? 1.f : r);
    }
    if constexpr (kTerm) term[lane] = p;
    return add(mul(acc, 0.999999f), mul(p, 1e-12f));
  } else if constexpr (C == LOG) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc = logf(add(fabsf(acc), 0.5f));
    return tail(acc);
  } else if constexpr (C == EXP2) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc = exp2f(-fabsf(acc));
    return tail(acc);
  } else if constexpr (C == DIV) {
    const float den = add(fabsf(d.x), 1.001f);
#pragma unroll
    for (int i = 0; i < K; ++i) acc = __fdiv_rn(acc, den);
    return tail(acc);
  } else if constexpr (C == WHERE) {
    const bool keep = d.x > 0.5f;
#pragma unroll
    for (int i = 0; i < K; ++i) acc = keep ? acc : mul(acc, 0.5f);
    return tail(acc);
  } else if constexpr (C == ACC_MATMUL3 || C == ACC_MATMUL2) {
    const float hi = bf16r(acc);
    const float lo = bf16r(sub(acc, hi));
    float v[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      // hi·b_hi + hi·b_lo + lo·b_hi (3 passes) or hi·b_hi + lo·b_hi (2)
      v[k] = C == ACC_MATMUL3 ? add(add(mul(hi, d.bh[k]), mul(hi, d.bl[k])), mul(lo, d.bh[k]))
                              : add(mul(hi, d.bh[k]), mul(lo, d.bh[k]));
    }
    row_sum<5>(v, ex, lane);
    if constexpr (kTerm) {
      if (lane < 5) term[lane] = v[lane];
    }
    const float s = add(add(add(add(v[0], v[1]), v[2]), v[3]), v[4]);
    return add(mul(acc, 0.999999f), mul(s, 1e-12f));
  } else {
    constexpr int L = C == TRI_MATMUL2 ? 256 : C == TRI_BLOCKED ? 128 : 64;
    return add(mul(tri_prefix<L>(acc, ex, lane), 1e-6f), 0.5f);
  }
}

__device__ __forceinline__ Lane load_lane(const float* __restrict__ x, int row) {
  Lane d;
  d.lane = threadIdx.x;
  d.x = x[row * kLanes + d.lane];
  const float c[5] = {x[d.lane], x[kLanes + d.lane], x[2 * kLanes + d.lane], 1.f,
                      x[3 * kLanes + d.lane]};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    d.bh[k] = bf16r(c[k]);
    d.bl[k] = bf16r(sub(c[k], d.bh[k]));
  }
  return d;
}

template <int C>
__global__ void __launch_bounds__(kLanes)
op_mix_loop(const float* __restrict__ x, float* __restrict__ out, int niter) {
  __shared__ float smem[2 * kLanes];
  Exchange ex{smem, 0};
  const Lane d = load_lane(x, blockIdx.x);
  float acc = mul(d.x, 0.5f);
#pragma unroll 1
  for (int j = 0; j < niter; ++j) acc = body<C, false>(acc, d, ex, nullptr);
  out[blockIdx.x * kLanes + d.lane] = acc;
}

// One body application from a given acc: the case's extra term, per row
// (scan8: 256 values, acc_matmul3/2: 5 values).
template <int C>
__global__ void __launch_bounds__(kLanes)
op_mix_term(const float* __restrict__ x, const float* __restrict__ acc_in,
            float* __restrict__ term) {
  __shared__ float smem[2 * kLanes];
  Exchange ex{smem, 0};
  const Lane d = load_lane(x, blockIdx.x);
  const int width = C == SCAN8 ? kLanes : 5;
  body<C, true>(acc_in[blockIdx.x * kLanes + d.lane], d, ex, term + blockIdx.x * width);
}

template <int C>
void launch_loop(const float* x, float* out, int rows, int niter, cudaStream_t s) {
  op_mix_loop<C><<<rows, kLanes, 0, s>>>(x, out, niter);
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
    case SCAN8: op_mix_term<SCAN8><<<rows, kLanes, 0, s>>>(xf, af, tf); break;
    case ACC_MATMUL3: op_mix_term<ACC_MATMUL3><<<rows, kLanes, 0, s>>>(xf, af, tf); break;
    case ACC_MATMUL2: op_mix_term<ACC_MATMUL2><<<rows, kLanes, 0, s>>>(xf, af, tf); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
