// K4: 3D Gaussian splatting tile compositing, forward.
//
// Replaces cap4d_tpu/ops/gsplat_pallas.py:197 `_fwd_kernel` (pallas_call at
// :557 in `_make_composite`, driven by `rasterize_gaussians_pallas`).
//
// Contract (ops/gsplat.py, the plain version `rasterize_gaussians_plain`):
// per 16x16 tile, the tile's pairs pair_gauss[bounds[t] : bounds[t+1]] are
// already sorted front to back (depth rank, ties by gaussian index). For each
// pixel centre (x + 0.5, y + 0.5) and pair: sigma = 0.5 (a dx^2 + c dy^2) +
// b dx dy; the pair is kept where sigma >= 0 and opac e^-sigma >= 1/255;
// alpha = min(opac e^-sigma, 0.999); w = alpha T; T *= 1 - alpha. Outputs per
// pixel: sum w rgb, sum w, sum w depth and ln T = sum log1p(-alpha). The tile
// stops at the first 256-pair batch boundary of its own segment at which every
// pixel has ln T < ln(1e-4); n_done[t] records the batches it ran, so the
// backward (K5) replays exactly those.
//
// What bounds it on an H100: the pair-pixel evaluations (about 20 fp32
// operations each, one __expf) -- a few hundred thousand to a few million
// pairs times 256 pixels at 512^2 -- against 67 TFLOP/s; the bytes (10 floats
// per gaussian, one int per pair, 24 bytes per pixel out) are small beside
// that. The design: one block per tile, one thread per pixel; the block
// stages each batch of 256 pairs in shared memory (structure of arrays, one
// gather of the packed row per thread), then every thread walks the batch
// front to back in registers; __syncthreads_count both guards the next
// batch's shared-memory writes and applies the termination rule. The TPU
// kernel's MXU prefix-sum trick (split-bf16 triangular matmuls, log2
// transmittance) has no counterpart: a thread carries its pixel's T serially.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;  // pixels per tile == pairs per batch
constexpr int kPacked = 10;            // mean x/y, conic a/b/c, opacity, rgb, depth
constexpr int kOut = 6;                // sum w rgb, sum w, sum w depth, ln T
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;
constexpr float kLnTStop = -9.210340371976184f;  // ln(1e-4)

__global__ void __launch_bounds__(kBlock)
gsplat_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ pair_gauss,
                  const int* __restrict__ bounds, int tiles_x,
                  float* __restrict__ out, int* __restrict__ n_done) {
  __shared__ float s_mx[kBlock], s_my[kBlock], s_ca[kBlock], s_cb[kBlock], s_cc[kBlock];
  __shared__ float s_op[kBlock], s_r[kBlock], s_g[kBlock], s_b[kBlock], s_d[kBlock];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = bounds[t];
  const int len = bounds[t + 1] - start;
  const float px = static_cast<float>((t % tiles_x) * kTile + tid % kTile) + 0.5f;
  const float py = static_cast<float>((t / tiles_x) * kTile + tid / kTile) + 0.5f;

  float r = 0.f, g = 0.f, b = 0.f, wsum = 0.f, dsum = 0.f, ln_t = 0.f, T = 1.f;
  const int n_batches = (len + kBlock - 1) / kBlock;
  int done = 0;
  for (int j = 0; j < n_batches; ++j) {
    const int k0 = j * kBlock;
    if (k0 + tid < len) {
      const float* row = packed + static_cast<size_t>(pair_gauss[start + k0 + tid]) * kPacked;
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
    __syncthreads();
    const int cnt = min(kBlock, len - k0);
    for (int k = 0; k < cnt; ++k) {
      const float dx = px - s_mx[k];
      const float dy = py - s_my[k];
      const float sigma = 0.5f * (s_ca[k] * dx * dx + s_cc[k] * dy * dy) + s_cb[k] * dx * dy;
      if (sigma < 0.f) continue;
      const float raw = s_op[k] * __expf(-sigma);
      if (raw < kAlphaMin) continue;
      const float a = fminf(raw, kAlphaMax);
      const float w = a * T;
      r += w * s_r[k];
      g += w * s_g[k];
      b += w * s_b[k];
      wsum += w;
      dsum += w * s_d[k];
      ln_t += log1pf(-a);
      T *= 1.f - a;
    }
    done = j + 1;
    // a barrier as well: no thread refills shared memory while another reads it
    if (__syncthreads_count(ln_t >= kLnTStop) == 0) break;
  }
  float* o = out + (static_cast<size_t>(t) * kBlock + tid) * kOut;
  o[0] = r;
  o[1] = g;
  o[2] = b;
  o[3] = wsum;
  o[4] = dsum;
  o[5] = ln_t;
  if (tid == 0) n_done[t] = done;
}

}  // namespace

extern "C" {

// packed (N, 10) float32; pair_gauss (M,) int32 gaussian of each sorted pair;
// bounds (n_tiles + 1,) int32 segment starts. Outputs out (n_tiles, 256, 6)
// float32 and n_done (n_tiles,) int32. Returns cudaGetLastError().
int c4d_gsplat_fwd(const void* packed, const void* pair_gauss, const void* bounds,
                   int n_tiles, int tiles_x, void* out, void* n_done, void* stream) {
  if (n_tiles > 0) {
    gsplat_fwd_kernel<<<n_tiles, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packed), static_cast<const int*>(pair_gauss),
        static_cast<const int*>(bounds), tiles_x, static_cast<float*>(out),
        static_cast<int*>(n_done));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
