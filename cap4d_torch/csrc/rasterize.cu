// K3: forward z-buffer triangle rasterizer in pytorch3d screen NDC, one face
// per pixel.
//
// Replaces cap4d_tpu/ops/rasterize.py:233 `_raster_kernel` (reached through
// `rasterize_meshes_pallas` from `rasterize_meshes`).
//
// Contract (that of `_rasterize_single`, rasterize.py:47-113): pixel (i, j)
// sits at the NDC centre given by the host-computed px[j], py[i]
// (1 - (2k+1)/S); coverage is the sign-agnostic barycentric test b >= 0 with
// b = edge / area, so there is no culling; the nearest z wins and, on equal
// z, the lowest face index. Empty pixels keep z = +inf, face -1, bary 0.
//
// What bounds it on an H100: the function needs only the pixel-face tests
// inside each face's screen box, a few per face at 128², so its floor is the
// bytes it moves (vertices, faces, 20 bytes per pixel written). This simple
// kernel tests every pixel against every face (~20 flops a test) instead, so
// it is bound by fp32 arithmetic, far above that floor; bounding-box culling
// (binning faces to tiles) is what closes the gap, and is later work.
// The design: one thread per pixel, faces staged through shared memory in
// chunks of 256 (vertices gathered and area / 1/area computed once per face),
// faces walked in ascending index with a strict `<` on z, which reproduces the
// lowest-index tie rule. Every product and sum uses the round-to-nearest
// intrinsics (and the file is built with -fmad=false) so that no multiply-add
// is contracted into an FMA: the kernel then rounds exactly as the plain
// PyTorch version does, and pixels on shared edges pick the same face.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // pixels per block == faces per staged chunk

__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// (xa - xb) * (py - yb) - (ya - yb) * (px - xb), as the plain version orders it
__device__ __forceinline__ float edge(float xa, float ya, float xb, float yb,
                                      float px, float py) {
  return sub(mul(sub(xa, xb), sub(py, yb)), mul(sub(ya, yb), sub(px, xb)));
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ verts, const int* __restrict__ faces,
              const float* __restrict__ px_ndc, const float* __restrict__ py_ndc,
              int V, int F, int H, int W, float* __restrict__ zbuf,
              int* __restrict__ p2f, float* __restrict__ bary) {
  __shared__ float fd[kThreads][11];  // x0 y0 z0 x1 y1 z1 x2 y2 z2 1/area ok

  const int b = blockIdx.y;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  const bool live = pix < H * W;
  const float px = live ? px_ndc[pix % W] : 0.f;
  const float py = live ? py_ndc[pix / W] : 0.f;
  const float* vb = verts + static_cast<long long>(b) * V * 3;

  float best_z = CUDART_INF_F, bb0 = 0.f, bb1 = 0.f, bb2 = 0.f;
  int best_f = -1;

  for (int f0 = 0; f0 < F; f0 += kThreads) {
    __syncthreads();  // the previous chunk is consumed
    const int f = f0 + threadIdx.x;
    if (f < F) {
      float* d = fd[threadIdx.x];
      for (int c = 0; c < 3; ++c) {
        const float* p = vb + static_cast<long long>(faces[f * 3 + c]) * 3;
        d[3 * c] = p[0];
        d[3 * c + 1] = p[1];
        d[3 * c + 2] = p[2];
      }
      // area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
      const float area = sub(mul(sub(d[3], d[0]), sub(d[7], d[1])),
                             mul(sub(d[4], d[1]), sub(d[6], d[0])));
      d[9] = area == 0.f ? 0.f : __frcp_rn(area);
      d[10] = area != 0.f ? 1.f : 0.f;
    }
    __syncthreads();
    const int n = min(kThreads, F - f0);
    for (int j = 0; j < n; ++j) {
      const float* d = fd[j];
      if (d[10] == 0.f) continue;
      const float inv = d[9];
      const float b0 = mul(edge(d[6], d[7], d[3], d[4], px, py), inv);
      const float b1 = mul(edge(d[0], d[1], d[6], d[7], px, py), inv);
      const float b2 = mul(edge(d[3], d[4], d[0], d[1], px, py), inv);
      if (b0 >= 0.f && b1 >= 0.f && b2 >= 0.f) {
        const float z = add(add(mul(b0, d[2]), mul(b1, d[5])), mul(b2, d[8]));
        if (z < best_z) {
          best_z = z;
          best_f = f0 + j;
          bb0 = b0;
          bb1 = b1;
          bb2 = b2;
        }
      }
    }
  }
  if (!live) return;
  const long long o = static_cast<long long>(b) * H * W + pix;
  zbuf[o] = best_z;
  p2f[o] = best_f;
  bary[o * 3] = bb0;
  bary[o * 3 + 1] = bb1;
  bary[o * 3 + 2] = bb2;
}

}  // namespace

extern "C" {

// verts (B, V, 3) float32 NDC; faces (F, 3) int32 (indices < V, checked by the
// Python wrapper); px (W,), py (H,) pixel-centre NDC. Outputs zbuf (B, H, W)
// float32, pix_to_face (B, H, W) int32, bary (B, H, W, 3) float32. Returns
// cudaGetLastError().
int c4d_rasterize(const void* verts, const void* faces, const void* px, const void* py,
                  int B, int V, int F, int H, int W, void* zbuf, void* p2f,
                  void* bary, void* stream) {
  dim3 grid((H * W + kThreads - 1) / kThreads, B);
  raster_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(verts), static_cast<const int*>(faces),
      static_cast<const float*>(px), static_cast<const float*>(py), V, F, H, W,
      static_cast<float*>(zbuf), static_cast<int*>(p2f), static_cast<float*>(bary));
  return static_cast<int>(cudaGetLastError());
}

const char* c4d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
