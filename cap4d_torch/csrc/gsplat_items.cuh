// Shared by K4 (gsplat_fwd.cu) and K5 (gsplat_bwd.cu): the constants of the
// compositing contract, the work items and the staging of a batch.
//
// A work item is one (tile, 256-pair batch). Tile t holds
// ceil(len_t / 256) batches; they take the state rows
// row_start[t] .. row_start[t + 1] - 1, where row_start is the exclusive
// scan of those counts over the tiles. Its upper bound is known on the host
// without reading the device: sum ceil(len_t / 256) <= n_tiles + M / 256 for
// M pairs, so the item kernels launch that many blocks and the blocks past
// the device's count return at once.

#pragma once

#include <cuda_runtime.h>

namespace gsplat {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;  // pixels per tile == pairs per batch
constexpr int kPacked = 10;            // mean x/y, conic a/b/c, opacity, rgb, depth
constexpr int kOut = 6;                // sum w rgb, sum w, sum w depth, ln T
constexpr int kState = 6;              // ln T before the batch, then the prefix of the five sums
constexpr int kScanThreads = 1024;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.999f;
constexpr float kLnTStop = -9.210340371976184f;  // ln(1e-4)
constexpr unsigned kFull = 0xffffffffu;

// One staged pair: the packed row in three 16-byte slots, so a thread reads
// it with three broadcast LDS.128 (mean x, mean y, conic a, conic b |
// conic c, opacity, r, g | b, depth, -, -).
struct __align__(16) Pair {
  float4 a, b, c;
};

__device__ __forceinline__ int n_batches(const int* bounds, int t) {
  return (bounds[t + 1] - bounds[t] + kBlock - 1) / kBlock;
}

// Exclusive scan of one int per thread over a block of kScanThreads
// threads; s_warp holds 33 ints. Every thread gets the total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = s_warp[lane];
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(kFull, wi, off);
      if (lane >= off) wi += n;
    }
    s_warp[lane] = wi - w;
    if (lane == 31) s_warp[32] = wi;
  }
  __syncthreads();
  const int excl = incl - v + s_warp[warp];
  total = s_warp[32];
  __syncthreads();
  return excl;
}

// One block of kScanThreads threads. row_start (n_tiles + 1): exclusive scan
// of each tile's batch count. The work items are the first n_work[t]
// batches of each tile (all of them where n_work is null): work_start
// (n_tiles + 1) is their exclusive scan and work_tile[i] the tile of work
// item i. row_start and work_start may be one buffer when n_work is null.
__device__ __forceinline__ void scan_items(const int* __restrict__ bounds,
                                           const int* __restrict__ n_work, int n_tiles,
                                           int* row_start, int* work_start,
                                           int* __restrict__ work_tile) {
  __shared__ int s_warp[33];
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int t0 = min(static_cast<int>(threadIdx.x) * per, n_tiles);
  const int t1 = min(t0 + per, n_tiles);
  int rows = 0, work = 0;
  for (int t = t0; t < t1; ++t) {
    const int nb = n_batches(bounds, t);
    rows += nb;
    work += n_work ? min(n_work[t], nb) : nb;
  }
  int rows_total, work_total;
  int row = block_exclusive_scan(rows, s_warp, rows_total);
  int item = block_exclusive_scan(work, s_warp, work_total);
  for (int t = t0; t < t1; ++t) {
    const int nb = n_batches(bounds, t);
    const int nw = n_work ? min(n_work[t], nb) : nb;
    row_start[t] = row;
    work_start[t] = item;
    for (int j = 0; j < nw; ++j) work_tile[item + j] = t;
    row += nb;
    item += nw;
  }
  if (threadIdx.x == 0) {
    row_start[n_tiles] = rows_total;
    work_start[n_tiles] = work_total;
  }
}

// Gathers batch j of tile t into s_pair (thread k stages pair k) and
// returns the number of pairs in the batch. The caller synchronises.
__device__ __forceinline__ int stage_batch(const float* __restrict__ packed,
                                           const int* __restrict__ pair_gauss,
                                           const int* __restrict__ bounds, int t, int j,
                                           Pair* s_pair, int* gid_out) {
  const int start = bounds[t] + j * kBlock;
  const int cnt = min(kBlock, bounds[t + 1] - start);
  const int k = threadIdx.x;
  if (k < cnt) {
    const int gid = pair_gauss[start + k];
    // rows are 40 bytes apart: 8-byte aligned, so five float2 loads
    const float2* row = reinterpret_cast<const float2*>(packed + static_cast<size_t>(gid) * kPacked);
    const float2 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3], r4 = row[4];
    s_pair[k].a = make_float4(r0.x, r0.y, r1.x, r1.y);
    s_pair[k].b = make_float4(r2.x, r2.y, r3.x, r3.y);
    s_pair[k].c = make_float4(r4.x, r4.y, 0.f, 0.f);
    if (gid_out) gid_out[k] = gid;
  }
  return cnt;
}

// Looks up work item `item` (one block each): its tile and batch index
// within the tile, and gathers its batch into s_pair (and the gaussian
// indices into gid_out where it is not null). Returns the pair count. The
// caller synchronises before reading s_pair.
__device__ __forceinline__ int stage_item(const float* __restrict__ packed,
                                          const int* __restrict__ pair_gauss,
                                          const int* __restrict__ bounds,
                                          const int* __restrict__ work_start,
                                          const int* __restrict__ work_tile, int item,
                                          Pair* s_pair, int* gid_out, int& tile, int& batch) {
  tile = work_tile[item];
  batch = item - work_start[tile];
  return stage_batch(packed, pair_gauss, bounds, tile, batch, s_pair, gid_out);
}

__device__ __forceinline__ float pixel_x(int t, int tiles_x) {
  return static_cast<float>((t % tiles_x) * kTile + threadIdx.x % kTile) + 0.5f;
}

__device__ __forceinline__ float pixel_y(int t, int tiles_x) {
  return static_cast<float>((t / tiles_x) * kTile + threadIdx.x / kTile) + 0.5f;
}

}  // namespace gsplat
