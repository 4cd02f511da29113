// Deterministic sorted-segment reduction, shared by ba_kernels.cu (K9
// cam_segment_sum) and schur_kernels.cu (the point side of K10, the camera
// side of K11).
//
// Replaces: sfm_tpu/kernels/schur_spmv.py cam_segment_sum (Pallas: a one-hot
// MXU matmul into a VMEM accumulator with a three-term bf16 split, a
// workaround for a machine without gathers that does not come over).
//
// Bound on the H100: bytes (each value read once, S*K sums written). What
// the design does about it:
//
// - Sorted side (the observations already lie in segment order, e.g. by
//   point): a sub-warp group of `width` lanes (1, 2, 4 .. 32, chosen by the
//   caller from the mean segment length) owns one segment and up to
//   kRowsPerGroup feature rows of it, so a warp covers 32 / width
//   neighbouring segments with neighbouring addresses and reads `bounds`
//   once per segment and row chunk. The lanes add their strided share in
//   index order and a butterfly of __shfl_xor_sync adds the lanes: no shared
//   memory, no __syncthreads().
// - Permuted side (segments are ranges of a sorting permutation, e.g. by
//   camera, while the values lie in point order): gathering 4 bytes per
//   32-byte sector wastes 7/8 of the traffic. A first pass reads values_t
//   coalesced in tiles of kTileObs observations x up to kTileRows rows,
//   transposes the tile in padded shared memory and writes each
//   observation's rows contiguously at its sorted position inv_perm[o] of a
//   scratch [M, K] (observations that the permutation leaves out, the
//   zero-weight padding, have inv_perm -1 and are dropped here); a second
//   pass gives each segment a block of 1..32 warps whose lanes lie along the
//   K contiguous floats (several observations per warp when K <= 16), so
//   every load is a full line. Three coalesced streams take the place of
//   eight-fold amplified gathers. A lane adds hundreds of terms one after
//   the other, so its running sum is compensated (Kahan): the result is as
//   close to the exact sum as the tree reduction this replaces.
//
// No float atomics: the order of every sum is a fixed function of the
// shapes, the bounds and the launch widths, so a rerun gives identical bits.
// All offsets are size_t (K * O and N * K pass 2^26 on the large problems).

#pragma once

#include <cuda_runtime.h>

namespace sfm {
namespace {  // internal linkage: each translation unit gets its own copy

constexpr int kRowsPerGroup = 12;   // feature rows one group accumulates
constexpr int kSortedThreads = 256;
constexpr int kTileObs = 64;        // observations per transpose tile
constexpr int kTileRows = 64;       // feature rows per tile / per packed pass
constexpr int kScatterThreads = 256;
constexpr int kMaxSegmentWarps = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// values [K, O] feature-major, segments contiguous in o. grid = (groups of
// segments, row chunks of `rows` <= kRowsPerGroup rows); width is a power of
// two <= 32.
__global__ __launch_bounds__(kSortedThreads) void segment_sum_sorted_kernel(
    const float* __restrict__ values, const int* __restrict__ bounds, int O,
    int K, int S, int rows, int width, float* __restrict__ out) {
  const int seg = (blockIdx.x * kSortedThreads + threadIdx.x) / width;
  const int lane = threadIdx.x & (width - 1);
  const int k0 = blockIdx.y * rows;
  const int nrows = min(rows, K - k0);
  const bool live = seg < S;
  const int lo = live ? bounds[seg] : 0;
  const int hi = live ? bounds[seg + 1] : 0;
  const float* base = values + (size_t)k0 * O;
  float acc[kRowsPerGroup];
#pragma unroll
  for (int k = 0; k < kRowsPerGroup; ++k) acc[k] = 0.0f;
  for (int i = lo + lane; i < hi; i += width) {
#pragma unroll
    for (int k = 0; k < kRowsPerGroup; ++k)
      if (k < nrows) acc[k] += base[(size_t)k * O + i];
  }
  // Butterfly over the group's lanes: each level adds the same two partial
  // sums on both sides, so every lane ends with the same bits. Whole warps
  // reach this point (no early return above).
  for (int off = width >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kRowsPerGroup; ++k)
      acc[k] += __shfl_xor_sync(kFullMask, acc[k], off);
  }
  if (live && lane == 0) {
    float* dst = out + (size_t)seg * K + k0;
#pragma unroll
    for (int k = 0; k < kRowsPerGroup; ++k)
      if (k < nrows) dst[k] = acc[k];
  }
}

// First pass of the permuted side: values [K, O] -> packed [M, K] with
// packed[inv_perm[o]] = values[:, o] for the o < N with inv_perm[o] >= 0.
// grid = (tiles of kTileObs observations, chunks of kTileRows rows).
__global__ __launch_bounds__(kScatterThreads) void segment_scatter_kernel(
    const float* __restrict__ values, const int* __restrict__ inv_perm, int O,
    int K, int N, float* __restrict__ packed) {
  __shared__ float tile[kTileObs * (kTileRows + 1)];
  __shared__ int dest[kTileObs];
  const int o0 = blockIdx.x * kTileObs;
  const int k0 = blockIdx.y * kTileRows;
  const int kw = min(kTileRows, K - k0);
  const int stride = kw | 1;  // odd: a column of the tile touches 32 banks
  const int tid = threadIdx.x;
  if (tid < kTileObs) dest[tid] = (o0 + tid < N) ? inv_perm[o0 + tid] : -1;
  const int x = tid & (kTileObs - 1);
  const bool in = o0 + x < N;
  const float* src = values + (size_t)k0 * O + o0 + x;
  for (int k = tid / kTileObs; k < kw; k += kScatterThreads / kTileObs)
    tile[x * stride + k] = in ? src[(size_t)k * O] : 0.0f;
  __syncthreads();
  for (int e = tid; e < kTileObs * kw; e += kScatterThreads) {
    const int xx = e / kw, k = e - xx * kw;
    const int d = dest[xx];
    if (d >= 0) packed[(size_t)d * K + k0 + k] = tile[xx * stride + k];
  }
}

// acc += v with the rounding error of every earlier step carried in c.
__device__ __forceinline__ void kahan_add(float& acc, float& c, float v) {
  const float y = v - c;
  const float t = acc + y;
  c = (t - acc) - y;
  acc = t;
}

// Second pass, one warp's share of one segment: warp `warp` of a team of
// `warps` warps that owns the segment [lo, hi) of packed [M, K]
// (observation-major) adds every `warps`-th step of the segment's
// observations for the rows k0 + r, r < kw <= kTileRows, and writes its sums
// to part_row[r]. All 32 lanes of the warp call it together. With a chunk of
// kw <= 32 rows a warp covers 32 / kw observations per step (lane ->
// (observation, row)); with 32 < kw <= 64 a lane covers rows lane and
// lane + 32 of one observation. packed is read with plain loads: the fused
// PCG solve (schur_kernels.cu) writes it in the same launch.
__device__ __forceinline__ void segment_sum_packed_warp(
    const float* packed, int lo, int hi, int K, int k0, int kw, int warp, int warps,
    float* part_row) {
  const int lane = threadIdx.x & 31;
  const bool wide = kw > 32;
  const int nsub = wide ? 1 : 32 / kw;
  const int sub = wide ? 0 : lane / kw;
  const int k = wide ? lane : lane - sub * kw;
  const bool on0 = sub < nsub;
  const bool on1 = wide && lane + 32 < kw;
  const int step = warps * nsub;
  const float* base = packed + k0 + k;
  float acc0 = 0.0f, acc1 = 0.0f, c0 = 0.0f, c1 = 0.0f;
  if (on0) {
    int i = lo + warp * nsub + sub;
    // Eight independent loads in flight, added in index order.
    for (; i + 7 * step < hi; i += 8 * step) {
      float v[8], w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* p = base + (size_t)(i + u * step) * K;
        v[u] = p[0];
        w[u] = on1 ? p[32] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        kahan_add(acc0, c0, v[u]);
        kahan_add(acc1, c1, w[u]);
      }
    }
    for (; i < hi; i += step) {
      const float* p = base + (size_t)i * K;
      kahan_add(acc0, c0, p[0]);
      if (on1) kahan_add(acc1, c1, p[32]);
    }
  }
  if (!wide) {
    // Row k of the chunk: the partial sums of lanes k, k + kw, ... in order.
    float tot = 0.0f;
    for (int s = 0; s < nsub; ++s)
      tot += __shfl_sync(kFullMask, acc0, (k + s * kw) & 31);
    if (lane < kw) part_row[lane] = tot;
  } else {
    part_row[lane] = acc0;
    if (on1) part_row[lane + 32] = acc1;
  }
}

// Second pass, one segment: out[r] = sum of packed[m, k0 + r] over m in
// [lo, hi) for r < kw <= kTileRows, by the block's blockDim.x / 32 <=
// kMaxSegmentWarps warps (every thread of the block calls it; part is shared
// scratch of as many rows): each warp's share (segment_sum_packed_warp),
// then the warps' sums in warp order.
__device__ __forceinline__ void segment_sum_packed_rows(
    const float* packed, int lo, int hi, int K, int k0, int kw,
    float (*part)[kTileRows], float* out) {
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  segment_sum_packed_warp(packed, lo, hi, K, k0, kw, warp, warps, part[warp]);
  __syncthreads();
  for (int r = threadIdx.x; r < kw; r += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < warps; ++w) s += part[w][r];
    out[r] = s;
  }
}

// grid = (S, chunks of kTileRows rows), blockDim = 32 * warps.
__global__ __launch_bounds__(32 * kMaxSegmentWarps) void segment_sum_packed_kernel(
    const float* __restrict__ packed, const int* __restrict__ bounds, int K,
    float* __restrict__ out) {
  __shared__ float part[kMaxSegmentWarps][kTileRows];
  const int seg = blockIdx.x;
  const int k0 = blockIdx.y * kTileRows;
  segment_sum_packed_rows(packed, bounds[seg], bounds[seg + 1], K, k0,
                          min(kTileRows, K - k0), part,
                          out + (size_t)seg * K + k0);
}

// out[s, k] = sum of packed[m, k] over m in [bounds[s], bounds[s+1]):
// packed [M, K] observation-major, `warps` (1..kMaxSegmentWarps) per segment.
int launch_segment_sum_packed(const float* packed, const int* bounds, int K,
                              int S, int warps, float* out,
                              cudaStream_t stream) {
  if (S <= 0 || K <= 0) return 0;
  if (warps < 1 || warps > kMaxSegmentWarps) return (int)cudaErrorInvalidValue;
  dim3 grid(S, (K + kTileRows - 1) / kTileRows);
  segment_sum_packed_kernel<<<grid, 32 * warps, 0, stream>>>(packed, bounds, K,
                                                             out);
  return (int)cudaGetLastError();
}

// out[s, k] = sum of values[k, o] over the observations o of segment s,
// values [K, O], bounds [S+1], out [S, K].
// inv_perm == nullptr: segment s is o in [bounds[s], bounds[s+1]); `width` is
//   the lanes per segment (a power of two, 1..32); packed is not used.
// inv_perm != nullptr: segment s is the o < N with inv_perm[o] in
//   [bounds[s], bounds[s+1]) (inv_perm [N], N <= O, holds the distinct
//   places 0..M-1 and -1 for observations of no segment); `width` is the
//   warps per segment (1..kMaxSegmentWarps); packed is caller-allocated
//   scratch of M * K floats.
int launch_segment_sum(const float* values, const int* inv_perm,
                       const int* bounds, int O, int K, int S, int N,
                       int width, float* packed, float* out,
                       cudaStream_t stream) {
  if (S <= 0 || K <= 0) return 0;
  if (inv_perm == nullptr) {
    if (width < 1 || width > 32 || (width & (width - 1)) != 0)
      return (int)cudaErrorInvalidValue;
    const int chunks = (K + kRowsPerGroup - 1) / kRowsPerGroup;
    const int rows = (K + chunks - 1) / chunks;
    const int per_block = kSortedThreads / width;
    dim3 grid((S + per_block - 1) / per_block, (K + rows - 1) / rows);
    segment_sum_sorted_kernel<<<grid, kSortedThreads, 0, stream>>>(
        values, bounds, O, K, S, rows, width, out);
    return (int)cudaGetLastError();
  }
  if (N > 0) {
    dim3 grid((N + kTileObs - 1) / kTileObs, (K + kTileRows - 1) / kTileRows);
    segment_scatter_kernel<<<grid, kScatterThreads, 0, stream>>>(
        values, inv_perm, O, K, N, packed);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return launch_segment_sum_packed(packed, bounds, K, S, width, out, stream);
}

}  // namespace
}  // namespace sfm
