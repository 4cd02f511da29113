// Deterministic sorted-segment reduction, shared by ba_kernels.cu (K9
// cam_segment_sum) and schur_kernels.cu (the camera side of K11).
//
// One block per (segment, feature row) walks its segment of a sorting
// permutation (or of the identity, for already-sorted point segments) and
// tree-reduces in shared memory: no float atomics, so every run adds in the
// same order and gives the same bits. Launch with blockDim.x a power of two
// and blockDim.x * sizeof(float) bytes of dynamic shared memory.

#pragma once

#include <cuda_runtime.h>

namespace sfm {
namespace {  // internal linkage: each translation unit gets its own copy

__global__ void segment_sum_kernel(const float* __restrict__ values,
                                   const int* __restrict__ perm,
                                   const int* __restrict__ bounds, int O,
                                   int K, float* __restrict__ out) {
  extern __shared__ float sh[];
  const int seg = blockIdx.x;
  const int k = blockIdx.y;
  const int lo = bounds[seg], hi = bounds[seg + 1];
  const float* row = values + (size_t)k * O;
  float acc = 0.0f;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x)
    acc += row[perm != nullptr ? perm[i] : i];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sh[threadIdx.x] += sh[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[(size_t)seg * K + k] = sh[0];
}

// Launches segment_sum_kernel over S segments and K feature rows.
int launch_segment_sum(const float* values, const int* perm, const int* bounds,
                       int O, int K, int S, int threads, float* out,
                       cudaStream_t stream) {
  dim3 grid(S, K);
  segment_sum_kernel<<<grid, threads, threads * sizeof(float), stream>>>(
      values, perm, bounds, O, K, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sfm
