// The Schur-Jacobi preconditioner's per-observation term W_o Hpp^-1 W_o^T,
// shared by fused_ne_payloads (K3, which builds the blocks with the normal
// equations for a PCG solve: ba_kernels.cu) and the standalone
// whw_cam_reduce entry (K7: schur_kernels.cu), so that the check of the one
// holds the code of the other.
//
// The 6x6 term is symmetric: 21 entries, the upper triangle row by row
// ((0,0) (0,1) .. (0,5) (1,1) .. (5,5)), are formed and summed per camera,
// and the block is mirrored when it is written.

#pragma once
#include <cuda_runtime.h>

namespace sfm {
namespace {  // internal linkage: each translation unit gets its own copy

constexpr int kWhwEntries = 21;

// Place of entry (i, j), i <= j, in the upper triangle's row-major order.
__device__ __forceinline__ int whw_index(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// The upper triangle of W Hinv W^T for W row-major 6x3 (W[i * 3 + k]) and
// Hinv row-major 3x3: u = W Hinv, then entry (i, j) = u_i . W_j.
__device__ __forceinline__ void whw_upper(const float (&W)[18], const float (&H)[9],
                                          float (&out)[kWhwEntries]) {
  float u[18];
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      u[r * 3 + l] = W[r * 3] * H[l] + W[r * 3 + 1] * H[3 + l] + W[r * 3 + 2] * H[6 + l];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j)
      out[whw_index(i, j)] = u[i * 3] * W[j * 3] + u[i * 3 + 1] * W[j * 3 + 1] +
                             u[i * 3 + 2] * W[j * 3 + 2];
}

// Observation o's W (feature-major [18, O]) and its point's Hinv ([P, 9]),
// then its 21 entries.
__device__ __forceinline__ void whw_of_observation(const float* w_t, const float* hinv,
                                                   int O, int o, int p,
                                                   float (&out)[kWhwEntries]) {
  float W[18], H[9];
#pragma unroll
  for (int k = 0; k < 18; ++k) W[k] = w_t[(size_t)k * O + o];
  const float* h = hinv + 9 * (size_t)p;
#pragma unroll
  for (int k = 0; k < 9; ++k) H[k] = h[k];
  whw_upper(W, H, out);
}

// The mirrored 6x6 block [36] from a camera's 21 sums.
__device__ __forceinline__ float whw_block_entry(const float* sums, int k) {
  const int i = k / 6, j = k % 6;
  return sums[i <= j ? whw_index(i, j) : whw_index(j, i)];
}

}  // namespace
}  // namespace sfm
