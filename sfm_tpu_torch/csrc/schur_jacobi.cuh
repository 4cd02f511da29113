// The Schur-Jacobi preconditioner's per-observation term W_o Hpp^-1 W_o^T,
// shared by fused_ne_payloads (K3, which builds the blocks with the normal
// equations for a PCG solve: ba_kernels.cu) and the standalone
// whw_cam_reduce entry (K7: schur_kernels.cu), so that the check of the one
// holds the code of the other.
//
// The D x D term (D = 6, or 8 with the intrinsic columns) is symmetric:
// D (D + 1) / 2 entries, the upper triangle row by row ((0,0) (0,1) ..
// (0,D-1) (1,1) .. (D-1,D-1)), are formed and summed per camera, and the
// block is mirrored when it is written.

#pragma once
#include <cuda_runtime.h>

// A C entry point `name` for 6-wide camera blocks and its twin `name`_w8
// for 8-wide ones (intrinsics refinement): the same arguments, one template
// impl<D> behind both.
#define SFM_ENTRY_BOTH_WIDTHS(name, impl, params, args) \
  extern "C" int name params { return impl<6> args; }  \
  extern "C" int name##_w8 params { return impl<8> args; }

namespace sfm {
namespace {  // internal linkage: each translation unit gets its own copy

template <int D>
constexpr int kWhwEntries = D * (D + 1) / 2;

// Place of entry (i, j), i <= j, in the upper triangle's row-major order.
template <int D>
__device__ __forceinline__ int whw_index(int i, int j) {
  return i * D - i * (i - 1) / 2 + (j - i);
}

// The upper triangle of W Hinv W^T for W row-major D x 3 (W[i * 3 + k]) and
// Hinv row-major 3x3: u = W Hinv, then entry (i, j) = u_i . W_j.
template <int D>
__device__ __forceinline__ void whw_upper(const float (&W)[3 * D], const float (&H)[9],
                                          float (&out)[kWhwEntries<D>]) {
  float u[3 * D];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      u[r * 3 + l] = W[r * 3] * H[l] + W[r * 3 + 1] * H[3 + l] + W[r * 3 + 2] * H[6 + l];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j)
      out[whw_index<D>(i, j)] = u[i * 3] * W[j * 3] + u[i * 3 + 1] * W[j * 3 + 1] +
                                u[i * 3 + 2] * W[j * 3 + 2];
}

// Observation o's W (feature-major [3D, O]) and its point's Hinv ([P, 9]),
// then its D (D + 1) / 2 entries.
template <int D>
__device__ __forceinline__ void whw_of_observation(const float* w_t, const float* hinv,
                                                   int O, int o, int p,
                                                   float (&out)[kWhwEntries<D>]) {
  float W[3 * D], H[9];
#pragma unroll
  for (int k = 0; k < 3 * D; ++k) W[k] = w_t[(size_t)k * O + o];
  const float* h = hinv + 9 * (size_t)p;
#pragma unroll
  for (int k = 0; k < 9; ++k) H[k] = h[k];
  whw_upper<D>(W, H, out);
}

// Entry k of the mirrored D x D block from a camera's upper-triangle sums.
template <int D>
__device__ __forceinline__ float whw_block_entry(const float* sums, int k) {
  const int i = k / D, j = k % D;
  return sums[i <= j ? whw_index<D>(i, j) : whw_index<D>(j, i)];
}

}  // namespace
}  // namespace sfm
