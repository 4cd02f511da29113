// Reduced-camera-system kernels of the PCG solver: the Schur-Jacobi
// preconditioner blocks and the implicit Schur coupling matvec.
//
// whw_cam_reduce replaces sfm_tpu/kernels/schur_spmv.py whw_cam_reduce
// (Pallas: per-observation W Hpp^-1 W^T formed in VMEM, reduced into a
// [36, C] accumulator by a one-hot MXU matmul over the sequential grid).
// Bound on the H100: bytes — ~320 flops per observation against 80 bytes of
// index, W and Hpp^-1 reads, and the reads are gathers. One block per camera
// walks that camera's segment of the stable camera-sorting permutation;
// each thread forms the 6x6 product of its observations in registers and
// the block sums them in a fixed order (warp shuffles, then the warps in
// order). The [O, 6, 6] payload never reaches device memory, there are no
// float atomics, and a rerun gives identical bits. Hpp^-1 is read per point
// ([P, 3, 3]) through the observation's point id: no [9, O] gather.
//
// schur_coupling_matvec replaces schur_spmv.py schur_coupling_matvec
// (Pallas: paged VPU gather of v, tile-local same-point pair indicator and
// two-level one-hot MXU camera scatter with bf16 splits — all workarounds
// for the TPU's lack of gathers and scatters). Bound: bytes — W (72 bytes
// per observation) dominates; ~80 flops per observation. One warp per
// point walks the point's contiguous segment (observations are sorted by
// point, so the lanes' loads coalesce) twice: first u_o = W_o^T v[cam_o],
// summed over the segment into g_p by a fixed shuffle tree, and
// h_p = Hpp^-1_p g_p in registers; then y_o = W_o h_p written feature-major
// [6, O]. The deterministic sorted-segment reduction (segment_sum.cuh)
// then sums y by camera. No atomics anywhere: reruns are bit-identical.

#include <cuda_runtime.h>

#include "segment_sum.cuh"

namespace {

constexpr int kWhwThreads = 128;
constexpr int kPointThreads = 128;

__global__ __launch_bounds__(kWhwThreads) void whw_cam_kernel(
    const float* __restrict__ w_t, const float* __restrict__ hinv,
    const int* __restrict__ obs_point, const int* __restrict__ cam_perm,
    const int* __restrict__ cam_bounds, int O, float* __restrict__ out) {
  __shared__ float part[kWhwThreads / 32][36];
  const int c = blockIdx.x;
  const int lo = cam_bounds[c], hi = cam_bounds[c + 1];
  float acc[36];
#pragma unroll
  for (int k = 0; k < 36; ++k) acc[k] = 0.0f;
  for (int i = lo + threadIdx.x; i < hi; i += kWhwThreads) {
    const int o = cam_perm[i];
    const float* h = hinv + 9 * (size_t)obs_point[o];
    float W[18], H[9], u[18];
#pragma unroll
    for (int k = 0; k < 18; ++k) W[k] = w_t[(size_t)k * O + o];
#pragma unroll
    for (int k = 0; k < 9; ++k) H[k] = h[k];
    // u[i, l] = sum_k W[i, k] Hinv[k, l];  whw[i, j] = sum_l u[i, l] W[j, l].
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int l = 0; l < 3; ++l)
        u[r * 3 + l] = W[r * 3] * H[l] + W[r * 3 + 1] * H[3 + l] +
                       W[r * 3 + 2] * H[6 + l];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int j = 0; j < 6; ++j)
        acc[r * 6 + j] += u[r * 3] * W[j * 3] + u[r * 3 + 1] * W[j * 3 + 1] +
                          u[r * 3 + 2] * W[j * 3 + 2];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 36; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 36) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWhwThreads / 32; ++w) s += part[w][threadIdx.x];
    out[(size_t)c * 36 + threadIdx.x] = s;
  }
}

__global__ __launch_bounds__(kPointThreads) void coupling_point_kernel(
    const float* __restrict__ w_t, const float* __restrict__ hinv,
    const int* __restrict__ obs_cam, const int* __restrict__ point_bounds,
    const float* __restrict__ v, int O, int P, float* __restrict__ y_t) {
  // One warp per point: p is uniform across the warp, so a warp leaves
  // together and the shuffles below always see all 32 lanes.
  const int p = blockIdx.x * (kPointThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= P) return;
  const int lo = point_bounds[p], hi = point_bounds[p + 1];
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  for (int o = lo + lane; o < hi; o += 32) {
    const float* vc = v + 6 * (size_t)obs_cam[o];
    float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float vi = vc[i];
      u0 += w_t[(size_t)(i * 3) * O + o] * vi;
      u1 += w_t[(size_t)(i * 3 + 1) * O + o] * vi;
      u2 += w_t[(size_t)(i * 3 + 2) * O + o] * vi;
    }
    g0 += u0;
    g1 += u1;
    g2 += u2;
  }
  // Butterfly sum: every lane ends with the same bits (each level adds the
  // same two partial sums, in either order).
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    g0 += __shfl_xor_sync(0xffffffffu, g0, off);
    g1 += __shfl_xor_sync(0xffffffffu, g1, off);
    g2 += __shfl_xor_sync(0xffffffffu, g2, off);
  }
  const float* h = hinv + 9 * (size_t)p;
  const float h0 = h[0] * g0 + h[1] * g1 + h[2] * g2;
  const float h1 = h[3] * g0 + h[4] * g1 + h[5] * g2;
  const float h2 = h[6] * g0 + h[7] * g1 + h[8] * g2;
  for (int o = lo + lane; o < hi; o += 32) {
#pragma unroll
    for (int i = 0; i < 6; ++i)
      y_t[(size_t)i * O + o] = w_t[(size_t)(i * 3) * O + o] * h0 +
                               w_t[(size_t)(i * 3 + 1) * O + o] * h1 +
                               w_t[(size_t)(i * 3 + 2) * O + o] * h2;
  }
}

}  // namespace

extern "C" int sfm_whw_cam_reduce(const float* w_t, const float* hinv,
                                  const int* obs_point, const int* cam_perm,
                                  const int* cam_bounds, int O, int C,
                                  float* out, void* stream) {
  whw_cam_kernel<<<C, kWhwThreads, 0, (cudaStream_t)stream>>>(
      w_t, hinv, obs_point, cam_perm, cam_bounds, O, out);
  return (int)cudaGetLastError();
}

// y_t [6, O] is caller-allocated scratch; the point segments must cover
// every observation that cam_perm lists (point_bounds[0] = 0 and
// point_bounds[P] = N, the length of cam_perm): only those rows are written.
extern "C" int sfm_schur_coupling_matvec(
    const float* w_t, const float* hinv, const int* obs_cam,
    const int* point_bounds, const float* v, const int* cam_perm,
    const int* cam_bounds, int O, int P, int C, int seg_threads, float* y_t,
    float* out, void* stream) {
  constexpr int kPointsPerBlock = kPointThreads / 32;
  const int blocks = (P + kPointsPerBlock - 1) / kPointsPerBlock;
  coupling_point_kernel<<<blocks, kPointThreads, 0, (cudaStream_t)stream>>>(
      w_t, hinv, obs_cam, point_bounds, v, O, P, y_t);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return sfm::launch_segment_sum(y_t, cam_perm, cam_bounds, O, 6, C,
                                 seg_threads, out, (cudaStream_t)stream);
}
