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
// h_p = Hpp^-1_p g_p in registers; then y_o = W_o h_p, whose six values go
// straight to the observation's camera-sorted position of a packed [M, 6]
// scratch (24 contiguous bytes), so the packed pass of the deterministic
// sorted-segment reduction (segment_sum.cuh) sums y by camera with
// coalesced loads and no gather. No atomics anywhere: reruns are
// bit-identical.

//
// whw_payloads_big replaces schur_spmv.py whw_payloads_big (Pallas: the
// same W Hpp^-1 W^T tile written out per observation for camera counts whose
// one-hot accumulator does not fit VMEM). Bound: bytes — 76 bytes in
// (W and the point id; Hpp^-1 is read per point and stays in cache, as
// observations are sorted by point) and 144 out per observation against
// ~320 flops. One thread per observation in observation order, so W is read
// in contiguous rows (whw_cam_reduce gathers it in camera order) and the
// [36, O] payload is stored feature-major for the sorted-segment reduction.
//
// schur_coupling_payloads_big replaces schur_spmv.py
// schur_coupling_payloads_big (Pallas: v gathered per observation outside
// the kernel, the per-point sum through a tile-local same-point indicator
// matmul that needs every point segment inside one tile). Bound: bytes —
// W is read twice (144 bytes per observation), v 24, y 24. Observation-
// parallel, for long tracks: one thread per observation forms
// u_o = W_o^T v_o [3, O]; the deterministic sorted-segment reduction
// (segment_sum.cuh) sums u over each point's contiguous segment into g_p, a
// sub-warp group per point, so a segment of any length and at any offset is
// one group's work and no segment straddles anything; then one thread per
// observation forms y_o = W_o (Hpp^-1_p g_p) [6, O]. The caller reduces y by
// camera. No atomics: reruns are bit-identical.

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
    const float* __restrict__ v, const int* __restrict__ cam_inv_perm, int O,
    int P, float* __restrict__ y_packed) {
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
    const int place = cam_inv_perm[o];
    if (place < 0) continue;  // a zero-weight row: of no camera segment
    float* y = y_packed + 6 * (size_t)place;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      y[i] = w_t[(size_t)(i * 3) * O + o] * h0 +
             w_t[(size_t)(i * 3 + 1) * O + o] * h1 +
             w_t[(size_t)(i * 3 + 2) * O + o] * h2;
  }
}

constexpr int kObsThreads = 128;

__global__ __launch_bounds__(kObsThreads) void whw_payloads_kernel(
    const float* __restrict__ w_t, const float* __restrict__ hinv,
    const int* __restrict__ obs_point, int O, float* __restrict__ out_t) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
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
      out_t[(size_t)(r * 6 + j) * O + o] =
          u[r * 3] * W[j * 3] + u[r * 3 + 1] * W[j * 3 + 1] +
          u[r * 3 + 2] * W[j * 3 + 2];
}

// u_o = W_o^T v_o: w_t [18, O], v_obs_t [6, O] -> u_t [3, O].
__global__ __launch_bounds__(kObsThreads) void coupling_u_kernel(
    const float* __restrict__ w_t, const float* __restrict__ v_obs_t, int O,
    float* __restrict__ u_t) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
  float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float vi = v_obs_t[(size_t)i * O + o];
    u0 += w_t[(size_t)(i * 3) * O + o] * vi;
    u1 += w_t[(size_t)(i * 3 + 1) * O + o] * vi;
    u2 += w_t[(size_t)(i * 3 + 2) * O + o] * vi;
  }
  u_t[o] = u0;
  u_t[(size_t)O + o] = u1;
  u_t[(size_t)2 * O + o] = u2;
}

// y_o = W_o Hpp^-1_p g_p for the observations [0, N) that the point
// segments cover, zero for the unweighted tail [N, O).
__global__ __launch_bounds__(kObsThreads) void coupling_y_kernel(
    const float* __restrict__ w_t, const float* __restrict__ hinv,
    const int* __restrict__ obs_point, const float* __restrict__ g, int O,
    int N, float* __restrict__ y_t) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
  float h0 = 0.0f, h1 = 0.0f, h2 = 0.0f;
  if (o < N) {
    const size_t p = (size_t)obs_point[o];
    const float* h = hinv + 9 * p;
    const float g0 = g[3 * p], g1 = g[3 * p + 1], g2 = g[3 * p + 2];
    h0 = h[0] * g0 + h[1] * g1 + h[2] * g2;
    h1 = h[3] * g0 + h[4] * g1 + h[5] * g2;
    h2 = h[6] * g0 + h[7] * g1 + h[8] * g2;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
    y_t[(size_t)i * O + o] =
        o < N ? w_t[(size_t)(i * 3) * O + o] * h0 +
                    w_t[(size_t)(i * 3 + 1) * O + o] * h1 +
                    w_t[(size_t)(i * 3 + 2) * O + o] * h2
              : 0.0f;
}

}  // namespace

extern "C" int sfm_whw_payloads_big(const float* w_t, const float* hinv,
                                    const int* obs_point, int O, float* out_t,
                                    void* stream) {
  const int blocks = (O + kObsThreads - 1) / kObsThreads;
  whw_payloads_kernel<<<blocks, kObsThreads, 0, (cudaStream_t)stream>>>(
      w_t, hinv, obs_point, O, out_t);
  return (int)cudaGetLastError();
}

// u_t [3, O] and g [P, 3] are caller-allocated scratch; point_bounds [P+1]
// covers the observations [0, N) (sorted by point); seg_lanes is the
// sub-warp group width of the point-side reduction.
extern "C" int sfm_schur_coupling_payloads_big(
    const float* w_t, const float* hinv, const int* obs_point,
    const int* point_bounds, const float* v_obs_t, int O, int P, int N,
    int seg_lanes, float* u_t, float* g, float* y_t, void* stream) {
  const int blocks = (O + kObsThreads - 1) / kObsThreads;
  coupling_u_kernel<<<blocks, kObsThreads, 0, (cudaStream_t)stream>>>(
      w_t, v_obs_t, O, u_t);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = sfm::launch_segment_sum(u_t, nullptr, point_bounds, O, 3, P, N,
                                seg_lanes, nullptr, g, (cudaStream_t)stream);
  if (err != 0) return err;
  coupling_y_kernel<<<blocks, kObsThreads, 0, (cudaStream_t)stream>>>(
      w_t, hinv, obs_point, g, O, N, y_t);
  return (int)cudaGetLastError();
}

extern "C" int sfm_whw_cam_reduce(const float* w_t, const float* hinv,
                                  const int* obs_point, const int* cam_perm,
                                  const int* cam_bounds, int O, int C,
                                  float* out, void* stream) {
  whw_cam_kernel<<<C, kWhwThreads, 0, (cudaStream_t)stream>>>(
      w_t, hinv, obs_point, cam_perm, cam_bounds, O, out);
  return (int)cudaGetLastError();
}

// The point segments must cover exactly the observations [0, N)
// (point_bounds[0] = 0, point_bounds[P] = N); cam_inv_perm [N] is each one's
// place among the M weighted observations in their stable camera sort, which
// cam_bounds [C+1] cuts into segments, or -1 for a zero-weight row;
// y_packed [M, 6] is caller-allocated scratch and seg_warps the warps per
// camera of the packed reduction.
extern "C" int sfm_schur_coupling_matvec(
    const float* w_t, const float* hinv, const int* obs_cam,
    const int* point_bounds, const float* v, const int* cam_inv_perm,
    const int* cam_bounds, int O, int P, int C, int seg_warps, float* y_packed,
    float* out, void* stream) {
  constexpr int kPointsPerBlock = kPointThreads / 32;
  const int blocks = (P + kPointsPerBlock - 1) / kPointsPerBlock;
  coupling_point_kernel<<<blocks, kPointThreads, 0, (cudaStream_t)stream>>>(
      w_t, hinv, obs_cam, point_bounds, v, cam_inv_perm, O, P, y_packed);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return sfm::launch_segment_sum_packed(y_packed, cam_bounds, 6, C, seg_warps,
                                        out, (cudaStream_t)stream);
}
