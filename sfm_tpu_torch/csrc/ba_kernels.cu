// Bundle-adjustment kernels: fused normal-equation payloads, fused robust
// cost sums, and the deterministic sorted-segment reduction.
//
// fused_ne_payloads replaces sfm_tpu/kernels/schur_spmv.py fused_ne_payloads
// (Pallas: closed-form residual/Jacobian per observation tile, camera side
// reduced in VMEM through a one-hot MXU matmul). Bound on the H100: bytes —
// ~300 flops per observation against 32 bytes in and 276 bytes out. One
// thread per observation computes the residual and closed-form Jacobian
// (Rodrigues, k1/k2 distortion, SO(3) right Jacobian), the IRLS weight, the
// near-plane gate and the freeze masks, and stores feature-major payloads
// ([rows, O], so a warp's stores are contiguous): W = Jc^T Jp [18, O], the
// point payload sym(Jp^T Jp), -Jp^T r [9, O] and the camera payload
// vec(Jc^T Jc), -Jc^T r [42, O]. The TPU's one-hot camera matmul, paged
// gathers and bf16 splits are workarounds for the MXU and do not come over:
// camera rows are read straight from the [C, 6] tables (they stay in L1/L2),
// and the camera payload is reduced by segment_sum below.
//
// fused_cost_sums replaces schur_spmv.py fused_cost_sums. Bound: bytes
// (read 32 bytes per observation, ~60 flops). One thread per observation
// runs the same projection, a fixed-shape tree reduction per block writes
// partial sums, and a single-block second pass adds the partials in a fixed
// order, so both sums are deterministic.
//
// segment_sum replaces schur_spmv.py cam_segment_sum (Pallas one-hot MXU
// reduction into a VMEM accumulator). Bound: bytes (one read per value).
// One block per (segment, feature row) walks its segment of a sorting
// permutation (or of the identity, for already-sorted point segments) and
// tree-reduces in shared memory: no float atomics, so every run adds in the
// same order and gives the same bits.

#include <cuda_runtime.h>

#include "ba_project.cuh"

namespace {

using sfm::Projection;

constexpr int kNeThreads = 128;
constexpr int kCostThreads = 256;

__global__ __launch_bounds__(kNeThreads) void fused_ne_kernel(
    const int* __restrict__ obs_cam, const float* __restrict__ pts_t,
    const float* __restrict__ static_t, const float* __restrict__ cams,
    const float* __restrict__ intr, const float* __restrict__ zf, int O,
    int loss, float scale, float* __restrict__ w_t, float* __restrict__ yp_t,
    float* __restrict__ cam_t) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
  const int c = obs_cam[o];
  const float px = pts_t[o], py = pts_t[O + o], pz = pts_t[2 * O + o];
  const float u = static_t[o], v = static_t[O + o];
  float w_obs = static_t[2 * O + o];
  const float cam_free = static_t[3 * O + o];
  const float pt_free = static_t[4 * O + o];
  const float* cam = cams + 6 * c;
  const float* in = intr + 6 * c;
  const Projection P = sfm::project_obs(cam, in, px, py, pz, u, v);
  if (zf != nullptr) w_obs = (P.xc2 > *zf) ? w_obs : 0.0f;

  const float fx = in[0], fy = in[1], k1 = in[4], k2 = in[5];
  const float x = P.x, y = P.y, r2 = P.r2, s = P.s, inv_z = P.inv_z;
  const float* R = P.R;

  // M = diag(f) D_dist A_proj: d(uv)/d(x_cam), 2x3.
  const float dsc = (k1 + 2.0f * k2 * r2) * 2.0f;
  const float ds_dx = dsc * x, ds_dy = dsc * y;
  const float d00 = s + x * ds_dx, d01 = x * ds_dy;
  const float d10 = y * ds_dx, d11 = s + y * ds_dy;
  const float m00 = fx * inv_z * d00, m01 = fx * inv_z * d01;
  const float m02 = -fx * inv_z * (d00 * x + d01 * y);
  const float m10 = fy * inv_z * d10, m11 = fy * inv_z * d11;
  const float m12 = -fy * inv_z * (d10 * x + d11 * y);

  // Jp = M R.
  float jp0[3], jp1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    jp0[k] = m00 * R[k] + m01 * R[3 + k] + m02 * R[6 + k];
    jp1[k] = m10 * R[k] + m11 * R[3 + k] + m12 * R[6 + k];
  }
  // d(R p)/d rvec = -R [p]x Jr, Jr = I - B [w]x + C2 [w]x^2.
  float J[9];
  sfm::rot_entries(cam[0], cam[1], cam[2], -P.B, P.C2, J);
  float g0[3], g1[3], g2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g0[k] = -pz * J[3 + k] + py * J[6 + k];
    g1[k] = pz * J[k] - px * J[6 + k];
    g2[k] = -py * J[k] + px * J[3 + k];
  }
  float drx[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      drx[r][k] = -(R[3 * r] * g0[k] + R[3 * r + 1] * g1[k] + R[3 * r + 2] * g2[k]);
  // Jc = [M dRX | M].
  float jc0[6], jc1[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    jc0[k] = m00 * drx[0][k] + m01 * drx[1][k] + m02 * drx[2][k];
    jc1[k] = m10 * drx[0][k] + m11 * drx[1][k] + m12 * drx[2][k];
  }
  jc0[3] = m00; jc0[4] = m01; jc0[5] = m02;
  jc1[3] = m10; jc1[4] = m11; jc1[5] = m12;

  // IRLS weight on the unweighted residual, freeze masks folded in.
  const float ru = P.ru, rv = P.rv;
  const float w_r = sfm::robust_weight(ru * ru + rv * rv, loss, scale) * w_obs;
  const float sw = sqrtf(sfm::nan_max(w_r, 0.0f));
  const float ru_w = ru * sw, rv_w = rv * sw;
  const float swc = sw * cam_free, swp = sw * pt_free;
  float a[6], b[6], p0[3], p1[3];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    a[i] = jc0[i] * swc;
    b[i] = jc1[i] * swc;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p0[j] = jp0[j] * swp;
    p1[j] = jp1[j] * swp;
  }

  // Camera payload: vec(Jc^T Jc) (36) then -Jc^T r (6).
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      cam_t[(size_t)(i * 6 + j) * O + o] = a[i] * a[j] + b[i] * b[j];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    cam_t[(size_t)(36 + i) * O + o] = -(a[i] * ru_w + b[i] * rv_w);
  // W = Jc^T Jp, row-major 6x3.
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      w_t[(size_t)(i * 3 + j) * O + o] = a[i] * p0[j] + b[i] * p1[j];
  // Point payload: sym(Jp^T Jp) (00, 01, 02, 11, 12, 22) then -Jp^T r.
  yp_t[o] = p0[0] * p0[0] + p1[0] * p1[0];
  yp_t[(size_t)1 * O + o] = p0[0] * p0[1] + p1[0] * p1[1];
  yp_t[(size_t)2 * O + o] = p0[0] * p0[2] + p1[0] * p1[2];
  yp_t[(size_t)3 * O + o] = p0[1] * p0[1] + p1[1] * p1[1];
  yp_t[(size_t)4 * O + o] = p0[1] * p0[2] + p1[1] * p1[2];
  yp_t[(size_t)5 * O + o] = p0[2] * p0[2] + p1[2] * p1[2];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    yp_t[(size_t)(6 + j) * O + o] = -(p0[j] * ru_w + p1[j] * rv_w);
}

__global__ __launch_bounds__(kCostThreads) void cost_partials_kernel(
    const int* __restrict__ obs_cam, const float* __restrict__ pts_t,
    const float* __restrict__ static_t, const float* __restrict__ cams,
    const float* __restrict__ intr, const float* __restrict__ zf, int O,
    int loss, float scale, float* __restrict__ partials) {
  __shared__ float sc[kCostThreads];
  __shared__ float sw[kCostThreads];
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  float c = 0.0f, w = 0.0f;
  if (o < O) {
    const int cam = obs_cam[o];
    const Projection P = sfm::project_obs(
        cams + 6 * cam, intr + 6 * cam, pts_t[o], pts_t[O + o],
        pts_t[2 * O + o], static_t[o], static_t[O + o]);
    w = static_t[2 * O + o];
    if (zf != nullptr) w = (P.xc2 > *zf) ? w : 0.0f;
    c = sfm::robust_cost(P.ru * P.ru + P.rv * P.rv, loss, scale) * w;
  }
  sc[threadIdx.x] = c;
  sw[threadIdx.x] = w;
  __syncthreads();
  for (int off = kCostThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      sc[threadIdx.x] += sc[threadIdx.x + off];
      sw[threadIdx.x] += sw[threadIdx.x + off];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = sc[0];
    partials[2 * blockIdx.x + 1] = sw[0];
  }
}

__global__ __launch_bounds__(kCostThreads) void cost_finish_kernel(
    const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ float sc[kCostThreads];
  __shared__ float sw[kCostThreads];
  float c = 0.0f, w = 0.0f;
  for (int i = threadIdx.x; i < n; i += kCostThreads) {
    c += partials[2 * i];
    w += partials[2 * i + 1];
  }
  sc[threadIdx.x] = c;
  sw[threadIdx.x] = w;
  __syncthreads();
  for (int off = kCostThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) {
      sc[threadIdx.x] += sc[threadIdx.x + off];
      sw[threadIdx.x] += sw[threadIdx.x + off];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = sc[0];
    out[1] = sw[0];
  }
}

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

}  // namespace

extern "C" int sfm_fused_ne_payloads(const int* obs_cam, const float* pts_t,
                                     const float* static_t, const float* cams,
                                     const float* intr, const float* zf, int O,
                                     int loss, float scale, float* w_t,
                                     float* yp_t, float* cam_t, void* stream) {
  const int blocks = (O + kNeThreads - 1) / kNeThreads;
  fused_ne_kernel<<<blocks, kNeThreads, 0, (cudaStream_t)stream>>>(
      obs_cam, pts_t, static_t, cams, intr, zf, O, loss, scale, w_t, yp_t,
      cam_t);
  return (int)cudaGetLastError();
}

extern "C" int sfm_fused_cost_sums(const int* obs_cam, const float* pts_t,
                                   const float* static_t, const float* cams,
                                   const float* intr, const float* zf, int O,
                                   int loss, float scale, float* partials,
                                   int num_partials, float* out, void* stream) {
  cost_partials_kernel<<<num_partials, kCostThreads, 0, (cudaStream_t)stream>>>(
      obs_cam, pts_t, static_t, cams, intr, zf, O, loss, scale, partials);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  cost_finish_kernel<<<1, kCostThreads, 0, (cudaStream_t)stream>>>(
      partials, num_partials, out);
  return (int)cudaGetLastError();
}

extern "C" int sfm_segment_sum(const float* values, const int* perm,
                               const int* bounds, int O, int K, int S,
                               int threads, float* out, void* stream) {
  dim3 grid(S, K);
  segment_sum_kernel<<<grid, threads, threads * sizeof(float),
                       (cudaStream_t)stream>>>(values, perm, bounds, O, K, out);
  return (int)cudaGetLastError();
}
