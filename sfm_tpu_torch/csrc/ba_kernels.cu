// Bundle-adjustment kernels: the normal equations over point segments, the
// LM candidate's back-substitution and robust cost, their large-camera-count
// twins, and the deterministic sorted-segment reduction.
//
// fused_ne_payloads (K3) replaces sfm_tpu/kernels/schur_spmv.py
// fused_ne_payloads (Pallas: closed-form residual/Jacobian per observation
// tile, the camera side reduced in VMEM by a one-hot MXU matmul into
// cam_red [C, 48]) together with the reductions, damping and 3x3 inversions
// that sfm_tpu/ba/core.py build_normal_equations runs around it. Bound on
// the H100: bytes — ~300 flops per observation against ~44 bytes in and up
// to 240 out (W 72, the packed camera row 168). At the main path's shapes a
// chain of small launches around a per-observation kernel cost more than
// the kernel itself, so the reductions go where the per-observation work is,
// and the whole build is two launches:
//  1. ne_points_kernel: block b owns a slice of the points and so the
//     contiguous range of their observations (observations are sorted by
//     point; slices balanced by observation count and cut at point
//     boundaries, pcg_solve's plan). It walks the range in chunks of one
//     observation per thread: the thread computes the residual, closed-form
//     Jacobian (SO(3) right Jacobian, k1/k2 distortion), IRLS weight,
//     near-plane gate and freeze masks, stores W = Jc^T Jp [18, O]
//     feature-major and the camera row vec(Jc^T Jc), -Jc^T r (42 floats) at
//     the observation's camera-sorted place of a packed [M, 42] buffer (rows
//     of no camera segment store nothing), and leaves sym(Jp^T Jp), -Jp^T r
//     in shared memory. After a barrier the thread of each point segment's
//     first observation adds its point's terms in observation order (a
//     point that spans chunks carries its sums over in shared memory), damps
//     the diagonal (lam read from the device: no host sync), inverts the 3x3
//     block by the Jacobi-equilibrated adjugate with the plain version's
//     determinant clamp, and writes Hpp^-1 [P, 3, 3] and bp [P, 3]. Points
//     without observations (the capacity padding's slots) get the damped
//     inverse of a zero block, and the zero-weight tail [N, O) of W zeros,
//     each block taking its share. A first version gave each point a
//     sub-warp group of lanes sized by the mean track length (4 lanes for
//     tracks of 3.5 views); a track of tens of views then ran its
//     observations one after another, and that group set the kernel's time.
//  2. ne_cams_kernel: the packed pass of segment_sum.cuh per camera (the
//     rows already lie in camera order, so K9's transpose-scatter drops
//     out), with the diagonal damping folded in: Hcc [C, 6, 6], bc [C, 6].
// For a PCG solve K3 also builds the Schur-Jacobi preconditioner's blocks
// sum_c W Hpp^-1 W^T, which replace sfm_tpu/kernels/schur_spmv.py
// whw_cam_reduce (K7) on the solver's path: the camera rows are then 64
// floats wide, and after its chunks ne_points_kernel sweeps its slice once
// more, when the damped Hpp^-1 of all its points are written (by this
// block: slices hold whole points), one observation a thread in
// observation order (W in contiguous rows, Hpp^-1 per point, which
// neighbouring threads share), and stores the 21 distinct entries of
// W_o Hpp^-1 W_o^T (schur_jacobi.cuh) beside the observation's camera row;
// ne_cams_kernel sums 63 columns in place of 42 and writes the mirrored
// blocks [C, 36] too. No launch of its own, and the dense solves (which
// need no preconditioner) do not pay for it. The standalone whw_cam_reduce
// entry (schur_kernels.cu) runs the same device code.
//
// fused_cost_sums (K5) replaces schur_spmv.py fused_cost_sums (Pallas: the
// robust cost over observation tiles) together with the LM candidate of
// sfm_tpu/ba/core.py bundle_adjust_impl around it: the back-substitution
// dp = Hpp^-1 (bp - W^T dc), the freeze masks and the candidate parameters.
// Bound: bytes — W (72 bytes per observation) dominates; ~130 flops. One
// launch on K3's slices and chunks: a first pass forms u_o = W_o^T dc[cam_o]
// per observation (dc read from the [C, 6] table, masked by cam_fixed), the
// thread of each segment's first observation sums them and writes the
// candidate point (dp zero for a fixed point); after a barrier a second
// pass projects each observation's candidate point (written by the same
// block) through its candidate camera (cams + masked dc, formed in
// registers) and adds the robust cost times the gated weight. Each block
// writes its two sums; the last block to finish (an integer ticket taken
// after __threadfence and reset by that block) adds the blocks' sums in
// block order and writes the mean cost. The cost at given parameters is
// the second pass alone (a template flag), also one launch.
//
// fused_ne_payloads_big (K4) and fused_cost_sums_big (K6) replace
// schur_spmv.py fused_ne_payloads_big and fused_cost_sums_big (Pallas: the
// same tiles on camera and intrinsic rows gathered per observation outside
// the kernel, for camera counts whose one-hot tiles do not fit VMEM).
// Bound: bytes — 80 bytes in per observation (points, statics and the two
// pre-gathered [6, O] row sets) against 276 out for the NE payloads, 80 in
// for the cost. One thread per observation reads its own feature-major
// rows, so every load of a warp is contiguous and nothing depends on the
// camera count. The per-observation arithmetic is K3's and K5's device code
// (ne_rows, cost_term), shared line for line; K4 stores the camera payload
// [42, O] and the point payload [9, O] feature-major for the caller's K9
// reductions, and K6 adds its block sums in a second, one-block launch.
//
// segment_sum replaces schur_spmv.py cam_segment_sum (Pallas one-hot MXU
// reduction into a VMEM accumulator). Bound: bytes (one read per value).
// The kernels (segment_sum.cuh) are a sub-warp shuffle reduction for
// segments that lie in order and a coalesced transpose-scatter plus packed
// reduction for segments of a permutation.
//
// No float atomics anywhere: every sum is taken in an order fixed by the
// shapes, the tables and the launch widths, so a rerun gives identical bits.

#include <cuda_runtime.h>

#include "ba_project.cuh"
#include "schur_jacobi.cuh"
#include "segment_sum.cuh"

namespace {

using sfm::Projection;

constexpr int kNeThreads = 128;
constexpr int kCostThreads = 256;
constexpr int kSegThreads = 512;   // K3 and K5: observations per chunk, one a thread
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kCamRows = 42;       // vec(Jc^T Jc) (36) then -Jc^T r (6)
// With the Schur-Jacobi blocks: the camera row, the 21 entries of
// W Hpp^-1 W^T, one unused float (16-byte rows).
constexpr int kPcgRow = 64;
constexpr unsigned kFull = 0xffffffffu;

// The IRLS-weighted Jacobian rows of one observation: the two rows of Jc
// (scaled by the camera-free mask) and of Jp (by the point-free mask), and
// the weighted residual.
struct NeRows {
  float a[6], b[6];
  float p0[3], p1[3];
  float ru_w, rv_w;
};

// Residual, closed-form Jacobian, IRLS weight, near-plane gate and freeze
// masks of an observation (u, v, weight w_obs, masks) of the point
// (px, py, pz) in the camera `cam` (rvec, tvec) with intrinsics `in`.
__device__ __forceinline__ NeRows ne_rows(const float* cam, const float* in,
                                         float px, float py, float pz,
                                         float u, float v, float w_obs,
                                         float cam_free, float pt_free,
                                         const float* __restrict__ zf,
                                         int loss, float scale) {
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
  const float swc = sw * cam_free, swp = sw * pt_free;
  NeRows out;
  out.ru_w = ru * sw;
  out.rv_w = rv * sw;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    out.a[i] = jc0[i] * swc;
    out.b[i] = jc1[i] * swc;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out.p0[j] = jp0[j] * swp;
    out.p1[j] = jp1[j] * swp;
  }
  return out;
}

// Entry k of the camera payload: vec(Jc^T Jc) for k < 36, then -Jc^T r.
// k must be a compile-time constant after unrolling.
__device__ __forceinline__ float cam_entry(const NeRows& J, int k) {
  if (k < 36) {
    const int i = k / 6, j = k % 6;
    return J.a[i] * J.a[j] + J.b[i] * J.b[j];
  }
  const int i = k - 36;
  return -(J.a[i] * J.ru_w + J.b[i] * J.rv_w);
}

// Entry k of the point payload: sym(Jp^T Jp) (00, 01, 02, 11, 12, 22), then
// -Jp^T r. k must be a compile-time constant after unrolling.
__device__ __forceinline__ float point_entry(const NeRows& J, int k) {
  if (k < 6) {
    const int i = k < 3 ? 0 : (k < 5 ? 1 : 2);
    const int j = k < 3 ? k : (k < 5 ? k - 2 : 2);
    return J.p0[i] * J.p0[j] + J.p1[i] * J.p1[j];
  }
  const int j = k - 6;
  return -(J.p0[j] * J.ru_w + J.p1[j] * J.rv_w);
}

// W = Jc^T Jp, row-major 6x3, stored feature-major at column o of [18, O].
__device__ __forceinline__ void store_w(const NeRows& J, float* __restrict__ w_t,
                                        int O, int o) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      w_t[(size_t)(i * 3 + j) * O + o] = J.a[i] * J.p0[j] + J.b[i] * J.p1[j];
}

// ---- K3: the normal equations over point segments ---------------------------

struct NeArgs {
  const int* obs_cam;       // [O]
  const int* obs_point;     // [O]
  const float* points;      // [P, 3]
  const float* static_t;    // [5, O] u, v, weight, camera-free, point-free
  const float* cams;        // [C, 6]
  const float* intr;        // [C, 6]
  const float* zf;          // 0-d or null
  const float* lam;         // 0-d
  const int* point_bounds;  // [P+1] over [0, N)
  const int* cam_inv_perm;  // [N]
  const int* block_points;  // [G+1]
  int O, P, loss;
  float scale;
  int row;                  // floats per packed row: kCamRows, or kPcgRow with the blocks
  float* w_t;               // [18, O]
  float* packed;            // [M, row]
  float* hinv;              // [P, 9]
  float* bp;                // [P, 3]
};

// Damped point block from its sums t (sym(Jp^T Jp) 6, -Jp^T r 3), inverted
// and written: Hpp_d = Hpp + (lam diag(Hpp) + 1e-6) I, inverted as
// D (D Hpp_d D)^-1 D with D = diag(Hpp_d)^-1/2 by the adjugate, the
// determinant clamped to 1e-10 (kernels/ba_kernels.py sym_solve3's algorithm).
__device__ __forceinline__ void finish_point(const NeArgs& a, int p, const float (&t)[9],
                                             float lam) {
  float A[3][3];
  A[0][0] = t[0]; A[0][1] = t[1]; A[0][2] = t[2];
  A[1][0] = t[1]; A[1][1] = t[3]; A[1][2] = t[4];
  A[2][0] = t[2]; A[2][1] = t[4]; A[2][2] = t[5];
#pragma unroll
  for (int i = 0; i < 3; ++i) A[i][i] = A[i][i] + (lam * A[i][i] + 1e-6f);
  float dinv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dinv[i] = 1.0f / sqrtf(sfm::nan_max(fabsf(A[i][i]), 1e-18f));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i][j] = A[i][j] * dinv[i] * dinv[j];
  const float a0 = A[0][0], b0 = A[0][1], c0 = A[0][2];
  const float d0 = A[1][1], e0 = A[1][2], f0 = A[2][2];
  const float co00 = d0 * f0 - e0 * e0;
  const float co01 = c0 * e0 - b0 * f0;
  const float co02 = b0 * e0 - c0 * d0;
  const float co11 = a0 * f0 - c0 * c0;
  const float co12 = b0 * c0 - a0 * e0;
  const float co22 = a0 * d0 - b0 * b0;
  const float det = a0 * co00 + b0 * co01 + c0 * co02;
  const float inv_det = 1.0f / (fabsf(det) < 1e-10f ? 1e-10f : det);
  const float co[9] = {co00, co01, co02, co01, co11, co12, co02, co12, co22};
  float* h = a.hinv + 9 * (size_t)p;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) h[3 * i + j] = co[3 * i + j] * inv_det * dinv[i] * dinv[j];
#pragma unroll
  for (int j = 0; j < 3; ++j) a.bp[3 * (size_t)p + j] = t[6 + j];
}

// The sums over one point's observations [lo, hi) in chunk `chunk`
// [c0, c1), whose per-observation terms lie in rows[k][o - c0] (shared
// memory), by the thread of the segment's first observation in the chunk,
// in observation order. A point that began in an earlier chunk starts from
// its sums so far, carry[chunk & 1]; one that runs on past c1 leaves its
// sums in carry[(chunk + 1) & 1] (two slots: the chunk's first segment
// reads one while its last may write the other) and returns false. Returns
// true when `t` holds the point's total.
template <int K>
__device__ __forceinline__ bool segment_total(float (*rows)[kSegThreads], int chunk, int c0,
                                              int c1, int lo, int hi, int first,
                                              float (*carry)[K], float (&t)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = lo < c0 ? carry[chunk & 1][k] : 0.0f;
  const int end = min(hi, c1) - c0;
  for (int j = first - c0; j < end; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) t[k] += rows[k][j];
  }
  if (hi <= c1) return true;
#pragma unroll
  for (int k = 0; k < K; ++k) carry[(chunk + 1) & 1][k] = t[k];
  return false;
}

// Block b owns the observations [o_lo, o_hi) of its points (pcg_solve's
// slices) and walks them in chunks of kSegThreads, one observation a
// thread; then the first thread of each point segment in the chunk adds the
// segment's terms from shared memory. Points without observations (the
// capacity padding's slots among them) are finished by every block for its
// share of [0, P), the zero-weight tail [N, O) of W likewise. With the
// Schur-Jacobi blocks (a.row == kPcgRow) a last sweep over the slice stores
// each weighted observation's 21 entries of W Hpp^-1 W^T at columns
// [42, 63) of its packed row.
__global__ __launch_bounds__(kSegThreads) void ne_points_kernel(const NeArgs a) {
  __shared__ float rows[9][kSegThreads];
  __shared__ float carry[2][9];
  const int b = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const int O = a.O;
  const float lam = *a.lam;
  const int o_lo = a.point_bounds[a.block_points[b]];
  const int o_hi = a.point_bounds[a.block_points[b + 1]];
  for (int chunk = 0, c0 = o_lo; c0 < o_hi; ++chunk, c0 += kSegThreads) {
    const int c1 = min(c0 + kSegThreads, o_hi);
    const int o = c0 + tid;
    int pt = -1;
    if (o < c1) {
      pt = a.obs_point[o];
      const int c = a.obs_cam[o];
      const float* p = a.points + 3 * (size_t)pt;
      const NeRows J = ne_rows(a.cams + 6 * (size_t)c, a.intr + 6 * (size_t)c, p[0], p[1], p[2],
                               a.static_t[o], a.static_t[(size_t)O + o],
                               a.static_t[(size_t)2 * O + o], a.static_t[(size_t)3 * O + o],
                               a.static_t[(size_t)4 * O + o], a.zf, a.loss, a.scale);
      store_w(J, a.w_t, O, o);
      const int place = a.cam_inv_perm[o];
      if (place >= 0 && a.row == kCamRows) {
        // 168 bytes per row: every row starts 8-byte aligned.
        float2* row = reinterpret_cast<float2*>(a.packed + (size_t)kCamRows * place);
#pragma unroll
        for (int k = 0; k < kCamRows / 2; ++k)
          row[k] = make_float2(cam_entry(J, 2 * k), cam_entry(J, 2 * k + 1));
      } else if (place >= 0) {
        // 256 bytes per row: 16-byte stores.
        float4* row = reinterpret_cast<float4*>(a.packed + (size_t)kPcgRow * place);
#pragma unroll
        for (int k = 0; k < kCamRows / 4; ++k)
          row[k] = make_float4(cam_entry(J, 4 * k), cam_entry(J, 4 * k + 1),
                               cam_entry(J, 4 * k + 2), cam_entry(J, 4 * k + 3));
        reinterpret_cast<float2*>(row)[kCamRows / 2 - 1] =
            make_float2(cam_entry(J, kCamRows - 2), cam_entry(J, kCamRows - 1));
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) rows[k][tid] = point_entry(J, k);
    }
    __syncthreads();
    if (pt >= 0 && (o == c0 || a.obs_point[o - 1] != pt)) {
      float t[9];
      if (segment_total(rows, chunk, c0, c1, a.point_bounds[pt], a.point_bounds[pt + 1], o, carry,
                        t))
        finish_point(a, pt, t, lam);
    }
    __syncthreads();
  }
  if (a.row == kPcgRow) {
    // W and Hpp^-1 of the slice were written by this block before the last
    // barrier.
    for (int o = o_lo + tid; o < o_hi; o += kSegThreads) {
      const int place = a.cam_inv_perm[o];
      if (place < 0) continue;
      float e[sfm::kWhwEntries];
      sfm::whw_of_observation(a.w_t, a.hinv, O, o, a.obs_point[o], e);
      // Column 42 of a 256-byte row: 8-byte aligned.
      float* dst = a.packed + (size_t)kPcgRow * place + kCamRows;
#pragma unroll
      for (int k = 0; k < sfm::kWhwEntries / 2; ++k)
        reinterpret_cast<float2*>(dst)[k] = make_float2(e[2 * k], e[2 * k + 1]);
      dst[sfm::kWhwEntries - 1] = e[sfm::kWhwEntries - 1];
    }
  }
  float zero[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) zero[k] = 0.0f;
  for (int p = b * kSegThreads + tid; p < a.P; p += G * kSegThreads)
    if (a.point_bounds[p] == a.point_bounds[p + 1]) finish_point(a, p, zero, lam);
  const int N = a.point_bounds[a.P];
  for (int o = N + b * kSegThreads + tid; o < O; o += G * kSegThreads) {
#pragma unroll
    for (int k = 0; k < 18; ++k) a.w_t[(size_t)k * O + o] = 0.0f;
  }
}

// Camera c's 42 sums of the packed rows [cam_bounds[c], cam_bounds[c+1]),
// the diagonal of Hcc damped by lam diag + 1e-6; with whw (rows of kPcgRow
// floats) also the 21 sums of W Hpp^-1 W^T, mirrored to whw [C, 36].
// blockDim = 32 * warps.
__global__ __launch_bounds__(32 * sfm::kMaxSegmentWarps) void ne_cams_kernel(
    const float* __restrict__ packed, const int* __restrict__ cam_bounds,
    const float* __restrict__ lam, float* __restrict__ hcc, float* __restrict__ bc,
    float* __restrict__ whw) {
  __shared__ float part[sfm::kMaxSegmentWarps][sfm::kTileRows];
  __shared__ float sums[kCamRows + sfm::kWhwEntries];
  const int c = blockIdx.x;
  const int row = whw != nullptr ? kPcgRow : kCamRows;
  const int cols = whw != nullptr ? kCamRows + sfm::kWhwEntries : kCamRows;
  sfm::segment_sum_packed_rows(packed, cam_bounds[c], cam_bounds[c + 1], row, 0, cols, part,
                               sums);
  __syncthreads();
  const float l = *lam;
  for (int k = threadIdx.x; k < kCamRows; k += blockDim.x) {
    float v = sums[k];
    if (k < 36) {
      if (k % 7 == 0) v = v + (l * v + 1e-6f);
      hcc[36 * (size_t)c + k] = v;
    } else {
      bc[6 * (size_t)c + k - 36] = v;
    }
  }
  if (whw != nullptr)
    for (int k = threadIdx.x; k < 36; k += blockDim.x)
      whw[36 * (size_t)c + k] = sfm::whw_block_entry(sums + kCamRows, k);
}

// ---- K5: the LM candidate and its robust cost -------------------------------

struct CostArgs {
  const int* obs_cam;            // [O]
  const int* obs_point;          // [O]
  const float* points;           // [P, 3]
  const float* static_t;         // [5, O]
  const float* cams;             // [C, 6]
  const float* intr;             // [C, 6]
  const float* zf;               // 0-d or null
  const int* point_bounds;       // [P+1] over [0, N)
  const int* block_points;       // [G+1]
  // The step (candidate mode only):
  const float* dc;               // [C, 6]
  const unsigned char* cam_fixed;    // [C]
  const unsigned char* point_fixed;  // [P]
  const float* w_t;              // [18, O]
  const float* hinv;             // [P, 9]
  const float* bp;               // [P, 3]
  int O, P, C, loss;
  float scale;
  float* new_points;             // [P, 3] (candidate mode)
  float* new_cams;               // [C, 6] (candidate mode)
  float* partials;               // [2, G]
  unsigned int* ticket;          // 0 on entry, 0 again on exit
  float* out;                    // [3]: sum cost * w, sum w, their mean
};

// Robust cost times the (gated) weight, and the weight, of one observation.
__device__ __forceinline__ void cost_term(const float* cam, const float* in, float px,
                                          float py, float pz, float u, float v, float w,
                                          const float* __restrict__ zf, int loss,
                                          float scale, float* cw, float* wout) {
  const Projection P = sfm::project_obs(cam, in, px, py, pz, u, v);
  if (zf != nullptr) w = (P.xc2 > *zf) ? w : 0.0f;
  *cw = sfm::robust_cost(P.ru * P.ru + P.rv * P.rv, loss, scale) * w;
  *wout = w;
}

// dc[c, i] unless camera c is fixed.
__device__ __forceinline__ float step_cam(const CostArgs& a, int c, int i) {
  return a.cam_fixed[c] ? 0.0f : a.dc[6 * (size_t)c + i];
}

// new_points[p] = points[p] + dp, dp = Hpp^-1 (bp - g) (zero for a fixed point).
__device__ __forceinline__ void candidate_point(const CostArgs& a, int p, const float (&g)[3]) {
  const float* h = a.hinv + 9 * (size_t)p;
  const float* bpp = a.bp + 3 * (size_t)p;
  const float r0 = bpp[0] - g[0], r1 = bpp[1] - g[1], r2 = bpp[2] - g[2];
  float d0 = h[0] * r0 + h[1] * r1 + h[2] * r2;
  float d1 = h[3] * r0 + h[4] * r1 + h[5] * r2;
  float d2 = h[6] * r0 + h[7] * r1 + h[8] * r2;
  if (a.point_fixed[p]) d0 = d1 = d2 = 0.0f;
  const float* q = a.points + 3 * (size_t)p;
  float* out = a.new_points + 3 * (size_t)p;
  out[0] = q[0] + d0;
  out[1] = q[1] + d1;
  out[2] = q[2] + d2;
}

// Block b walks its observation slice as K3 does. With a step, a first pass
// forms u_o = W_o^T dc[cam_o] per observation and the first thread of each
// point segment sums them (g) and writes the candidate point; points
// without observations and the candidate cameras are written by every block
// for its share. The second pass (the only one without a step) projects each
// observation's (candidate) point through its (candidate) camera: the
// points it reads were written by this block before the barrier.
template <bool kStep>
__global__ __launch_bounds__(kSegThreads) void cost_points_kernel(const CostArgs a) {
  __shared__ float rows[3][kSegThreads];
  __shared__ float carry[2][3];
  __shared__ float red[kSegWarps][2];
  __shared__ bool last;
  const int b = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const int O = a.O;
  const int o_lo = a.point_bounds[a.block_points[b]];
  const int o_hi = a.point_bounds[a.block_points[b + 1]];
  if constexpr (kStep) {
    for (int chunk = 0, c0 = o_lo; c0 < o_hi; ++chunk, c0 += kSegThreads) {
      const int c1 = min(c0 + kSegThreads, o_hi);
      const int o = c0 + tid;
      int pt = -1;
      if (o < c1) {
        pt = a.obs_point[o];
        const int c = a.obs_cam[o];
        float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float di = step_cam(a, c, i);
          u0 += a.w_t[(size_t)(i * 3) * O + o] * di;
          u1 += a.w_t[(size_t)(i * 3 + 1) * O + o] * di;
          u2 += a.w_t[(size_t)(i * 3 + 2) * O + o] * di;
        }
        rows[0][tid] = u0;
        rows[1][tid] = u1;
        rows[2][tid] = u2;
      }
      __syncthreads();
      if (pt >= 0 && (o == c0 || a.obs_point[o - 1] != pt)) {
        float g[3];
        if (segment_total(rows, chunk, c0, c1, a.point_bounds[pt], a.point_bounds[pt + 1], o,
                          carry, g))
          candidate_point(a, pt, g);
      }
      __syncthreads();
    }
    const float g0[3] = {0.0f, 0.0f, 0.0f};
    for (int p = b * kSegThreads + tid; p < a.P; p += G * kSegThreads)
      if (a.point_bounds[p] == a.point_bounds[p + 1]) candidate_point(a, p, g0);
    for (int e = b * kSegThreads + tid; e < 6 * a.C; e += G * kSegThreads)
      a.new_cams[e] = a.cams[e] + step_cam(a, e / 6, e % 6);
  }
  float acc_c = 0.0f, acc_w = 0.0f;
  for (int o = o_lo + tid; o < o_hi; o += kSegThreads) {
    const int pt = a.obs_point[o];
    const int c = a.obs_cam[o];
    const float* p = (kStep ? a.new_points : a.points) + 3 * (size_t)pt;
    float cam[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      cam[i] = a.cams[6 * (size_t)c + i];
      if constexpr (kStep) cam[i] = cam[i] + step_cam(a, c, i);
    }
    float cw, w;
    cost_term(cam, a.intr + 6 * (size_t)c, p[0], p[1], p[2], a.static_t[o],
              a.static_t[(size_t)O + o], a.static_t[(size_t)2 * O + o], a.zf, a.loss, a.scale,
              &cw, &w);
    acc_c += cw;
    acc_w += w;
  }
  // The block's sums: butterflies in the warps, then the warps in order.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc_c += __shfl_xor_sync(kFull, acc_c, off);
    acc_w += __shfl_xor_sync(kFull, acc_w, off);
  }
  if ((tid & 31) == 0) {
    red[tid >> 5][0] = acc_c;
    red[tid >> 5][1] = acc_w;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f, t = 0.0f;
    for (int w = 0; w < kSegWarps; ++w) {
      s += red[w][0];
      t += red[w][1];
    }
    a.partials[b] = s;
    a.partials[G + b] = t;
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == (unsigned)(G - 1);
  }
  __syncthreads();
  if (!last || tid >= 32) return;
  // The last block: every block's sums, in an order fixed by G alone.
  __threadfence();
  float s = 0.0f, t = 0.0f;
  for (int i = tid; i < G; i += 32) {
    s += __ldcg(a.partials + i);
    t += __ldcg(a.partials + G + i);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(kFull, s, off);
    t += __shfl_xor_sync(kFull, t, off);
  }
  if (tid == 0) {
    a.out[0] = s;
    a.out[1] = t;
    a.out[2] = s / sfm::nan_max(t, 1.0f);
    *a.ticket = 0u;
  }
}

// ---- K4 and K6: rows gathered per observation -------------------------------

// Row k of a feature-major [6, O] table at observation o, for k = 0..5.
__device__ __forceinline__ void load_rows6(const float* __restrict__ rows_t,
                                           int O, int o, float out[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k] = rows_t[(size_t)k * O + o];
}

__global__ __launch_bounds__(kNeThreads) void fused_ne_big_kernel(
    const float* __restrict__ pts_t, const float* __restrict__ static_t,
    const float* __restrict__ cams_t, const float* __restrict__ intr_t,
    const float* __restrict__ zf, int O, int loss, float scale,
    float* __restrict__ w_t, float* __restrict__ yp_t,
    float* __restrict__ cam_t) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
  float cam[6], in[6];
  load_rows6(cams_t, O, o, cam);
  load_rows6(intr_t, O, o, in);
  const NeRows J = ne_rows(cam, in, pts_t[o], pts_t[O + o], pts_t[(size_t)2 * O + o],
                           static_t[o], static_t[O + o], static_t[(size_t)2 * O + o],
                           static_t[(size_t)3 * O + o], static_t[(size_t)4 * O + o], zf,
                           loss, scale);
  store_w(J, w_t, O, o);
#pragma unroll
  for (int k = 0; k < kCamRows; ++k) cam_t[(size_t)k * O + o] = cam_entry(J, k);
#pragma unroll
  for (int k = 0; k < 9; ++k) yp_t[(size_t)k * O + o] = point_entry(J, k);
}

// Fixed-shape tree sum of (c, w) over the block into sc[0], sw[0].
__device__ __forceinline__ void cost_block_sum(float c, float w, float* sc,
                                               float* sw) {
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
}

__global__ __launch_bounds__(kCostThreads) void cost_partials_big_kernel(
    const float* __restrict__ pts_t, const float* __restrict__ static_t,
    const float* __restrict__ cams_t, const float* __restrict__ intr_t,
    const float* __restrict__ zf, int O, int loss, float scale,
    float* __restrict__ partials) {
  __shared__ float sc[kCostThreads];
  __shared__ float sw[kCostThreads];
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  float c = 0.0f, w = 0.0f;
  if (o < O) {
    float cam[6], in[6];
    load_rows6(cams_t, O, o, cam);
    load_rows6(intr_t, O, o, in);
    cost_term(cam, in, pts_t[o], pts_t[O + o], pts_t[(size_t)2 * O + o], static_t[o],
              static_t[O + o], static_t[(size_t)2 * O + o], zf, loss, scale, &c, &w);
  }
  cost_block_sum(c, w, sc, sw);
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
  cost_block_sum(c, w, sc, sw);
  if (threadIdx.x == 0) {
    out[0] = sc[0];
    out[1] = sw[0];
  }
}

}  // namespace

// K3. block_points [grid+1] cuts the points into the blocks' slices
// (pcg_solve's plan); observations are sorted by point (obs_point) and
// point_bounds [P+1] covers [0, N); cam_inv_perm [N] gives each
// observation's place among the M weighted ones in their stable camera sort
// (-1: none), which cam_bounds [C+1] cuts into segments; cam_warps (1..32)
// is the warps per camera of the camera pass. whw null: packed [M, 42] is
// caller-allocated scratch. Otherwise packed is [M, 64] and whw [C, 36]
// gets the Schur-Jacobi blocks. Two launches.
extern "C" int sfm_fused_ne_payloads(
    const int* obs_cam, const int* obs_point, const float* points, const float* static_t,
    const float* cams, const float* intr, const float* zf, const float* lam,
    const int* point_bounds, const int* cam_inv_perm, const int* cam_bounds,
    const int* block_points, int O, int P, int C, int loss, float scale, int grid, int cam_warps,
    float* w_t, float* packed, float* hinv, float* bp, float* hcc, float* bc, float* whw,
    void* stream) {
  if (grid < 1 || cam_warps < 1 || cam_warps > sfm::kMaxSegmentWarps)
    return (int)cudaErrorInvalidValue;
  const NeArgs a{obs_cam, obs_point, points, static_t, cams, intr, zf, lam, point_bounds,
                 cam_inv_perm, block_points, O, P, loss, scale,
                 whw != nullptr ? kPcgRow : kCamRows, w_t, packed, hinv, bp};
  ne_points_kernel<<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(a);
  const int err = (int)cudaGetLastError();
  if (err != 0 || C == 0) return err;
  ne_cams_kernel<<<C, 32 * cam_warps, 0, (cudaStream_t)stream>>>(packed, cam_bounds, lam, hcc,
                                                                  bc, whw);
  return (int)cudaGetLastError();
}

// K5. The same plan and tables as K3. dc == nullptr: the cost at (cams,
// points), and cam_fixed, point_fixed, w_t, hinv, bp, new_points and
// new_cams are not read or written. Otherwise the candidate
// (cams + dc, points + dp) with the freeze masks, its parameters written to
// new_cams [C, 6] and new_points [P, 3], and its cost. partials [2 * grid]
// is scratch; ticket is an unsigned int that is 0 on entry and left 0; out
// [3] gets (sum cost * w, sum w, their mean). One launch.
extern "C" int sfm_fused_cost_sums(
    const int* obs_cam, const int* obs_point, const float* points, const float* static_t,
    const float* cams, const float* intr, const float* zf, const int* point_bounds,
    const int* block_points, const float* dc, const unsigned char* cam_fixed,
    const unsigned char* point_fixed, const float* w_t, const float* hinv, const float* bp,
    int O, int P, int C, int loss, float scale, int grid, float* new_points, float* new_cams,
    float* partials, unsigned int* ticket, float* out, void* stream) {
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const CostArgs a{obs_cam, obs_point, points, static_t, cams, intr, zf, point_bounds,
                   block_points, dc, cam_fixed, point_fixed, w_t, hinv, bp, O, P, C, loss,
                   scale, new_points, new_cams, partials, ticket, out};
  if (dc != nullptr)
    cost_points_kernel<true><<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(a);
  else
    cost_points_kernel<false><<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int sfm_fused_ne_payloads_big(const float* pts_t,
                                         const float* static_t,
                                         const float* cams_t,
                                         const float* intr_t, const float* zf,
                                         int O, int loss, float scale,
                                         float* w_t, float* yp_t, float* cam_t,
                                         void* stream) {
  const int blocks = (O + kNeThreads - 1) / kNeThreads;
  fused_ne_big_kernel<<<blocks, kNeThreads, 0, (cudaStream_t)stream>>>(
      pts_t, static_t, cams_t, intr_t, zf, O, loss, scale, w_t, yp_t, cam_t);
  return (int)cudaGetLastError();
}

extern "C" int sfm_fused_cost_sums_big(const float* pts_t,
                                       const float* static_t,
                                       const float* cams_t,
                                       const float* intr_t, const float* zf,
                                       int O, int loss, float scale,
                                       float* partials, int num_partials,
                                       float* out, void* stream) {
  cost_partials_big_kernel<<<num_partials, kCostThreads, 0,
                             (cudaStream_t)stream>>>(
      pts_t, static_t, cams_t, intr_t, zf, O, loss, scale, partials);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  cost_finish_kernel<<<1, kCostThreads, 0, (cudaStream_t)stream>>>(
      partials, num_partials, out);
  return (int)cudaGetLastError();
}

// inv_perm null: sorted segments, `width` lanes per segment. Otherwise
// inv_perm [N] places observation o at its segment-sorted position (-1: of
// no segment), `width` is the warps per segment and packed is scratch of
// one row of K floats per placed observation.
extern "C" int sfm_segment_sum(const float* values, const int* inv_perm,
                               const int* bounds, int O, int K, int S, int N,
                               int width, float* packed, float* out,
                               void* stream) {
  return sfm::launch_segment_sum(values, inv_perm, bounds, O, K, S, N, width,
                                 packed, out, (cudaStream_t)stream);
}
