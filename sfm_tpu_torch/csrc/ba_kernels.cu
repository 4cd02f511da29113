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
// Camera width. K3 and K5 are templates on the width D of a camera block:
// D = 6 (rvec, tvec) or D = 8 with intrinsics refinement (then the log focal
// scale and dk1, sfm_tpu/ba/problem.py build_problem(refine_intrinsics)).
// sfm_tpu runs an 8-wide BA as plain XLA (every kernel gate asks for six
// columns); here both widths take the same kernels, each a C entry of its own
// (the `_w8` entries: the same arguments, 8-wide tables). At D = 8, W is
// [24, O], a camera row 72 floats (vec(Jc^T Jc) 64, -Jc^T r 8; 16-byte rows)
// and a PCG row 112 (72, the 36 entries of W Hpp^-1 W^T, 4 unused): the
// camera pass sums 72 or 108 columns in two passes of segment_sum.cuh's
// 64-column tiles. K5 takes a column mask for the candidate cameras (focal
// or k1 frozen by the config), applied after its back-substitution, which
// reads the whole step as sfm_tpu's bundle_adjust_impl does: the frozen
// columns' W rows are not zero. The large-camera-count kernels K4 and K6
// are templates on D too (the `_w8` entries: cams_t [8, O]; K4 writes W
// [24, O] and the camera payload [72, O]): 88 bytes in and 420 out per
// observation for K4 at D = 8, 88 in for K6. sfm_tpu runs that case as
// plain XLA (its large-C kernels ask for six columns); the LM candidate of
// that route zeroes the frozen columns in torch ops (ba/core.py).
//
// K3's sharded mode (fused_ne_sums) serves the camera-sharded LM
// (sfm_tpu/dist/sharded_ba.py): each device holds the observations of its
// cameras, so a point's rows span devices and its block can be damped and
// inverted only after the sums of every device are added (sfm_tpu psums
// Hpp, bp, Hcc and bc before its damping, sfm_tpu/ba/core.py:664-667). The
// same two launches over the same point segments write the UNDAMPED
// sums: per point the 6 distinct entries of sym(Jp^T Jp) and -Jp^T r
// ([P, 9], a point without observations on this device zero), per camera
// Hcc [C, D, D] and bc [C, D], and W as in the single-device build; no
// damping, no inversion, no Schur-Jacobi blocks (those need the summed
// Hpp^-1: the caller runs K7's standalone entry after the all-reduce). A
// zero block damped on each of D devices would carry D floors.
//
// No float atomics anywhere: every sum is taken in an order fixed by the
// shapes, the tables and the launch widths, so a rerun gives identical bits.

#include <cuda_runtime.h>

#include "ba_project.cuh"
#include "schur_jacobi.cuh"
#include "segment_sum.cuh"

namespace {

using sfm::Projection;

// The precision of K3's Jacobian rows (ne_rows) and of K5's back-substitution
// sums and dp (cost_points_kernel): double. In fp32 both missed their 1e-5
// bars against float64 on a 1,000-camera polish (chip_smoke.check_ba).
using RowT = double;

constexpr int kNeThreads = 128;
constexpr int kCostThreads = 256;
constexpr int kSegThreads = 512;   // K3 and K5: observations per chunk, one a thread
constexpr int kSegWarps = kSegThreads / 32;
// Floats of a camera row: vec(Jc^T Jc) (D^2) then -Jc^T r (D): 42 or 72.
template <int D>
constexpr int kCamRows = D * D + D;
// With the Schur-Jacobi blocks: the camera row, the D (D + 1) / 2 entries
// of W Hpp^-1 W^T, padded to a multiple of 16 floats (64-byte rows): 64
// (one unused) or 112 (four).
template <int D>
constexpr int kPcgRow = (kCamRows<D> + sfm::kWhwEntries<D> + 15) / 16 * 16;
constexpr unsigned kFull = 0xffffffffu;

// The IRLS-weighted Jacobian rows of one observation: the two rows of Jc
// (scaled by the camera-free mask) and of Jp (by the point-free mask), and
// the weighted residual.
template <int D>
struct NeRows {
  float a[D], b[D];
  float p0[3], p1[3];
  float ru_w, rv_w;
};

// Residual, closed-form Jacobian, IRLS weight, near-plane gate and freeze
// masks of an observation (u, v, weight w_obs, masks) of the point
// (px, py, pz) in the camera `cam` (rvec, tvec; at D = 8 then the log focal
// scale and dk1) with intrinsics `in`. Formed in RowT from the fp32
// inputs (ba_project.cuh), rounded to fp32 rows.
template <int D>
__device__ __forceinline__ NeRows<D> ne_rows(const float* cam, const float* in,
                                            float px_, float py_, float pz_,
                                            float u, float v, float w_obs,
                                            float cam_free, float pt_free,
                                            const float* __restrict__ zf,
                                            int loss, float scale) {
  using T = RowT;
  const sfm::ProjectionT<T> P = sfm::project_obs<D, T>(cam, in, px_, py_, pz_, u, v);
  if (zf != nullptr) w_obs = (P.xc2 > T(*zf)) ? w_obs : 0.0f;

  const T px = px_, py = py_, pz = pz_;
  const T fx = P.fx, fy = P.fy, k1 = P.k1, k2 = in[5];
  const T x = P.x, y = P.y, r2 = P.r2, s = P.s, inv_z = P.inv_z;
  const T* R = P.R;

  // M = diag(f) D_dist A_proj: d(uv)/d(x_cam), 2x3.
  const T dsc = (k1 + T(2) * k2 * r2) * T(2);
  const T ds_dx = dsc * x, ds_dy = dsc * y;
  const T d00 = s + x * ds_dx, d01 = x * ds_dy;
  const T d10 = y * ds_dx, d11 = s + y * ds_dy;
  const T m00 = fx * inv_z * d00, m01 = fx * inv_z * d01;
  const T m02 = -fx * inv_z * (d00 * x + d01 * y);
  const T m10 = fy * inv_z * d10, m11 = fy * inv_z * d11;
  const T m12 = -fy * inv_z * (d10 * x + d11 * y);

  // Jp = M R.
  T jp0[3], jp1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    jp0[k] = m00 * R[k] + m01 * R[3 + k] + m02 * R[6 + k];
    jp1[k] = m10 * R[k] + m11 * R[3 + k] + m12 * R[6 + k];
  }
  // d(R p)/d rvec = -R [p]x Jr, Jr = I - B [w]x + C2 [w]x^2.
  T J[9];
  sfm::rot_entries<T>(cam[0], cam[1], cam[2], -P.B, P.C2, J);
  T g0[3], g1[3], g2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g0[k] = -pz * J[3 + k] + py * J[6 + k];
    g1[k] = pz * J[k] - px * J[6 + k];
    g2[k] = -py * J[k] + px * J[3 + k];
  }
  T drx[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      drx[r][k] = -(R[3 * r] * g0[k] + R[3 * r + 1] * g1[k] + R[3 * r + 2] * g2[k]);
  // Jc = [M dRX | M], at D = 8 then d r / d log focal scale = f x s (uv - c
  // scales with f) and d r / d dk1 = f x r2 (sfm_tpu/ba/core.py
  // _residual_jac_analytic).
  T jc0[D], jc1[D];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    jc0[k] = m00 * drx[0][k] + m01 * drx[1][k] + m02 * drx[2][k];
    jc1[k] = m10 * drx[0][k] + m11 * drx[1][k] + m12 * drx[2][k];
  }
  jc0[3] = m00; jc0[4] = m01; jc0[5] = m02;
  jc1[3] = m10; jc1[4] = m11; jc1[5] = m12;
  if constexpr (D == 8) {
    jc0[6] = (x * s) * fx;
    jc1[6] = (y * s) * fy;
    jc0[7] = fx * x * r2;
    jc1[7] = fy * y * r2;
  }

  // IRLS weight on the unweighted residual, freeze masks folded in.
  const T ru = P.ru, rv = P.rv;
  const T w_r = sfm::robust_weight(ru * ru + rv * rv, loss, scale) * T(w_obs);
  const T sw = sfm::tsqrt(sfm::nan_max(w_r, T(0)));
  const T swc = sw * T(cam_free), swp = sw * T(pt_free);
  NeRows<D> out;
  out.ru_w = static_cast<float>(ru * sw);
  out.rv_w = static_cast<float>(rv * sw);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    out.a[i] = static_cast<float>(jc0[i] * swc);
    out.b[i] = static_cast<float>(jc1[i] * swc);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out.p0[j] = static_cast<float>(jp0[j] * swp);
    out.p1[j] = static_cast<float>(jp1[j] * swp);
  }
  return out;
}

// Entry k of the camera payload: vec(Jc^T Jc) for k < D^2, then -Jc^T r.
// k must be a compile-time constant after unrolling.
template <int D>
__device__ __forceinline__ float cam_entry(const NeRows<D>& J, int k) {
  if (k < D * D) {
    const int i = k / D, j = k % D;
    return J.a[i] * J.a[j] + J.b[i] * J.b[j];
  }
  const int i = k - D * D;
  return -(J.a[i] * J.ru_w + J.b[i] * J.rv_w);
}

// Entry k of the point payload: sym(Jp^T Jp) (00, 01, 02, 11, 12, 22), then
// -Jp^T r. k must be a compile-time constant after unrolling.
template <int D>
__device__ __forceinline__ float point_entry(const NeRows<D>& J, int k) {
  if (k < 6) {
    const int i = k < 3 ? 0 : (k < 5 ? 1 : 2);
    const int j = k < 3 ? k : (k < 5 ? k - 2 : 2);
    return J.p0[i] * J.p0[j] + J.p1[i] * J.p1[j];
  }
  const int j = k - 6;
  return -(J.p0[j] * J.ru_w + J.p1[j] * J.rv_w);
}

// W = Jc^T Jp, row-major D x 3, stored feature-major at column o of [3D, O].
template <int D>
__device__ __forceinline__ void store_w(const NeRows<D>& J, float* __restrict__ w_t,
                                        int O, int o) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      w_t[(size_t)(i * 3 + j) * O + o] = J.a[i] * J.p0[j] + J.b[i] * J.p1[j];
}

// The camera row of an observation at dst: 16-byte stores where dst is
// 16-byte aligned (`quad`: every row of an 8-wide build, the PCG rows of a
// 6-wide one), else 8-byte stores (the 168-byte rows of a 6-wide build).
template <int D>
__device__ __forceinline__ void store_cam_row(const NeRows<D>& J, float* dst, bool quad) {
  constexpr int K = kCamRows<D>;
  if (quad) {
    float4* row = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < K / 4; ++k)
      row[k] = make_float4(cam_entry<D>(J, 4 * k), cam_entry<D>(J, 4 * k + 1),
                           cam_entry<D>(J, 4 * k + 2), cam_entry<D>(J, 4 * k + 3));
    if constexpr (K % 4 == 2)
      reinterpret_cast<float2*>(dst)[K / 2 - 1] =
          make_float2(cam_entry<D>(J, K - 2), cam_entry<D>(J, K - 1));
  } else {
    float2* row = reinterpret_cast<float2*>(dst);
#pragma unroll
    for (int k = 0; k < K / 2; ++k)
      row[k] = make_float2(cam_entry<D>(J, 2 * k), cam_entry<D>(J, 2 * k + 1));
  }
}

// ---- K3: the normal equations over point segments ---------------------------

struct NeArgs {
  const int* obs_cam;       // [O]
  const int* obs_point;     // [O]
  const float* points;      // [P, 3]
  const float* static_t;    // [5, O] u, v, weight, camera-free, point-free
  const float* cams;        // [C, D]
  const float* intr;        // [C, 6]
  const float* zf;          // 0-d or null
  const float* lam;         // 0-d
  const int* point_bounds;  // [P+1] over [0, N)
  const int* cam_inv_perm;  // [N]
  const int* block_points;  // [G+1]
  int O, P, loss;
  float scale;
  int row;                  // floats per packed row: kCamRows<D>, or kPcgRow<D> with the blocks
  float* w_t;               // [3D, O]
  float* packed;            // [M, row]
  float* hinv;              // [P, 9]
  float* bp;                // [P, 3]
  float* psums;             // [P, 9] undamped point sums (sharded mode: lam, hinv, bp null)
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

// A point's sums t are complete: damped, inverted and written, or in
// sharded mode written as they are.
__device__ __forceinline__ void point_done(const NeArgs& a, int p, const float (&t)[9],
                                           float lam) {
  if (a.psums == nullptr) {
    finish_point(a, p, t, lam);
    return;
  }
  float* out = a.psums + 9 * (size_t)p;
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = t[k];
}

// The sums over one point's observations [lo, hi) in chunk `chunk`
// [c0, c1), whose per-observation terms lie in rows[k][o - c0] (shared
// memory), by the thread of the segment's first observation in the chunk,
// in observation order. A point that began in an earlier chunk starts from
// its sums so far, carry[chunk & 1]; one that runs on past c1 leaves its
// sums in carry[(chunk + 1) & 1] (two slots: the chunk's first segment
// reads one while its last may write the other) and returns false. Returns
// true when `t` holds the point's total. Acc is the type of the sums (K5
// adds its terms in RowT: a point seen by hundreds of views loses digits
// in a float sum, and dp amplifies them by Hpp^-1).
template <int K, typename Acc = float>
__device__ __forceinline__ bool segment_total(float (*rows)[kSegThreads], int chunk, int c0,
                                              int c1, int lo, int hi, int first,
                                              Acc (*carry)[K], Acc (&t)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = lo < c0 ? carry[chunk & 1][k] : Acc(0);
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
// Schur-Jacobi blocks (a.row == kPcgRow<D>) a last sweep over the slice
// stores each weighted observation's D (D + 1) / 2 entries of
// W Hpp^-1 W^T after the camera row of its packed row.
template <int D>
__global__ __launch_bounds__(kSegThreads) void ne_points_kernel(const NeArgs a) {
  __shared__ float rows[9][kSegThreads];
  __shared__ float carry[2][9];
  const int b = blockIdx.x, G = gridDim.x, tid = threadIdx.x;
  const int O = a.O;
  const float lam = a.lam != nullptr ? *a.lam : 0.0f;
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
      const NeRows<D> J = ne_rows<D>(a.cams + D * (size_t)c, a.intr + 6 * (size_t)c, p[0], p[1],
                                     p[2], a.static_t[o], a.static_t[(size_t)O + o],
                                     a.static_t[(size_t)2 * O + o], a.static_t[(size_t)3 * O + o],
                                     a.static_t[(size_t)4 * O + o], a.zf, a.loss, a.scale);
      store_w<D>(J, a.w_t, O, o);
      const int place = a.cam_inv_perm[o];
      // Rows of 168 bytes (6-wide, 8-byte aligned), 288, 256 or 448 bytes
      // (16-byte aligned).
      if (place >= 0)
        store_cam_row<D>(J, a.packed + (size_t)a.row * place,
                         a.row != kCamRows<D> || kCamRows<D> % 4 == 0);
#pragma unroll
      for (int k = 0; k < 9; ++k) rows[k][tid] = point_entry<D>(J, k);
    }
    __syncthreads();
    if (pt >= 0 && (o == c0 || a.obs_point[o - 1] != pt)) {
      float t[9];
      if (segment_total(rows, chunk, c0, c1, a.point_bounds[pt], a.point_bounds[pt + 1], o, carry,
                        t))
        point_done(a, pt, t, lam);
    }
    __syncthreads();
  }
  if (a.row == kPcgRow<D>) {
    // W and Hpp^-1 of the slice were written by this block before the last
    // barrier.
    constexpr int E = sfm::kWhwEntries<D>;
    for (int o = o_lo + tid; o < o_hi; o += kSegThreads) {
      const int place = a.cam_inv_perm[o];
      if (place < 0) continue;
      float e[E];
      sfm::whw_of_observation<D>(a.w_t, a.hinv, O, o, a.obs_point[o], e);
      float* dst = a.packed + (size_t)kPcgRow<D> * place + kCamRows<D>;
      if constexpr (kCamRows<D> % 4 == 0) {
        // Column 72 of a 448-byte row: 16-byte aligned, 36 entries.
#pragma unroll
        for (int k = 0; k < E / 4; ++k)
          reinterpret_cast<float4*>(dst)[k] =
              make_float4(e[4 * k], e[4 * k + 1], e[4 * k + 2], e[4 * k + 3]);
#pragma unroll
        for (int k = E / 4 * 4; k < E; ++k) dst[k] = e[k];
      } else {
        // Column 42 of a 256-byte row: 8-byte aligned, 21 entries.
#pragma unroll
        for (int k = 0; k < E / 2; ++k)
          reinterpret_cast<float2*>(dst)[k] = make_float2(e[2 * k], e[2 * k + 1]);
        if constexpr (E % 2 == 1) dst[E - 1] = e[E - 1];
      }
    }
  }
  float zero[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) zero[k] = 0.0f;
  for (int p = b * kSegThreads + tid; p < a.P; p += G * kSegThreads)
    if (a.point_bounds[p] == a.point_bounds[p + 1]) point_done(a, p, zero, lam);
  const int N = a.point_bounds[a.P];
  for (int o = N + b * kSegThreads + tid; o < O; o += G * kSegThreads) {
#pragma unroll
    for (int k = 0; k < 3 * D; ++k) a.w_t[(size_t)k * O + o] = 0.0f;
  }
}

// Camera c's D^2 + D sums of the packed rows [cam_bounds[c], cam_bounds[c+1]),
// the diagonal of Hcc damped by lam diag + 1e-6 (undamped when lam is null:
// the sharded mode); with whw (rows of
// kPcgRow<D> floats) also the D (D + 1) / 2 sums of W Hpp^-1 W^T, mirrored
// to whw [C, D^2]. The columns go in equal tiles of at most kTileRows (64):
// one pass for the 42 or 63 columns of a 6-wide build, two of 36 or 54 for
// the 72 or 108 of an 8-wide one. Every tile is wider than 32 columns, so
// each column is summed by one lane of each warp over the same terms in
// the same order whatever the row width: the build with the blocks gives
// the bits of the build without them, and its blocks those of K7's
// standalone entry (one tile of 21 or 36 columns: the same order where it
// is wider than 32, the 8-wide case). blockDim = 32 * warps.
template <int D>
__global__ __launch_bounds__(32 * sfm::kMaxSegmentWarps) void ne_cams_kernel(
    const float* __restrict__ packed, const int* __restrict__ cam_bounds,
    const float* __restrict__ lam, float* __restrict__ hcc, float* __restrict__ bc,
    float* __restrict__ whw) {
  __shared__ float part[sfm::kMaxSegmentWarps][sfm::kTileRows];
  __shared__ float sums[kCamRows<D> + sfm::kWhwEntries<D>];
  const int c = blockIdx.x;
  const int row = whw != nullptr ? kPcgRow<D> : kCamRows<D>;
  const int cols = whw != nullptr ? kCamRows<D> + sfm::kWhwEntries<D> : kCamRows<D>;
  const int tiles = (cols + sfm::kTileRows - 1) / sfm::kTileRows;
  const int tile = (cols + tiles - 1) / tiles;
  for (int k0 = 0; k0 < cols; k0 += tile) {
    sfm::segment_sum_packed_rows(packed, cam_bounds[c], cam_bounds[c + 1], row, k0,
                                 min(tile, cols - k0), part, sums + k0);
    __syncthreads();   // part is reused by the next tile; sums read below
  }
  const float l = lam != nullptr ? *lam : 0.0f;
  for (int k = threadIdx.x; k < kCamRows<D>; k += blockDim.x) {
    float v = sums[k];
    if (k < D * D) {
      if (lam != nullptr && k % (D + 1) == 0) v = v + (l * v + 1e-6f);
      hcc[D * D * (size_t)c + k] = v;
    } else {
      bc[D * (size_t)c + k - D * D] = v;
    }
  }
  if (whw != nullptr)
    for (int k = threadIdx.x; k < D * D; k += blockDim.x)
      whw[D * D * (size_t)c + k] = sfm::whw_block_entry<D>(sums + kCamRows<D>, k);
}

// ---- K5: the LM candidate and its robust cost -------------------------------

struct CostArgs {
  const int* obs_cam;            // [O]
  const int* obs_point;          // [O]
  const float* points;           // [P, 3]
  const float* static_t;         // [5, O]
  const float* cams;             // [C, D]
  const float* intr;             // [C, 6]
  const float* zf;               // 0-d or null
  const int* point_bounds;       // [P+1] over [0, N)
  const int* block_points;       // [G+1]
  // The step (candidate mode only):
  const float* dc;               // [C, D]
  const unsigned char* cam_fixed;    // [C]
  const unsigned char* point_fixed;  // [P]
  const float* w_t;              // [3D, O]
  const float* hinv;             // [P, 9]
  const float* bp;               // [P, 3]
  int O, P, C, loss;
  float scale;
  int frozen;                    // bit 0: column 6 (focal) frozen, bit 1: column 7 (k1)
  float* new_points;             // [P, 3] (candidate mode)
  float* new_cams;               // [C, D] (candidate mode)
  float* partials;               // [2, G]
  unsigned int* ticket;          // 0 on entry, 0 again on exit
  float* out;                    // [3]: sum cost * w, sum w, their mean
};

// Robust cost times the (gated) weight, and the weight, of one observation.
template <int D>
__device__ __forceinline__ void cost_term(const float* cam, const float* in, float px,
                                          float py, float pz, float u, float v, float w,
                                          const float* __restrict__ zf, int loss,
                                          float scale, float* cw, float* wout) {
  const Projection P = sfm::project_obs<D>(cam, in, px, py, pz, u, v);
  if (zf != nullptr) w = (P.xc2 > *zf) ? w : 0.0f;
  *cw = sfm::robust_cost(P.ru * P.ru + P.rv * P.rv, loss, scale) * w;
  *wout = w;
}

// dc[c, i] unless camera c is fixed: the step the back-substitution reads.
template <int D>
__device__ __forceinline__ float step_cam(const CostArgs& a, int c, int i) {
  return a.cam_fixed[c] ? 0.0f : a.dc[D * (size_t)c + i];
}

// The candidate camera's step: step_cam, zero in an intrinsic column the
// config freezes (sfm_tpu zeroes dc[:, 6] or dc[:, 7] after dp is formed).
template <int D>
__device__ __forceinline__ float new_cam_step(const CostArgs& a, int c, int i) {
  if (i >= 6 && ((a.frozen >> (i - 6)) & 1)) return 0.0f;
  return step_cam<D>(a, c, i);
}

// new_points[p] = points[p] + dp, dp = Hpp^-1 (bp - g) (zero for a fixed
// point), formed in RowT from g's RowT sums.
__device__ __forceinline__ void candidate_point(const CostArgs& a, int p, const RowT (&g)[3]) {
  const float* h = a.hinv + 9 * (size_t)p;
  const float* bpp = a.bp + 3 * (size_t)p;
  const RowT r0 = bpp[0] - g[0], r1 = bpp[1] - g[1], r2 = bpp[2] - g[2];
  RowT d0 = h[0] * r0 + h[1] * r1 + h[2] * r2;
  RowT d1 = h[3] * r0 + h[4] * r1 + h[5] * r2;
  RowT d2 = h[6] * r0 + h[7] * r1 + h[8] * r2;
  if (a.point_fixed[p]) d0 = d1 = d2 = RowT(0);
  const float* q = a.points + 3 * (size_t)p;
  float* out = a.new_points + 3 * (size_t)p;
  out[0] = static_cast<float>(q[0] + d0);
  out[1] = static_cast<float>(q[1] + d1);
  out[2] = static_cast<float>(q[2] + d2);
}

// Block b walks its observation slice as K3 does. With a step, a first pass
// forms u_o = W_o^T dc[cam_o] per observation and the first thread of each
// point segment sums them (g) and writes the candidate point; points
// without observations and the candidate cameras are written by every block
// for its share. The second pass (the only one without a step) projects each
// observation's (candidate) point through its (candidate) camera: the
// points it reads were written by this block before the barrier.
template <bool kStep, int D>
__global__ __launch_bounds__(kSegThreads) void cost_points_kernel(const CostArgs a) {
  __shared__ float rows[3][kSegThreads];
  __shared__ RowT carry[2][3];
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
        for (int i = 0; i < D; ++i) {
          const float di = step_cam<D>(a, c, i);
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
        RowT g[3];
        if (segment_total(rows, chunk, c0, c1, a.point_bounds[pt], a.point_bounds[pt + 1], o,
                          carry, g))
          candidate_point(a, pt, g);
      }
      __syncthreads();
    }
    const RowT g0[3] = {RowT(0), RowT(0), RowT(0)};
    for (int p = b * kSegThreads + tid; p < a.P; p += G * kSegThreads)
      if (a.point_bounds[p] == a.point_bounds[p + 1]) candidate_point(a, p, g0);
    for (int e = b * kSegThreads + tid; e < D * a.C; e += G * kSegThreads)
      a.new_cams[e] = a.cams[e] + new_cam_step<D>(a, e / D, e % D);
  }
  float acc_c = 0.0f, acc_w = 0.0f;
  for (int o = o_lo + tid; o < o_hi; o += kSegThreads) {
    const int pt = a.obs_point[o];
    const int c = a.obs_cam[o];
    const float* p = (kStep ? a.new_points : a.points) + 3 * (size_t)pt;
    float cam[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      cam[i] = a.cams[D * (size_t)c + i];
      if constexpr (kStep) cam[i] = cam[i] + new_cam_step<D>(a, c, i);
    }
    float cw, w;
    cost_term<D>(cam, a.intr + 6 * (size_t)c, p[0], p[1], p[2], a.static_t[o],
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

// Rows 0..K-1 of a feature-major [K, O] table at observation o.
template <int K>
__device__ __forceinline__ void load_rows(const float* __restrict__ rows_t, int O, int o,
                                          float (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = rows_t[(size_t)k * O + o];
}

template <int D>
__global__ __launch_bounds__(kNeThreads) void fused_ne_big_kernel(
    const float* __restrict__ pts_t, const float* __restrict__ static_t,
    const float* __restrict__ cams_t, const float* __restrict__ intr_t,
    const float* __restrict__ zf, int O, int loss, float scale,
    float* __restrict__ w_t, float* __restrict__ yp_t,
    float* __restrict__ cam_t) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
  float cam[D], in[6];
  load_rows<D>(cams_t, O, o, cam);
  load_rows<6>(intr_t, O, o, in);
  const NeRows<D> J = ne_rows<D>(cam, in, pts_t[o], pts_t[O + o], pts_t[(size_t)2 * O + o],
                                  static_t[o], static_t[O + o], static_t[(size_t)2 * O + o],
                                  static_t[(size_t)3 * O + o], static_t[(size_t)4 * O + o], zf,
                                  loss, scale);
  store_w<D>(J, w_t, O, o);
#pragma unroll
  for (int k = 0; k < kCamRows<D>; ++k) cam_t[(size_t)k * O + o] = cam_entry<D>(J, k);
#pragma unroll
  for (int k = 0; k < 9; ++k) yp_t[(size_t)k * O + o] = point_entry<D>(J, k);
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

template <int D>
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
    float cam[D], in[6];
    load_rows<D>(cams_t, O, o, cam);
    load_rows<6>(intr_t, O, o, in);
    cost_term<D>(cam, in, pts_t[o], pts_t[O + o], pts_t[(size_t)2 * O + o], static_t[o],
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

template <int D>
int fused_ne_payloads(const int* obs_cam, const int* obs_point, const float* points,
                      const float* static_t, const float* cams, const float* intr,
                      const float* zf, const float* lam, const int* point_bounds,
                      const int* cam_inv_perm, const int* cam_bounds, const int* block_points,
                      int O, int P, int C, int loss, float scale, int grid, int cam_warps,
                      float* w_t, float* packed, float* hinv, float* bp, float* hcc, float* bc,
                      float* whw, void* stream) {
  if (grid < 1 || cam_warps < 1 || cam_warps > sfm::kMaxSegmentWarps)
    return (int)cudaErrorInvalidValue;
  const NeArgs a{obs_cam, obs_point, points, static_t, cams, intr, zf, lam, point_bounds,
                 cam_inv_perm, block_points, O, P, loss, scale,
                 whw != nullptr ? kPcgRow<D> : kCamRows<D>, w_t, packed, hinv, bp};
  ne_points_kernel<D><<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(a);
  const int err = (int)cudaGetLastError();
  if (err != 0 || C == 0) return err;
  ne_cams_kernel<D><<<C, 32 * cam_warps, 0, (cudaStream_t)stream>>>(packed, cam_bounds, lam, hcc,
                                                                     bc, whw);
  return (int)cudaGetLastError();
}

// K3's sharded mode: the same two launches, undamped, no inversion.
template <int D>
int fused_ne_sums(const int* obs_cam, const int* obs_point, const float* points,
                  const float* static_t, const float* cams, const float* intr, const float* zf,
                  const int* point_bounds, const int* cam_inv_perm, const int* cam_bounds,
                  const int* block_points, int O, int P, int C, int loss, float scale, int grid,
                  int cam_warps, float* w_t, float* packed, float* psums, float* hcc, float* bc,
                  void* stream) {
  if (grid < 1 || cam_warps < 1 || cam_warps > sfm::kMaxSegmentWarps || psums == nullptr)
    return (int)cudaErrorInvalidValue;
  const NeArgs a{obs_cam, obs_point, points, static_t, cams, intr, zf, nullptr, point_bounds,
                 cam_inv_perm, block_points, O, P, loss, scale, kCamRows<D>, w_t, packed,
                 nullptr, nullptr, psums};
  ne_points_kernel<D><<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(a);
  const int err = (int)cudaGetLastError();
  if (err != 0 || C == 0) return err;
  ne_cams_kernel<D><<<C, 32 * cam_warps, 0, (cudaStream_t)stream>>>(packed, cam_bounds, nullptr,
                                                                     hcc, bc, nullptr);
  return (int)cudaGetLastError();
}

template <int D>
int fused_cost_sums(const int* obs_cam, const int* obs_point, const float* points,
                    const float* static_t, const float* cams, const float* intr, const float* zf,
                    const int* point_bounds, const int* block_points, const float* dc,
                    const unsigned char* cam_fixed, const unsigned char* point_fixed,
                    const float* w_t, const float* hinv, const float* bp, int O, int P, int C,
                    int loss, float scale, int grid, int frozen, float* new_points,
                    float* new_cams, float* partials, unsigned int* ticket, float* out,
                    void* stream) {
  if (grid < 1 || frozen < 0 || frozen > (D == 8 ? 3 : 0)) return (int)cudaErrorInvalidValue;
  const CostArgs a{obs_cam, obs_point, points, static_t, cams, intr, zf, point_bounds,
                   block_points, dc, cam_fixed, point_fixed, w_t, hinv, bp, O, P, C, loss,
                   scale, frozen, new_points, new_cams, partials, ticket, out};
  if (dc != nullptr)
    cost_points_kernel<true, D><<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(a);
  else
    cost_points_kernel<false, D><<<grid, kSegThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int fused_ne_payloads_big(const float* pts_t, const float* static_t, const float* cams_t,
                          const float* intr_t, const float* zf, int O, int loss, float scale,
                          float* w_t, float* yp_t, float* cam_t, void* stream) {
  if (O < 1) return 0;
  const int blocks = (O + kNeThreads - 1) / kNeThreads;
  fused_ne_big_kernel<D><<<blocks, kNeThreads, 0, (cudaStream_t)stream>>>(
      pts_t, static_t, cams_t, intr_t, zf, O, loss, scale, w_t, yp_t, cam_t);
  return (int)cudaGetLastError();
}

template <int D>
int fused_cost_sums_big(const float* pts_t, const float* static_t, const float* cams_t,
                        const float* intr_t, const float* zf, int O, int loss, float scale,
                        float* partials, int num_partials, float* out, void* stream) {
  if (num_partials < 1) return (int)cudaErrorInvalidValue;
  cost_partials_big_kernel<D><<<num_partials, kCostThreads, 0, (cudaStream_t)stream>>>(
      pts_t, static_t, cams_t, intr_t, zf, O, loss, scale, partials);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  cost_finish_kernel<<<1, kCostThreads, 0, (cudaStream_t)stream>>>(partials, num_partials, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K3. block_points [grid+1] cuts the points into the blocks' slices
// (pcg_solve's plan); observations are sorted by point (obs_point) and
// point_bounds [P+1] covers [0, N); cam_inv_perm [N] gives each
// observation's place among the M weighted ones in their stable camera sort
// (-1: none), which cam_bounds [C+1] cuts into segments; cam_warps (1..32)
// is the warps per camera of the camera pass. whw null: packed [M, 42] is
// caller-allocated scratch. Otherwise packed is [M, 64] and whw [C, 36]
// gets the Schur-Jacobi blocks. Two launches. The _w8 entry: cams [C, 8],
// W [24, O], packed [M, 72] or [M, 112], hcc [C, 64], bc [C, 8], whw [C, 64].
SFM_ENTRY_BOTH_WIDTHS(
    sfm_fused_ne_payloads, fused_ne_payloads,
    (const int* obs_cam, const int* obs_point, const float* points, const float* static_t,
     const float* cams, const float* intr, const float* zf, const float* lam,
     const int* point_bounds, const int* cam_inv_perm, const int* cam_bounds,
     const int* block_points, int O, int P, int C, int loss, float scale, int grid, int cam_warps,
     float* w_t, float* packed, float* hinv, float* bp, float* hcc, float* bc, float* whw,
     void* stream),
    (obs_cam, obs_point, points, static_t, cams, intr, zf, lam, point_bounds, cam_inv_perm,
     cam_bounds, block_points, O, P, C, loss, scale, grid, cam_warps, w_t, packed, hinv, bp, hcc,
     bc, whw, stream))

// K3's sharded mode: K3's arguments without lam, hinv and bp; psums [P, 9]
// gets each point's undamped sym(Jp^T Jp) (00, 01, 02, 11, 12, 22) and
// -Jp^T r over this device's observations, hcc [C, D, D] and bc [C, D] the
// undamped camera sums; packed [M, D^2 + D] is scratch. Two launches. The
// _w8 entry: cams [C, 8], W [24, O], packed [M, 72], hcc [C, 64], bc [C, 8].
SFM_ENTRY_BOTH_WIDTHS(
    sfm_fused_ne_sums, fused_ne_sums,
    (const int* obs_cam, const int* obs_point, const float* points, const float* static_t,
     const float* cams, const float* intr, const float* zf, const int* point_bounds,
     const int* cam_inv_perm, const int* cam_bounds, const int* block_points, int O, int P, int C,
     int loss, float scale, int grid, int cam_warps, float* w_t, float* packed, float* psums,
     float* hcc, float* bc, void* stream),
    (obs_cam, obs_point, points, static_t, cams, intr, zf, point_bounds, cam_inv_perm, cam_bounds,
     block_points, O, P, C, loss, scale, grid, cam_warps, w_t, packed, psums, hcc, bc, stream))

// K5. The same plan and tables as K3. dc == nullptr: the cost at (cams,
// points), and cam_fixed, point_fixed, w_t, hinv, bp, frozen, new_points and
// new_cams are not read or written. Otherwise the candidate
// (cams + dc, points + dp) with the freeze masks, its parameters written to
// new_cams [C, 6] and new_points [P, 3], and its cost; `frozen` must be 0.
// partials [2 * grid] is scratch; ticket is an unsigned int that is 0 on
// entry and left 0; out [3] gets (sum cost * w, sum w, their mean). One
// launch. The _w8 entry: cams, dc and new_cams [C, 8], W [24, O]; `frozen`
// (bit 0 the focal column 6, bit 1 the k1 column 7) zeroes those columns of
// the candidate cameras only, after dp = Hpp^-1 (bp - W^T dc) has read them.
SFM_ENTRY_BOTH_WIDTHS(
    sfm_fused_cost_sums, fused_cost_sums,
    (const int* obs_cam, const int* obs_point, const float* points, const float* static_t,
     const float* cams, const float* intr, const float* zf, const int* point_bounds,
     const int* block_points, const float* dc, const unsigned char* cam_fixed,
     const unsigned char* point_fixed, const float* w_t, const float* hinv, const float* bp,
     int O, int P, int C, int loss, float scale, int grid, int frozen, float* new_points,
     float* new_cams, float* partials, unsigned int* ticket, float* out, void* stream),
    (obs_cam, obs_point, points, static_t, cams, intr, zf, point_bounds, block_points, dc,
     cam_fixed, point_fixed, w_t, hinv, bp, O, P, C, loss, scale, grid, frozen, new_points,
     new_cams, partials, ticket, out, stream))

// K4. pts_t [3, O], static_t [5, O], cams_t [6, O], intr_t [6, O] (rows
// gathered per observation), zf 0-d or null -> w_t [18, O], yp_t [9, O],
// cam_t [42, O]. One launch. The _w8 entry: cams_t [8, O], w_t [24, O],
// cam_t [72, O].
SFM_ENTRY_BOTH_WIDTHS(
    sfm_fused_ne_payloads_big, fused_ne_payloads_big,
    (const float* pts_t, const float* static_t, const float* cams_t, const float* intr_t,
     const float* zf, int O, int loss, float scale, float* w_t, float* yp_t, float* cam_t,
     void* stream),
    (pts_t, static_t, cams_t, intr_t, zf, O, loss, scale, w_t, yp_t, cam_t, stream))

// K6. K4's inputs -> out [2] (sum cost * w, sum w); partials
// [2 * num_partials] is scratch, num_partials = ceil(O / 256). Two launches.
// The _w8 entry: cams_t [8, O].
SFM_ENTRY_BOTH_WIDTHS(
    sfm_fused_cost_sums_big, fused_cost_sums_big,
    (const float* pts_t, const float* static_t, const float* cams_t, const float* intr_t,
     const float* zf, int O, int loss, float scale, float* partials, int num_partials, float* out,
     void* stream),
    (pts_t, static_t, cams_t, intr_t, zf, O, loss, scale, partials, num_partials, out, stream))

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
