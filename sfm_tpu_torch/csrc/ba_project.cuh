// Shared per-observation projection for the bundle-adjustment kernels
// (fused_ne_payloads and fused_cost_sums run this same code, so the LM
// accept test scores exactly the objective the normal equations linearise).
//
// Mirrors sfm_tpu/kernels/schur_spmv.py _project_rows: Taylor-guarded
// Rodrigues rotation, sign-preserving guarded perspective divide, radial
// distortion (k1, k2), pixel residual. A camera of width D = 8 also refines
// its intrinsics, as sfm_tpu/ba/core.py _residuals_flat does: fx and fy
// scaled by exp(cam[6]), cam[7] added to k1. Every operation is fp32 in the
// same order as the plain PyTorch version (sfm_tpu_torch/kernels/ba_kernels.py).
// The normal equations' rows (ba_kernels.cu ne_rows) run the same code in
// double (project_obs<D, double>) on the fp32 inputs: on a full orbit of a
// thousand views fp32 left Hcc 1.1e-5 of a camera block's max from the
// float64 build, in the plain version as in the kernel.

#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace sfm {

enum Loss { kLossNone = 0, kLossHuber = 1, kLossCauchy = 2 };

// The math functions at either precision (the float ones are the fp32
// intrinsics the kernels always used).
__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double tsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float tsin(float x) { return sinf(x); }
__device__ __forceinline__ double tsin(double x) { return sin(x); }
__device__ __forceinline__ float tcos(float x) { return cosf(x); }
__device__ __forceinline__ double tcos(double x) { return cos(x); }
__device__ __forceinline__ float texp(float x) { return expf(x); }
__device__ __forceinline__ double texp(double x) { return exp(x); }
__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ double tabs(double x) { return fabs(x); }
__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double tmax(double a, double b) { return fmax(a, b); }

// jnp.maximum(a, b) for a constant b: NaN in a propagates.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : tmax(a, b);
}

// Entries of I + a [w]x + b [w]x^2, row-major.
template <typename T>
__device__ __forceinline__ void rot_entries(T wx, T wy, T wz, T a, T b, T R[9]) {
  const T t2 = wx * wx + wy * wy + wz * wz;
  R[0] = T(1) + b * (wx * wx - t2);
  R[1] = -a * wz + b * wx * wy;
  R[2] = a * wy + b * wx * wz;
  R[3] = a * wz + b * wx * wy;
  R[4] = T(1) + b * (wy * wy - t2);
  R[5] = -a * wx + b * wy * wz;
  R[6] = -a * wy + b * wx * wz;
  R[7] = a * wx + b * wy * wz;
  R[8] = T(1) + b * (wz * wz - t2);
}

template <typename T>
struct ProjectionT {
  T ru, rv;          // pixel residual
  T fx, fy, k1;      // the intrinsics the residual used (refined at D = 8)
  T xc2;             // camera-frame depth (for the near-plane gate)
  T x, y, r2, s;     // normalised coords, radius^2, distortion scale
  T inv_z;
  T R[9];
  T B, C2;           // (1-cos)/t^2 and (t-sin)/t^3 (right Jacobian)
};
using Projection = ProjectionT<float>;

// cam: rvec(3) tvec(3), at D = 8 then log focal scale and dk1;
// intr: fx fy cx cy k1 k2. T: the precision of every operation (the
// inputs are fp32 either way).
template <int D, typename T = float>
__device__ __forceinline__ ProjectionT<T> project_obs(const float* cam,
                                                      const float* intr, float px_,
                                                      float py_, float pz_, float u,
                                                      float v) {
  static_assert(D == 6 || D == 8, "camera blocks are 6 or 8 wide");
  ProjectionT<T> p;
  const T px = px_, py = py_, pz = pz_;
  const T wx = cam[0], wy = cam[1], wz = cam[2];
  T fx = intr[0], fy = intr[1];
  const T cx = intr[2], cy = intr[3];
  T k1 = intr[4];
  const T k2 = intr[5];
  if constexpr (D == 8) {
    const T sf = texp(T(cam[6]));
    fx = fx * sf;
    fy = fy * sf;
    k1 = k1 + T(cam[7]);
  }
  p.fx = fx;
  p.fy = fy;
  p.k1 = k1;
  const T t2 = wx * wx + wy * wy + wz * wz;
  const T th = tsqrt(tmax(t2, T(1e-24f)));
  const bool small = t2 < T(1e-8f);
  const T sin_t = tsin(th), cos_t = tcos(th);
  const T A = small ? T(1) - t2 / T(6) : sin_t / th;
  p.B = small ? T(0.5f) - t2 / T(24) : (T(1) - cos_t) / t2;
  p.C2 = small ? T(1) / T(6) - t2 / T(120) : (th - sin_t) / (t2 * th);
  rot_entries(wx, wy, wz, A, p.B, p.R);
  const T* R = p.R;
  const T xc0 = R[0] * px + R[1] * py + R[2] * pz + T(cam[3]);
  const T xc1 = R[3] * px + R[4] * py + R[5] * pz + T(cam[4]);
  const T xc2 = R[6] * px + R[7] * py + R[8] * pz + T(cam[5]);
  const T z = tabs(xc2) < T(1e-8f) ? (xc2 < T(0) ? T(-1e-8f) : T(1e-8f)) : xc2;
  p.inv_z = T(1) / z;
  p.x = xc0 * p.inv_z;
  p.y = xc1 * p.inv_z;
  p.r2 = p.x * p.x + p.y * p.y;
  p.s = T(1) + p.r2 * (k1 + p.r2 * k2);
  p.ru = fx * (p.x * p.s) + cx - T(u);
  p.rv = fy * (p.y * p.s) + cy - T(v);
  p.xc2 = xc2;
  return p;
}

// IRLS weight rho'(s) (sfm_tpu/geometry/losses.py robust_weight).
template <typename T>
__device__ __forceinline__ T robust_weight(T s, int loss, float scale_) {
  const T scale = scale_;
  if (loss == kLossHuber) {
    const T d2 = scale * scale;
    return s <= d2 ? T(1) : scale / tsqrt(nan_max(s, T(1e-20f)));
  }
  if (loss == kLossCauchy) {
    const T d2 = scale * scale;
    return T(1) / (T(1) + s / d2);
  }
  return T(1);
}

// rho(s) (sfm_tpu/geometry/losses.py robust_cost).
__device__ __forceinline__ float robust_cost(float s, int loss, float scale) {
  if (loss == kLossHuber) {
    const float d2 = scale * scale;
    return s <= d2 ? s : 2.0f * scale * sqrtf(nan_max(s, 1e-20f)) - d2;
  }
  if (loss == kLossCauchy) {
    const float d2 = scale * scale;
    return d2 * log1pf(s / d2);
  }
  return s;
}

}  // namespace sfm
