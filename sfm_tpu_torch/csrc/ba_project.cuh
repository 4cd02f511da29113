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

#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace sfm {

enum Loss { kLossNone = 0, kLossHuber = 1, kLossCauchy = 2 };

// jnp.maximum(a, b) for a constant b: NaN in a propagates.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : fmaxf(a, b);
}

// Entries of I + a [w]x + b [w]x^2, row-major.
__device__ __forceinline__ void rot_entries(float wx, float wy, float wz,
                                            float a, float b, float R[9]) {
  const float t2 = wx * wx + wy * wy + wz * wz;
  R[0] = 1.0f + b * (wx * wx - t2);
  R[1] = -a * wz + b * wx * wy;
  R[2] = a * wy + b * wx * wz;
  R[3] = a * wz + b * wx * wy;
  R[4] = 1.0f + b * (wy * wy - t2);
  R[5] = -a * wx + b * wy * wz;
  R[6] = -a * wy + b * wx * wz;
  R[7] = a * wx + b * wy * wz;
  R[8] = 1.0f + b * (wz * wz - t2);
}

struct Projection {
  float ru, rv;          // pixel residual
  float fx, fy, k1;      // the intrinsics the residual used (refined at D = 8)
  float xc2;             // camera-frame depth (for the near-plane gate)
  float x, y, r2, s;     // normalised coords, radius^2, distortion scale
  float inv_z;
  float R[9];
  float B, C2;           // (1-cos)/t^2 and (t-sin)/t^3 (right Jacobian)
};

// cam: rvec(3) tvec(3), at D = 8 then log focal scale and dk1;
// intr: fx fy cx cy k1 k2.
template <int D>
__device__ __forceinline__ Projection project_obs(const float* cam,
                                                  const float* intr, float px,
                                                  float py, float pz, float u,
                                                  float v) {
  static_assert(D == 6 || D == 8, "camera blocks are 6 or 8 wide");
  Projection p;
  const float wx = cam[0], wy = cam[1], wz = cam[2];
  float fx = intr[0], fy = intr[1];
  const float cx = intr[2], cy = intr[3];
  float k1 = intr[4];
  const float k2 = intr[5];
  if constexpr (D == 8) {
    const float sf = expf(cam[6]);
    fx = fx * sf;
    fy = fy * sf;
    k1 = k1 + cam[7];
  }
  p.fx = fx;
  p.fy = fy;
  p.k1 = k1;
  const float t2 = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(fmaxf(t2, 1e-24f));
  const bool small = t2 < 1e-8f;
  const float sin_t = sinf(th), cos_t = cosf(th);
  const float A = small ? 1.0f - t2 / 6.0f : sin_t / th;
  p.B = small ? 0.5f - t2 / 24.0f : (1.0f - cos_t) / t2;
  p.C2 = small ? 1.0f / 6.0f - t2 / 120.0f : (th - sin_t) / (t2 * th);
  rot_entries(wx, wy, wz, A, p.B, p.R);
  const float* R = p.R;
  const float xc0 = R[0] * px + R[1] * py + R[2] * pz + cam[3];
  const float xc1 = R[3] * px + R[4] * py + R[5] * pz + cam[4];
  const float xc2 = R[6] * px + R[7] * py + R[8] * pz + cam[5];
  const float z = fabsf(xc2) < 1e-8f ? (xc2 < 0.0f ? -1e-8f : 1e-8f) : xc2;
  p.inv_z = 1.0f / z;
  p.x = xc0 * p.inv_z;
  p.y = xc1 * p.inv_z;
  p.r2 = p.x * p.x + p.y * p.y;
  p.s = 1.0f + p.r2 * (k1 + p.r2 * k2);
  p.ru = fx * (p.x * p.s) + cx - u;
  p.rv = fy * (p.y * p.s) + cy - v;
  p.xc2 = xc2;
  return p;
}

// IRLS weight rho'(s) (sfm_tpu/geometry/losses.py robust_weight).
__device__ __forceinline__ float robust_weight(float s, int loss, float scale) {
  if (loss == kLossHuber) {
    const float d2 = scale * scale;
    return s <= d2 ? 1.0f : scale / sqrtf(nan_max(s, 1e-20f));
  }
  if (loss == kLossCauchy) {
    const float d2 = scale * scale;
    return 1.0f / (1.0f + s / d2);
  }
  return 1.0f;
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
