// Sub-pixel refinement of one octave's extremum candidates in one launch,
// K14.
//
// Replaces no TPU kernel: sfm_tpu/ops/detect.py refine_candidates is plain
// JAX, and so was the port's version (kernels/subpixel_refine.py
// subpixel_refine_plain, which the CPU runs and the tests against sfm_tpu
// still take). On the H100 that version issued its ops one by one from the
// host: three rounds of a 4 x 3 x 3 cube gather, ~20 elementwise ops, 9
// stacks and a batched 3 x 3 solve each, then the final gather and tests.
// ~1,000 small launches an extraction call, issued more slowly than the
// card ran them, so the card sat idle under detection; this kernel exists
// to take the host out of that path.
//
// Bound on the H100: device-memory bytes. A call must read the [B, K]
// candidate indices and scores once, each 32-byte sector of the Gaussian
// stack that a candidate's first cube touches once (candidates of one
// image share sectors; a step moves a cube by one voxel, and the few
// sectors that reaches are left out), and write the eight [B * K]
// keypoint fields once (chip_smoke.refine_least_bytes counts it). The
// arithmetic, a few hundred operations a candidate, is far below the
// card's rate. The design does
// not aim at that bound either: a thread's 36 loads a round are scattered
// and latency-bound, and the whole call is a few tens of microseconds.
//
// Design: one thread per candidate, 256 threads a block; nothing but the
// outputs goes to device memory. Per thread, the plain version's fp32
// arithmetic in its order, each op rounded as the card's PyTorch rounds
// its elementwise ops (__fadd_rn / __fmul_rn: no contraction into FMAs):
// 1. the DoG voxel (l, y, x) from the flat index, clamped into
//    [1, L - 3] x [2, H - 3] x [2, W - 3]; alive = score > 0;
// 2. refine_iters rounds: the 4 x 3 x 3 Gaussian values read with __ldg
//    straight from the stack, the 3 x 3 x 3 DoG cube as their differences
//    in registers; gradient and Hessian (0.5 (a - b), (a + b) - 2c,
//    0.25 (((a - b) - c) + d)), 1e-6 added to the diagonal; the 3 x 3
//    system solved by LU with partial pivoting in LAPACK getf2 / getrs
//    order (the first largest |a| as pivot, multipliers scaled by the
//    pivot's reciprocal, FMA updates); the offset clamped to +-1.5 (NaN
//    kept, as torch.clamp keeps it) and a step of one voxel on each axis
//    where |offset| > 0.6, the voxel clamped again;
// 3. the final cube: contrast c + 0.5 (grad . offset), convergence
//    (every |offset| < 1), the edge test on the 2-D Hessian;
// 4. level, y, x = voxel + offset; sigma = sigma0 * exp2(level / s), the
//    division by s taken as the product with the fp32 reciprocal (as the
//    card's PyTorch divides a tensor by a scalar).
// The solve and the three-term sum may round differently from the
// library's batched solve and reduction, by an ulp or so: offsets agree to
// ~1e-6 px, and a decision (the 0.6 step, the tests) can flip only where
// it lies within rounding of its threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const float* gauss;     // [B, L, H, W] the octave's Gaussian stacks
  const int64_t* idx;     // [B, K] flat indices into the DoG volumes [L - 1, H, W]
  int64_t idx_stride;     // row strides of idx and scores (rows of top-k
  const float* scores;    // slices: each row contiguous)
  int64_t score_stride;
  int64_t* img;           // [B * K] outputs: image index,
  float* x;               // position, level, blur, contrast, angle,
  float* y;
  float* level;
  float* sigma;
  float* response;
  float* angle;
  uint8_t* valid;         // and the bool validity mask
  int n;                  // B * K
  int K, L, H, W, iters;
  float contrast_min;     // contrast_threshold / scales_per_octave
  float edge_r;           // edge_threshold r
  float edge_r1_sq;       // (r + 1)^2
  float sigma0;
  float spo;              // scales_per_octave
};

// torch.clamp on integers: lo where v < lo, then hi where v > hi (hi wins
// where lo > hi).
__device__ __forceinline__ int clamp_int(int64_t v, int lo, int hi) {
  return (int)min(max(v, (int64_t)lo), (int64_t)hi);
}

// torch.clamp on floats: NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The DoG cube d[level][y][x] around voxel (l, y, x) of one image: DoG
// level l + k is Gaussian level l + k + 1 less level l + k.
__device__ __forceinline__ void dog_cube(const float* plane0, int64_t hw, int W, int l, int y, int x,
                                         float (&d)[3][3][3]) {
  float g[4][3][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* row = plane0 + (int64_t)(l - 1 + k) * hw + (int64_t)(y - 1 + i) * W + (x - 1);
#pragma unroll
      for (int j = 0; j < 3; ++j) g[k][i][j] = __ldg(row + j);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) d[k][i][j] = __fsub_rn(g[k + 1][i][j], g[k][i][j]);
}

// 0.5 (a - b)
__device__ __forceinline__ float half_diff(float a, float b) { return __fmul_rn(0.5f, __fsub_rn(a, b)); }

// (a + b) - 2c
__device__ __forceinline__ float second(float a, float b, float c) {
  return __fsub_rn(__fadd_rn(a, b), __fmul_rn(2.0f, c));
}

// 0.25 (((a - b) - c) + d)
__device__ __forceinline__ float cross(float a, float b, float c, float d) {
  return __fmul_rn(0.25f, __fadd_rn(__fsub_rn(__fsub_rn(a, b), c), d));
}

// Solves h o = r in place (o in r) by LU with partial pivoting, in LAPACK
// getf2 / getrs order. Rows of h and r are interchanged together as the
// factorisation goes, which is getrs' laswp of r after it. A zero pivot
// skips its scaling, as getf2 does; the solve then divides by it.
__device__ __forceinline__ void lu_solve3(float (&h)[3][3], float (&r)[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    int p = j;
    float best = fabsf(h[j][j]);
#pragma unroll
    for (int i = j + 1; i < 3; ++i) {
      if (fabsf(h[i][j]) > best) {
        best = fabsf(h[i][j]);
        p = i;
      }
    }
#pragma unroll
    for (int i = j + 1; i < 3; ++i) {
      if (i == p) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float t = h[j][k];
          h[j][k] = h[i][k];
          h[i][k] = t;
        }
        const float t = r[j];
        r[j] = r[i];
        r[i] = t;
      }
    }
    if (h[j][j] != 0.0f) {
      const float inv = __frcp_rn(h[j][j]);
#pragma unroll
      for (int i = j + 1; i < 3; ++i) h[i][j] = __fmul_rn(h[i][j], inv);
    }
#pragma unroll
    for (int i = j + 1; i < 3; ++i)
#pragma unroll
      for (int k = j + 1; k < 3; ++k) h[i][k] = __fmaf_rn(-h[i][j], h[j][k], h[i][k]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = j + 1; i < 3; ++i) r[i] = __fmaf_rn(-h[i][j], r[j], r[i]);
#pragma unroll
  for (int j = 2; j >= 0; --j) {
    r[j] = __fdiv_rn(r[j], h[j][j]);
#pragma unroll
    for (int i = 0; i < j; ++i) r[i] = __fmaf_rn(-h[i][j], r[j], r[i]);
  }
}

__global__ __launch_bounds__(kThreads) void subpixel_refine_kernel(const Args a) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.n) return;
  const int H = a.H, W = a.W;
  const int64_t hw = (int64_t)H * W;
  const int64_t b = t / a.K, k = t % a.K;
  const float* plane0 = a.gauss + b * a.L * hw;

  const int64_t id = a.idx[b * a.idx_stride + k];
  int l = clamp_int(id / hw, 1, a.L - 3);
  const int64_t rem = id % hw;
  int y = clamp_int(rem / W, 2, H - 3);
  int x = clamp_int(rem % W, 2, W - 3);
  const bool alive = a.scores[b * a.score_stride + k] > 0.0f;

  float d[3][3][3];
  float off[3] = {0.0f, 0.0f, 0.0f};
  float grad[3] = {0.0f, 0.0f, 0.0f};
  for (int it = 0; it < a.iters; ++it) {
    dog_cube(plane0, hw, W, l, y, x, d);
    const float c = d[1][1][1];
    grad[0] = half_diff(d[2][1][1], d[0][1][1]);
    grad[1] = half_diff(d[1][2][1], d[1][0][1]);
    grad[2] = half_diff(d[1][1][2], d[1][1][0]);
    const float dll = second(d[2][1][1], d[0][1][1], c);
    const float dyy = second(d[1][2][1], d[1][0][1], c);
    const float dxx = second(d[1][1][2], d[1][1][0], c);
    const float dly = cross(d[2][2][1], d[2][0][1], d[0][2][1], d[0][0][1]);
    const float dlx = cross(d[2][1][2], d[2][1][0], d[0][1][2], d[0][1][0]);
    const float dyx = cross(d[1][2][2], d[1][2][0], d[1][0][2], d[1][0][0]);
    // + 1e-6 * eye: the diagonal gains 1e-6, every other entry + 0.
    float h[3][3] = {{dll, dly, dlx}, {dly, dyy, dyx}, {dlx, dyx, dxx}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) h[i][k] = __fadd_rn(h[i][k], i == k ? 1e-6f : 0.0f);
    float r[3] = {grad[0], grad[1], grad[2]};
    lu_solve3(h, r);
#pragma unroll
    for (int k = 0; k < 3; ++k) off[k] = clamp_nan(-r[k], -1.5f, 1.5f);
    int step[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) step[k] = fabsf(off[k]) > 0.6f ? (off[k] > 0.0f ? 1 : -1) : 0;
    l = clamp_int(l + step[0], 1, a.L - 3);
    y = clamp_int(y + step[1], 2, H - 3);
    x = clamp_int(x + step[2], 2, W - 3);
  }

  dog_cube(plane0, hw, W, l, y, x, d);
  const float c = d[1][1][1];
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(grad[0], off[0]), __fmul_rn(grad[1], off[1])),
                              __fmul_rn(grad[2], off[2]));
  const float contrast = __fadd_rn(c, __fmul_rn(0.5f, dot));
  const bool converged = fabsf(off[0]) < 1.0f && fabsf(off[1]) < 1.0f && fabsf(off[2]) < 1.0f;

  const float dyy = second(d[1][2][1], d[1][0][1], c);
  const float dxx = second(d[1][1][2], d[1][1][0], c);
  const float dyx = cross(d[1][2][2], d[1][2][0], d[1][0][2], d[1][0][0]);
  const float tr = __fadd_rn(dxx, dyy);
  const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dyx, dyx));
  const bool not_edge = det > 0.0f && __fmul_rn(__fmul_rn(tr, tr), a.edge_r) < __fmul_rn(a.edge_r1_sq, det);
  const bool good_contrast = fabsf(contrast) >= a.contrast_min;

  const float level = __fadd_rn((float)l, off[0]);
  a.img[t] = b;
  a.x[t] = __fadd_rn((float)x, off[2]);
  a.y[t] = __fadd_rn((float)y, off[1]);
  a.level[t] = level;
  a.sigma[t] = __fmul_rn(a.sigma0, exp2f(__fmul_rn(level, __frcp_rn(a.spo))));
  a.response[t] = fabsf(contrast);
  a.angle[t] = 0.0f;
  a.valid[t] = alive && converged && good_contrast && not_edge;
}

}  // namespace

// Refined keypoints [n = B * K] of one octave's candidates (idx int64 and
// scores fp32, [B, K], each row contiguous, rows idx_stride and
// score_stride elements apart) from its Gaussian stacks [B, L, H, W] fp32
// (contiguous); outputs
// img int64, x, y, level, sigma, response, angle fp32, valid bool (one
// byte). One thread a candidate (kernels/subpixel_refine.py
// refine_launch_plan).
extern "C" int sfm_subpixel_refine(const float* gauss, const int64_t* idx, int64_t idx_stride,
                                   const float* scores, int64_t score_stride, int64_t* img, float* x, float* y, float* level, float* sigma,
                                   float* response, float* angle, uint8_t* valid, int n, int K,
                                   int L, int H, int W, int iters, float contrast_min, float edge_r,
                                   float edge_r1_sq, float sigma0, float spo, void* stream) {
  if (n < 1 || K < 1 || n % K != 0 || L < 4 || H < 5 || W < 5 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{gauss, idx, idx_stride, scores, score_stride, img, x, y, level, sigma, response, angle, valid, n,
               K, L, H, W, iters, contrast_min, edge_r, edge_r1_sq, sigma0, spo};
  const int blocks = (int)(((int64_t)n + kThreads - 1) / kThreads);
  subpixel_refine_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
