// SIFT 128-D descriptors of one octave's keypoints in one launch, K12.
//
// Replaces no TPU kernel: sfm_tpu/ops/descriptor.py compute_descriptors is
// plain JAX, and so was the port's version (kernels/sift_descriptors.py
// sift_descriptors_plain, which the CPU runs and the tests against sfm_tpu
// still take). On the H100 that version gathered a [64, 64] window of each
// gradient channel per keypoint, built [N, 256, 64] separable bilinear
// weights, ran two fp32 bmm and ~30 elementwise ops over [N, 256, 8]: about
// 85 launches and 0.5-1 MB of intermediates a keypoint in device memory,
// 55% of the feature stage's device time.
//
// Bound on the H100: device-memory bytes. A call must write the [N, 128]
// descriptors once and read, once, each 32-byte sector of dx and dy that a
// tap of some lattice point touches (keypoints of one plane share
// sectors; Lowe's second-peak duplicates share whole patches). The
// arithmetic, ~60 operations a lattice point, is far below the card's rate.
//
// What a keypoint computes (the plain version's arithmetic, in fp32):
// - the 16 x 16 lattice in cell units ((k + 0.5) / 4 - 2 on each axis),
//   scaled by 3 sigma and rotated by the keypoint's angle: the offset of
//   each point, rounded op by op as the plain version's elementwise ops
//   round it (__fmul_rn / __fadd_rn: no contraction into FMAs);
// - the level round(level) clamped into [0, L); the clamp box: where
//   min(H, W) >= 64 the 64-px window whose corner is round(x) - 32 (and
//   round(y) - 32) clamped into the image, else the whole plane; the
//   position, relative to the box, clamped to [0, size - 1.000001];
// - 4-tap bilinear samples of dx and dy inside the box (the plain
//   windowed sampler is exactly 2-tap bilinear on each axis inside its
//   window, so the two agree to rounding; on the whole-plane route they are
//   the same ops in the same order);
// - the magnitude sqrt(gx^2 + gy^2 + 1e-12) times the Gaussian window
//   exp(-(u^2 + v^2) / 8) (computed in double and rounded to fp32, as the
//   plain version's numpy table is), the orientation atan2(gy, gx) - angle
//   soft-binned into 8 bins (x / 2pi as the card's PyTorch divides by a
//   scalar: times the fp32 reciprocal);
// - the bilinear 4 x 4 cell weights, exact dyadic constants computed from
//   the lattice index; L2 normalise, clip at 0.2, normalise again, and the
//   root-SIFT branch. Nothing is uploaded per call.
// Every slot is computed, valid or not.
//
// Design: one block of 128 threads per keypoint.
// 1. Each thread takes lattice points t and t + 128 (a warp: two lattice
//    rows, neighbouring taps), reads its 8 taps with __ldg (a patch stays
//    in L1 / L2) and writes the point's contribution to each of the 8
//    bins (mag * (1 - frac) to its low bin, mag * frac to the next, zeros)
//    to shared memory. The lattice is laid out with a border of two zero
//    points on each side (20 x 20 points, 16 KB a block), so that every
//    cell's 8 x 8 window of points lies inside it.
// 2. Each thread owns one output, (cell, orientation) = (t / 8, t % 8), and
//    sums its bin over the 8 x 8 points of its cell's window in a fixed
//    order: one shared load and one FMA with a constant weight a point, a
//    deterministic sum, no atomics. A point's 8 bins are 8 consecutive
//    floats, and 8 more floats follow every 4 points, so that the four
//    cells of a warp (4 points apart) read 32 distinct banks.
// 3. Block sums (warp butterflies, then the four warps' partials in a fixed
//    order) give the norms; the block writes its 128 floats coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSamples = 16;                  // lattice points along each axis
constexpr int kPoints = kSamples * kSamples;  // 256
constexpr int kBorder = 2;                    // zero points around the lattice
constexpr int kRow = kSamples + 2 * kBorder;  // 20 points a padded row
constexpr int kPadded = kRow * kRow;          // 400
constexpr int kOri = 8;                       // orientation bins
constexpr int kThreads = 128;                 // 4 x 4 cells x 8 bins: one output a thread
constexpr int kWarps = kThreads / 32;
constexpr int kWin = 64;                      // sampling window of the windowed route
constexpr float kCellSigma = 3.0f;
constexpr float kClip = 0.2f;
// PyTorch on the card divides a float tensor by a Python scalar as a
// product with the scalar's fp32 reciprocal.
constexpr float kInvTwoPi = 1.0f / 6.28318530717958647692f;

struct Args {
  const float* dx;  // [B, L, H, W]
  const float* dy;
  const int64_t* img;  // [N] keypoint fields
  const float* x;
  const float* y;
  const float* level;
  const float* sigma;
  const float* angle;
  float* out;  // [N, 128]
  int B, L, H, W, root_sift;
};

// Lattice coordinate of index k in cell units (exact in fp32).
__device__ __forceinline__ float lattice(int k) { return (k + 0.5f) * 0.25f - 2.0f; }

// Bilinear weight to cell c, along one axis, of lattice index k = 4c - 2 + d
// (d in [0, 8): the cell's window): max(0, 1 - |lattice(k) - (c - 1.5)|) =
// 1 - |d - 3.5| / 4, exact.
__host__ __device__ constexpr float cell_weight(int d) { return (d < 4 ? d + 0.5f : 7.5f - d) * 0.25f; }

// Offset in floats of padded point q's 8 bins (8 more floats every 4
// points).
__host__ __device__ constexpr int bins_at(int q) { return kOri * (q + q / 4); }

// round(v) (half to even) as an integer clamped into [lo, hi].
__device__ __forceinline__ int round_clamp(float v, int lo, int hi) {
  return (int)fminf(fmaxf(rintf(v), (float)lo), (float)hi);
}

// Sum of v over the block, the same bits in every thread. `part` holds
// kWarps floats; the leading barrier lets a call reuse it.
__device__ __forceinline__ float block_sum(float v, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  return (part[0] + part[1]) + (part[2] + part[3]);
}

__global__ __launch_bounds__(kThreads) void sift_descriptors_kernel(const Args a) {
  // Each padded lattice point's contribution to the 8 bins.
  __shared__ __align__(16) float s_bins[bins_at(kPadded)];
  __shared__ float s_part[kWarps];

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int H = a.H, W = a.W;
  const float xk = a.x[k], yk = a.y[k], ang = a.angle[k];
  const float scale = __fmul_rn(a.sigma[k], kCellSigma);
  const float ct = cosf(ang), st = sinf(ang);
  // The image index is the detector's; clamped so that a bad one reads a
  // wrong plane, never outside the stacks.
  const int64_t img = min(max(a.img[k], (int64_t)0), (int64_t)(a.B - 1));
  const int lev = round_clamp(a.level[k], 0, a.L - 1);
  const size_t plane = ((size_t)img * a.L + lev) * H * W;

  // The clamp box: the 64-px window or the whole plane.
  // (round(x) - 32) clamped into [0, W - 64] is round(x) clamped into
  // [32, W - 32], less 32.
  const bool windowed = min(H, W) >= kWin;
  const int box_x = windowed ? round_clamp(xk, kWin / 2, W - kWin / 2) - kWin / 2 : 0;
  const int box_y = windowed ? round_clamp(yk, kWin / 2, H - kWin / 2) - kWin / 2 : 0;
  const int box_w = windowed ? kWin : W, box_h = windowed ? kWin : H;
  const float hi_x = (float)((double)box_w - 1.000001), hi_y = (float)((double)box_h - 1.000001);
  const float* gx_plane = a.dx + plane + (size_t)box_y * W + box_x;
  const float* gy_plane = a.dy + plane + (size_t)box_y * W + box_x;

  // The border's points contribute nothing.
  for (int q = t; q < kPadded; q += kThreads) {
    const int r = q / kRow, c = q % kRow;
    if (r < kBorder || r >= kBorder + kSamples || c < kBorder || c >= kBorder + kSamples) {
      float4* dst = reinterpret_cast<float4*>(s_bins + bins_at(q));
      dst[0] = dst[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

#pragma unroll
  for (int h = 0; h < kPoints / kThreads; ++h) {
    const int p = t + h * kThreads;
    const int i = p / kSamples, j = p % kSamples;  // lattice row (v) and column (u)
    const float u = lattice(j), v = lattice(i);
    const float du = __fmul_rn(u, scale), dv = __fmul_rn(v, scale);
    const float off_x = __fsub_rn(__fmul_rn(ct, du), __fmul_rn(st, dv));
    const float off_y = __fadd_rn(__fmul_rn(st, du), __fmul_rn(ct, dv));
    const float px = fminf(fmaxf(__fsub_rn(__fadd_rn(xk, off_x), (float)box_x), 0.0f), hi_x);
    const float py = fminf(fmaxf(__fsub_rn(__fadd_rn(yk, off_y), (float)box_y), 0.0f), hi_y);
    const float fx0 = floorf(px), fy0 = floorf(py);
    const float fx = __fsub_rn(px, fx0), fy = __fsub_rn(py, fy0);
    const float gfx = __fsub_rn(1.0f, fx), gfy = __fsub_rn(1.0f, fy);
    const int x0 = min(max((int)fx0, 0), box_w - 1), y0 = min(max((int)fy0, 0), box_h - 1);
    const int x1 = min(x0 + 1, box_w - 1), y1 = min(y0 + 1, box_h - 1);
    const size_t r0 = (size_t)y0 * W, r1 = (size_t)y1 * W;

    // v00 (1 - fx)(1 - fy) + v01 fx (1 - fy) + v10 (1 - fx) fy + v11 fx fy,
    // left to right, each op rounded.
    auto tap = [&](const float* g) {
      float s = __fmul_rn(__fmul_rn(__ldg(g + r0 + x0), gfx), gfy);
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(__ldg(g + r0 + x1), fx), gfy));
      s = __fadd_rn(s, __fmul_rn(__fmul_rn(__ldg(g + r1 + x0), gfx), fy));
      return __fadd_rn(s, __fmul_rn(__fmul_rn(__ldg(g + r1 + x1), fx), fy));
    };
    const float gx = tap(gx_plane), gy = tap(gy_plane);

    const double uu = u, vv = v;
    const float w_gauss = (float)exp(-(uu * uu + vv * vv) / 8.0);
    const float sq = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), 1e-12f);
    const float mag = __fmul_rn(__fsqrt_rn(sq), w_gauss);
    const float theta = __fsub_rn(atan2f(gy, gx), ang);
    // (theta / 2pi * 8) % 8, the floor remainder as PyTorch takes it.
    float binf = fmodf(__fmul_rn(__fmul_rn(theta, kInvTwoPi), (float)kOri), (float)kOri);
    if (binf < 0.0f) binf = __fadd_rn(binf, (float)kOri);
    const float b0 = floorf(binf);
    const float frac = __fsub_rn(binf, b0);
    const float lo = __fmul_rn(mag, __fsub_rn(1.0f, frac)), hi = __fmul_rn(mag, frac);
    const int b = (int)b0 & (kOri - 1);  // b0 is 8 only where the remainder rounded up to 8
    float w[kOri];
#pragma unroll
    for (int o = 0; o < kOri; ++o) w[o] = o == b ? lo : (o == ((b + 1) & (kOri - 1)) ? hi : 0.0f);
    float4* dst = reinterpret_cast<float4*>(s_bins + bins_at((i + kBorder) * kRow + j + kBorder));
    dst[0] = make_float4(w[0], w[1], w[2], w[3]);
    dst[1] = make_float4(w[4], w[5], w[6], w[7]);
  }
  __syncthreads();

  // The cell's window starts at padded point (4 cy, 4 cx), a multiple of 4,
  // so bins_at(start + c) = bins_at(start) + bins_at(c).
  const int cell = t / kOri, cy = cell / 4, cx = cell % 4;
  const float* win = s_bins + bins_at(4 * cy * kRow + 4 * cx) + t % kOri;
  float acc = 0.0f;
#pragma unroll
  for (int di = 0; di < 8; ++di) {
#pragma unroll
    for (int dj = 0; dj < 8; ++dj)
      acc = fmaf(cell_weight(di) * cell_weight(dj), win[bins_at(di * kRow + dj)], acc);
  }

  float d = __fdiv_rn(acc, fmaxf(__fsqrt_rn(block_sum(acc * acc, s_part)), 1e-8f));
  d = fminf(d, kClip);
  d = __fdiv_rn(d, fmaxf(__fsqrt_rn(block_sum(d * d, s_part)), 1e-8f));
  if (a.root_sift) d = __fsqrt_rn(__fdiv_rn(d, fmaxf(block_sum(d, s_part), 1e-8f)));
  a.out[(size_t)k * kThreads + t] = d;
}

}  // namespace

// Descriptors [n, 128] of n keypoints (img int64; x, y, level, sigma,
// angle fp32; each [n]) from gradient stacks dx, dy [B, L, H, W]; one block
// of 128 threads a keypoint (kernels/sift_descriptors.py
// descriptor_launch_plan).
extern "C" int sfm_sift_descriptors(const float* dx, const float* dy, const int64_t* img,
                                    const float* x, const float* y, const float* level,
                                    const float* sigma, const float* angle, float* out, int n,
                                    int B, int L, int H, int W, int root_sift, void* stream) {
  if (n < 1 || B < 1 || L < 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const Args a{dx, dy, img, x, y, level, sigma, angle, out, B, L, H, W, root_sift};
  sift_descriptors_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
