// Fused DoG + 26-neighbour extremum score map (SIFT detection).
//
// Replaces: sfm_tpu/kernels/dog_extrema.py dog_extrema_scores_batch (Pallas,
// row tiles of the Gaussian stack DMA'd into VMEM with an 8-row halo).
//
// Bound on the H100: device-memory bytes. Per octave the kernel reads the
// Gaussian stack once (L planes) and writes the Ld = L-1 score planes; the
// arithmetic is ~30 compares per voxel. The DoG volume and the two window
// max/min volumes of the plain path never reach device memory.
//
// Design: one thread per (b, y, x) column. It walks the levels keeping the
// 3x3 DoG neighbourhoods of three consecutive DoG levels in registers, so
// each Gaussian value it needs is loaded once per thread (neighbouring
// threads share them through L1). Only interior voxels are scored; every
// other voxel is 0, exactly like the interior mask of the plain version, so
// the border never needs padding. All arithmetic is the plain version's:
// the same fp32 subtraction and compares, hence bit-exact scores.

#include <cuda_runtime.h>

namespace {

constexpr int kMargin = 5;

__device__ __forceinline__ void load3x3(const float* __restrict__ plane, int W,
                                        int y, int x, float v[9]) {
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      v[(dy + 1) * 3 + (dx + 1)] = plane[(size_t)(y + dy) * W + (x + dx)];
    }
  }
}

__global__ void dog_extrema_kernel(const float* __restrict__ gauss,
                                   float* __restrict__ out, int L, int H, int W,
                                   float pre) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const int Ld = L - 1;
  const size_t plane = (size_t)H * W;
  const float* g = gauss + (size_t)b * L * plane;
  float* o = out + (size_t)b * Ld * plane;
  const size_t pix = (size_t)y * W + x;

  const bool inside = y >= kMargin && y < H - kMargin && x >= kMargin &&
                      x < W - kMargin;
  if (!inside || Ld < 3) {
    for (int l = 0; l < Ld; ++l) o[l * plane + pix] = 0.0f;
    return;
  }

  float ga[9], gb[9], prev[9], cur[9], nxt[9];
  load3x3(g, W, y, x, ga);
  load3x3(g + plane, W, y, x, gb);
#pragma unroll
  for (int i = 0; i < 9; ++i) prev[i] = gb[i] - ga[i];
#pragma unroll
  for (int i = 0; i < 9; ++i) ga[i] = gb[i];
  load3x3(g + 2 * plane, W, y, x, gb);
#pragma unroll
  for (int i = 0; i < 9; ++i) cur[i] = gb[i] - ga[i];

  o[pix] = 0.0f;  // level 0 is outside [1, Ld-2]
  for (int l = 1; l <= Ld - 2; ++l) {
#pragma unroll
    for (int i = 0; i < 9; ++i) ga[i] = gb[i];
    load3x3(g + (size_t)(l + 2) * plane, W, y, x, gb);
#pragma unroll
    for (int i = 0; i < 9; ++i) nxt[i] = gb[i] - ga[i];

    float wmax = prev[0], wmin = prev[0];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      wmax = prev[i] > wmax ? prev[i] : wmax;
      wmin = prev[i] < wmin ? prev[i] : wmin;
      wmax = cur[i] > wmax ? cur[i] : wmax;
      wmin = cur[i] < wmin ? cur[i] : wmin;
      wmax = nxt[i] > wmax ? nxt[i] : wmax;
      wmin = nxt[i] < wmin ? nxt[i] : wmin;
    }
    const float c = cur[4];
    const bool is_ext = (c >= wmax && c > pre) || (c <= wmin && c < -pre);
    o[l * plane + pix] = is_ext ? fabsf(c) : 0.0f;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      prev[i] = cur[i];
      cur[i] = nxt[i];
    }
  }
  o[(size_t)(Ld - 1) * plane + pix] = 0.0f;
}

}  // namespace

extern "C" int sfm_dog_extrema(const float* gauss, float* out, int B, int L,
                               int H, int W, float pre_thresh, void* stream) {
  dim3 block(32, 8);
  dim3 grid((W + 31) / 32, (H + 7) / 8, B);
  dog_extrema_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(gauss, out, L, H,
                                                              W, pre_thresh);
  return (int)cudaGetLastError();
}
