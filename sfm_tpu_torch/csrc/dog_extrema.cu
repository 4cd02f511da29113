// Fused DoG + 26-neighbour extremum score map (SIFT detection), K1.
//
// Replaces: sfm_tpu/kernels/dog_extrema.py dog_extrema_scores_batch (Pallas,
// row tiles of the Gaussian stack DMA'd into VMEM with an 8-row halo).
//
// Bound on the H100: device-memory bytes. Per octave the kernel reads the
// Gaussian stack once (L planes) and writes the Ld = L-1 score planes; the
// arithmetic is ~20 compares per voxel. The DoG volume and the window
// max/min volumes of the plain path never reach device memory.
//
// Design: a memory-bound stencil over halo tiles in shared memory.
// - A block owns a tile of 16 rows x TW columns of one image (the launch
//   plan, kernels/dog_extrema.py dog_launch_plan, takes TW = 64, or 32 when
//   an octave's grid would otherwise give an SM fewer than two blocks: the
//   128^2 octave of a chunk of 8 images) and walks the L levels. Each
//   level's tile plus a 1-pixel halo, (TH+2) x (TW+2) values, is copied
//   into shared memory by cp.async into a ring of three stages: while level
//   g is turned into DoG plane g-1 and scored, levels g+1 and g+2 are in
//   flight. Each Gaussian value crosses device memory once, plus the halo
//   share: (TH+2)(TW+2) / (TH TW) of the tile, 1.160 for (16, 64) and 1.195
//   for (16, 32); neighbouring tiles run at about the same time, so most
//   halo reads are served by L2. A block of 128 threads holds 20.7 KB of
//   shared memory. Other tiles and deeper rings were as fast or slower on
//   the H100 (tools/torch_perf.py dogsweep).
// - Routes: when W % 4 == 0 and the stack is 16-byte aligned (every
//   canvas of the pipeline), rows are copied as 16-byte chunks (cp.async.cg)
//   plus one 4-byte copy for each halo column, and scores are stored as
//   16-byte vectors; otherwise (ragged W, an offset view) every value is a
//   4-byte copy and a scalar store. Halo values outside the image are
//   zero-filled by the copy; they lie within the 5-pixel border, whose
//   scores are 0 whatever they hold.
// - Each DoG voxel is formed once per block: G[g] - G[g-1] over the haloed
//   tile, written to one DoG plane in shared memory (the same fp32
//   subtraction as the plain version).
// - Separable window: a thread owns 4 columns x 2 rows. From the DoG plane
//   it takes the 3-wide max and min along x of its 4 rows with the halo
//   rows, then along y, giving the plane's 3x3 max and min at its 8 pixels.
//   Across levels it keeps in registers, for the two latest planes, max(3x3
//   of plane d-1, 3x3 of plane d) and the 3x3 of plane d, and the DoG of
//   plane d at its pixels (the centres of the level scored next): the
//   3x3x3 max of level d is then one more max with plane d+1's 3x3. The
//   centre's compares are the plain version's (>= max and > pre, or <= min
//   and < -pre); max and min of finite values do not depend on their order,
//   so the scores are bit-exact.
// - Stores: levels 0 and Ld-1, pixels outside the 5-pixel interior and
//   tiles holding no scored pixel (or Ld < 3) write zeros through the same
//   stores, coalesced along x (__stcs: the scores are not read again here).

#include <cuda_runtime.h>

namespace {

constexpr int kMargin = 5;
constexpr int kStages = 3;  // Gaussian tiles: level g in use, g+1 and g+2 loading
constexpr int kRows = 2;    // rows a thread owns (4 columns each)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Asynchronous copies of 16 and 4 bytes; a copy that is not `valid` reads
// nothing and zero-fills its destination.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <int TH, int TW>
struct Tile {
  static constexpr int kTX = TW / 4;               // threads along x
  static constexpr int kThreads = kTX * (TH / kRows);
  static constexpr int kSH = TH + 2;               // rows with the halo
  // Row pitch: halo column at 3, tile columns at 4 .. TW+3 (16-byte
  // aligned), halo column at TW+4; 0-2 and TW+5..TW+7 are never read.
  static constexpr int kSW = TW + 8;
  static constexpr int kPlane = kSH * kSW;
  // kStages Gaussian tiles and the DoG plane (kernels/dog_extrema.py
  // tile_smem_bytes computes the same).
  static constexpr int kSmemBytes = (kStages + 1) * kPlane * (int)sizeof(float);
};

template <int TH, int TW, bool VEC>
__global__ void __launch_bounds__(Tile<TH, TW>::kThreads)
dog_extrema_kernel(const float* __restrict__ gauss, float* __restrict__ out, int L, int H,
                   int W, float pre) {
  using T = Tile<TH, TW>;
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                          // kStages Gaussian tiles
  float* ds = smem + kStages * T::kPlane;    // the DoG plane

  const int tid = threadIdx.x;
  const int tx = tid % T::kTX, ty = tid / T::kTX;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int Ld = L - 1;
  const size_t plane = (size_t)H * W;
  const float* g = gauss + (size_t)blockIdx.z * L * plane;
  float* o = out + (size_t)blockIdx.z * Ld * plane;
  const int px = x0 + 4 * tx;       // this thread's columns px .. px+3
  const int py = y0 + kRows * ty;   // and rows py, py+1

  auto store = [&](int l, int r, float4 v) {
    const int y = py + r;
    if (y >= H) return;
    float* dst = o + (size_t)l * plane + (size_t)y * W + px;
    if (VEC) {
      if (px < W) __stcs(reinterpret_cast<float4*>(dst), v);
    } else {
      if (px < W) __stcs(dst, v.x);
      if (px + 1 < W) __stcs(dst + 1, v.y);
      if (px + 2 < W) __stcs(dst + 2, v.z);
      if (px + 3 < W) __stcs(dst + 3, v.w);
    }
  };
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // A tile without a scored pixel (or a stack without a scored level)
  // writes zeros and loads nothing.
  const bool scored = Ld >= 3 && x0 + TW > kMargin && x0 < W - kMargin &&
                      y0 + TH > kMargin && y0 < H - kMargin;
  if (!scored) {
    for (int l = 0; l < Ld; ++l)
#pragma unroll
      for (int r = 0; r < kRows; ++r) store(l, r, zero);
    return;
  }

  // Level `lev`'s haloed tile into its stage (one commit group per call).
  auto load_level = [&](int lev) {
    float* dst = gs + (lev % kStages) * T::kPlane;
    const float* src = g + (size_t)lev * plane;
    if (VEC) {
#pragma unroll 1
      for (int i = tid; i < T::kSH * T::kTX; i += T::kThreads) {
        const int r = i / T::kTX, c = i % T::kTX;
        const int y = y0 - 1 + r, x = x0 + 4 * c;
        const bool ok = y >= 0 && y < H && x < W;
        cp_async16(dst + r * T::kSW + 4 + 4 * c, ok ? src + (size_t)y * W + x : src, ok);
      }
#pragma unroll 1
      for (int i = tid; i < 2 * T::kSH; i += T::kThreads) {
        const int r = i >> 1, right = i & 1;
        const int y = y0 - 1 + r, x = right ? x0 + TW : x0 - 1;
        const bool ok = y >= 0 && y < H && x >= 0 && x < W;
        cp_async4(dst + r * T::kSW + (right ? TW + 4 : 3), ok ? src + (size_t)y * W + x : src, ok);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < T::kSH * (TW + 2); i += T::kThreads) {
        const int r = i / (TW + 2), c = i % (TW + 2);
        const int y = y0 - 1 + r, x = x0 - 1 + c;
        const bool ok = y >= 0 && y < H && x >= 0 && x < W;
        cp_async4(dst + r * T::kSW + 3 + c, ok ? src + (size_t)y * W + x : src, ok);
      }
    }
  };

  // Which of this thread's pixels lie in the interior.
  bool in_x[4], in_y[kRows];
#pragma unroll
  for (int k = 0; k < 4; ++k) in_x[k] = px + k >= kMargin && px + k < W - kMargin;
#pragma unroll
  for (int r = 0; r < kRows; ++r) in_y[r] = py + r >= kMargin && py + r < H - kMargin;

  for (int lev = 0; lev < kStages; ++lev) {   // one commit group per level
    if (lev < L) load_level(lev);
    cp_async_commit();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) store(0, r, zero);   // level 0 is never scored

  // Across planes: two_max = max(3x3 of plane d-1, 3x3 of plane d),
  // one_max = 3x3 of plane d, cen = DoG of plane d at this thread's pixels.
  float two_max[kRows][4], two_min[kRows][4], one_max[kRows][4], one_min[kRows][4];
  float cen[kRows][4];

  for (int lev = 1; lev < L; ++lev) {
    cp_async_wait<kStages - 2>();   // level lev has landed; later ones may be loading
    __syncthreads();
    {
      const float4* ga = reinterpret_cast<const float4*>(gs + ((lev - 1) % kStages) * T::kPlane);
      const float4* gb = reinterpret_cast<const float4*>(gs + (lev % kStages) * T::kPlane);
      float4* dd = reinterpret_cast<float4*>(ds);
#pragma unroll 1
      for (int i = tid; i < T::kPlane / 4; i += T::kThreads) {
        const float4 a = ga[i], b = gb[i];
        dd[i] = make_float4(b.x - a.x, b.y - a.y, b.z - a.z, b.w - a.w);
      }
    }
    __syncthreads();   // the DoG plane is whole; level lev-1's stage is free
    if (lev + kStages - 1 < L) load_level(lev + kStages - 1);
    cp_async_commit();   // possibly empty: keeps one group per level

    // 3x3 max and min of plane d = lev-1 at this thread's pixels: x then y.
    float sp_max[kRows][4], sp_min[kRows][4], c_new[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows + 2; ++i) {
      const float* row = ds + (kRows * ty + i) * T::kSW + 4 + 4 * tx;
      const float4 m = *reinterpret_cast<const float4*>(row);
      const float v[6] = {row[-1], m.x, m.y, m.z, m.w, row[4]};
      const float hi12 = fmaxf(v[1], v[2]), hi34 = fmaxf(v[3], v[4]);
      const float lo12 = fminf(v[1], v[2]), lo34 = fminf(v[3], v[4]);
      const float xmax[4] = {fmaxf(v[0], hi12), fmaxf(hi12, v[3]), fmaxf(v[2], hi34),
                             fmaxf(hi34, v[5])};
      const float xmin[4] = {fminf(v[0], lo12), fminf(lo12, v[3]), fminf(v[2], lo34),
                             fminf(lo34, v[5])};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (i < r || i > r + 2) continue;   // row i is in output row r's window
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sp_max[r][k] = i == r ? xmax[k] : fmaxf(sp_max[r][k], xmax[k]);
          sp_min[r][k] = i == r ? xmin[k] : fminf(sp_min[r][k], xmin[k]);
        }
      }
      if (i >= 1 && i <= kRows) {
#pragma unroll
        for (int k = 0; k < 4; ++k) c_new[i - 1][k] = v[k + 1];
      }
    }

    const int d = lev - 1;
    if (d >= 2) {   // score level d-1 (in [1, Ld-2]): centres cen, planes d-2 .. d
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float s[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wmax = fmaxf(two_max[r][k], sp_max[r][k]);
          const float wmin = fminf(two_min[r][k], sp_min[r][k]);
          const float c = cen[r][k];
          const bool ext = (c >= wmax && c > pre) || (c <= wmin && c < -pre);
          s[k] = ext && in_x[k] && in_y[r] ? fabsf(c) : 0.0f;
        }
        store(d - 1, r, make_float4(s[0], s[1], s[2], s[3]));
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        two_max[r][k] = d == 0 ? sp_max[r][k] : fmaxf(one_max[r][k], sp_max[r][k]);
        two_min[r][k] = d == 0 ? sp_min[r][k] : fminf(one_min[r][k], sp_min[r][k]);
        one_max[r][k] = sp_max[r][k];
        one_min[r][k] = sp_min[r][k];
        cen[r][k] = c_new[r][k];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) store(Ld - 1, r, zero);   // nor is level Ld-1
}

template <int TH, int TW, bool VEC>
int launch_tiles(const float* gauss, float* out, int B, int L, int H, int W, float pre,
                 cudaStream_t stream) {
  using T = Tile<TH, TW>;
  static_assert(T::kSmemBytes <= 48 * 1024, "no opt-in to more dynamic shared memory");
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  dog_extrema_kernel<TH, TW, VEC><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      gauss, out, L, H, W, pre);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_route(const float* gauss, float* out, int B, int L, int H, int W, float pre,
                 int tile_h, int tile_w, cudaStream_t stream) {
  if (tile_h == 16 && tile_w == 64)
    return launch_tiles<16, 64, VEC>(gauss, out, B, L, H, W, pre, stream);
  if (tile_h == 16 && tile_w == 32)
    return launch_tiles<16, 32, VEC>(gauss, out, B, L, H, W, pre, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Gaussian stacks [B, L, H, W] -> scores [B, L-1, H, W] on tiles of
// tile_h x tile_w (one of kernels/dog_extrema.py TILES); vec: the 16-byte
// route (W % 4 == 0 and both pointers 16-byte aligned).
extern "C" int sfm_dog_extrema(const float* gauss, float* out, int B, int L, int H, int W,
                               float pre_thresh, int tile_h, int tile_w, int vec,
                               void* stream) {
  if (B < 1 || L < 2 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (vec && W % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_route<true>(gauss, out, B, L, H, W, pre_thresh, tile_h, tile_w, s)
             : launch_route<false>(gauss, out, B, L, H, W, pre_thresh, tile_h, tile_w, s);
}
