// An octave's Gaussian levels from its base in one launch, K13.
//
// Replaces no TPU kernel: sfm_tpu/ops/pyramid.py blurs each level with two
// dense banded-Toeplitz products, and so did the port
// (kernels/blur_levels.py blur_levels_plain, which the CPU runs and the
// tests against sfm_tpu still take). On the H100 that version built an
// [L, n, n] operator stack on the host at every octave of every chunk
// (25 MB for octave 0 at 1024^2), copied it up from pageable memory and
// ran two fp32 GEMMs a level: 2 n multiply-adds a pixel a pass where the
// band holds at most 2 ceil(4 sigma) + 1 taps.
//
// Bound on the H100: the base read once and the L levels written once at
// 3.35 TB/s, or the band's multiply-adds (two passes, every level) at
// 67 TFLOP/s fp32, whichever is longer. The two are close at 1024^2
// (8 views, octave 0: 235 MB, 70 us; 2.6 G FMAs, 78 us).
//
// What it computes (kernels/blur_levels.py band_tables): for each level l
// and each row i of the level's operator T, the window of W_l columns that
// holds every nonzero of the row, and T's entries over it (zeros inside it
// included), laid out by the host for each group of 4 rows over the
// group's common window. The output is T (T base)^T, as the plain
// version's matmul(matmul(T, base), T^T): the vertical pass first, each sum
// an fmaf chain from 0 over T's entries in ascending column order. The
// dense fp32 product's other terms are exact zeros, so the two agree to the
// bit when the library sums in that order too. fp32 throughout, no
// fast-math.
//
// Design: a block of 256 threads takes a 32 x 64 output tile of one view
// and makes every level of it.
// 1. The base rows and columns that any level of the tile reads (the
//    host's tile_rows / tile_cols) go into shared memory once, by
//    asynchronous copies through the base's strides (downsample2's view
//    needs no copy).
// 2. Per level, the taps of the tile's 8 row groups and 16 column groups
//    ([group][tap][4]: one float4 a tap, the same address across a warp of
//    the vertical pass) and their windows, by asynchronous 16-byte copies
//    of contiguous runs of the tables: one round trip a level.
// 3. Vertical pass: a thread makes 4 rows x 4 columns of T base for every
//    column the tile's horizontal windows read (a float4 of base and a
//    float4 of taps a tap, 16 FMAs), into shared memory (an odd row
//    pitch).
// 4. Horizontal pass: a thread makes 2 rows (16 apart) x 4 columns of the
//    level and writes them (a row's two groups of a warp: 32 contiguous
//    bytes).
// No allocation, no sync with the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;                  // output rows a block
constexpr int kTileW = 64;                  // output columns a block
constexpr int kGroup = 4;                   // outputs over one window of taps
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroups = kTileH / kGroup;  // 8
constexpr int kColGroups = kTileW / kGroup;  // 16
constexpr int kGroups = kRowGroups + kColGroups;
constexpr int kHalfTile = kTileH / 2;       // horizontal pass: rows r and r + 16
constexpr int kMaxSmemBytes = 227 * 1024;
static_assert(kColGroups * kHalfTile == kThreads, "one horizontal task a thread");
static_assert(kTileW % kTileH == 0, "the host pads the group tables to whole column tiles");

struct Args {
  const float* base;          // [B, n, n] at element strides sb, sy, sx
  int64_t sb, sy, sx;
  const int* group_windows;   // [L, groups, 2]: (first, end) columns; (n, n) is empty
  const float* group_taps;    // [L, groups, group_w, kGroup]: T over the windows
  const int* tile_rows;       // [ceil(n / kTileH), 2]: base rows a tile reads
  const int* tile_cols;       // [ceil(n / kTileW), 2]: base columns a tile reads
  float* out;                 // [B, L, n, n]
  int L, n, groups, span_h, span_w, group_w;
};

// Shared memory, in floats: the base [span_h][pitch_s], the vertical pass
// [kTileH][pitch_t], the tile's group taps [kGroups][group_w][kGroup] (its
// 8 row groups, then its 16 column groups), their windows [kGroups][2]
// (ints).
struct Layout {
  int pitch_s, pitch_t, tmp, taps, windows, bytes;
};

__host__ __device__ inline Layout layout(int span_h, int span_w, int group_w) {
  Layout l;
  // The vertical pass reads float4s from a multiple of 4 below a window's
  // first column to at most 3 past the tile's last one.
  l.pitch_s = (span_w + 3 + 3) / 4 * 4;
  l.pitch_t = l.pitch_s + 1;
  l.tmp = span_h * l.pitch_s;
  l.taps = l.tmp + kTileH * l.pitch_t;  // kTileH is a multiple of 4: aligned
  l.windows = l.taps + kGroups * group_w * kGroup;
  l.bytes = (l.windows + 2 * kGroups) * 4;
  return l;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads) blur_levels_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout(a.span_h, a.span_w, a.group_w);
  float* s_base = smem;
  float* s_tmp = smem + lay.tmp;
  float* s_taps = smem + lay.taps;
  int* s_win = reinterpret_cast<int*>(smem + lay.windows);

  const int t = threadIdx.x, lane = t % 32, warp = t / 32, n = a.n;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH, view = blockIdx.z;
  const int ry0 = a.tile_rows[2 * blockIdx.y], ry1 = a.tile_rows[2 * blockIdx.y + 1];
  const int rx0 = a.tile_cols[2 * blockIdx.x], rx1 = a.tile_cols[2 * blockIdx.x + 1];

  // 1. The base's rows ry0..ry1-1, columns rx0.. (zeros past rx1), by
  // asynchronous 4-byte copies through the base's strides.
  const float* src = a.base + (int64_t)view * a.sb;
  for (int r = warp; r < ry1 - ry0; r += kWarps) {
    const float* row = src + (int64_t)(ry0 + r) * a.sy;
    for (int c = lane; c < lay.pitch_s; c += 32) {
      if (rx0 + c < rx1) {
        cp_async4(s_base + r * lay.pitch_s + c, row + (int64_t)(rx0 + c) * a.sx);
      } else {
        s_base[r * lay.pitch_s + c] = 0.0f;
      }
    }
  }

  const int gw4 = a.group_w * kGroup;
  for (int lev = 0; lev < a.L; ++lev) {
    // 2. The tile's group taps and windows: its row groups from y0 / 4 and
    // its column groups from x0 / 4, each a contiguous run of the tables
    // (16-byte copies; the host pads the groups to whole column tiles).
    const int64_t level = (int64_t)lev * a.groups;
    const float* row_taps = a.group_taps + (level + y0 / kGroup) * gw4;
    const float* col_taps = a.group_taps + (level + x0 / kGroup) * gw4;
    for (int i = t; i < kGroups * a.group_w; i += kThreads) {
      const int split = kRowGroups * a.group_w;
      cp_async16(s_taps + 4 * i, i < split ? row_taps + 4 * i : col_taps + 4 * (i - split));
    }
    if (t < kGroups) {
      const int g = t < kRowGroups ? y0 / kGroup + t : x0 / kGroup + t - kRowGroups;
      cp_async8(s_win + 2 * t, a.group_windows + 2 * (level + g));
    }
    cp_async_wait_all();
    __syncthreads();

    // 3. Vertical pass over the columns the horizontal windows read, from a
    // multiple of 4 (in shared-memory columns) at or below the first.
    int cx0 = n, cx1 = 0;
    for (int g = kRowGroups; g < kGroups; ++g) {
      if (s_win[2 * g] < s_win[2 * g + 1]) {
        cx0 = min(cx0, s_win[2 * g]);
        cx1 = max(cx1, s_win[2 * g + 1]);
      }
    }
    const int ca = rx0 + ((cx0 - rx0) & ~3);
    const int quads = cx1 > cx0 ? (cx1 - ca + 3) / 4 : 0;
    for (int task = t; task < kRowGroups * quads; task += kThreads) {
      const int g = task / quads, q = task - g * quads;
      const int vs = s_win[2 * g], ve = s_win[2 * g + 1];
      if (vs >= ve) continue;
      const float4* sp = reinterpret_cast<const float4*>(s_base + (vs - ry0) * lay.pitch_s + (ca - rx0)) + q;
      const float4* wp = reinterpret_cast<const float4*>(s_taps + g * gw4);
      float acc[kGroup][4] = {};
#pragma unroll 4
      for (int m = 0; m < ve - vs; ++m) {
        const float4 s = sp[m * (lay.pitch_s / 4)];
        const float4 w = wp[m];
        const float wk[kGroup] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          acc[k][0] = fmaf(wk[k], s.x, acc[k][0]);
          acc[k][1] = fmaf(wk[k], s.y, acc[k][1]);
          acc[k][2] = fmaf(wk[k], s.z, acc[k][2]);
          acc[k][3] = fmaf(wk[k], s.w, acc[k][3]);
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        float* dst = s_tmp + (g * kGroup + k) * lay.pitch_t + 4 * q;
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c] = acc[k][c];
      }
    }
    __syncthreads();

    // 4. Horizontal pass and the level's writes.
    {
      const int g = t / kHalfTile, r = t % kHalfTile;
      const int hs = s_win[2 * (kRowGroups + g)], he = s_win[2 * (kRowGroups + g) + 1];
      if (hs < he) {
        const float4* wp = reinterpret_cast<const float4*>(s_taps + (kRowGroups + g) * gw4);
        const float* r0 = s_tmp + r * lay.pitch_t + (hs - ca);
        const float* r1 = r0 + kHalfTile * lay.pitch_t;
        float acc0[kGroup] = {}, acc1[kGroup] = {};
#pragma unroll 4
        for (int m = 0; m < he - hs; ++m) {
          const float4 w = wp[m];
          const float a0 = r0[m], a1 = r1[m];
          acc0[0] = fmaf(w.x, a0, acc0[0]);
          acc0[1] = fmaf(w.y, a0, acc0[1]);
          acc0[2] = fmaf(w.z, a0, acc0[2]);
          acc0[3] = fmaf(w.w, a0, acc0[3]);
          acc1[0] = fmaf(w.x, a1, acc1[0]);
          acc1[1] = fmaf(w.y, a1, acc1[1]);
          acc1[2] = fmaf(w.z, a1, acc1[2]);
          acc1[3] = fmaf(w.w, a1, acc1[3]);
        }
        const int x = x0 + g * kGroup;
        float* plane = a.out + ((int64_t)view * a.L + lev) * n * n;
        const bool vec = (n % 4 == 0) && x + 3 < n;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int y = y0 + r + half * kHalfTile;
          if (y >= n) continue;
          float* dst = plane + (int64_t)y * n + x;
          if (vec) {
            *reinterpret_cast<float4*>(dst) = half ? make_float4(acc1[0], acc1[1], acc1[2], acc1[3])
                                                   : make_float4(acc0[0], acc0[1], acc0[2], acc0[3]);
          } else {
#pragma unroll
            for (int k = 0; k < kGroup; ++k)
              if (x + k < n) dst[k] = half ? acc1[k] : acc0[k];
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Levels [B, L, n, n] of the bases [B, n, n] (element strides sb, sy, sx):
// level l is T_l base T_l^T with T_l given by its group tables
// (kernels/blur_levels.py band_tables: group_windows, group_taps over
// `groups` groups a level, the tiles' windows tile_rows / tile_cols, and
// the spans and group window that size shared memory). One block a 32 x 64
// tile of a view.
extern "C" int sfm_blur_levels(const float* base, int64_t sb, int64_t sy, int64_t sx,
                               const int* group_windows, const float* group_taps, const int* tile_rows,
                               const int* tile_cols, float* out, int B, int L, int n, int span_h,
                               int span_w, int group_w, void* stream) {
  const int groups = (n + kTileW - 1) / kTileW * kColGroups;
  if (B < 1 || B > 65535 || L < 1 || n < 1 || span_h < 1 || span_w < 1 || group_w < 1)
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout(span_h, span_w, group_w);
  if (lay.bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(blur_levels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kMaxSmemBytes);
  if (err != 0) return err;
  const Args a{base, sb, sy, sx, group_windows, group_taps, tile_rows, tile_cols, out,
               L, n, groups, span_h, span_w, group_w};
  const dim3 grid((n + kTileW - 1) / kTileW, (n + kTileH - 1) / kTileH, B);
  blur_levels_kernel<<<grid, kThreads, lay.bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
