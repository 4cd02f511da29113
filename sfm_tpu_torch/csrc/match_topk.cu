// Fused descriptor distance + top-2 nearest neighbours (Lowe ratio test).
//
// Replaces: sfm_tpu/kernels/match_topk.py match_topk2 (Pallas: bf16 Gram
// tile on the MXU against the whole resident db, min/argmin/second-min
// reduced in VMEM).
//
// Bound on the H100: operations, on the bf16 tensor cores. One pair of 4096
// keypoints is 4.3 GFLOP of 128-deep dot products against 2 x 1 MB of bf16
// descriptors, so the operands live in L2 and shared memory, only three
// numbers per row go back to device memory, and the [N1, N2] distance
// matrix of the plain path is never written.
//
// Design:
// - Tensor cores through wgmma (m64n128k16, bf16 x bf16 -> fp32). A block of
//   two warpgroups owns kBM = 128 rows of da, resident in shared memory for
//   the whole walk over db; each warpgroup multiplies its 64 rows by a tile
//   of kBN = 128 rows of db (eight k16 steps over the 128-deep descriptor).
//   Both operands are K-major exactly as they lie in memory ([N, 128]
//   row-major), so nothing is transposed.
// - Loads overlap the math: db tiles go through a ring of kStages
//   shared-memory stages filled by cp.async in 16-byte chunks, written at
//   128-byte-swizzled addresses (chunk ^ (row & 7) inside each 128-byte row
//   of a [rows, 64] half tile) that the wgmma descriptors name as such, and
//   retired by cp.async.wait_group: tile t + 3 is being copied while tile
//   t + 1 is multiplied and tile t is reduced.
// - The products overlap the reduction: a warpgroup keeps two accumulator
//   fragments and starts the asynchronous products of tile t + 1 into one
//   before it reduces tile t out of the other (wgmma.wait_group 1), so the
//   tensor cores work on one tile while the CUDA cores reduce the other. One
//   block of 256 threads per SM (the two fragments take 128 registers a
//   thread). The loop body holds no branch around a product, or the
//   assembler serializes the wgmma pipeline.
// - The reduction runs on the accumulator fragment, never through memory: a
//   thread holds two rows x two columns of every 8-column group and keeps a
//   running (e1, argmin, e2) of e = |b|^2 - 2 a.b per row over its columns in
//   ascending order (seven instructions per element); |a|^2 is constant along
//   a row, so it is added, and the distance clamped at 0, once at the end:
//   d = max(|a|^2 + e, 0). The four lanes that share a row merge by shuffles,
//   ties going to the lower column like argmin.
// - Norms once: a pre-pass writes |a|^2 per row and |b|^2 per column from
//   the bf16-rounded values; it writes 1e9 in place of |b|^2 for an invalid
//   column and +inf past N2, and such a value replaces e through a select,
//   never an add, so NaN padding cannot leak into the minima, an invalid
//   column reads as exactly 1e9 and a ragged one never wins. Rows past N1
//   and past N2 are zero-filled by the copies.
// A batch of pairs is the grid's y dimension.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;             // descriptor width (bf16 values)
constexpr int kBM = 128;            // rows of da per block (64 per warpgroup)
constexpr int kBN = 128;            // rows of db per tile
constexpr int kStages = 4;          // db tiles in the shared-memory ring
constexpr int kThreads = 256;       // two warpgroups
constexpr float kBig = 1e9f;
constexpr int kHalfBytesA = kBM * 128;        // one [kBM, 64] bf16 half tile
constexpr int kHalfBytesB = kBN * 128;
constexpr int kTileBytesA = 2 * kHalfBytesA;  // 32 KB
constexpr int kTileBytesB = 2 * kHalfBytesB;  // 32 KB
constexpr int kInfoBytes = 1024;              // |b|^2 per column (512 bytes used)
constexpr int kStageBytes = kTileBytesB + kInfoBytes;  // a multiple of 1024
constexpr int kSmemBytes = kTileBytesA + kStages * kStageBytes + 1024;

// Merge another candidate triple into (b1, i1, b2); the lower index wins a tie.
__device__ __forceinline__ void merge_top2(float& b1, int& i1, float& b2,
                                           float o1, int oi, float o2) {
  if (o1 < b1 || (o1 == b1 && oi < i1)) {
    b2 = fminf(b1, o2);
    b1 = o1;
    i1 = oi;
  } else {
    b2 = fminf(b2, o1);
  }
}

// ---- pre-pass: squared norms of the bf16-rounded rows ----------------------

// One warp per row. Rows [0, P*N1) are da's and write na; the rest are the
// P * N2pad padded columns of db and write nb: |b|^2, 1e9 for an invalid
// column, +inf past N2.
__global__ __launch_bounds__(256) void match_norms_kernel(
    const uint16_t* __restrict__ da, const uint16_t* __restrict__ db,
    const uint8_t* __restrict__ vb, int P, int N1, int N2, int N2pad,
    float* __restrict__ na, float* __restrict__ nb) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long rows_a = (long long)P * N1;
  const long long rows_b = (long long)P * N2pad;
  if (row >= rows_a + rows_b) return;  // whole warps leave together
  const uint16_t* src = nullptr;
  long long p = 0;
  int c = 0;
  if (row < rows_a) {
    src = da + row * kD;
  } else {
    const long long rb = row - rows_a;
    p = rb / N2pad;
    c = (int)(rb - p * N2pad);
    if (c < N2) src = db + (p * N2 + c) * kD;
  }
  float s = 0.0f;
  if (src != nullptr) {
    const uint2 q = *reinterpret_cast<const uint2*>(src + lane * 4);
    const float x0 = __uint_as_float(q.x << 16);
    const float x1 = __uint_as_float(q.x & 0xffff0000u);
    const float x2 = __uint_as_float(q.y << 16);
    const float x3 = __uint_as_float(q.y & 0xffff0000u);
    s = fmaf(x0, x0, fmaf(x1, x1, fmaf(x2, x2, x3 * x3)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  if (row < rows_a) {
    na[row] = s;
  } else {
    float v = INFINITY;  // past N2: never a candidate
    if (c < N2) v = vb[p * N2 + c] ? s : kBig;
    nb[p * N2pad + c] = v;
  }
}

// ---- main kernel -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; `bytes` (0 or 16) of it come from src, the rest
// of the chunk is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies rows [row0, row0 + 128) of a row-major [n_rows, 128] bf16 matrix
// into two 128-byte-swizzled [128, 64] half tiles at `dst` (1024-aligned).
// Rows at or past n_rows are zero-filled.
__device__ __forceinline__ void load_tile(uint32_t dst, const uint16_t* src,
                                          int row0, int n_rows, int tid) {
#pragma unroll
  for (int i = 0; i < (128 * 16) / kThreads; ++i) {
    const int q = tid + i * kThreads;
    const int r = q >> 4, cc = q & 15;        // row, 16-byte chunk of the row
    const int half = cc >> 3, c = cc & 7;
    const bool in = row0 + r < n_rows;
    const uint16_t* g = src + ((size_t)(in ? row0 + r : 0) * kD + cc * 8);
    cp_async16(dst + half * (128 * 128) + r * 128 + ((c ^ (r & 7)) << 4), g,
               in ? 16 : 0);
  }
}

// Shared-memory matrix descriptor of a K-major operand in 128-byte-swizzled
// rows: start address, leading offset 1 (unused for swizzled K-major),
// stride 1024 bytes between 8-row groups, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// acc (+)= A[64, 16] * B[128, 16]^T; scale_d == 0 overwrites acc.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The eight k16 products of one [64, 128] x [128, 128]^T tile into acc,
// as one committed group.
__device__ __forceinline__ void start_tile(float (&acc)[64], uint32_t a_base,
                                           uint32_t b_base) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off_a = (kk >> 2) * kHalfBytesA + (kk & 3) * 32;
    const uint32_t off_b = (kk >> 2) * kHalfBytesB + (kk & 3) * 32;
    wgmma_m64n128k16(acc, wgmma_desc(a_base + off_a), wgmma_desc(b_base + off_b),
                     kk > 0);
  }
  wgmma_commit();
}

// Folds one tile's accumulators into the running top-2 of the thread's two
// rows. acc[j * 4 + h * 2 + e] is row h, column col0 + j * 8 + e; nb2[j * 4]
// holds |b|^2 of that column pair.
__device__ __forceinline__ void reduce_tile(float (&acc)[64], const float2* nb2,
                                            int col0, float (&b1)[2],
                                            float (&b2)[2], int (&i1)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const float2 q = nb2[j * 4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float nb = e ? q.y : q.x;
      const bool valid = nb < kBig;  // else 1e9 (invalid) or +inf (past N2)
      const int c = col0 + j * 8 + e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = valid ? fmaf(-2.0f, acc[j * 4 + h * 2 + e], nb) : nb;
        // Ascending columns and a strict <: the lower column keeps a tie.
        b2[h] = fminf(b2[h], fmaxf(v, b1[h]));
        i1[h] = v < b1[h] ? c : i1[h];
        b1[h] = fminf(b1[h], v);
      }
    }
  }
}

__global__ __launch_bounds__(kThreads, 1) void match_topk2_kernel(
    const uint16_t* __restrict__ da, const uint16_t* __restrict__ db,
    const float* __restrict__ na, const float* __restrict__ nb, int N1, int N2,
    int N2pad,
    float* __restrict__ d1, float* __restrict__ d2, int* __restrict__ idx) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: align the tiles to that.
  const uint32_t smem0 = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (smem0 - smem_addr(smem_raw));
  const uint32_t a_tile = smem0;
  const uint32_t ring = smem0 + kTileBytesA;

  const int p = blockIdx.y;
  da += (size_t)p * N1 * kD;
  db += (size_t)p * N2 * kD;
  na += (size_t)p * N1;
  nb += (size_t)p * N2pad;
  d1 += (size_t)p * N1;
  d2 += (size_t)p * N1;
  idx += (size_t)p * N1;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;                 // warpgroup: rows wg * 64 ..
  const int warp_in_wg = (tid >> 5) & 3;
  const int row0 = blockIdx.x * kBM;
  const int tiles = N2pad / kBN;

  auto stage_of = [&](int t) { return ring + (t % kStages) * kStageBytes; };
  auto load_stage = [&](int t) {
    const uint32_t stage = stage_of(t);
    load_tile(stage, db, t * kBN, N2, tid);
    if (tid < kBN * 4 / 16)
      cp_async16(stage + kTileBytesB + tid * 16,
                 reinterpret_cast<const uint8_t*>(nb + (size_t)t * kBN) + tid * 16, 16);
  };
  // |b|^2 of the thread's first column pair of tile t (generic address).
  auto nb_of = [&](int t) {
    return reinterpret_cast<const float2*>(smem + (stage_of(t) - smem0) + kTileBytesB) +
           (lane & 3);
  };

  // Prologue: the resident A block with tile 0, then tiles 1 .. kStages - 2;
  // one commit group per tile, empty past the last tile.
  load_tile(a_tile, da, row0, N1, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_stage(s);
    cp_async_commit();
  }

  float b1[2] = {INFINITY, INFINITY};
  float b2[2] = {INFINITY, INFINITY};
  int i1[2] = {0, 0};
  float acc0[64], acc1[64];
  const uint32_t a_base = a_tile + wg * (64 * 128);
  const int col0 = 2 * (lane & 3);

  // Tile t's copies are group t: with kStages - 1 groups committed ahead,
  // at most kStages - 2 may still be in flight when tile t is needed.
  cp_async_wait<kStages - 2>();
  // cp.async wrote through the generic proxy; wgmma reads through the async
  // proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  start_tile(acc0, a_base, stage_of(0));

  // Step t: tile t's products are in flight into `cur`. Start tile t + 1's
  // into `nxt`, then reduce tile t while they run. The loop body is straight
  // line (no branch around a product), so that the assembler can follow
  // which fragment is in flight; the last one or two tiles are peeled.
  auto step = [&](float (&cur)[64], float (&nxt)[64], int t) {
    cp_async_wait<kStages - 3>();  // this thread's chunks of tile t + 1 landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // Everyone's chunks of tile t + 1 landed, and every warp is past the
    // products and the reduction of tile t - 1: its stage may be refilled.
    __syncthreads();
    if (t + kStages - 1 < tiles) load_stage(t + kStages - 1);
    cp_async_commit();
    start_tile(nxt, a_base, stage_of(t + 1));
    wgmma_wait<1>();                 // tile t's products are complete
    reduce_tile(cur, nb_of(t), t * kBN + col0, b1, b2, i1);
  };
  auto last_step = [&](float (&cur)[64], int t) {
    wgmma_wait<0>();
    reduce_tile(cur, nb_of(t), t * kBN + col0, b1, b2, i1);
  };
  int t = 0;
  for (; t + 2 < tiles; t += 2) {
    step(acc0, acc1, t);
    step(acc1, acc0, t + 1);
  }
  if (t + 1 < tiles) {
    step(acc0, acc1, t);
    last_step(acc1, t + 1);
  } else {
    last_step(acc0, t);
  }

  // The four lanes of a quad hold the same two rows: merge them, then add
  // the row's own |a|^2 and clamp. e >= 1e9 marks an invalid column and is
  // the distance as it stands.
  const int r_lo = row0 + wg * 64 + warp_in_wg * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, b1[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, i1[h], off);
      const float o2 = __shfl_xor_sync(0xffffffffu, b2[h], off);
      merge_top2(b1[h], i1[h], b2[h], o1, oi, o2);
    }
    const int r = r_lo + 8 * h;
    if ((lane & 3) == 0 && r < N1) {
      const float na_r = na[r];
      d1[r] = b1[h] < kBig ? fmaxf(na_r + b1[h], 0.0f) : fminf(b1[h], kBig);
      d2[r] = b2[h] < kBig ? fmaxf(na_r + b2[h], 0.0f) : fminf(b2[h], kBig);
      idx[r] = i1[h];
    }
  }
}

}  // namespace

// na [P, N1] and nb [P, N2pad] (N2pad = N2 rounded up to a multiple of 128)
// are caller-allocated scratch.
extern "C" int sfm_match_topk2(const uint16_t* da, const uint16_t* db,
                               const uint8_t* vb, int P, int N1, int N2,
                               int N2pad, float* na, float* nb, float* d1,
                               float* d2, int* idx, void* stream) {
  if (P <= 0 || N1 <= 0) return 0;
  if (N2pad % kBN != 0 || N2pad < N2 || N2pad <= 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)P * N1 + (long long)P * N2pad;
  match_norms_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, (cudaStream_t)stream>>>(
      da, db, vb, P, N1, N2, N2pad, na, nb);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(match_topk2_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemBytes);
  if (err != 0) return err;
  dim3 grid((N1 + kBM - 1) / kBM, P);
  match_topk2_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      da, db, na, nb, N1, N2, N2pad, d1, d2, idx);
  return (int)cudaGetLastError();
}
