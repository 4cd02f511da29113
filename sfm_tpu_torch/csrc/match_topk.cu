// Fused descriptor distance + top-2 nearest neighbours (Lowe ratio test).
//
// Replaces: sfm_tpu/kernels/match_topk.py match_topk2 (Pallas: bf16 Gram
// tile on the MXU against the whole resident db, min/argmin/second-min
// reduced in VMEM).
//
// Bound on the H100: arithmetic. One pair of 4096 keypoints is 4.3 GFLOP of
// 128-deep dot products against 2 x 1 MB of bf16 descriptors, so the
// operands stay in L2 and shared memory and only three numbers per row go
// back to device memory; the [N1, N2] distance matrix of the plain path is
// never written.
//
// Design (correct and simple first; no tensor cores yet): a block owns 32
// rows of da and walks db in 64-column tiles staged in shared memory as
// bf16. Each of the 128 threads keeps a 4x4 register tile of fp32 dot
// products (bf16 x bf16 products are exact in fp32, summed in fp32) and a
// running (d1, argmin, d2) for its 4 rows over the columns it visits in
// ascending order; the 16 threads that share a row then merge their
// candidates with warp shuffles, ties going to the lower column index like
// argmin. Invalid columns read as 1e9 through a select, never an add, so
// NaN padding cannot leak into the minima; ragged columns past N2 are
// skipped. Squared norms come from the bf16-rounded values, as in the TPU
// kernel. A batch of pairs is the grid's y dimension.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTM = 32;    // rows of da per block
constexpr int kTN = 64;    // columns of db per shared-memory tile
constexpr int kD = 128;    // descriptor width
constexpr int kThreads = 128;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float bf16_to_float(uint16_t h) {
  return __uint_as_float(((uint32_t)h) << 16);
}

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

__global__ __launch_bounds__(kThreads) void match_topk2_kernel(
    const uint16_t* __restrict__ da, const uint16_t* __restrict__ db,
    const uint8_t* __restrict__ vb, int N1, int N2, float* __restrict__ d1,
    float* __restrict__ d2, int* __restrict__ idx) {
  __shared__ uint16_t As[kD][kTM];
  __shared__ uint16_t Bs[kD][kTN];
  __shared__ float na[kTM];
  __shared__ float nb[kTN];
  __shared__ uint8_t vbs[kTN];

  const int p = blockIdx.y;
  da += (size_t)p * N1 * kD;
  db += (size_t)p * N2 * kD;
  vb += (size_t)p * N2;
  d1 += (size_t)p * N1;
  d2 += (size_t)p * N1;
  idx += (size_t)p * N1;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group: columns tx + 16 * j
  const int ty = tid >> 4;   // row group: rows ty + 8 * i
  const int row0 = blockIdx.x * kTM;

  for (int e = tid; e < kTM * kD; e += kThreads) {
    const int r = e / kD, k = e % kD;
    As[k][r] = (row0 + r < N1) ? da[(size_t)(row0 + r) * kD + k] : (uint16_t)0;
  }
  __syncthreads();
  if (tid < kTM) {
    float s = 0.0f;
    for (int k = 0; k < kD; ++k) {
      const float a = bf16_to_float(As[k][tid]);
      s = fmaf(a, a, s);
    }
    na[tid] = s;
  }

  float b1[4], b2[4];
  int i1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b1[i] = INFINITY;
    b2[i] = INFINITY;
    i1[i] = 0;
  }

  for (int col0 = 0; col0 < N2; col0 += kTN) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kTN * kD; e += kThreads) {
      const int c = e / kD, k = e % kD;
      Bs[k][c] = (col0 + c < N2) ? db[(size_t)(col0 + c) * kD + k] : (uint16_t)0;
    }
    if (tid < kTN) vbs[tid] = (col0 + tid < N2) ? vb[col0 + tid] : (uint8_t)0;
    __syncthreads();
    if (tid < kTN) {
      float s = 0.0f;
      for (int k = 0; k < kD; ++k) {
        const float b = bf16_to_float(Bs[k][tid]);
        s = fmaf(b, b, s);
      }
      nb[tid] = s;
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < kD; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = bf16_to_float(As[k][ty + 8 * i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bf16_to_float(Bs[k][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = tx + 16 * j;
      const int c = col0 + cl;
      if (c >= N2) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float d = (na[ty + 8 * i] + nb[cl]) - 2.0f * acc[i][j];
        d = vbs[cl] ? fmaxf(d, 0.0f) : kBig;
        if (d < b1[i]) {
          b2[i] = b1[i];
          b1[i] = d;
          i1[i] = c;
        } else if (d < b2[i]) {
          b2[i] = d;
        }
      }
    }
  }

  // Merge the 16 column groups of each row (lanes ty*16 .. ty*16+15 of a warp).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, b1[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, i1[i], off);
      const float o2 = __shfl_xor_sync(0xffffffffu, b2[i], off);
      merge_top2(b1[i], i1[i], b2[i], o1, oi, o2);
    }
    const int r = row0 + ty + 8 * i;
    if (tx == 0 && r < N1) {
      d1[r] = b1[i];
      d2[r] = b2[i];
      idx[r] = i1[i];
    }
  }
}

}  // namespace

extern "C" int sfm_match_topk2(const uint16_t* da, const uint16_t* db,
                               const uint8_t* vb, int P, int N1, int N2,
                               float* d1, float* d2, int* idx, void* stream) {
  dim3 grid((N1 + kTM - 1) / kTM, P);
  match_topk2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      da, db, vb, N1, N2, d1, d2, idx);
  return (int)cudaGetLastError();
}
