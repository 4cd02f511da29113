// Reduced-camera-system kernels of the PCG solver: the Schur-Jacobi
// preconditioner blocks, the implicit Schur coupling matvec and the fused
// PCG solve built on it.
//
// whw_cam_reduce replaces sfm_tpu/kernels/schur_spmv.py whw_cam_reduce
// (Pallas: per-observation W Hpp^-1 W^T formed in VMEM, reduced into a
// [36, C] accumulator by a one-hot MXU matmul over the sequential grid).
// Bound on the H100: bytes — ~200 flops per observation against ~80 bytes of
// index, W and Hpp^-1 reads. On the solver's path this kernel takes no
// launch of its own: fused_ne_payloads (K3, ba_kernels.cu) builds the
// blocks with the normal equations of a PCG solve, with the same device
// code (schur_jacobi.cuh, segment_sum.cuh). The standalone entry here is
// that code in two launches: one thread per observation in observation
// order (W read in contiguous rows, Hpp^-1 per point, which neighbouring
// threads share) forms the 21 distinct entries of W_o Hpp^-1 W_o^T and
// stores them at the observation's camera-sorted place of a packed
// [M, 24] scratch; then the packed pass of the sorted-segment reduction
// sums each camera's rows, and the block is mirrored to [C, 36]. Observation
// order, not camera order: gathering W's 18 feature-major rows in camera
// order costs a 32-byte sector per 4-byte value and three dependent gathers
// per observation. No float atomics, and a rerun gives identical bits.
//
// schur_coupling_matvec replaces schur_spmv.py schur_coupling_matvec
// (Pallas: paged VPU gather of v, tile-local same-point pair indicator and
// two-level one-hot MXU camera scatter with bf16 splits — all workarounds
// for the TPU's lack of gathers and scatters). Bound: bytes — W (72 bytes
// per observation) dominates; ~80 flops per observation. One warp per
// point walks the point's contiguous segment (observations are sorted by
// point, so the lanes' loads coalesce) twice: first u_o = W_o^T v[cam_o],
// summed over the segment into g_p by a fixed shuffle tree, and
// h_p = Hpp^-1_p g_p in registers; then y_o = W_o h_p, whose six values go
// straight to the observation's camera-sorted position of a packed [M, 6]
// scratch (24 contiguous bytes), so the packed pass of the deterministic
// sorted-segment reduction (segment_sum.cuh) sums y by camera with
// coalesced loads and no gather. No atomics anywhere: reruns are
// bit-identical.
//
// whw_payloads_big replaces schur_spmv.py whw_payloads_big (Pallas: the
// same W Hpp^-1 W^T tile written out per observation for camera counts whose
// one-hot accumulator does not fit VMEM). Bound: bytes — 76 bytes in
// (W and the point id; Hpp^-1 is read per point and stays in cache, as
// observations are sorted by point) and 144 out per observation against
// ~320 flops. One thread per observation in observation order, so W is read
// in contiguous rows and the [36, O] payload is stored feature-major for
// the sorted-segment reduction.
//
// schur_coupling_payloads_big replaces schur_spmv.py
// schur_coupling_payloads_big (Pallas: v gathered per observation outside
// the kernel, the per-point sum through a tile-local same-point indicator
// matmul that needs every point segment inside one tile). Bound: bytes —
// W 72 bytes per observation, v 24 in, y 24 out. It is K11's point code
// (coupling_point) with v read per observation ([6, O]) and y_o written in
// observation order ([6, O]) for the caller's camera reduction: a group of
// 1-32 lanes per point (32 on the merged model's tracks of 40-150 views).
// The same code is the coupling phase of pcg_solve past 4,096 cameras, so
// this entry's check holds what that solve runs; u and the point sums stay
// in registers. No atomics: reruns are bit-identical.
//
// Camera width: K7, K11 and pcg_solve are templates on the width D of a
// camera block, 6 or 8 (intrinsics refinement: the log focal scale and dk1
// columns; sfm_tpu runs that case as plain XLA), each with a 6-wide C entry
// and an 8-wide `_w8` twin of the same arguments. At D = 8, W is [24, O], a
// standalone K7 row holds 36 entries (144 bytes), v and y rows are 32 bytes
// (two 16-byte accesses), a lane group of 8 owns all eight rows of a camera
// in pcg_solve's camera phases, and a resident slice stages 26 rows (W's 24,
// the camera, the place): 104 bytes per observation. K8 and K10 (the
// large-camera-count route) are templates on D too, with `_w8` entries: at
// D = 8, K8 reads W [24, O] and writes [64, O] (100 bytes in, 256 out per
// observation) and K10 reads v_obs_t and writes y_t [8, O]; pcg_solve past
// 4,096 cameras runs K10's coupling code at either width.
//
// The camera-sharded LM (sfm_tpu/dist/sharded_ba.py) cannot run K11 whole:
// a point's observations span devices, so g_p must be all-reduced before
// h_p = Hpp^-1_p g_p. K11's point half (coupling_gather, writing g [P, 3])
// and camera half (coupling_scatter from a given h [P, 3], then the packed
// camera sums) are K11's own device code, two entries of their own
// (coupling_point_half, coupling_camera_half) at both widths; the sharded
// CG steps run them with an all-reduce after each, at every camera count.

#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include <cstdint>

#include "schur_jacobi.cuh"
#include "segment_sum.cuh"

namespace {

constexpr int kPointThreads = 128;
constexpr int kObsThreads = 128;
// Floats per packed row of the standalone K7: the D (D + 1) / 2 entries in
// 16-byte rows (24 for 21 entries, 36 for 36).
template <int D>
constexpr int kWhwRow = (sfm::kWhwEntries<D> + 3) / 4 * 4;

// K7, first pass: the entries of each weighted observation of [0, N) at
// its camera-sorted place of packed [M, kWhwRow<D>].
template <int D>
__global__ __launch_bounds__(kObsThreads) void whw_rows_kernel(
    const float* __restrict__ w_t, const float* __restrict__ hinv,
    const int* __restrict__ obs_point, const int* __restrict__ cam_inv_perm, int O, int N,
    float* __restrict__ packed) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= N) return;
  const int place = cam_inv_perm[o];
  if (place < 0) return;  // a zero-weight row: of no camera segment
  constexpr int E = sfm::kWhwEntries<D>;
  float e[E];
  sfm::whw_of_observation<D>(w_t, hinv, O, o, obs_point[o], e);
  float* dst = packed + (size_t)kWhwRow<D> * place;
  float4* row = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int k = 0; k < E / 4; ++k) row[k] = make_float4(e[4 * k], e[4 * k + 1], e[4 * k + 2], e[4 * k + 3]);
#pragma unroll
  for (int k = E / 4 * 4; k < E; ++k) dst[k] = e[k];
}

// K7, second pass: camera c's D (D + 1) / 2 sums, mirrored to its [D^2]
// block. blockDim = 32 * warps.
template <int D>
__global__ __launch_bounds__(32 * sfm::kMaxSegmentWarps) void whw_cams_kernel(
    const float* __restrict__ packed, const int* __restrict__ cam_bounds,
    float* __restrict__ out) {
  __shared__ float part[sfm::kMaxSegmentWarps][sfm::kTileRows];
  __shared__ float sums[sfm::kWhwEntries<D>];
  const int c = blockIdx.x;
  sfm::segment_sum_packed_rows(packed, cam_bounds[c], cam_bounds[c + 1], kWhwRow<D>, 0,
                               sfm::kWhwEntries<D>, part, sums);
  __syncthreads();
  for (int k = threadIdx.x; k < D * D; k += blockDim.x)
    out[D * D * (size_t)c + k] = sfm::whw_block_entry<D>(sums, k);
}

// Per-observation rows of the coupling matvec as they lie in device memory:
// W feature-major [3D, O], the camera and the camera-sorted place per
// observation.
struct GlobalObs {
  const float* __restrict__ w_t;
  const int* __restrict__ cam;
  const int* __restrict__ place;
  int O;
  __device__ __forceinline__ float w(int k, int o) const {
    return w_t[(size_t)k * O + o];
  }
  __device__ __forceinline__ int camera(int o) const { return cam[o]; }
  __device__ __forceinline__ int sorted_place(int o) const { return place[o]; }
};

// Where the coupling of K11 and pcg_solve reads v and writes y: v is a
// [C, D] table read through the observation's camera, y_o goes to its
// camera-sorted place of y_packed [M, D] (no row for a zero-weight one).
// Plain loads and stores: the fused PCG solve rewrites v and reads y_packed
// in the same launch.
template <int D>
struct CameraIo {
  const float* v;
  float* y_packed;
  // Rows of 24 bytes (D = 6, 8-byte aligned: three 8-byte accesses) or 32
  // bytes (D = 8, 16-byte aligned: two 16-byte accesses).
  template <class Obs>
  __device__ __forceinline__ void load_v(const Obs& obs, int o, float (&vo)[D]) const {
    const float* vc = v + D * (size_t)obs.camera(o);
    if constexpr (D % 4 == 0) {
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float4 t = reinterpret_cast<const float4*>(vc)[i];
        vo[4 * i] = t.x;
        vo[4 * i + 1] = t.y;
        vo[4 * i + 2] = t.z;
        vo[4 * i + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        const float2 t = reinterpret_cast<const float2*>(vc)[i];
        vo[2 * i] = t.x;
        vo[2 * i + 1] = t.y;
      }
    }
  }
  template <class Obs>
  __device__ __forceinline__ int dest(const Obs& obs, int o) const { return obs.sorted_place(o); }
  __device__ __forceinline__ void store_y(int dst, const float (&y)[D]) const {
    float* row = y_packed + D * (size_t)dst;
    if constexpr (D % 4 == 0) {
#pragma unroll
      for (int i = 0; i < D / 4; ++i)
        reinterpret_cast<float4*>(row)[i] = make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        reinterpret_cast<float2*>(row)[i] = make_float2(y[2 * i], y[2 * i + 1]);
    }
  }
};

// K10's: v gathered per observation (v_obs_t [D, O]), y_o written in
// observation order (y_t [D, O]).
template <int D>
struct ObservationIo {
  const float* __restrict__ v_obs_t;
  float* __restrict__ y_t;
  int O;
  template <class Obs>
  __device__ __forceinline__ void load_v(const Obs&, int o, float (&vo)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) vo[i] = v_obs_t[(size_t)i * O + o];
  }
  template <class Obs>
  __device__ __forceinline__ int dest(const Obs&, int o) const { return o; }
  __device__ __forceinline__ void store_y(int dst, const float (&y)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) y_t[(size_t)i * O + dst] = y[i];
  }
};

// The point half of one point's share of the coupling, by a group of
// `width` lanes (a power of two <= 32; lane is the lane's place in its
// group; all 32 lanes of the warp call it together, each group with its own
// point, so the shuffles see the whole warp; lo = hi for a group without a
// point): g_p = sum of u_o = W_o^T v_o over the point's observations
// [lo, hi), the same bits in every lane of the group. D: the camera width
// (W's 3D rows, v of D values).
template <int D, class Obs, class Io>
__device__ __forceinline__ void coupling_gather(const Obs& obs, const Io& io, int lo, int hi,
                                                int lane, int width, float& g0, float& g1,
                                                float& g2) {
  g0 = 0.0f;
  g1 = 0.0f;
  g2 = 0.0f;
  for (int o = lo + lane; o < hi; o += width) {
    float vo[D];
    io.load_v(obs, o, vo);
    float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      u0 += obs.w(i * 3, o) * vo[i];
      u1 += obs.w(i * 3 + 1, o) * vo[i];
      u2 += obs.w(i * 3 + 2, o) * vo[i];
    }
    g0 += u0;
    g1 += u1;
    g2 += u2;
  }
  // Butterfly sum over the group: every lane ends with the same bits (each
  // level adds the same two partial sums, in either order).
  for (int off = width >> 1; off > 0; off >>= 1) {
    g0 += __shfl_xor_sync(0xffffffffu, g0, off);
    g1 += __shfl_xor_sync(0xffffffffu, g1, off);
    g2 += __shfl_xor_sync(0xffffffffu, g2, off);
  }
}

// The camera half of one point's share: y_o = W_o h_p for the point's
// observations [lo, hi), written where io puts it (the same lane groups as
// coupling_gather).
template <int D, class Obs, class Io>
__device__ __forceinline__ void coupling_scatter(const Obs& obs, const Io& io, float h0, float h1,
                                                 float h2, int lo, int hi, int lane, int width) {
  for (int o = lo + lane; o < hi; o += width) {
    const int dst = io.dest(obs, o);
    if (dst < 0) continue;  // a zero-weight row: of no camera segment
    float y[D];
#pragma unroll
    for (int i = 0; i < D; ++i)
      y[i] = obs.w(i * 3, o) * h0 + obs.w(i * 3 + 1, o) * h1 + obs.w(i * 3 + 2, o) * h2;
    io.store_y(dst, y);
  }
}

// One point's share of (W Hpp^-1 W^T) v (p < 0 with lo = hi for a group
// without a point): g_p by coupling_gather, h_p = Hpp^-1_p g_p, then
// y_o = W_o h_p by coupling_scatter.
template <int D, class Obs, class Io>
__device__ __forceinline__ void coupling_point(
    const Obs& obs, const Io& io, const float* __restrict__ hinv, int p, int lo, int hi,
    int lane, int width) {
  float g0, g1, g2;
  coupling_gather<D>(obs, io, lo, hi, lane, width, g0, g1, g2);
  if (p < 0) return;
  const float* h = hinv + 9 * (size_t)p;
  const float h0 = h[0] * g0 + h[1] * g1 + h[2] * g2;
  const float h1 = h[3] * g0 + h[4] * g1 + h[5] * g2;
  const float h2 = h[6] * g0 + h[7] * g1 + h[8] * g2;
  coupling_scatter<D>(obs, io, h0, h1, h2, lo, hi, lane, width);
}

// K11's point half (the camera-sharded LM): g [P, 3] = sum_{o in p} W_o^T
// v[cam_o] over this device's observations, one warp per point.
template <int D>
__global__ __launch_bounds__(kPointThreads) void coupling_gather_kernel(
    const float* __restrict__ w_t, const int* __restrict__ obs_cam,
    const int* __restrict__ point_bounds, const float* __restrict__ v, int O, int P,
    float* __restrict__ g) {
  const int p = blockIdx.x * (kPointThreads / 32) + (threadIdx.x >> 5);
  if (p >= P) return;
  float g0, g1, g2;
  coupling_gather<D>(GlobalObs{w_t, obs_cam, nullptr, O}, CameraIo<D>{v, nullptr},
                     point_bounds[p], point_bounds[p + 1], threadIdx.x & 31, 32, g0, g1, g2);
  if ((threadIdx.x & 31) == 0) {
    g[3 * (size_t)p] = g0;
    g[3 * (size_t)p + 1] = g1;
    g[3 * (size_t)p + 2] = g2;
  }
}

// K11's camera half: y_o = W_o h[p] at the observation's camera-sorted
// place of y_packed [M, D], one warp per point; the packed pass of the
// sorted-segment reduction then sums y by camera.
template <int D>
__global__ __launch_bounds__(kPointThreads) void coupling_scatter_kernel(
    const float* __restrict__ w_t, const int* __restrict__ cam_inv_perm,
    const int* __restrict__ point_bounds, const float* __restrict__ h, int O, int P,
    float* __restrict__ y_packed) {
  const int p = blockIdx.x * (kPointThreads / 32) + (threadIdx.x >> 5);
  if (p >= P) return;
  const float* hp = h + 3 * (size_t)p;
  coupling_scatter<D>(GlobalObs{w_t, nullptr, cam_inv_perm, O}, CameraIo<D>{nullptr, y_packed},
                      hp[0], hp[1], hp[2], point_bounds[p], point_bounds[p + 1],
                      threadIdx.x & 31, 32);
}

template <int D>
__global__ __launch_bounds__(kPointThreads) void coupling_point_kernel(
    const float* __restrict__ w_t, const float* __restrict__ hinv,
    const int* __restrict__ obs_cam, const int* __restrict__ point_bounds,
    const float* __restrict__ v, const int* __restrict__ cam_inv_perm, int O,
    int P, float* __restrict__ y_packed) {
  // One warp per point: p is uniform across the warp, so a warp leaves
  // together.
  const int p = blockIdx.x * (kPointThreads / 32) + (threadIdx.x >> 5);
  if (p >= P) return;
  coupling_point<D>(GlobalObs{w_t, obs_cam, cam_inv_perm, O}, CameraIo<D>{v, y_packed}, hinv, p,
                 point_bounds[p], point_bounds[p + 1], threadIdx.x & 31, 32);
}

// K10: a group of `lanes` lanes per point, consecutive groups on
// consecutive points; then the unweighted tail [N, O) of y_t, each block its
// share.
template <int D>
__global__ __launch_bounds__(kPointThreads) void coupling_big_kernel(
    const float* __restrict__ w_t, const float* __restrict__ hinv,
    const int* __restrict__ point_bounds, const float* __restrict__ v_obs_t, int O, int P,
    int N, int lanes, float* __restrict__ y_t) {
  const int p = blockIdx.x * (kPointThreads / lanes) + (int)threadIdx.x / lanes;
  const bool has = p < P;
  coupling_point<D>(GlobalObs{w_t, nullptr, nullptr, O}, ObservationIo<D>{v_obs_t, y_t, O}, hinv,
                    has ? p : -1, has ? point_bounds[p] : 0, has ? point_bounds[p + 1] : 0,
                    threadIdx.x & (lanes - 1), lanes);
  for (int o = N + blockIdx.x * kPointThreads + threadIdx.x; o < O;
       o += gridDim.x * kPointThreads) {
#pragma unroll
    for (int i = 0; i < D; ++i) y_t[(size_t)i * O + o] = 0.0f;
  }
}

// K8: vec(W_o Hinv_p W_o^T) [D^2] per observation, feature-major [D^2, O].
template <int D>
__global__ __launch_bounds__(kObsThreads) void whw_payloads_kernel(
    const float* __restrict__ w_t, const float* __restrict__ hinv,
    const int* __restrict__ obs_point, int O, float* __restrict__ out_t) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
  const float* h = hinv + 9 * (size_t)obs_point[o];
  float W[3 * D], H[9], u[3 * D];
#pragma unroll
  for (int k = 0; k < 3 * D; ++k) W[k] = w_t[(size_t)k * O + o];
#pragma unroll
  for (int k = 0; k < 9; ++k) H[k] = h[k];
  // u[i, l] = sum_k W[i, k] Hinv[k, l];  whw[i, j] = sum_l u[i, l] W[j, l].
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int l = 0; l < 3; ++l)
      u[r * 3 + l] = W[r * 3] * H[l] + W[r * 3 + 1] * H[3 + l] +
                     W[r * 3 + 2] * H[6 + l];
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int j = 0; j < D; ++j)
      out_t[(size_t)(r * D + j) * O + o] =
          u[r * 3] * W[j * 3] + u[r * 3 + 1] * W[j * 3 + 1] +
          u[r * 3 + 2] * W[j * 3 + 2];
}

// ---- pcg_solve --------------------------------------------------------------
//
// pcg_solve replaces sfm_tpu/ba/core.py _pcg (a jax.lax.fori_loop of
// cfg.cg_iterations CG steps over schur_spmv.py schur_coupling_matvec, or
// schur_coupling_payloads_big past its two-level kernel's reach, one device
// program): the whole preconditioned CG solve of the reduced camera system
// in one cooperative launch, at every camera count. Bound: bytes — W (72
// bytes per observation) is read every step by the coupling matvec; the
// camera vectors are a few KB at 128 cameras and 240 KB at 10,240. What the
// design does about it: where the largest slice fits the shared-memory
// budget, each block copies its slice of the observations (W's 18 rows, the
// camera and the camera-sorted place, 80 bytes per observation; slices
// balanced by observation count and cut at point boundaries) into shared
// memory once, with 16-byte cp.async chunks, and every step reads W from
// there; only the packed y rows and the camera vectors go through L2. Past
// that (the merged model's 1.5 M observations hold ~110 MB of W, more than
// the 50 MB L2 and the SMs' shared memory together) the same kernel
// (template flag) reads W from device memory every step, the slices still
// cut at point boundaries, so a point's sums stay inside one block. A step
// is four phases between grid barriers: (A) the coupling code of
// K10/K11 (coupling_point) per point of the block's slice, a group of 1-32
// lanes per point (the plan's width for the mean track length: a warp per
// point would leave most lanes idle on tracks of 3-5 views); (B) the packed
// camera sums of segment_sum.cuh for the block's cameras c = b, b + G, ...,
// several cameras at once: a team of 16 / t warps per camera for t cameras a
// pass (t the least power of two that covers the most cameras a block owns,
// up to one warp a camera), each team adding its camera's rows in a fixed
// order, then Ap = (Hcc v - coupling) / d and the block's partials of p.Ap
// and r.r; (C) every block adds all partials in index order (identical bits
// everywhere, so every block takes the same done, dead and alpha), updates x
// and r and forms z = d M^-1 (d r); (D) the same for r.z, then p and
// v = p / d. A lane group of 8 owns a camera's six rows in (C) and (D), so
// x, r, z and p are read and written by one thread only; the
// preconditioner's six-term products are summed in double (the merged
// polish's equilibrated blocks cancel ~4 digits). (B) takes cameras in
// teams because a block owns up to 78 of them at 10,240 cameras, and one
// at a time costs two block barriers each. No float atomics: a rerun gives
// identical bits.

constexpr int kPcgThreads = 512;
constexpr int kPcgWarps = kPcgThreads / 32;
constexpr int kCamsPerPass = kPcgThreads / 8;  // a lane group of 8 per camera
constexpr unsigned kAll = 0xffffffffu;

// (address / 4) mod 4: where a 4-byte word sits inside its 16-byte chunk.
__device__ __forceinline__ int word_shift(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The block's observation slice [lo, lo + n) staged in shared memory: row k
// (W's 3D rows, then the camera, then the camera-sorted place) starts at
// word k * stride + the source's word_shift, so that every 16-byte chunk of
// the source lands 16-byte aligned.
struct SharedObs {
  const float* w_s;
  const int* cam_s;    // already offset by its shift and by -lo
  const int* place_s;  // the same
  int stride, lo, shift0, shift_step;  // W row k's shift: (shift0 + k * shift_step) & 3
  __device__ __forceinline__ float w(int k, int o) const {
    return w_s[k * stride + ((shift0 + k * shift_step) & 3) + o - lo];
  }
  __device__ __forceinline__ int camera(int o) const { return cam_s[o]; }
  __device__ __forceinline__ int sorted_place(int o) const { return place_s[o]; }
};

// Copy n words from src (device memory) to dst_row + word_shift(src)
// (shared, 16-byte aligned), by all threads of the block: 16-byte cp.async
// chunks, single words at the ragged ends. The caller waits and syncs.
__device__ __forceinline__ void stage_row(uint32_t* dst_row, const uint32_t* src, int n) {
  uint32_t* dst = dst_row + word_shift(src);
  const int head = min((4 - word_shift(src)) & 3, n);
  const int chunks = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int i = head + 4 * chunks + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst + head + 4 * c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
                 "l"(src + head + 4 * c)
                 : "memory");
  }
}

struct PcgArgs {
  const float* w_t;           // [3D, O]
  const float* hinv;          // [P, 9]
  const int* obs_cam;         // [O]
  const int* point_bounds;    // [P+1] over [0, N)
  const int* cam_inv_perm;    // [N]
  const int* cam_bounds;      // [C+1] over [0, M)
  const float* hcc;           // [C, D^2]
  const float* minv;          // [C, D^2]
  const float* d;             // [C, D]
  const float* rhs;           // [C, D]
  const int* block_points;    // [G+1]
  int O, C, iterations;
  float tolerance;
  int lanes;                  // lanes per point in (A): a power of two <= 32
  int stride;                 // words per staged row (resident mode)
  float* y_packed;            // [M, D] scratch
  float *v, *p, *x, *r, *z, *ap;  // [C, D] scratch each
  float* part;                // [3, G] scratch: the blocks' partial sums
  float* out;                 // [C, D]
};

// Deterministic block sum of (a, b): butterflies inside the warps, then the
// warps in order. The result is valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b, float (*red)[2]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(kAll, a, off);
    b += __shfl_xor_sync(kAll, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5][0] = a;
    red[threadIdx.x >> 5][1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.0f;
    b = 0.0f;
    for (int w = 0; w < kPcgWarps; ++w) {
      a += red[w][0];
      b += red[w][1];
    }
  }
  __syncthreads();
}

// The sums of the G blocks' partials pa[0, G) and pb[0, G), written before
// the last grid barrier, in an order fixed by G alone: every thread of every
// block gets the same bits.
__device__ __forceinline__ void grid_total2(const float* pa, const float* pb, int G,
                                            float* bcast, float& a, float& b) {
  if (threadIdx.x < 32) {
    float s = 0.0f, t = 0.0f;
    for (int i = threadIdx.x; i < G; i += 32) {
      s += pa[i];
      t += pb[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(kAll, s, off);
      t += __shfl_xor_sync(kAll, t, off);
    }
    if (threadIdx.x == 0) {
      bcast[0] = s;
      bcast[1] = t;
    }
  }
  __syncthreads();
  a = bcast[0];
  b = bcast[1];
  __syncthreads();
}

// Streaming mode keeps two blocks on an SM (at most 64 registers a thread):
// its coupling phase waits on device memory, and 32 warps an SM hide more
// of that wait than 16. D: the camera width (6, or 8 with the intrinsic
// columns: the lane group of 8 then owns all eight rows of a camera).
template <bool kResident, int D>
__global__ __launch_bounds__(kPcgThreads, kResident ? 1 : 2) void pcg_solve_kernel(const PcgArgs a) {
  __shared__ float part_s[kPcgWarps][sfm::kTileRows];
  __shared__ float red[kPcgWarps][2];
  __shared__ float bcast[2];
  extern __shared__ __align__(16) uint32_t slice[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int p_lo = a.block_points[b];
  const int o_lo = a.point_bounds[p_lo], o_hi = a.point_bounds[a.block_points[b + 1]];
  // The block's points end at the first one that starts at o_hi: those
  // after it are empty (the capacity padding's point slots all lie there).
  int p_hi = p_lo;
  for (int q = a.block_points[b + 1]; p_hi < q;) {
    const int mid = (p_hi + q) >> 1;
    if (a.point_bounds[mid] >= o_hi) q = mid; else p_hi = mid + 1;
  }
  const int groups = kPcgThreads / a.lanes;  // point groups of the block
  // The block's cameras c = b, b + G, ...: in (C) and (D) the lane group
  // grp owns one camera per pass and its lane `row` < D one row of it.
  const int ncam = b < a.C ? (a.C - 1 - b) / G + 1 : 0;
  const int grp = threadIdx.x >> 3, row = threadIdx.x & 7, gbase = lane & ~7;
  // (B)'s teams: the least power of two t of cameras a pass that covers the
  // most cameras any block owns (at most one a warp), 16 / t warps a team.
  // It depends on C and G alone, so the order of every sum is fixed.
  const int ncam_max = (a.C + G - 1) / G;
  int teams = 1;
  while (teams < kPcgWarps && teams < ncam_max) teams <<= 1;
  const int team_warps = kPcgWarps / teams;
  const int warp = threadIdx.x >> 5, team = warp / team_warps, twarp = warp % team_warps;

  SharedObs sobs{};
  if constexpr (kResident) {
    const int n = o_hi - o_lo, s = a.stride;
    for (int k = 0; k < 3 * D; ++k)
      stage_row(slice + k * s, reinterpret_cast<const uint32_t*>(a.w_t + (size_t)k * a.O + o_lo), n);
    stage_row(slice + 3 * D * s, reinterpret_cast<const uint32_t*>(a.obs_cam + o_lo), n);
    stage_row(slice + (3 * D + 1) * s, reinterpret_cast<const uint32_t*>(a.cam_inv_perm + o_lo), n);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    sobs = SharedObs{reinterpret_cast<const float*>(slice),
                     reinterpret_cast<const int*>(slice + 3 * D * s) + word_shift(a.obs_cam + o_lo) - o_lo,
                     reinterpret_cast<const int*>(slice + (3 * D + 1) * s) +
                         word_shift(a.cam_inv_perm + o_lo) - o_lo,
                     s, o_lo, word_shift(a.w_t + o_lo), a.O & 3};
  }
  const GlobalObs gobs{a.w_t, a.obs_cam, a.cam_inv_perm, a.O};
  const CameraIo<D> io{a.v, a.y_packed};

  // fn(live, c, e) for every (camera, row) of the block; every thread calls
  // fn the same number of times (a block-uniform count), so fn may shuffle
  // inside its lane group.
  auto each_camera_row = [&](auto&& fn) {
    for (int j0 = 0; j0 < ncam; j0 += kCamsPerPass) {
      const int j = j0 + grp;
      const bool live = j < ncam && row < D;
      const int c = live ? b + j * G : 0;
      fn(live, c, (size_t)c * D + row);
    }
  };
  // d_e (M^-1 (d r))_e for the row of this lane, dr = d r of this lane's
  // row. In double: the equilibrated blocks of M^-1 are ill-conditioned
  // (on the merged polish this six-term product cancels ~4 digits, and in
  // fp32 it sets the solve's error after one step: chip_smoke's
  // pcg_solve_big row logs the plain fp32 version's), and its cost is D^2
  // FMAs a camera.
  auto precond = [&](bool live, int c, float dd, double dr) {
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const double drj = __shfl_sync(kAll, dr, gbase + j);
      if (live) acc += (double)a.minv[(size_t)c * D * D + row * D + j] * drj;
    }
    return (float)((double)dd * acc);
  };

  // b = rhs / d, x = 0, r = b, z = M^-1 r, p = z (d b = rhs exactly);
  // rz = r.z, |b|^2.
  float acc_a = 0.0f, acc_b = 0.0f;
  each_camera_row([&](bool live, int c, size_t e) {
    const float dd = live ? a.d[e] : 1.0f;
    const float dinv = 1.0f / dd;
    const float bv = live ? dinv * a.rhs[e] : 0.0f;
    const float z = precond(live, c, dd, live ? (double)a.rhs[e] : 0.0);
    if (live) {
      a.x[e] = 0.0f;
      a.r[e] = bv;
      a.p[e] = z;
      a.v[e] = dinv * z;
      acc_a += bv * z;
      acc_b += bv * bv;
    }
  });
  block_sum2(acc_a, acc_b, red);
  if (threadIdx.x == 0) {
    a.part[b] = acc_a;
    a.part[G + b] = acc_b;
  }
  grid.sync();
  float rz, bb;
  grid_total2(a.part, a.part + G, G, bcast, rz, bb);
  const float rhs_norm = sqrtf(bb) + 1e-20f;
  bool dead = false;

  for (int it = 0; it < a.iterations; ++it) {
    // (A) y rows of the block's points from v = p / d: a group of a.lanes
    // lanes per point, consecutive groups on consecutive points; a
    // block-uniform number of passes, so whole warps shuffle.
    for (int base = p_lo; base < p_hi; base += groups) {
      const int pt = base + (int)threadIdx.x / a.lanes;
      const bool has = pt < p_hi;
      const int lo = has ? a.point_bounds[pt] : 0, hi = has ? a.point_bounds[pt + 1] : 0;
      const int sub = threadIdx.x & (a.lanes - 1);
      if constexpr (kResident)
        coupling_point<D>(sobs, io, a.hinv, has ? pt : -1, lo, hi, sub, a.lanes);
      else
        coupling_point<D>(gobs, io, a.hinv, has ? pt : -1, lo, hi, sub, a.lanes);
    }
    grid.sync();

    // (B) coupling per camera into ap, `teams` cameras a pass; then
    // Ap = (Hcc v - coupling) / d.
    for (int j0 = 0; j0 < ncam; j0 += teams) {
      const int j = j0 + team;
      const bool live = j < ncam;
      const int c = b + j * G;
      sfm::segment_sum_packed_warp(a.y_packed, live ? a.cam_bounds[c] : 0,
                                   live ? a.cam_bounds[c + 1] : 0, D, 0, D, twarp, team_warps,
                                   part_s[warp]);
      __syncthreads();
      if (twarp == 0 && lane < D && live) {
        float s = 0.0f;
        for (int w = 0; w < team_warps; ++w) s += part_s[team * team_warps + w][lane];
        a.ap[(size_t)c * D + lane] = s;
      }
      __syncthreads();
    }
    acc_a = 0.0f;
    acc_b = 0.0f;
    each_camera_row([&](bool live, int c, size_t e) {
      if (!live) return;
      float hv = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) hv += a.hcc[(size_t)c * D * D + row * D + j] * a.v[(size_t)c * D + j];
      const float ap = (1.0f / a.d[e]) * (hv - a.ap[e]);
      a.ap[e] = ap;
      const float re = a.r[e];
      acc_a += a.p[e] * ap;
      acc_b += re * re;
    });
    block_sum2(acc_a, acc_b, red);
    if (threadIdx.x == 0) {
      a.part[b] = acc_a;
      a.part[G + b] = acc_b;
    }
    grid.sync();

    // (C) done, dead, alpha; x += alpha p, r -= alpha Ap, z = M^-1 r; r.z.
    float pap, rr;
    grid_total2(a.part, a.part + G, G, bcast, pap, rr);
    dead = dead || !isfinite(pap) || pap <= 0.0f;
    const bool done = dead || (sqrtf(rr) / rhs_norm < a.tolerance);
    const float alpha = done ? 0.0f : rz / pap;
    acc_a = 0.0f;
    each_camera_row([&](bool live, int c, size_t e) {
      float dd = 1.0f, re = 0.0f;
      if (live) {
        dd = a.d[e];
        a.x[e] = a.x[e] + alpha * a.p[e];
        re = a.r[e] - alpha * a.ap[e];
        a.r[e] = re;
      }
      const float z = precond(live, c, dd, (double)dd * re);
      if (live) {
        a.z[e] = z;
        acc_a += re * z;
      }
    });
    acc_b = 0.0f;
    block_sum2(acc_a, acc_b, red);
    if (threadIdx.x == 0) a.part[2 * G + b] = acc_a;
    grid.sync();

    // (D) beta; p = z + beta p unless done, v = p / d.
    float rz_sum, unused;
    grid_total2(a.part + 2 * G, a.part + 2 * G, G, bcast, rz_sum, unused);
    const float rz_new = done ? rz : rz_sum;
    const float beta = rz_new / fmaxf(rz, 1e-20f);
    each_camera_row([&](bool live, int c, size_t e) {
      if (!live) return;
      const float pe = done ? a.p[e] : a.z[e] + beta * a.p[e];
      a.p[e] = pe;
      a.v[e] = (1.0f / a.d[e]) * pe;
    });
    rz = rz_new;
    grid.sync();
  }
  each_camera_row([&](bool live, int c, size_t e) {
    if (live) a.out[e] = (1.0f / a.d[e]) * a.x[e];
  });
}

using PcgKernel = void (*)(const PcgArgs);

template <int D>
PcgKernel pcg_kernel(int streaming) {
  return streaming ? pcg_solve_kernel<false, D> : pcg_solve_kernel<true, D>;
}

// Blocks of the solve (streaming or resident) with smem_bytes of dynamic
// shared memory that one SM holds at once, after raising the kernel's
// dynamic shared-memory limit.
template <int D>
int pcg_blocks_per_sm(int streaming, int smem_bytes, int* out) {
  const PcgKernel kernel = pcg_kernel<D>(streaming);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kPcgThreads,
                                                            (size_t)smem_bytes);
}

template <int D>
int whw_cam_reduce(const float* w_t, const float* hinv, const int* obs_point,
                   const int* cam_inv_perm, const int* cam_bounds, int O, int N, int C, int warps,
                   float* packed, float* out, void* stream) {
  if (warps < 1 || warps > sfm::kMaxSegmentWarps) return (int)cudaErrorInvalidValue;
  if (N > 0) {
    whw_rows_kernel<D><<<(N + kObsThreads - 1) / kObsThreads, kObsThreads, 0,
                         (cudaStream_t)stream>>>(w_t, hinv, obs_point, cam_inv_perm, O, N, packed);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  whw_cams_kernel<D><<<C, 32 * warps, 0, (cudaStream_t)stream>>>(packed, cam_bounds, out);
  return (int)cudaGetLastError();
}

template <int D>
int schur_coupling_matvec(const float* w_t, const float* hinv, const int* obs_cam,
                          const int* point_bounds, const float* v, const int* cam_inv_perm,
                          const int* cam_bounds, int O, int P, int C, int seg_warps,
                          float* y_packed, float* out, void* stream) {
  constexpr int kPointsPerBlock = kPointThreads / 32;
  const int blocks = (P + kPointsPerBlock - 1) / kPointsPerBlock;
  coupling_point_kernel<D><<<blocks, kPointThreads, 0, (cudaStream_t)stream>>>(
      w_t, hinv, obs_cam, point_bounds, v, cam_inv_perm, O, P, y_packed);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return sfm::launch_segment_sum_packed(y_packed, cam_bounds, D, C, seg_warps,
                                        out, (cudaStream_t)stream);
}

template <int D>
int coupling_point_half(const float* w_t, const int* obs_cam, const int* point_bounds,
                        const float* v, int O, int P, float* g, void* stream) {
  if (P < 1) return 0;
  constexpr int kPointsPerBlock = kPointThreads / 32;
  coupling_gather_kernel<D><<<(P + kPointsPerBlock - 1) / kPointsPerBlock, kPointThreads, 0,
                              (cudaStream_t)stream>>>(w_t, obs_cam, point_bounds, v, O, P, g);
  return (int)cudaGetLastError();
}

template <int D>
int coupling_camera_half(const float* w_t, const int* point_bounds, const float* h,
                         const int* cam_inv_perm, const int* cam_bounds, int O, int P, int C,
                         int seg_warps, float* y_packed, float* out, void* stream) {
  if (P > 0) {
    constexpr int kPointsPerBlock = kPointThreads / 32;
    coupling_scatter_kernel<D><<<(P + kPointsPerBlock - 1) / kPointsPerBlock, kPointThreads, 0,
                                 (cudaStream_t)stream>>>(w_t, cam_inv_perm, point_bounds, h, O, P,
                                                         y_packed);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return sfm::launch_segment_sum_packed(y_packed, cam_bounds, D, C, seg_warps, out,
                                        (cudaStream_t)stream);
}

template <int D>
int pcg_solve(const float* w_t, const float* hinv, const int* obs_cam, const int* point_bounds,
              const int* cam_inv_perm, const int* cam_bounds, const float* hcc, const float* minv,
              const float* d, const float* rhs, const int* block_points, int O, int C,
              int iterations, float tolerance, int streaming, int grid, int lanes, int stride,
              int smem_bytes, float* y_packed, float* work, float* out, void* stream) {
  if (grid < 1 || C < 1 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const PcgKernel kernel = pcg_kernel<D>(streaming);
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem_bytes);
  if (err != 0) return err;
  const size_t n = D * (size_t)C;
  PcgArgs a{w_t, hinv, obs_cam, point_bounds, cam_inv_perm, cam_bounds, hcc,
            minv, d, rhs, block_points, O, C, iterations, tolerance, lanes, stride,
            y_packed, work, work + n, work + 2 * n, work + 3 * n, work + 4 * n,
            work + 5 * n, work + 6 * n, out};
  void* args[] = {&a};
  err = (int)cudaLaunchCooperativeKernel((const void*)kernel, grid, kPcgThreads,
                                         args, (size_t)smem_bytes,
                                         (cudaStream_t)stream);
  if (err != 0) {
    cudaGetLastError();  // clear it: the wrapper raises
    return err;
  }
  return (int)cudaGetLastError();
}

template <int D>
int whw_payloads_big(const float* w_t, const float* hinv, const int* obs_point, int O,
                     float* out_t, void* stream) {
  if (O < 1) return 0;
  const int blocks = (O + kObsThreads - 1) / kObsThreads;
  whw_payloads_kernel<D><<<blocks, kObsThreads, 0, (cudaStream_t)stream>>>(w_t, hinv, obs_point, O,
                                                                         out_t);
  return (int)cudaGetLastError();
}

template <int D>
int schur_coupling_payloads_big(const float* w_t, const float* hinv, const int* point_bounds,
                                const float* v_obs_t, int O, int P, int N, int lanes, float* y_t,
                                void* stream) {
  if (P < 1 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int per_block = kPointThreads / lanes;
  const int blocks = (P + per_block - 1) / per_block;
  coupling_big_kernel<D><<<blocks, kPointThreads, 0, (cudaStream_t)stream>>>(
      w_t, hinv, point_bounds, v_obs_t, O, P, N, lanes, y_t);
  return (int)cudaGetLastError();
}

}  // namespace

// K8. W [18, O], hinv [P, 9], obs_point [O] -> out_t [36, O]. One launch.
// The _w8 entry: W [24, O] -> out_t [64, O].
SFM_ENTRY_BOTH_WIDTHS(
    sfm_whw_payloads_big, whw_payloads_big,
    (const float* w_t, const float* hinv, const int* obs_point, int O, float* out_t, void* stream),
    (w_t, hinv, obs_point, O, out_t, stream))

// K10. point_bounds [P+1] covers the observations [0, N) (sorted by point);
// `lanes` (a power of two <= 32) lanes walk one point; v_obs_t and y_t are
// [6, O]. One launch; rows [N, O) of y_t are zero. The _w8 entry: W
// [24, O], v_obs_t and y_t [8, O].
SFM_ENTRY_BOTH_WIDTHS(
    sfm_schur_coupling_payloads_big, schur_coupling_payloads_big,
    (const float* w_t, const float* hinv, const int* point_bounds, const float* v_obs_t, int O,
     int P, int N, int lanes, float* y_t, void* stream),
    (w_t, hinv, point_bounds, v_obs_t, O, P, N, lanes, y_t, stream))

// The weighted observations of [0, N): cam_inv_perm [N] gives each one's
// place among the M of them in their stable camera sort (-1: a zero-weight
// row), which cam_bounds [C+1] cuts into segments; packed [M, 24] is
// caller-allocated scratch and warps (1..32) the warps per camera of the
// camera pass. Two launches. The _w8 entry: W [24, O], packed [M, 36],
// out [C, 64].
SFM_ENTRY_BOTH_WIDTHS(
    sfm_whw_cam_reduce, whw_cam_reduce,
    (const float* w_t, const float* hinv, const int* obs_point, const int* cam_inv_perm,
     const int* cam_bounds, int O, int N, int C, int warps, float* packed, float* out,
     void* stream),
    (w_t, hinv, obs_point, cam_inv_perm, cam_bounds, O, N, C, warps, packed, out, stream))

// The point segments must cover exactly the observations [0, N)
// (point_bounds[0] = 0, point_bounds[P] = N); cam_inv_perm [N] is each one's
// place among the M weighted observations in their stable camera sort, which
// cam_bounds [C+1] cuts into segments, or -1 for a zero-weight row;
// y_packed [M, 6] is caller-allocated scratch and seg_warps the warps per
// camera of the packed reduction. The _w8 entry: W [24, O], v, out [C, 8]
// (v 16-byte aligned), y_packed [M, 8].
SFM_ENTRY_BOTH_WIDTHS(
    sfm_schur_coupling_matvec, schur_coupling_matvec,
    (const float* w_t, const float* hinv, const int* obs_cam, const int* point_bounds,
     const float* v, const int* cam_inv_perm, const int* cam_bounds, int O, int P, int C,
     int seg_warps, float* y_packed, float* out, void* stream),
    (w_t, hinv, obs_cam, point_bounds, v, cam_inv_perm, cam_bounds, O, P, C, seg_warps,
     y_packed, out, stream))

// K11 cut at h, for the camera-sharded LM, whose point sums need an
// all-reduce between the halves. The point half: g [P, 3] = sum over the
// observations [point_bounds[p], point_bounds[p+1]) of W_o^T v[obs_cam[o]]
// (v [C, D], 8-byte aligned rows at D = 6, 16-byte at D = 8), one launch.
// The camera half: out [C, D] = sum over camera c's weighted observations
// of W_o h[p(o)] for h [P, 3], in the packed order of the sorted-segment
// reduction (cam_inv_perm [N], cam_bounds [C+1] as for
// sfm_schur_coupling_matvec; y_packed [M, D] scratch), two launches.
// Deterministic. The _w8 entries: W [24, O], v and out [C, 8].
SFM_ENTRY_BOTH_WIDTHS(
    sfm_coupling_point_half, coupling_point_half,
    (const float* w_t, const int* obs_cam, const int* point_bounds, const float* v, int O, int P,
     float* g, void* stream),
    (w_t, obs_cam, point_bounds, v, O, P, g, stream))

SFM_ENTRY_BOTH_WIDTHS(
    sfm_coupling_camera_half, coupling_camera_half,
    (const float* w_t, const int* point_bounds, const float* h, const int* cam_inv_perm,
     const int* cam_bounds, int O, int P, int C, int seg_warps, float* y_packed, float* out,
     void* stream),
    (w_t, point_bounds, h, cam_inv_perm, cam_bounds, O, P, C, seg_warps, y_packed, out, stream))

// Blocks of pcg_solve (streaming mode or resident mode with smem_bytes of
// staged slice) that one SM holds at once: the plan's grid is this times the
// SM count.
SFM_ENTRY_BOTH_WIDTHS(sfm_pcg_blocks_per_sm, pcg_blocks_per_sm,
                      (int streaming, int smem_bytes, int* out), (streaming, smem_bytes, out))

// The whole PCG solve of (Hcc - W Hpp^-1 W^T) x = rhs in the
// Jacobi-equilibrated space (d = sqrt|diag M|, M_inv the Schur-Jacobi
// preconditioner), `iterations` steps, one cooperative launch of `grid`
// blocks. block_points [grid+1] cuts the points into the blocks' slices,
// `lanes` lanes walk one point's observations;
// resident mode stages each slice in `smem_bytes` of shared memory
// (3D + 2 rows of `stride` words), streaming mode reads W from device
// memory. y_packed [M, D] and work [6 * D * C + 3 * grid] are
// caller-allocated scratch. A grid that cannot be co-resident (the
// cooperative launch's cudaErrorCooperativeLaunchTooLarge), or any other
// refused launch, returns the CUDA error. D = 6; the _w8 entry D = 8.
SFM_ENTRY_BOTH_WIDTHS(
    sfm_pcg_solve, pcg_solve,
    (const float* w_t, const float* hinv, const int* obs_cam, const int* point_bounds,
     const int* cam_inv_perm, const int* cam_bounds, const float* hcc, const float* minv,
     const float* d, const float* rhs, const int* block_points, int O, int C, int iterations,
     float tolerance, int streaming, int grid, int lanes, int stride, int smem_bytes,
     float* y_packed, float* work, float* out, void* stream),
    (w_t, hinv, obs_cam, point_bounds, cam_inv_perm, cam_bounds, hcc, minv, d, rhs,
     block_points, O, C, iterations, tolerance, streaming, grid, lanes, stride, smem_bytes,
     y_packed, work, out, stream))
