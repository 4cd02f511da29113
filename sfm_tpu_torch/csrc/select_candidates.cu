// Exact top-k candidate selection over a batch of score maps, K15: each
// map's k entries of largest (score, lower flat index), found by a radix
// select whose memory follows k, not the pixels (ops/detect.py
// select_candidates).
//
// Replaces no TPU kernel: sfm_tpu/ops/detect.py select_candidates is
// jax.lax.top_k over each whole map. The port's version sorted each whole
// map (a stable torch.sort of [B, (L - 1) H W] with int64 indices), whose
// memory follows the pixels: at COLMAP's default settings (a 6400^2 first
// octave, chunks of 8) its buffers set the stage's peak, 57 GB of an H100's
// 80.
//
// Each entry i of a map has the key
//   key = (bits(score) << 31) | (2^31 - 1 - i)      (bits = 0 for a score <= 0)
// which orders as top_k_stable does: by score, then by the lower index
// (a positive float's bits order as the float does), and is unique within
// a map (n < 2^31). The k largest keys are the selection. A 0 entry past
// the first k never is (k entries of a lower index beat it), and the 0
// entries of the first k all come after every positive one; so a map's
// selection is its k largest positive keys (all of them where it has no
// more than k) followed by the 0 entries of its first k in index order. A
// map's row of the output holds 3k slots: up to 2k positive keys that
// include its k largest, the 0 entries of its first k, and INT64_MAX in the
// rest; an ascending sort of the row (the caller's) puts the selection
// first, whatever else the row holds and whatever order the atomics took.
//
// One C entry, nine launches, no host sync:
// - four passes of (histogram, find) over the positive keys' 62 bits, 16 +
//   16 + 16 + 14, most significant first: select_histogram counts the
//   positive entries whose key has the prefix found so far, by the next
//   digit (global atomics, one bin array a pass and map); select_find (a
//   block a map) sums the bins in 256 groups, then its last thread walks
//   the groups and the bins of one group from the top to the bin holding
//   the k-th key, reading 16 at a time. Where taking that whole bin takes
//   no more than 2k keys in all (or the map has no more than k positive
//   entries), every key from the bin's least on is taken and the map is
//   done: its later passes return at once. Else the digit joins the
//   prefix. A bin of the first pass spans 1/128 of a binary order of
//   magnitude of score, so most maps are done after it; a map whose k-th
//   score is shared by more than k entries reaches the index bits;
// - select_write: each positive entry whose key is at least the map's
//   least taken key, and each 0 entry of the first k, takes the next of
//   the map's 3k slots (a 64-bit atomic cursor) and writes 2^62 - 1 - key
//   there.
// A block of the histogram and write launches reads a run of 256 float4 (or,
// where a map is not 16-byte aligned, floats) a step, coalesced, over a
// grid-stride loop within its map (gridDim.y = the maps). The find's
// threads share no memory but device memory, and only
// its last thread reads what the others wrote, so that the tests can run
// the source thread by thread on the host.
//
// Bound on the H100: device-memory bytes. The least is each map read once
// and its k keys written once; the kernel reads a map twice (the first
// pass, the write) where the first pass settles it, once more for each
// further pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPasses = 4;
constexpr int kBins = 1 << 16;       // bins a pass and map (the widest digit)
constexpr int kGroups = 256;         // select_find's threads, a group of bins each
constexpr long long kIndexMask = 0x7FFFFFFFLL;
constexpr long long kKeyMax = (1LL << 62) - 1;
// Words of a map's state (int64): the key prefix found so far, the keys
// still wanted within it, the least key taken, done, the write cursor.
enum { kPrefix, kWanted, kLeast, kDone, kCursor, kStateWords = 8 };

__device__ __forceinline__ long long select_key(float v, long long i) {
  const long long bits = v > 0.0f ? (long long)__float_as_uint(v) : 0LL;
  return (bits << 31) | (kIndexMask - i);
}

// visit(score, flat index) for this thread's entries of a map.
template <class Visit>
__device__ __forceinline__ void for_each_entry(const float* __restrict__ map, int64_t n, Visit visit) {
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x, stride = (int64_t)gridDim.x * kThreads;
  if ((n & 3) == 0 && ((uintptr_t)map & 15) == 0) {
    const float4* quads = reinterpret_cast<const float4*>(map);
    for (int64_t q = first; q < n / 4; q += stride) {
      const float4 v = quads[q];
      visit(v.x, 4 * q);
      visit(v.y, 4 * q + 1);
      visit(v.z, 4 * q + 2);
      visit(v.w, 4 * q + 3);
    }
  } else {
    for (int64_t i = first; i < n; i += stride) visit(map[i], i);
  }
}

// From a[top] down, the first index where the running count reaches
// `wanted`, which leaves the count still wanted there; -1 where a[0..top]
// hold fewer. Reads 16 entries at a time (top + 1 a multiple of 16).
__device__ int walk_down(const unsigned* a, int top, long long& wanted) {
  for (int base = top; base >= 0; base -= 16) {
    unsigned v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = a[base - j];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if ((long long)v[j] >= wanted) return base - j;
      wanted -= v[j];
    }
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads)
select_histogram_kernel(const float* __restrict__ score, int64_t n, int shift, int width,
                        const int64_t* __restrict__ state, unsigned* __restrict__ hist) {
  const int b = blockIdx.y;
  const int64_t* st = state + (int64_t)b * kStateWords;
  if (st[kDone]) return;
  const long long prefix = st[kPrefix];
  const unsigned mask = (1u << width) - 1;
  unsigned* h = hist + (int64_t)b * kBins;
  for_each_entry(score + (int64_t)b * n, n, [&](float v, int64_t i) {
    if (v > 0.0f) {
      const long long key = select_key(v, i);
      if ((key >> (shift + width)) == prefix) atomicAdd(h + ((key >> shift) & mask), 1u);
    }
  });
}

__global__ void __launch_bounds__(kGroups)
select_find_kernel(int64_t k, int first, int shift, int width, int64_t* __restrict__ state,
                   const unsigned* __restrict__ hist, unsigned* __restrict__ group_sums) {
  const int b = blockIdx.x;
  int64_t* st = state + (int64_t)b * kStateWords;
  if (st[kDone]) return;
  const unsigned* h = hist + (int64_t)b * kBins;
  unsigned* g = group_sums + (int64_t)b * kGroups;
  const int per = (1 << width) / kGroups;
  const uint4* mine = reinterpret_cast<const uint4*>(h + threadIdx.x * per);
  unsigned sum = 0;
  for (int j0 = 0; j0 < per / 4; j0 += 4) {
    uint4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = mine[j0 + j];
#pragma unroll
    for (int j = 0; j < 4; ++j) sum += v[j].x + v[j].y + v[j].z + v[j].w;
  }
  g[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x != kGroups - 1) return;
  long long wanted = first ? k : st[kWanted];
  const int group = walk_down(g, kGroups - 1, wanted);
  if (group < 0) {   // no more than k positive entries (the first pass): take them all
    st[kLeast] = 0;
    st[kDone] = 1;
    return;
  }
  const int d = walk_down(h + group * per, per - 1, wanted) + group * per;
  const long long prefix = ((first ? 0LL : st[kPrefix]) << width) | d;
  if ((long long)h[d] - wanted <= k) {   // (k - wanted) + h[d] keys taken: at most 2k
    st[kLeast] = prefix << shift;
    st[kDone] = 1;
  } else {
    st[kPrefix] = prefix;
    st[kWanted] = wanted;
  }
}

__global__ void __launch_bounds__(kThreads)
select_write_kernel(const float* __restrict__ score, int64_t n, int64_t k, int64_t* __restrict__ state,
                    int64_t* __restrict__ keys) {
  const int b = blockIdx.y;
  int64_t* st = state + (int64_t)b * kStateWords;
  const long long least = st[kLeast];
  int64_t* out = keys + (int64_t)b * 3 * k;
  for_each_entry(score + (int64_t)b * n, n, [&](float v, int64_t i) {
    const long long key = select_key(v, i);
    if (v > 0.0f ? key >= least : i < k) {
      const unsigned long long slot = atomicAdd((unsigned long long*)(st + kCursor), 1ULL);
      if (slot < 3ULL * (unsigned long long)k) out[slot] = kKeyMax - key;
    }
  });
}

}  // namespace

// The selected keys of each of `maps` score maps of n fp32 entries (>= 0;
// contiguous, one after another; k <= n < 2^31) into keys [maps, 3k] int64
// (filled with INT64_MAX by the caller), each 2^62 - 1 - key, in no
// particular order within its row: up to 2k positive keys, the k largest
// among them, and the 0 entries of the first k. work: zeroed int64 scratch of
// kernels/select_candidates.py work_words(maps). grid_x blocks a map
// (select_launch_plan).
extern "C" int sfm_select_keys(const float* score, int maps, int64_t n, int64_t k, int grid_x, int64_t* work,
                               int64_t* keys, void* stream) {
  if (maps < 1 || n < 1 || n > kIndexMask || k < 1 || k > n || grid_x < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int64_t* state = work;
  unsigned* hist = (unsigned*)(work + (int64_t)maps * kStateWords);
  unsigned* group_sums = hist + (int64_t)kPasses * maps * kBins;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int width = pass < kPasses - 1 ? 16 : 14;
    const int shift = 46 - 16 * pass > 0 ? 46 - 16 * pass : 0;
    unsigned* h = hist + (int64_t)pass * maps * kBins;
    select_histogram_kernel<<<dim3(grid_x, maps), kThreads, 0, s>>>(score, n, shift, width, state, h);
    select_find_kernel<<<maps, kGroups, 0, s>>>(k, pass == 0, shift, width, state, h, group_sums);
  }
  select_write_kernel<<<dim3(grid_x, maps), kThreads, 0, s>>>(score, n, k, state, keys);
  return (int)cudaGetLastError();
}
