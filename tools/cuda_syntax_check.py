#!/usr/bin/env python3
"""Syntax check of the port's CUDA sources with the host C++ compiler, for
machines without nvcc.

    python3 tools/cuda_syntax_check.py [SOURCE.cu ...]

Each source under sfm_tpu_torch/csrc/ (by default the bundle-adjustment
ones, ba_kernels.cu and schur_kernels.cu; sift_descriptors.cu, blur_levels.cu,
subpixel_refine.cu and select_candidates.cu parse too) is copied to a
temporary directory with its kernel launches (`<<<...>>>`) and inline PTX
(`asm volatile`) stripped, then parsed by `g++ -std=c++17 -fsyntax-only` against
a shim header that declares the CUDA keywords, vector types, intrinsics and
runtime calls the sources use. The C entry points instantiate every
template the library builds (both camera widths of K3-K8, K10, K11 and
pcg_solve), so template errors show up here. It proves nothing about code
generation, registers or results: that takes nvcc and the card
(chip_smoke.py, tools/torch_perf.py ptxas).
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "sfm_tpu_torch" / "csrc"
DEFAULT = ("ba_kernels.cu", "schur_kernels.cu")

CUDA_RUNTIME_SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
extern uint3 threadIdx, blockIdx;
extern dim3 blockDim, gridDim;
inline void __syncthreads() {}
inline void __threadfence() {}
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
template <class T> T __shfl_sync(unsigned, T v, int) { return v; }
inline unsigned atomicAdd(unsigned* p, unsigned v) { unsigned o = *p; *p += v; return o; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  unsigned long long o = *p; *p += v; return o;
}
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, sizeof u); return u; }
template <class T> T __ldcg(const T* p) { return *p; }
template <class T> T __ldg(const T* p) { return *p; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
using std::isfinite; using std::max; using std::min;
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int, size_t) {
  return cudaSuccess;
}
inline cudaError_t cudaLaunchCooperativeKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t) {
  return cudaSuccess;
}
#define SHIM_ASM(...) ((void)0)
"""

COOPERATIVE_GROUPS_SHIM = r"""
#pragma once
namespace cooperative_groups {
struct grid_group { void sync() {} };
inline grid_group this_grid() { return {}; }
}
"""


def check(sources) -> int:
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "include").mkdir()
        (tmp / "include" / "cuda_runtime.h").write_text(CUDA_RUNTIME_SHIM)
        (tmp / "include" / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS_SHIM)
        for f in CSRC.iterdir():
            if f.suffix in (".cu", ".cuh"):
                text = re.sub(r"<<<.*?>>>", "", f.read_text(), flags=re.S)
                (tmp / f.name).write_text(text.replace("asm volatile", "SHIM_ASM"))
        for name in sources:
            proc = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", "-Wall", "-Wno-unknown-pragmas",
                                   "-Wno-unused-function", "-Wno-unused-variable", "-Wno-sign-compare",
                                   "-I", str(tmp / "include"), "-x", "c++", str(tmp / name)],
                                  capture_output=True, text=True)
            print(f"{name}: {'ok' if proc.returncode == 0 else 'FAILED'}")
            if proc.stderr:
                print(proc.stderr, end="")
            failed += proc.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(check(sys.argv[1:] or DEFAULT))
