// Shared helpers for the port's CUDA kernels (plain C interface, loaded
// with ctypes; see slcl_torch/ops/cuda/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slcl {

constexpr int kThreads = 256;    // threads per block, every kernel here
constexpr int kC = 4;            // classes: every kernel is built for C = 4
                                 // only, and its entry point rejects others
constexpr int kMaxBlocks = 1024; // cap of a forward's persistent grid: its
                                 // final pass adds at most this many partials

// 8 consecutive values -> f32 registers. p must be 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Blocks per SM and shared memory per block (static + dyn_smem bytes) of a
// kernel launched with kThreads threads, from the CUDA runtime. Returns a
// cudaError_t.
template <typename Kern>
int occupancy(Kern kern, int dyn_smem, int* blocks_per_sm, int* smem_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  // above 48 KB in all, shared memory must be asked for
  if (e == cudaSuccess && static_cast<int>(a.sharedSizeBytes) + dyn_smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, kThreads, dyn_smem);
  if (e == cudaSuccess) *smem_bytes = static_cast<int>(a.sharedSizeBytes) + dyn_smem;
  return static_cast<int>(e);
}

// Sum of v over the block in a fixed tree order (deterministic).
// s must hold kThreads floats; every thread of the block must call it.
__device__ __forceinline__ float block_sum(float v, float* s) {
  s[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  const float r = s[0];
  __syncthreads();
  return r;
}

}  // namespace slcl

// Dispatch a template on the feature width F (a multiple of 8).
#define SLCL_DISPATCH_F(F, ...)                      \
  switch (F) {                                       \
    case 8: { constexpr int kF = 8; __VA_ARGS__; } break;   \
    case 16: { constexpr int kF = 16; __VA_ARGS__; } break; \
    case 32: { constexpr int kF = 32; __VA_ARGS__; } break; \
    case 64: { constexpr int kF = 64; __VA_ARGS__; } break; \
    default: return -1;                              \
  }
