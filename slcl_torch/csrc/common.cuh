// Shared helpers for the port's CUDA kernels (plain C interface, loaded
// with ctypes; see slcl_torch/ops/cuda/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slcl {

constexpr int kThreads = 256;    // threads per block, every kernel here
constexpr int kC = 4;            // classes of the templated kernels, which
                                 // reject others; the general kernels
                                 // (general.cuh, centroids_gen.cuh) take any
constexpr int kMaxBlocks = 1024; // cap of a forward's persistent grid: its
                                 // final pass adds at most this many partials

// One value <-> f32 (bf16 rounds to nearest even on the way out).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16_rn(v);
  else return v;
}

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

// Blocks of a general kernel's grid (general.cuh, centroids_gen.cuh) over M
// rows taken `per` a block-step: fixed whatever the device, so that the
// order of the forwards' sums is too.
inline int gen_grid(long long M, int per) {
  const long long t = (M + per - 1) / per;
  return t < 1 ? 1 : (t < kMaxBlocks ? static_cast<int>(t) : kMaxBlocks);
}

// Lets kKern take up to the device's opt-in shared memory a block (once per
// kernel and device); returns 0 if smem dynamic bytes fit, -1 if not, or a
// cudaError_t. Static, so that every library keeps its own flags.
template <auto kKern>
static int gen_prepare(int smem) {
  constexpr int kMaxDevices = 64;
  static int max_dyn[kMaxDevices];
  int dev = 0;
  int e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (max_dyn[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes a;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kKern);
    const int dyn = optin - static_cast<int>(a.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kKern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return e;
    max_dyn[dev] = dyn;
  }
  return smem <= max_dyn[dev] ? 0 : -1;
}

// Blocks per SM and shared memory per block of a general kernel at smem
// dynamic bytes, as occupancy() gives them for the templated ones.
template <auto kKern>
static int gen_occupancy(int smem, int* blocks_per_sm, int* smem_bytes) {
  const int rc = gen_prepare<kKern>(smem);
  if (rc != 0) return rc;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kKern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kKern, kThreads, smem);
  if (e == cudaSuccess) *smem_bytes = static_cast<int>(a.sharedSizeBytes) + smem;
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
