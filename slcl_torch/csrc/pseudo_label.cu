// Cosine pseudo-labels with the top1-top2 gap mask, for Hopper (sm_90a).
//
// Replaces slcl_tpu/ops/pallas/pseudo_label_kernel.py::pseudo_label_fused
// (_kernel).
//
// Per row m of feats (M, F): L2-normalise (rsqrt(sum x^2 + 1e-24)); cosine
// against the (C, F) prototypes, which the caller has normalised; label =
// first-occurrence argmax; mask = 1 where top1 - top2 > th (a tie gives a
// gap of 0). No gradient: the inputs are detached.
//
// Bound on this card: bytes. At the slice's shapes (M = 802,816, F = 32,
// C = 4, bf16 feats) it reads 51.4 MB of features and writes 3.2 MB of
// labels and 3.2 MB of mask (~58 MB, ~17 us at 3.35 TB/s).
//
// Design: one thread per row, C = slcl::kC fixed at compile time, the row
// read as 16-byte vectors, prototypes
// in shared memory (broadcast reads), f32 math in registers. No reduction
// across rows, so the result does not depend on the launch shape.
#include "common.cuh"

namespace {

using slcl::kC;
using slcl::kThreads;

template <typename T, int F, int C>
__global__ void __launch_bounds__(kThreads)
pseudo_label_kernel(const T* __restrict__ feats, const float* __restrict__ centers,
                    int M, float th, int* __restrict__ labels,
                    float* __restrict__ mask) {
  __shared__ float s_cent[C * F];
  for (int i = threadIdx.x; i < C * F; i += blockDim.x) s_cent[i] = centers[i];
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < M; row += stride) {
    float x[F];
#pragma unroll
    for (int k = 0; k < F; k += 8) slcl::load8(feats + (size_t)row * F + k, x + k);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < F; ++k) ss = fmaf(x[k], x[k], ss);
    const float inv = rsqrtf(ss + 1e-24f);
    float best = -INFINITY, second = -INFINITY;
    int arg = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float d = 0.f;
#pragma unroll
      for (int k = 0; k < F; ++k) d = fmaf(x[k], s_cent[c * F + k], d);
      const float cs = d * inv;
      if (cs > best) {
        second = best;
        best = cs;
        arg = c;
      } else if (cs > second) {
        second = cs;
      }
    }
    labels[row] = arg;
    mask[row] = (best - second > th) ? 1.f : 0.f;
  }
}

template <typename T>
int launch(const void* feats, const float* centers, int M, int F, float th,
           int* labels, float* mask, cudaStream_t st) {
  const int grid = slcl::grid_for(M, kThreads);
  SLCL_DISPATCH_F(F, pseudo_label_kernel<T, kF, kC><<<grid, kThreads, 0, st>>>(
                         static_cast<const T*>(feats), centers, M, th, labels, mask));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy_of(int F, int* blocks_per_sm, int* smem_bytes) {
  SLCL_DISPATCH_F(F, return slcl::occupancy(pseudo_label_kernel<T, kF, kC>, 0, blocks_per_sm,
                                            smem_bytes));
  return -1;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch; -1 for an unsupported F or a
// C other than slcl::kC.
int pseudo_label(const void* feats, int feats_bf16, const void* centers, int M,
                 int F, int C, float th, void* labels, void* mask, void* stream) {
  if (C != kC) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto cen = static_cast<const float*>(centers);
  auto lab = static_cast<int*>(labels);
  auto msk = static_cast<float*>(mask);
  return feats_bf16 ? launch<__nv_bfloat16>(feats, cen, M, F, th, lab, msk, st)
                    : launch<float>(feats, cen, M, F, th, lab, msk, st);
}

// Blocks per SM and shared memory per block of the kernel, from the CUDA
// runtime. Returns a cudaError_t; -1 for an unsupported F.
int pseudo_label_occupancy(int feats_bf16, int F, int* blocks_per_sm, int* smem_bytes) {
  return feats_bf16 ? occupancy_of<__nv_bfloat16>(F, blocks_per_sm, smem_bytes)
                    : occupancy_of<float>(F, blocks_per_sm, smem_bytes);
}

}  // extern "C"
