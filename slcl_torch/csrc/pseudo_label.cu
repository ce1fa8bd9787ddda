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
// Design (mpcl_fwd_tile.cuh, shared with the MPCL forwards). The thread-per-
// row kernel that held its whole row as floats ran at 43% of its bound
// (0.040 ms with its wrapper's normalisation of the prototypes, on an
// NVIDIA H100 80GB HBM3 at 700.00 W; 159 registers, one block of 8 warps
// per SM, loads started only at the top of a row, a grid tail). Now a
// persistent grid walks tiles of 256 rows, a thread a row: it holds the
// row's raw bytes in 16 registers, loaded with direct 16-byte loads, starts
// its next row's loads before it computes, and stores label and mask
// straight to memory, 128 contiguous bytes a warp. The cosines and the rule
// are the fused target kernels' own (stream_cosines, row_pseudo_label in
// mpcl_row.cuh), so both routes give every row the same label and mask.
// C = slcl::kC is fixed at compile time. No reduction across rows, so the
// result does not depend on the launch shape.
//
// General family (general.cuh): pseudo_label_gen takes any C and F at run
// time, a thread a row, with the same cosines and rule, for the shapes the
// templated kernel does not take.
#include "general.cuh"
#include "mpcl_fwd_tile.cuh"

namespace {

using slcl::kC;
using slcl::kThreads;

template <typename T, int F, int C>
__global__ void __launch_bounds__(kThreads, slcl::FwdTile<T, F>::kBlocksPerSM)
pseudo_label_kernel(const T* __restrict__ feats, const float* __restrict__ centers,
                    int M, float th, int* __restrict__ labels,
                    float* __restrict__ mask) {
  static_assert(C == kC, "the tile loop is built for kC classes");
  slcl::pseudo_label_tiles<T, F>(feats, centers, M, th, labels, mask);
}

template <typename T>
int launch(const void* feats, const float* centers, int M, int F, float th,
           int* labels, float* mask, cudaStream_t st) {
  SLCL_DISPATCH_F(F, {
    using G = slcl::FwdTile<T, kF>;
    int grid = 0;
    const int rc = slcl::ring_grid<G, pseudo_label_kernel<T, kF, kC>>(M, &grid);
    if (rc != 0) return rc;
    pseudo_label_kernel<T, kF, kC><<<grid, kThreads, G::kSmemBytes, st>>>(
        static_cast<const T*>(feats), centers, M, th, labels, mask);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy_of(int F, int* blocks_per_sm, int* smem_bytes) {
  SLCL_DISPATCH_F(F, return slcl::occupancy(pseudo_label_kernel<T, kF, kC>,
                                            slcl::FwdTile<T, kF>::kSmemBytes, blocks_per_sm,
                                            smem_bytes));
  return -1;
}

// ---- the general family: any C and F, at run time ----

template <typename T>
__global__ void __launch_bounds__(kThreads)
pseudo_label_gen(const T* __restrict__ feats, const float* __restrict__ centers, int M, int F,
                 int C, float th, int* __restrict__ labels, float* __restrict__ mask) {
  slcl::gen_pseudo_label_rows<T>(feats, centers, M, F, C, th, labels, mask);
}

template <typename T>
int gen_launch(const void* feats, const float* centers, int M, int F, int C, float th,
               int* labels, float* mask, cudaStream_t st) {
  const int smem = slcl::gen_rows_smem(C, F);
  const int rc = slcl::gen_prepare<pseudo_label_gen<T>>(smem);
  if (rc != 0) return rc;
  pseudo_label_gen<T><<<slcl::gen_grid(M, kThreads), kThreads, smem, st>>>(
      static_cast<const T*>(feats), centers, M, F, C, th, labels, mask);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gen_occupancy_of(int F, int C, int* blocks_per_sm, int* smem_bytes) {
  return slcl::gen_occupancy<pseudo_label_gen<T>>(slcl::gen_rows_smem(C, F), blocks_per_sm,
                                                  smem_bytes);
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

// The general kernel: the same call at any C >= 1 and F >= 1; -1 where
// the shape's shared memory (general.cuh::gen_rows_smem) does not fit a
// block of this device.
int pseudo_label_gen(const void* feats, int feats_bf16, const void* centers, int M, int F,
                     int C, float th, void* labels, void* mask, void* stream) {
  if (C < 1 || F < 1) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto cen = static_cast<const float*>(centers);
  auto lab = static_cast<int*>(labels);
  auto msk = static_cast<float*>(mask);
  return feats_bf16 ? gen_launch<__nv_bfloat16>(feats, cen, M, F, C, th, lab, msk, st)
                    : gen_launch<float>(feats, cen, M, F, C, th, lab, msk, st);
}

int pseudo_label_gen_occupancy(int feats_bf16, int F, int C, int* blocks_per_sm,
                               int* smem_bytes) {
  return feats_bf16 ? gen_occupancy_of<__nv_bfloat16>(F, C, blocks_per_sm, smem_bytes)
                    : gen_occupancy_of<float>(F, C, blocks_per_sm, smem_bytes);
}

}  // extern "C"
