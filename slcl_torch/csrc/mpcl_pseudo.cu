// Fused target branch of the SLCL step: cosine pseudo-labels, the top1-top2
// gap mask and the margin-preserving contrastive loss (MPCL) in one pass,
// forward and backward, for Hopper (sm_90a).
//
// Replaces slcl_tpu/ops/pallas/mpcl_pseudo_kernel.py::mpcl_pseudo_fused
// (_tile_terms, _fwd_kernel, _bwd_kernel and the custom VJP _f_fwd/_f_bwd).
//
// Per row m of feats (M, F): L2-normalise (rsqrt(sum x^2 + 1e-24)); cosine
// against the (C, F) normalised prototypes; label = first-occurrence argmax;
// sel = 1 where top1 - second > pixel_sel_th, second being the largest
// cosine among the other columns (a tie gives a gap of 0, as lax.top_k);
// then the MPCL margin softmax of mpcl.cu on that label. Loss =
// -(T/T_base) * sum(sel*mlpp) / (sum(sel) + 1e-4). Only the two sums leave
// the forward; labels and sel never reach memory. The backward recomputes
// each row, treats label and sel as constants (they are selections) and
// returns dfeats through the normalisation Jacobian; dcenters = 0.
//
// Bound on this card: bytes. At the slice's shapes (M = 16*224*224 =
// 802,816, F = 32, C = 4, bf16 feats) the forward reads 51.4 MB of
// features (~15 us at 3.35 TB/s); the backward reads them again and writes
// 51.4 MB of dfeats (~31 us). The two-op route it replaces (pseudo_label.cu
// then mpcl.cu) also writes and reads labels and mask (4 x 3.2 MB). The
// arithmetic is ~150 FMAs per 64 bytes, far under the card's ratio.
//
// Forward design (mpcl_fwd_tile.cuh, shared with mpcl.cu's forward and
// pseudo_label.cu). The thread-per-row forward that held its whole row as
// floats ran at 29% of its bound (0.052 ms on an NVIDIA H100 80GB HBM3 at
// 700.00 W): 163 registers let one block of 8 warps run per SM; loads were
// started only at the top of a row (at most 16 KB in flight per SM, and
// nothing during the math); a 1024-block grid left a tail of 7.76 waves;
// and a second launch added the 1024 block partials. A read-only bulk-copy
// ring with the backward's shape took it to 53% (0.029 ms). Now a
// persistent grid walks tiles of 256 rows, a thread a row: it holds the
// row's raw bytes in 16 registers, loaded with direct 16-byte loads, and
// starts its next row's loads before it takes the current row's cosines
// (stream_cosines, the backward's sums term by term) and softmax, within 80
// registers and 3 blocks per SM. C = slcl::kC is fixed at compile time;
// rows that fail the gap test skip the softmax. Sums go per thread, then
// per block in a fixed tree, one pair a block (at most 132 x blocks per SM
// of them), which mpcl_fwd_final adds in a second launch. No float atomics:
// two runs give bit-identical results.
//
// Backward design: mpcl.cu's backward, from mpcl_bwd_tile.cuh, with label
// and sel recomputed from the staged row's cosines. The thread-per-row
// backward that loaded its rows itself ran at 38% of its bound (236
// registers, one block of 8 warps per SM, at most 16 KB of loads in flight
// per SM and only between math phases, a grid tail, strided loads). Now a
// persistent grid streams tiles of 256 rows through a 2-stage shared-memory
// ring filled by 1D bulk copies; a thread streams its row from shared
// memory in chunks within 80 registers (3 blocks, 24 warps per SM), rows
// that fail the gap test write zeros, and each warp stores 512 contiguous
// bytes an instruction. The cosines come from the forward's stream_cosines,
// so every row gets the forward's label and sel.
//
// General family (general.cuh): mpcl_pseudo_gen_fwd_partial and
// mpcl_pseudo_gen_bwd take any C and F at run time, a thread a row, with
// the templated kernels' cosines and rule, for the shapes those do not
// take; the forward ends in the same mpcl_fwd_final.
#include "general.cuh"
#include "mpcl_bwd_tile.cuh"
#include "mpcl_fwd_tile.cuh"

namespace {

using slcl::kC;
using slcl::kThreads;
using slcl::Margin;

// The forward's streaming pass: each block's (num, den) pair into part.
template <typename T, int F, int C>
__global__ void __launch_bounds__(kThreads, slcl::FwdTile<T, F>::kBlocksPerSM)
mpcl_pseudo_fwd_partial(const T* __restrict__ feats, const float* __restrict__ centers,
                        int M, Margin mg, float sel_th, float* __restrict__ part) {
  static_assert(C == kC, "the tile loop is built for kC classes");
  __shared__ float s_red[kThreads];
  float num, den;
  slcl::mpcl_fwd_tiles<T, F, true>(feats, nullptr, nullptr, centers, M, mg, sel_th, num,
                                   den);
  num = slcl::block_sum(num, s_red);
  den = slcl::block_sum(den, s_red);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = num;
    part[2 * blockIdx.x + 1] = den;
  }
}

template <typename T, int F, int C>
__global__ void __launch_bounds__(kThreads, slcl::kRingBlocksPerSM)
mpcl_pseudo_bwd(const T* __restrict__ feats, const float* __restrict__ centers, int M,
                Margin mg, float sel_th, float scale, const float* __restrict__ grad_out,
                const float* __restrict__ stats, T* __restrict__ dfeats) {
  static_assert(C == kC, "the ring is built for kC classes");
  // dL/dmlpp_m = coef * sel_m
  const float coef = -scale * grad_out[0] / stats[2];
  slcl::mpcl_bwd_tiles<T, F, true>(feats, nullptr, nullptr, centers, M, mg, sel_th, coef,
                                   dfeats);
}

// Blocks of the forward's persistent launch: the pairs part must hold.
template <typename T>
int fwd_grid(int M, int F, int* grid) {
  SLCL_DISPATCH_F(F, return (slcl::ring_grid<slcl::FwdTile<T, kF>,
                                             mpcl_pseudo_fwd_partial<T, kF, kC>>(M, grid)));
  return -1;
}

// The streaming pass alone; *grid = its blocks (the pairs it wrote).
template <typename T>
int launch_partial(const void* feats, const float* centers, int M, int F, Margin mg,
                   float sel_th, float* part, int* grid, cudaStream_t st) {
  const int rc = fwd_grid<T>(M, F, grid);
  if (rc != 0) return rc;
  SLCL_DISPATCH_F(F, mpcl_pseudo_fwd_partial<T, kF, kC>
                     <<<*grid, kThreads, slcl::FwdTile<T, kF>::kSmemBytes, st>>>(
                         static_cast<const T*>(feats), centers, M, mg, sel_th, part));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* feats, const float* centers, int M, int F, Margin mg,
               float sel_th, float scale, float* part, float* out, cudaStream_t st) {
  int grid = 0;
  const int rc = launch_partial<T>(feats, centers, M, F, mg, sel_th, part, &grid, st);
  if (rc != 0) return rc;
  slcl::mpcl_fwd_final<<<1, kThreads, 0, st>>>(part, grid, M, 1, scale, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* feats, const float* centers, int M, int F, Margin mg,
               float sel_th, float scale, const float* grad_out, const float* stats,
               void* dfeats, cudaStream_t st) {
  SLCL_DISPATCH_F(F, {
    using G = slcl::BwdRing<T, kF, true>;
    int grid = 0;
    const int rc = slcl::ring_grid<G, mpcl_pseudo_bwd<T, kF, kC>>(M, &grid);
    if (rc != 0) return rc;
    mpcl_pseudo_bwd<T, kF, kC><<<grid, kThreads, G::kSmemBytes, st>>>(
        static_cast<const T*>(feats), centers, M, mg, sel_th, scale, grad_out, stats,
        static_cast<T*>(dfeats));
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy_of(int bwd, int F, int* blocks_per_sm, int* smem_bytes) {
  SLCL_DISPATCH_F(F, {
    return bwd ? slcl::occupancy(mpcl_pseudo_bwd<T, kF, kC>,
                                 slcl::BwdRing<T, kF, true>::kSmemBytes, blocks_per_sm,
                                 smem_bytes)
               : slcl::occupancy(mpcl_pseudo_fwd_partial<T, kF, kC>,
                                 slcl::FwdTile<T, kF>::kSmemBytes, blocks_per_sm,
                                 smem_bytes);
  });
  return -1;
}

// ---- the general family: any C and F, at run time ----

template <typename T>
__global__ void __launch_bounds__(kThreads)
mpcl_pseudo_gen_fwd_partial(const T* __restrict__ feats, const float* __restrict__ centers,
                            int M, int F, int C, Margin mg, float sel_th,
                            float* __restrict__ part) {
  __shared__ float s_red[kThreads];
  float num, den;
  slcl::gen_mpcl_fwd_sums<T, true>(feats, nullptr, nullptr, centers, M, F, C, mg, sel_th, num,
                                   den);
  num = slcl::block_sum(num, s_red);
  den = slcl::block_sum(den, s_red);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = num;
    part[2 * blockIdx.x + 1] = den;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mpcl_pseudo_gen_bwd(const T* __restrict__ feats, const float* __restrict__ centers, int M,
                    int F, int C, Margin mg, float sel_th, float scale,
                    const float* __restrict__ grad_out, const float* __restrict__ stats,
                    T* __restrict__ dfeats) {
  const float coef = -scale * grad_out[0] / stats[2];
  slcl::gen_mpcl_bwd_dfeats<T, true>(feats, nullptr, nullptr, centers, M, F, C, mg, sel_th, coef,
                                   dfeats);
}

template <typename T>
int gen_launch_partial(const void* feats, const float* centers, int M, int F, int C,
                       Margin mg, float sel_th, float* part, int* grid, cudaStream_t st) {
  const int smem = slcl::gen_rows_smem(C, F);
  const int rc = slcl::gen_prepare<mpcl_pseudo_gen_fwd_partial<T>>(smem);
  if (rc != 0) return rc;
  *grid = slcl::gen_grid(M, kThreads);
  mpcl_pseudo_gen_fwd_partial<T><<<*grid, kThreads, smem, st>>>(
      static_cast<const T*>(feats), centers, M, F, C, mg, sel_th, part);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gen_launch_bwd(const void* feats, const float* centers, int M, int F, int C, Margin mg,
                   float sel_th, float scale, const float* grad_out, const float* stats,
                   void* dfeats, cudaStream_t st) {
  const int smem = slcl::gen_rows_smem(C, F);
  const int rc = slcl::gen_prepare<mpcl_pseudo_gen_bwd<T>>(smem);
  if (rc != 0) return rc;
  mpcl_pseudo_gen_bwd<T><<<slcl::gen_grid(M, kThreads), kThreads, smem, st>>>(
      static_cast<const T*>(feats), centers, M, F, C, mg, sel_th, scale, grad_out, stats,
      static_cast<T*>(dfeats));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gen_occupancy_of(int bwd, int F, int C, int* blocks_per_sm, int* smem_bytes) {
  const int smem = slcl::gen_rows_smem(C, F);
  return bwd ? slcl::gen_occupancy<mpcl_pseudo_gen_bwd<T>>(smem, blocks_per_sm, smem_bytes)
             : slcl::gen_occupancy<mpcl_pseudo_gen_fwd_partial<T>>(smem, blocks_per_sm,
                                                                  smem_bytes);
}

}  // namespace

extern "C" {

// *n = the float pairs the forward's partial buffer must hold: the blocks
// of its persistent grid on the current device. Returns a cudaError_t; -1
// for an unsupported F.
int mpcl_pseudo_num_partials(int feats_bf16, int M, int F, int* n) {
  return feats_bf16 ? fwd_grid<__nv_bfloat16>(M, F, n) : fwd_grid<float>(M, F, n);
}

// out = [loss, sum(sel*mlpp), sum(sel) + 1e-4]. Returns cudaGetLastError()
// after the launches; -1 for an unsupported F or a C other than slcl::kC.
int mpcl_pseudo_fwd(const void* feats, int feats_bf16, const void* centers, int M,
                    int F, int C, float T, float cos_m, float sin_m, float th,
                    float mm, int easy, float scale, float sel_th, void* partials,
                    void* out, void* stream) {
  if (C != kC) return -1;
  const Margin mg{T, cos_m, sin_m, th, mm, easy};
  auto st = static_cast<cudaStream_t>(stream);
  auto cen = static_cast<const float*>(centers);
  auto part = static_cast<float*>(partials);
  auto o = static_cast<float*>(out);
  return feats_bf16
             ? launch_fwd<__nv_bfloat16>(feats, cen, M, F, mg, sel_th, scale, part, o, st)
             : launch_fwd<float>(feats, cen, M, F, mg, sel_th, scale, part, o, st);
}

// The forward in two calls, for a caller that sums the partial pairs of
// several processes in between (data parallelism): the streaming pass
// (*nparts = the pairs it wrote), then the final pass over nparts pairs.
// Together they give mpcl_pseudo_fwd's out.
int mpcl_pseudo_fwd_partial(const void* feats, int feats_bf16, const void* centers, int M,
                            int F, int C, float T, float cos_m, float sin_m, float th,
                            float mm, int easy, float sel_th, void* partials, int* nparts,
                            void* stream) {
  if (C != kC) return -1;
  const Margin mg{T, cos_m, sin_m, th, mm, easy};
  auto st = static_cast<cudaStream_t>(stream);
  auto cen = static_cast<const float*>(centers);
  auto part = static_cast<float*>(partials);
  return feats_bf16
             ? launch_partial<__nv_bfloat16>(feats, cen, M, F, mg, sel_th, part, nparts, st)
             : launch_partial<float>(feats, cen, M, F, mg, sel_th, part, nparts, st);
}

int mpcl_pseudo_fwd_final(const void* partials, int nparts, int M, float scale, void* out,
                          void* stream) {
  slcl::mpcl_fwd_final<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), nparts, M, 1, scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// stats is the forward's out (stats[2] = den); grad_out one float.
int mpcl_pseudo_bwd(const void* feats, int feats_bf16, const void* centers, int M,
                    int F, int C, float T, float cos_m, float sin_m, float th,
                    float mm, int easy, float scale, float sel_th,
                    const void* grad_out, const void* stats, void* dfeats,
                    void* stream) {
  if (C != kC) return -1;
  const Margin mg{T, cos_m, sin_m, th, mm, easy};
  auto st = static_cast<cudaStream_t>(stream);
  auto cen = static_cast<const float*>(centers);
  auto g = static_cast<const float*>(grad_out);
  auto stt = static_cast<const float*>(stats);
  return feats_bf16
             ? launch_bwd<__nv_bfloat16>(feats, cen, M, F, mg, sel_th, scale, g, stt,
                                         dfeats, st)
             : launch_bwd<float>(feats, cen, M, F, mg, sel_th, scale, g, stt, dfeats,
                                 st);
}

// Blocks per SM and shared memory per block (static + dynamic) of the
// forward's partial kernel (bwd = 0) or of the backward (bwd = 1), from the
// CUDA runtime. Returns a cudaError_t; -1 for an unsupported F.
int mpcl_pseudo_occupancy(int bwd, int feats_bf16, int F, int* blocks_per_sm,
                          int* smem_bytes) {
  return feats_bf16 ? occupancy_of<__nv_bfloat16>(bwd, F, blocks_per_sm, smem_bytes)
                    : occupancy_of<float>(bwd, F, blocks_per_sm, smem_bytes);
}

// ---- the general family: the same calls at any C >= 1 and F >= 1; -1
// where the shape's shared memory (general.cuh::gen_rows_smem) does not
// fit a block of this device ----

int mpcl_pseudo_gen_num_partials(int feats_bf16, int M, int F, int* n) {
  (void)feats_bf16;
  (void)F;
  *n = slcl::gen_grid(M, kThreads);
  return 0;
}

int mpcl_pseudo_gen_fwd_partial(const void* feats, int feats_bf16, const void* centers, int M,
                                int F, int C, float T, float cos_m, float sin_m, float th,
                                float mm, int easy, float sel_th, void* partials, int* nparts,
                                void* stream) {
  if (C < 1 || F < 1) return -1;
  const Margin mg{T, cos_m, sin_m, th, mm, easy};
  auto st = static_cast<cudaStream_t>(stream);
  auto cen = static_cast<const float*>(centers);
  auto part = static_cast<float*>(partials);
  return feats_bf16 ? gen_launch_partial<__nv_bfloat16>(feats, cen, M, F, C, mg, sel_th, part,
                                                        nparts, st)
                    : gen_launch_partial<float>(feats, cen, M, F, C, mg, sel_th, part, nparts,
                                                st);
}

int mpcl_pseudo_gen_bwd(const void* feats, int feats_bf16, const void* centers, int M, int F,
                        int C, float T, float cos_m, float sin_m, float th, float mm, int easy,
                        float scale, float sel_th, const void* grad_out, const void* stats,
                        void* dfeats, void* stream) {
  if (C < 1 || F < 1) return -1;
  const Margin mg{T, cos_m, sin_m, th, mm, easy};
  auto st = static_cast<cudaStream_t>(stream);
  auto cen = static_cast<const float*>(centers);
  auto g = static_cast<const float*>(grad_out);
  auto stt = static_cast<const float*>(stats);
  return feats_bf16 ? gen_launch_bwd<__nv_bfloat16>(feats, cen, M, F, C, mg, sel_th, scale, g,
                                                    stt, dfeats, st)
                    : gen_launch_bwd<float>(feats, cen, M, F, C, mg, sel_th, scale, g, stt,
                                            dfeats, st);
}

// Blocks per SM and shared memory per block of the general forward's
// partial kernel (bwd = 0) or backward (bwd = 1) at (C, F).
int mpcl_pseudo_gen_occupancy(int bwd, int feats_bf16, int F, int C, int* blocks_per_sm,
                              int* smem_bytes) {
  return feats_bf16 ? gen_occupancy_of<__nv_bfloat16>(bwd, F, C, blocks_per_sm, smem_bytes)
                    : gen_occupancy_of<float>(bwd, F, C, blocks_per_sm, smem_bytes);
}

}  // extern "C"
