// Margin-preserving pixel-vs-prototype contrastive loss (MPCL), forward and
// backward, for Hopper (sm_90a).
//
// Replaces slcl_tpu/ops/pallas/mpcl_kernel.py::mpcl_loss_fused (_fwd_kernel,
// _bwd_kernel and the custom VJP _fused_fwd/_fused_bwd).
//
// Per row m of feats (M, F): L2-normalise (rsqrt(sum x^2 + 1e-24)); cosine
// against the (C, F) normalised prototypes; logits = cos/T minus the row
// max; ArcFace margin phi on the label column (hard: phi if cos > cos(pi-m)
// else cos - sin(pi-m)*m; easy: phi if cos > 0 else cos), also minus its row
// max; log-softmax with +1e-4 in the partition sum; mlpp = log-prob of the
// label column. Loss = -(T/T_base) * sum(sel*mlpp) / den, den = sum(sel)+1e-4
// with sel, else M. Backward recomputes the row and returns dfeats through
// the normalisation Jacobian; the prototypes are detached (dcenters = 0).
//
// Bound on this card: bytes. At the slice's shapes (M = 16*224*224 =
// 802,816, F = 32, C = 4, bf16 feats) the forward reads 51.4 MB of features
// plus 3.2 MB of labels and 3.2 MB of sel (~58 MB, ~17 us at 3.35 TB/s); the
// backward also writes 51.4 MB of dfeats (~109 MB, ~33 us). The arithmetic
// is ~128 FMAs per 64 bytes, far under the card's ratio, and too narrow for
// tensor cores.
//
// Forward design (mpcl_fwd_tile.cuh, shared with mpcl_pseudo.cu and
// pseudo_label.cu). The thread-per-row forward that held its whole row in
// registers ran at 34% of its bound (0.051 ms on an NVIDIA H100 80GB HBM3
// at 700.00 W): 166 registers let one block of 8 warps run per SM; loads
// were started only at the top of a row (at most 16 KB in flight per SM,
// and nothing during the math); a warp's 16-byte loads sat 64 B apart; a
// 1024-block grid left a tail of 7.76 waves. Now a persistent grid walks
// tiles of 256 rows, a thread a row: it holds the row's raw bytes in 16
// registers, loaded with direct 16-byte loads, and starts the loads of its
// next row, label and sel before it takes the current row's cosines
// (stream_cosines, unrolled) and softmax, within 80 registers and 3 blocks
// per SM. The same loop through a bulk-copy ring measured slower. A row
// with sel = 0 skips the softmax. C = slcl::kC is fixed at compile time.
// Sums go per thread, then per block in a fixed tree, one (num, den) pair a
// block, which mpcl_fwd_final adds in a second launch in a fixed order, so
// two runs on the same inputs give bit-identical results (no float
// atomics).
//
// Backward design (mpcl_bwd_tile.cuh, shared with mpcl_pseudo.cu). The
// thread-per-row backward that loaded its rows itself ran at 35% of its
// bound: 236 registers let one block of 8 warps run per SM; at most 16 KB
// of loads were in flight per SM, and only between math phases; a
// 1024-block grid cap left a tail of 7.76 waves; a warp's 16-byte loads sat
// 64 B apart. Now a persistent grid (one block per resident slot) streams
// tiles of 256 rows, with their labels and sel, through a 2-stage
// shared-memory ring filled by 1D bulk copies, so loads stay in flight
// while the warps compute. A thread still takes one row, but streams it
// from shared memory in 8-value chunks, so at most 80 registers give 3
// blocks (24 warps) per SM; each warp stores 512 contiguous bytes of
// dfeats an instruction. Four lanes a row (one per class) measured slower:
// each lane repeats the row's norm and unpacks the whole row.
//
// General family (general.cuh): mpcl_gen_fwd_partial and mpcl_gen_bwd take
// any C and F at run time, a thread a row, for the shapes the templated
// kernels above do not take; the forward ends in the same mpcl_fwd_final.
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
mpcl_fwd_partial(const T* __restrict__ feats, const int* __restrict__ labels,
                 const float* __restrict__ sel, const float* __restrict__ centers,
                 int M, Margin mg, float* __restrict__ part) {
  static_assert(C == kC, "the tile loop is built for kC classes");
  __shared__ float s_red[kThreads];
  float num, den;
  slcl::mpcl_fwd_tiles<T, F, false>(feats, labels, sel, centers, M, mg, 0.f, num, den);
  num = slcl::block_sum(num, s_red);
  den = slcl::block_sum(den, s_red);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = num;
    part[2 * blockIdx.x + 1] = den;
  }
}

template <typename T, int F, int C>
__global__ void __launch_bounds__(kThreads, slcl::kRingBlocksPerSM)
mpcl_bwd(const T* __restrict__ feats, const int* __restrict__ labels,
         const float* __restrict__ sel, const float* __restrict__ centers, int M,
         Margin mg, float scale, const float* __restrict__ grad_out,
         const float* __restrict__ stats, T* __restrict__ dfeats) {
  static_assert(C == kC, "the ring is built for kC classes");
  // dL/dmlpp_m = coef * sel_m
  const float coef = -scale * grad_out[0] / stats[2];
  slcl::mpcl_bwd_tiles<T, F, false>(feats, labels, sel, centers, M, mg, 0.f, coef, dfeats);
}

// Blocks of the forward's persistent launch: the pairs part must hold.
template <typename T>
int fwd_grid(int M, int F, int* grid) {
  SLCL_DISPATCH_F(F, return (slcl::ring_grid<slcl::FwdTile<T, kF>,
                                             mpcl_fwd_partial<T, kF, kC>>(M, grid)));
  return -1;
}

// The streaming pass alone; *grid = its blocks (the pairs it wrote).
template <typename T>
int launch_partial(const void* feats, const int* labels, const float* sel,
                   const float* centers, int M, int F, Margin mg, float* part, int* grid,
                   cudaStream_t st) {
  const int rc = fwd_grid<T>(M, F, grid);
  if (rc != 0) return rc;
  SLCL_DISPATCH_F(F, mpcl_fwd_partial<T, kF, kC>
                     <<<*grid, kThreads, slcl::FwdTile<T, kF>::kSmemBytes, st>>>(
                         static_cast<const T*>(feats), labels, sel, centers, M, mg,
                         part));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* feats, const int* labels, const float* sel,
               const float* centers, int M, int F, Margin mg, float scale,
               float* part, float* out, cudaStream_t st) {
  int grid = 0;
  const int rc = launch_partial<T>(feats, labels, sel, centers, M, F, mg, part, &grid, st);
  if (rc != 0) return rc;
  slcl::mpcl_fwd_final<<<1, kThreads, 0, st>>>(part, grid, M, sel != nullptr, scale, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* feats, const int* labels, const float* sel,
               const float* centers, int M, int F, Margin mg, float scale,
               const float* grad_out, const float* stats, void* dfeats,
               cudaStream_t st) {
  SLCL_DISPATCH_F(F, {
    using G = slcl::BwdRing<T, kF, false>;
    int grid = 0;
    const int rc = slcl::ring_grid<G, mpcl_bwd<T, kF, kC>>(M, &grid);
    if (rc != 0) return rc;
    mpcl_bwd<T, kF, kC><<<grid, kThreads, G::kSmemBytes, st>>>(
        static_cast<const T*>(feats), labels, sel, centers, M, mg, scale, grad_out, stats,
        static_cast<T*>(dfeats));
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy_of(int bwd, int F, int* blocks_per_sm, int* smem_bytes) {
  SLCL_DISPATCH_F(F, {
    return bwd ? slcl::occupancy(mpcl_bwd<T, kF, kC>, slcl::BwdRing<T, kF, false>::kSmemBytes,
                                 blocks_per_sm, smem_bytes)
               : slcl::occupancy(mpcl_fwd_partial<T, kF, kC>,
                                 slcl::FwdTile<T, kF>::kSmemBytes, blocks_per_sm,
                                 smem_bytes);
  });
  return -1;
}

// ---- the general family: any C and F, at run time ----

template <typename T>
__global__ void __launch_bounds__(kThreads)
mpcl_gen_fwd_partial(const T* __restrict__ feats, const int* __restrict__ labels,
                     const float* __restrict__ sel, const float* __restrict__ centers, int M,
                     int F, int C, Margin mg, float* __restrict__ part) {
  __shared__ float s_red[kThreads];
  float num, den;
  slcl::gen_mpcl_fwd_sums<T, false>(feats, labels, sel, centers, M, F, C, mg, 0.f, num, den);
  num = slcl::block_sum(num, s_red);
  den = slcl::block_sum(den, s_red);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = num;
    part[2 * blockIdx.x + 1] = den;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mpcl_gen_bwd(const T* __restrict__ feats, const int* __restrict__ labels,
             const float* __restrict__ sel, const float* __restrict__ centers, int M, int F,
             int C, Margin mg, float scale, const float* __restrict__ grad_out,
             const float* __restrict__ stats, T* __restrict__ dfeats) {
  const float coef = -scale * grad_out[0] / stats[2];
  slcl::gen_mpcl_bwd_dfeats<T, false>(feats, labels, sel, centers, M, F, C, mg, 0.f, coef,
                                    dfeats);
}

template <typename T>
int gen_launch_partial(const void* feats, const int* labels, const float* sel,
                       const float* centers, int M, int F, int C, Margin mg, float* part,
                       int* grid, cudaStream_t st) {
  const int smem = slcl::gen_rows_smem(C, F);
  const int rc = slcl::gen_prepare<mpcl_gen_fwd_partial<T>>(smem);
  if (rc != 0) return rc;
  *grid = slcl::gen_grid(M, kThreads);
  mpcl_gen_fwd_partial<T><<<*grid, kThreads, smem, st>>>(static_cast<const T*>(feats), labels,
                                                          sel, centers, M, F, C, mg, part);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gen_launch_bwd(const void* feats, const int* labels, const float* sel,
                   const float* centers, int M, int F, int C, Margin mg, float scale,
                   const float* grad_out, const float* stats, void* dfeats, cudaStream_t st) {
  const int smem = slcl::gen_rows_smem(C, F);
  const int rc = slcl::gen_prepare<mpcl_gen_bwd<T>>(smem);
  if (rc != 0) return rc;
  mpcl_gen_bwd<T><<<slcl::gen_grid(M, kThreads), kThreads, smem, st>>>(
      static_cast<const T*>(feats), labels, sel, centers, M, F, C, mg, scale, grad_out, stats,
      static_cast<T*>(dfeats));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gen_occupancy_of(int bwd, int F, int C, int* blocks_per_sm, int* smem_bytes) {
  const int smem = slcl::gen_rows_smem(C, F);
  return bwd ? slcl::gen_occupancy<mpcl_gen_bwd<T>>(smem, blocks_per_sm, smem_bytes)
             : slcl::gen_occupancy<mpcl_gen_fwd_partial<T>>(smem, blocks_per_sm, smem_bytes);
}

}  // namespace

extern "C" {

// *n = the float pairs the forward's partial buffer must hold: the blocks
// of its persistent grid on the current device. Returns a cudaError_t; -1
// for an unsupported F.
int mpcl_num_partials(int feats_bf16, int M, int F, int* n) {
  return feats_bf16 ? fwd_grid<__nv_bfloat16>(M, F, n) : fwd_grid<float>(M, F, n);
}

// Returns cudaGetLastError() after the launches; -1 for an unsupported F or
// a C other than slcl::kC. sel may be null (plain mean over M).
int mpcl_fwd(const void* feats, int feats_bf16, const void* labels,
             const void* sel, const void* centers, int M, int F, int C, float T,
             float cos_m, float sin_m, float th, float mm, int easy, float scale,
             void* partials, void* out, void* stream) {
  if (C != kC) return -1;
  const Margin mg{T, cos_m, sin_m, th, mm, easy};
  auto st = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<const int*>(labels);
  auto s = static_cast<const float*>(sel);
  auto cen = static_cast<const float*>(centers);
  auto part = static_cast<float*>(partials);
  auto o = static_cast<float*>(out);
  return feats_bf16
             ? launch_fwd<__nv_bfloat16>(feats, lab, s, cen, M, F, mg, scale, part, o, st)
             : launch_fwd<float>(feats, lab, s, cen, M, F, mg, scale, part, o, st);
}

// The forward in two calls, for a caller that sums the partial pairs of
// several processes in between (data parallelism): the streaming pass
// (*nparts = the pairs it wrote), then the final pass over nparts pairs
// with M the rows of all of them. Together they give mpcl_fwd's out.
int mpcl_fwd_partial(const void* feats, int feats_bf16, const void* labels,
                     const void* sel, const void* centers, int M, int F, int C, float T,
                     float cos_m, float sin_m, float th, float mm, int easy,
                     void* partials, int* nparts, void* stream) {
  if (C != kC) return -1;
  const Margin mg{T, cos_m, sin_m, th, mm, easy};
  auto st = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<const int*>(labels);
  auto s = static_cast<const float*>(sel);
  auto cen = static_cast<const float*>(centers);
  auto part = static_cast<float*>(partials);
  return feats_bf16
             ? launch_partial<__nv_bfloat16>(feats, lab, s, cen, M, F, mg, part, nparts, st)
             : launch_partial<float>(feats, lab, s, cen, M, F, mg, part, nparts, st);
}

int mpcl_fwd_final(const void* partials, int nparts, int M, int use_sel, float scale,
                   void* out, void* stream) {
  slcl::mpcl_fwd_final<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), nparts, M, use_sel, scale,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// stats is the forward's out (stats[2] = den); grad_out one float.
int mpcl_bwd(const void* feats, int feats_bf16, const void* labels,
             const void* sel, const void* centers, int M, int F, int C, float T,
             float cos_m, float sin_m, float th, float mm, int easy, float scale,
             const void* grad_out, const void* stats, void* dfeats, void* stream) {
  if (C != kC) return -1;
  const Margin mg{T, cos_m, sin_m, th, mm, easy};
  auto st = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<const int*>(labels);
  auto s = static_cast<const float*>(sel);
  auto cen = static_cast<const float*>(centers);
  auto g = static_cast<const float*>(grad_out);
  auto stt = static_cast<const float*>(stats);
  return feats_bf16
             ? launch_bwd<__nv_bfloat16>(feats, lab, s, cen, M, F, mg, scale, g, stt, dfeats, st)
             : launch_bwd<float>(feats, lab, s, cen, M, F, mg, scale, g, stt, dfeats, st);
}

// Blocks per SM and shared memory per block (static + dynamic) of the
// forward's partial kernel (bwd = 0) or of the backward (bwd = 1), from the
// CUDA runtime. Returns a cudaError_t; -1 for an unsupported F.
int mpcl_occupancy(int bwd, int feats_bf16, int F, int* blocks_per_sm, int* smem_bytes) {
  return feats_bf16 ? occupancy_of<__nv_bfloat16>(bwd, F, blocks_per_sm, smem_bytes)
                    : occupancy_of<float>(bwd, F, blocks_per_sm, smem_bytes);
}

// ---- the general family: the same calls at any C >= 1 and F >= 1; -1
// where the shape's shared memory (general.cuh::gen_rows_smem) does not
// fit a block of this device ----

int mpcl_gen_num_partials(int feats_bf16, int M, int F, int* n) {
  (void)feats_bf16;
  (void)F;
  *n = slcl::gen_grid(M, kThreads);
  return 0;
}

int mpcl_gen_fwd_partial(const void* feats, int feats_bf16, const void* labels,
                         const void* sel, const void* centers, int M, int F, int C, float T,
                         float cos_m, float sin_m, float th, float mm, int easy,
                         void* partials, int* nparts, void* stream) {
  if (C < 1 || F < 1) return -1;
  const Margin mg{T, cos_m, sin_m, th, mm, easy};
  auto st = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<const int*>(labels);
  auto s = static_cast<const float*>(sel);
  auto cen = static_cast<const float*>(centers);
  auto part = static_cast<float*>(partials);
  return feats_bf16
             ? gen_launch_partial<__nv_bfloat16>(feats, lab, s, cen, M, F, C, mg, part, nparts,
                                                 st)
             : gen_launch_partial<float>(feats, lab, s, cen, M, F, C, mg, part, nparts, st);
}

int mpcl_gen_bwd(const void* feats, int feats_bf16, const void* labels, const void* sel,
                 const void* centers, int M, int F, int C, float T, float cos_m, float sin_m,
                 float th, float mm, int easy, float scale, const void* grad_out,
                 const void* stats, void* dfeats, void* stream) {
  if (C < 1 || F < 1) return -1;
  const Margin mg{T, cos_m, sin_m, th, mm, easy};
  auto st = static_cast<cudaStream_t>(stream);
  auto lab = static_cast<const int*>(labels);
  auto s = static_cast<const float*>(sel);
  auto cen = static_cast<const float*>(centers);
  auto g = static_cast<const float*>(grad_out);
  auto stt = static_cast<const float*>(stats);
  return feats_bf16 ? gen_launch_bwd<__nv_bfloat16>(feats, lab, s, cen, M, F, C, mg, scale, g,
                                                    stt, dfeats, st)
                    : gen_launch_bwd<float>(feats, lab, s, cen, M, F, C, mg, scale, g, stt,
                                            dfeats, st);
}

// Blocks per SM and shared memory per block of mpcl_gen_fwd_partial
// (bwd = 0) or mpcl_gen_bwd (bwd = 1) at (C, F).
int mpcl_gen_occupancy(int bwd, int feats_bf16, int F, int C, int* blocks_per_sm,
                       int* smem_bytes) {
  return feats_bf16 ? gen_occupancy_of<__nv_bfloat16>(bwd, F, C, blocks_per_sm, smem_bytes)
                    : gen_occupancy_of<float>(bwd, F, C, blocks_per_sm, smem_bytes);
}

}  // extern "C"
