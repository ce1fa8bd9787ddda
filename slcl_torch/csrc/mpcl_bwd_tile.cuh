// Backward of the MPCL loss for Hopper (sm_90a), shared by mpcl.cu (label
// and sel read from memory) and mpcl_pseudo.cu (label and sel recomputed
// from the row's cosines).
//
// Per row: the cosines as the forward computes them, the margin softmax,
// gcos[c] = dL/dcos[c], then dfeats through the row normalisation:
// dx = (dfn - fn * <dfn, fn>) * inv with dfn = gcos @ cent, fn = x * inv,
// and <dfn, fn> = sum_c gcos[c] * cos[c]. The prototypes are detached. Rows
// with sel = 0 or a label outside [0, C) get a zero gradient.
//
// Design:
// - Persistent grid: one block per resident slot (SMs x blocks per SM,
//   queried once per kernel and device and cached). Each block walks tiles
//   of kRows = kThreads rows at a fixed stride. There is no reduction
//   across rows, so dfeats does not depend on the launch shape.
// - A ring of kStages shared-memory stages (ring.cuh), filled by 1D bulk
//   copies (cp.async.bulk) that one elected thread starts. Each stage has a
//   "full" mbarrier, which the copies complete, and an "empty" one, which every
//   warp arrives on when it is done with the stage. At the main shape
//   (bf16, F = 32) a block has two stages of 16 KB of features and 2 KB of
//   labels and sel: one is computed on while the other fills, ~54 KB in
//   flight an SM.
// - One thread per row, streaming the staged row in 8-value chunks: the
//   cosines by the forwards' stream_cosines (sequential fmaf over k), so a
//   recomputed label and sel equal the forward's bit for bit; then the
//   margin softmax's gradient; then dx, written back over the row in
//   shared memory. Each warp then copies its 32 rows out with 16-byte
//   stores, 512 contiguous bytes an instruction.
// - At most 80 registers (__launch_bounds__(kThreads, kRingBlocksPerSM)),
//   so 3 blocks (24 warps) share an SM and hide the math's latency.
// Bulk copies need sizes and addresses in multiples of 16 bytes. Feature
// rows always are (F >= 8). Labels and sel go in whole groups of four rows;
// the last 1-3 rows of a ragged last tile read theirs from memory.
#pragma once

#include "mpcl_row.cuh"
#include "ring.cuh"

namespace slcl {

// blocks per SM the register budget allows: at most 80 registers a thread;
// measured faster than 4 blocks at 64 registers
constexpr int kRingBlocksPerSM = 3;

// Shape of the ring for one instantiation.
template <typename T, int F, bool kPseudo>
struct BwdRing {
  static constexpr int kRowBytes = F * static_cast<int>(sizeof(T));
  static constexpr int kRows = kThreads;  // one row a thread
  static constexpr int kFeatBytes = kRows * kRowBytes;
  // 2-4 stages, ~32 KB of features in all (more stages measured slower)
  static constexpr int kStages =
      32768 / kFeatBytes < 2 ? 2 : (32768 / kFeatBytes > 4 ? 4 : 32768 / kFeatBytes);
  static constexpr int kSide = kPseudo ? 0 : kRows * 4;  // label bytes a stage; sel the same
  static constexpr int kStageBytes = kFeatBytes + 2 * kSide;
  static constexpr int kSmemBytes = kStages * kStageBytes + kC * F * 4 + 2 * kStages * 8;
  static_assert(kRowBytes % 16 == 0 && kRows % 32 == 0, "ring shape");
};

// gcos[c] = g * d mlpp / d cos[c] of one row from its cosines, with
// g = dL/dmlpp (margin_softmax's terms; fast reciprocals and exponentials,
// which the gradient's tolerance allows).
template <int C>
__device__ __forceinline__ void margin_grad(const float* cosv, int lab, const Margin& mg,
                                            float invT, float g, float* gcos) {
  float logit[C], phil[C];
  float lmax = -INFINITY, pmax = -INFINITY, cl = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float cs = cosv[c];
    const float cl2 = fminf(fmaxf(1.f - cs * cs, 1e-4f), 1.f);
    float phi = cs * mg.cos_m - cl2 * rsqrtf(cl2) * mg.sin_m;
    if (mg.easy) phi = cs > 0.f ? phi : cs;
    else phi = cs > mg.th ? phi : cs - mg.mm;
    logit[c] = cs * invT;
    phil[c] = phi * invT;
    lmax = fmaxf(lmax, logit[c]);
    pmax = fmaxf(pmax, phil[c]);
    if (c == lab) cl = cs;
  }
  float e[C], z = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    e[c] = __expf(c == lab ? phil[c] - pmax : logit[c] - lmax);
    z += e[c];
  }
  // d mlpp / d mixed = onehot - p * sum(onehot); a label outside [0, C)
  // selects no column, so every gcos is 0
  const float rz = (lab >= 0 && lab < C) ? __fdividef(1.f, z + 1e-4f) : 0.f;
  // d phi / d cos on the label column; the clamped sine is constant there
  const float one_m = 1.f - cl * cl;
  const bool sat = one_m <= 1e-4f || one_m >= 1.f;
  const float dphi_on = sat ? mg.cos_m : mg.cos_m + mg.sin_m * cl * rsqrtf(one_m);
  const float dphi = cl > (mg.easy ? 0.f : mg.th) ? dphi_on : 1.f;
  const float gT = g * invT;
#pragma unroll
  for (int c = 0; c < C; ++c)
    gcos[c] = c == lab ? gT * (1.f - e[c] * rz) * dphi : gT * -(e[c] * rz);
}

// dx of one row, in place over the row in shared memory. With kPseudo,
// lab and s come from the cosines; otherwise they are given.
template <typename T, int F, bool kPseudo>
__device__ __forceinline__ void bwd_row(T* row, const float* s_cent, int lab, float s,
                                        const Margin& mg, float invT, float sel_th,
                                        float coef) {
  // one chunk at a time, and the row and prototypes read again below: held
  // across the phases they would not fit in the register budget
  float cosv[kC], inv;
  stream_cosines<T, F>(row, s_cent, cosv, inv);
  if constexpr (kPseudo) lab = row_pseudo_label<kC>(cosv, sel_th, s);
  if (s == 0.f) {
    const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < F; k += 8) store8(row + k, zero);
    return;
  }
  float gcos[kC];
  margin_grad<kC>(cosv, lab, mg, invT, coef * s, gcos);
  float proj = 0.f;  // <dfn, fn>
#pragma unroll
  for (int c = 0; c < kC; ++c) proj = fmaf(gcos[c], cosv[c], proj);
  const float xs = inv * proj;
  asm volatile("" ::: "memory");  // read the row and prototypes again below
#pragma unroll 1
  for (int k = 0; k < F; k += 8) {
    float x[8], dfn[8];
    load8(row + k, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) dfn[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float cc[8];
      load8(s_cent + c * F + k, cc);
#pragma unroll
      for (int i = 0; i < 8; ++i) dfn[i] = fmaf(gcos[c], cc[i], dfn[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dfn[i] = (dfn[i] - x[i] * xs) * inv;
    store8(row + k, dfn);
  }
}

// The body of both backward kernels. coef = dL/dmlpp of a row with sel 1.
// labels and sel are read only without kPseudo; sel may be null (all 1).
template <typename T, int F, bool kPseudo>
__device__ __forceinline__ void mpcl_bwd_tiles(const T* __restrict__ feats,
                                               const int* __restrict__ labels,
                                               const float* __restrict__ sel,
                                               const float* __restrict__ centers, int M,
                                               const Margin& mg, float sel_th, float coef,
                                               T* __restrict__ dfeats) {
  using G = BwdRing<T, F, kPseudo>;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_cent = reinterpret_cast<float*>(smem + G::kStages * G::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_cent + kC * F);
  uint64_t* empty = full + G::kStages;

  const int ntiles = (M + G::kRows - 1) / G::kRows;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < kC * F; i += kThreads) s_cent[i] = centers[i];
  __syncthreads();

  // thread 0 only: the tile's feature rows into the stage, and its labels
  // and sel in whole groups of four rows
  auto fill = [&](int stage, int tile) {
    const int row0 = tile * G::kRows;
    const int rows = min(G::kRows, M - row0);
    unsigned char* st = smem + stage * G::kStageBytes;
    const uint32_t fbytes = rows * G::kRowBytes;
    uint32_t sbytes = 0;
    if constexpr (!kPseudo) sbytes = (rows & ~3) * 4;
    mbar_expect_tx(&full[stage], fbytes + sbytes * (sel ? 2u : 1u));
    bulk_copy(st, feats + (size_t)row0 * F, fbytes, &full[stage]);
    if constexpr (!kPseudo) {
      if (sbytes) {
        bulk_copy(st + G::kFeatBytes, labels + row0, sbytes, &full[stage]);
        if (sel) bulk_copy(st + G::kFeatBytes + G::kSide, sel + row0, sbytes, &full[stage]);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < ntiles) fill(s, tile);
    }
  }

  const float invT = 1.f / mg.T;
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int stage = it % G::kStages;
    const uint32_t parity = (it / G::kStages) & 1;
    mbar_wait(&full[stage], parity);
    unsigned char* st = smem + stage * G::kStageBytes;
    const int row0 = tile * G::kRows;
    const int rows = min(G::kRows, M - row0);
    const int r = threadIdx.x;
    if (r < rows) {
      int lab = 0;
      float s = 0.f;
      if constexpr (!kPseudo) {
        if (r < (rows & ~3)) {
          lab = reinterpret_cast<const int*>(st + G::kFeatBytes)[r];
          s = sel ? reinterpret_cast<const float*>(st + G::kFeatBytes + G::kSide)[r] : 1.f;
        } else {
          lab = labels[row0 + r];
          s = sel ? sel[row0 + r] : 1.f;
        }
      }
      bwd_row<T, F, kPseudo>(reinterpret_cast<T*>(st) + r * F, s_cent, lab, s, mg, invT,
                             sel_th, coef);
    }
    __syncwarp();
    // the warp's rows out, 16 B a lane: 512 contiguous bytes an instruction
    const int wrows = min(32, rows - warp * 32);
    const uint4* src = reinterpret_cast<const uint4*>(st + warp * 32 * G::kRowBytes);
    uint4* dst = reinterpret_cast<uint4*>(dfeats + (size_t)(row0 + warp * 32) * F);
    for (int i = lane; i < wrows * (G::kRowBytes / 16); i += 32) dst[i] = src[i];
    // the next bulk copy into this stage comes after these shared-memory
    // writes and reads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (threadIdx.x == 0) {
      const int next = tile + G::kStages * gridDim.x;
      if (next < ntiles) {
        mbar_wait(&empty[stage], parity);
        fill(stage, next);
      }
    }
  }
}

}  // namespace slcl
