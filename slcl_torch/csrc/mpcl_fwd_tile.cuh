// Forward of the MPCL loss on a read-only ring, for Hopper (sm_90a). Used
// by mpcl_pseudo.cu, whose label and sel come from the row's own cosines.
//
// Per row: the cosines (stream_cosines, row_cosines' order), the pseudo-
// label and gap mask, and for a selected row the margin softmax's log-prob
// of the label column. Only sum(sel * mlpp) and sum(sel) leave the kernel.
//
// Design:
// - Persistent grid and ring as in the backward (mpcl_bwd_tile.cuh,
//   ring.cuh): one block per resident slot walks tiles of kRows = kThreads
//   rows at a fixed stride; one elected thread fills a stage with one bulk
//   copy that completes on the stage's "full" mbarrier, and each warp
//   arrives on its "empty" mbarrier as soon as it has taken its rows'
//   cosines. Nothing is written to a stage, so there is no proxy fence and
//   no copy-out: a stage is free before the softmax starts.
// - One thread per row, streaming the row from shared memory in 8-value
//   chunks. It holds no row across phases, so the register budget lets
//   kFwdBlocksPerSM blocks share an SM.
// - Sums per thread across its tiles, then per block in a fixed tree: one
//   (num, den) pair a block. The grid follows the device's SM count, so the
//   order of the sums is fixed per device and build, and two launches are
//   bit-identical. A second launch (mpcl_fwd_final) adds the pairs.
#pragma once

#include "mpcl_row.cuh"
#include "ring.cuh"

namespace slcl {

// blocks per SM the register budget allows (at most 80 registers a thread)
constexpr int kFwdBlocksPerSM = 3;

template <typename T, int F>
struct FwdRing {
  static constexpr int kRowBytes = F * static_cast<int>(sizeof(T));
  static constexpr int kRows = kThreads;  // one row a thread
  static constexpr int kFeatBytes = kRows * kRowBytes;
  // 2-4 stages, ~32 KB of features in all
  static constexpr int kStages =
      32768 / kFeatBytes < 2 ? 2 : (32768 / kFeatBytes > 4 ? 4 : 32768 / kFeatBytes);
  static constexpr int kStageBytes = kFeatBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + kC * F * 4 + 2 * kStages * 8;
  static_assert(kRowBytes % 16 == 0 && kRows % 32 == 0, "ring shape");
};

// This thread's sums over the block's tiles: num = sum(sel * mlpp),
// den = sum(sel), with label and sel from the row's cosines.
template <typename T, int F>
__device__ __forceinline__ void mpcl_pseudo_fwd_tiles(const T* __restrict__ feats,
                                                      const float* __restrict__ centers,
                                                      int M, const Margin& mg, float sel_th,
                                                      float& num, float& den) {
  using G = FwdRing<T, F>;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_cent = reinterpret_cast<float*>(smem + G::kStages * G::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_cent + kC * F);
  uint64_t* empty = full + G::kStages;

  const int ntiles = (M + G::kRows - 1) / G::kRows;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < kC * F; i += kThreads) s_cent[i] = centers[i];
  __syncthreads();

  // thread 0 only: the tile's feature rows into the stage (a ragged last
  // tile copies rows x row bytes, always a multiple of 16)
  auto fill = [&](int stage, int tile) {
    const int row0 = tile * G::kRows;
    const uint32_t fbytes = min(G::kRows, M - row0) * G::kRowBytes;
    mbar_expect_tx(&full[stage], fbytes);
    bulk_copy(smem + stage * G::kStageBytes, feats + (size_t)row0 * F, fbytes, &full[stage]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < ntiles) fill(s, tile);
    }
  }

  num = 0.f;
  den = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int stage = it % G::kStages;
    const uint32_t parity = (it / G::kStages) & 1;
    mbar_wait(&full[stage], parity);
    const bool live = static_cast<int>(threadIdx.x) < min(G::kRows, M - tile * G::kRows);
    float cosv[kC], inv;
    if (live)
      stream_cosines<T, F>(reinterpret_cast<const T*>(smem + stage * G::kStageBytes) +
                               threadIdx.x * F,
                           s_cent, cosv, inv);
    // the stage is free once the warp's cosines are taken
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (live) {
      float s;
      const int lab = row_pseudo_label<kC>(cosv, sel_th, s);
      if (s != 0.f) {  // rows that fail the gap test skip the softmax
        float e[kC], z;
        num += margin_softmax<kC>(cosv, lab, mg, e, z);
        den += 1.f;
      }
    }
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
