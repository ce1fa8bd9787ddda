// The kernels that only read their rows, for Hopper (sm_90a): the forward
// of the MPCL loss with labels and sel given (mpcl.cu) or taken from the
// row's own cosines (mpcl_pseudo.cu), and the pseudo-labels alone
// (pseudo_label.cu).
//
// Per row: the cosines (stream_cosines), then either the pseudo-label and
// gap mask (row_pseudo_label) or the given label and sel, and for a row with
// sel != 0 the margin softmax's log-prob of the label column. Only
// sum(sel * mlpp) and sum(sel) leave a loss kernel; the pseudo-label kernel
// writes label and mask of every row.
//
// Design:
// - Persistent grid (ring.cuh's ring_grid): one block per resident slot
//   walks tiles of kRows = kThreads rows at a fixed stride, one thread a row.
// - A thread reads its row with direct 16-byte loads into registers, and
//   starts the loads of its next tile's row, with that row's label and sel
//   (plain 4-byte loads, 128 contiguous bytes a warp), before it computes on
//   the current one: two rows in flight a thread, 3 blocks per SM within 80
//   registers. A row wider than 64 bytes leaves no registers for a second
//   one and is loaded where it is used. Nothing but the prototypes goes
//   through shared memory (dynamic: see fwd_rows). On an NVIDIA H100 80GB
//   HBM3 at 700 W this feed measured 5-10% faster than the backward's
//   bulk-copy ring carrying the same rows (tools/ring_variants.py,
//   fwd_ring), and two rows in flight faster than one (fwd_1row).
// - The cosine loop is fully unrolled, so that the row stays in registers;
//   its sums are the backward's, term by term (stream_cosines).
// - Sums per thread across its tiles, then per block in a fixed tree: one
//   (num, den) pair a block. The grid follows the device's SM count, so the
//   order of the sums is fixed per device and build, and two launches are
//   bit-identical. A second launch (mpcl_fwd_final) adds the pairs.
#pragma once

#include "mpcl_row.cuh"
#include "ring.cuh"

namespace slcl {

// Shape of one instantiation's tiles (what ring_grid asks of a tile type).
template <typename T, int F>
struct FwdTile {
  static constexpr int kRowBytes = F * static_cast<int>(sizeof(T));
  static constexpr int kVec = kRowBytes / 16;  // 16-byte loads a row
  static constexpr int kRows = kThreads;       // one row a thread
  static constexpr int kSmemBytes = kC * F * 4;  // dynamic shared memory: the prototypes
  // a second row in flight while a row takes at most 16 registers
  static constexpr bool kTwoRows = kRowBytes <= 64;
  // blocks per SM the register budget allows: 80 registers a thread, or 128
  // where one row alone takes 64
  static constexpr int kBlocksPerSM = kRowBytes <= 128 ? 3 : 2;
  static_assert(kRowBytes % 16 == 0, "rows are read as 16-byte vectors");
};

// The tile loop of the three kernels. For each row of the block's tiles, on
// the thread that owns it: side(row) returns what the row brings beside its
// features (loaded with the row, a tile ahead), then each(row, cosv, that)
// gets the row's cosines.
template <typename T, int F, typename Side, typename Each>
__device__ __forceinline__ void fwd_rows(const T* __restrict__ feats,
                                         const float* __restrict__ centers, int M,
                                         Side&& side, Each&& each) {
  using G = FwdTile<T, F>;
  using S = decltype(side(0));
  // dynamic, not static: with the prototypes at addresses known at compile
  // time ptxas schedules their loads so far ahead that the kernel spills
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_cent = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < kC * F; i += kThreads) s_cent[i] = centers[i];
  __syncthreads();

  const int ntiles = (M + G::kRows - 1) / G::kRows;
  uint4 cur[G::kVec], nxt[G::kVec];
  S side_cur{}, side_nxt{};
  // start the loads of this thread's row of a tile, if it has one
  auto start = [&](int tile, uint4* dst, S& sd) {
    const int row = tile * G::kRows + static_cast<int>(threadIdx.x);
    if (row < M) {
      const uint4* src = reinterpret_cast<const uint4*>(feats + (size_t)row * F);
#pragma unroll
      for (int v = 0; v < G::kVec; ++v) dst[v] = src[v];
      sd = side(row);
    }
  };
  if constexpr (G::kTwoRows) start(blockIdx.x, cur, side_cur);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    if constexpr (G::kTwoRows) start(tile + gridDim.x, nxt, side_nxt);
    else start(tile, cur, side_cur);
    const int row = tile * G::kRows + static_cast<int>(threadIdx.x);
    if (row < M) {
      float cosv[kC], inv;
      stream_cosines<T, F, F / 8>(reinterpret_cast<const T*>(cur), s_cent, cosv, inv);
      each(row, cosv, side_cur);
    }
    if constexpr (G::kTwoRows) {
#pragma unroll
      for (int v = 0; v < G::kVec; ++v) cur[v] = nxt[v];
      side_cur = side_nxt;
    }
  }
}

// A given label and sel of one row.
struct RowSide {
  int lab;
  float sel;
};

// This thread's sums over the block's tiles: num = sum(sel * mlpp),
// den = sum(sel). With kPseudo, label and sel come from the row's cosines;
// otherwise they are given, and sel may be null (all 1).
template <typename T, int F, bool kPseudo>
__device__ __forceinline__ void mpcl_fwd_tiles(const T* __restrict__ feats,
                                               const int* __restrict__ labels,
                                               const float* __restrict__ sel,
                                               const float* __restrict__ centers, int M,
                                               const Margin& mg, float sel_th, float& num,
                                               float& den) {
  float n = 0.f, d = 0.f;
  fwd_rows<T, F>(
      feats, centers, M,
      [&](int row) {
        RowSide r{0, 1.f};
        if constexpr (!kPseudo) {
          r.lab = labels[row];
          if (sel) r.sel = sel[row];
        }
        return r;
      },
      [&](int, const float* cosv, RowSide r) {
        if constexpr (kPseudo) r.lab = row_pseudo_label<kC>(cosv, sel_th, r.sel);
        if (r.sel != 0.f) {  // rows without weight skip the softmax
          float e[kC], z;
          n = fmaf(r.sel, margin_softmax<kC>(cosv, r.lab, mg, e, z), n);
          d += r.sel;
        }
      });
  num = n;
  den = d;
}

// labels[row], mask[row] of every row of the block's tiles, 4 bytes a
// thread and 128 contiguous bytes a warp, straight to memory.
template <typename T, int F>
__device__ __forceinline__ void pseudo_label_tiles(const T* __restrict__ feats,
                                                   const float* __restrict__ centers, int M,
                                                   float sel_th, int* __restrict__ labels,
                                                   float* __restrict__ mask) {
  fwd_rows<T, F>(
      feats, centers, M, [](int) { return 0; },
      [&](int row, const float* cosv, int) {
        float s;
        labels[row] = row_pseudo_label<kC>(cosv, sel_th, s);
        mask[row] = s;
      });
}

}  // namespace slcl
