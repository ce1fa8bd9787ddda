// Soft (or hard) class centroids per partition, forward and backward, for
// Hopper (sm_90a).
//
// Replaces slcl_tpu/ops/pallas/centroid_kernel.py::soft_centroids_fused
// (_kernel). The TPU kernel is forward-only; CNR backpropagates through the
// target centroids, so this file adds the backward.
//
// Forward, per row m of feats (M, F), probs (M, C) and a partition id
// assign[m] in [0, P): certain = (max prob >= thd) when 0 < thd < 1, else 1;
// weights w = probs * certain (soft) or onehot(first argmax) * certain
// (hard). Per partition p it sums w[c] * feats (P*C, F), w[c] (P*C) and
// certain (1); cents = sums / (counts + 1e-7), ratio = sum(certain) / M.
// With the std variant (kStd, MCCL's stdmin) it also sums w[c] * feats^2
// over all partitions (S2, (C, F)) and gives per class
// std = sqrt(mean_f max(S2 / W - cents[0]^2, 0) + 1e-7), W = sum_p counts[p]
// + 1e-7: the spread around partition 0's centroid
// (slcl_tpu/ops/centroids.py:137-146). Rows whose id lies outside [0, P)
// get no weight there either; JAX's draw never makes such ids.
// Backward, from dcents: dsums = dcents / (counts + 1e-7), dcounts =
// -sum_f dcents * cents / (counts + 1e-7); dfeats[m] = sum_c w[m,c] *
// dsums[p(m), c]; with soft weights dprobs[m,c] = (sum_f dsums[p(m),c,f] *
// feats[m,f] + dcounts[p(m),c]) * certain[m]. Hard weights pass no gradient
// to probs. The std variant adds, from g = dL/dstd (C,), with
// a[c,f] = g[c] * d max(var, 0) / (2 * std[c] * F) (half at var == 0, as
// jnp.maximum): dcents[0] -= 2 a cents[0] before the above, dfeats[m] +=
// 2 feats[m] * sum_c w[m,c] a[c] / W[c] (the features are read then even
// for hard weights), dprobs[m,c] += certain[m] * (sum_f a[c,f] feats[m,f]^2
// / W[c] - sum_f a[c,f] S2[c,f] / W[c]^2).
//
// Bound on this card: bytes. At the slice's shapes (M = 802,816, F = 32,
// C = 4, P = 1, bf16 feats, f32 probs) the forward reads 51.4 MB of
// features and 12.8 MB of probs (~64 MB, ~19 us at 3.35 TB/s). The hard-
// weight backward reads the probs and writes 51.4 MB of dfeats (~64 MB,
// ~19 us): it reads the features only for dprobs, so soft weights also read
// 51.4 MB of features and write 12.8 MB of dprobs.
//
// Design: F/8 threads per row, each owning 8 features read as one 16-byte
// vector (bf16), so the rows' sums need no exchange between threads until
// the end of the block. The forward's first version ran at 32% of its
// bound (0.059 ms on an NVIDIA H100 80GB HBM3 at 700.00 W, where all the
// figures here were taken; this one runs at 64%), for two reasons. Its
// streaming pass kept one 16-byte feature load and four scalar probs loads
// in flight per thread, in a grid-stride loop over 1024 blocks; it moved
// its bytes at 2.3 TB/s. Its final pass was one block in which 133 threads
// each added the 1024 block partials one after another, and took as long as
// the streaming pass. Now:
// - the streaming pass is a persistent grid (one block per resident slot)
//   in which a thread starts kRowsInFlight<P> rows' 16-byte feature loads
//   and their probs (one float4 a row) before it accumulates, within 128
//   registers (2 blocks per SM): with one partition four rows, 32 KB of
//   features in flight per SM; with two partitions (64 partial sums a
//   thread) two rows, since four spill. It needs no shared memory; a bulk-
//   copy ring as the MPCL kernels' (ring.cuh) was built and measured, and
//   moved its bytes ~8% slower at P = 1 (2.43 against 2.63 TB/s) and within
//   the spread of two rows' loads at P = 2 (PERF.md). Each thread keeps its
//   P*C x 8 partial sums in registers; at the end the warp folds them with
//   shuffles in a fixed order and the block adds its warps in a fixed order
//   into one partial a block, <= 132 x 2 of them, stored value-major so
//   that the final pass reads them coalesced.
// - the final pass gives every value a warp: the lanes stride the blocks'
//   partials (at most 32 each), a shuffle tree adds the lanes, and the warp
//   divides by its class's count, which it sums the same way.
// No float atomics, and the order of every sum is fixed by the launch shape:
// two runs on the same inputs give bit-identical centroids. The std variant
// is a compile-time switch (kStd): its instantiations hold C x 8 more sums a
// thread and take fewer rows in flight (kFwdRows, kFwdBlocks); the final
// pass gives each class's std a block of its own, which totals S2, the
// class's partition-0 sums and counts with all its threads. Without it the
// kernels are the same code as before it existed. The backward
// first forms dsums/dcounts for the block in shared memory, then writes each
// row's dfeats as 16-byte stores. C is fixed at compile time (slcl::kC).
#include "ring.cuh"

namespace {

using slcl::kThreads;
constexpr int kWarps = kThreads / 32;

// Weights of one row from its probs p and partition id: w[c], certain, and
// whether the id lies in [0, P) (part is 0 when it does not).
template <int P, int C>
__device__ __forceinline__ void weights_of(const float (&p)[C], int id, float thd,
                                           int use_thd, int weighted, float (&w)[C],
                                           float& cert, float& in_part, int& part) {
  float mx = p[0];
  int am = 0;
#pragma unroll
  for (int c = 1; c < C; ++c)
    if (p[c] > mx) {
      mx = p[c];
      am = c;
    }
  cert = (!use_thd || mx >= thd) ? 1.f : 0.f;
  part = id;
  // a row outside [0, P) belongs to no partition and gets no weight (it
  // still counts in the certain ratio)
  in_part = (part >= 0 && part < P) ? 1.f : 0.f;
  if (in_part == 0.f) part = 0;
#pragma unroll
  for (int c = 0; c < C; ++c)
    w[c] = (weighted ? p[c] : (c == am ? 1.f : 0.f)) * cert * in_part;
}

// The same, with probs and id read from memory.
template <int P, int C>
__device__ __forceinline__ void row_weights(const float* __restrict__ probs,
                                            const int* __restrict__ assign, int row,
                                            float thd, int use_thd, int weighted,
                                            float (&w)[C], float& cert,
                                            float& in_part, int& part) {
  float p[C];
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = probs[(size_t)row * C + c];
  weights_of<P, C>(p, (P > 1) ? assign[row] : 0, thd, use_thd, weighted, w, cert, in_part,
                   part);
}

// rows a thread of the forward loads before it accumulates: what 128
// registers hold beside its P * C * 8 partial sums without spilling
template <int P>
constexpr int kRowsInFlight = P == 1 ? 4 : 2;
constexpr int kCentFwdBlocksPerSM = 2;  // 128 registers a thread
// The same with the std sums (C x 8 more a thread): two rows at P = 1 in
// 128 registers; at P = 2 (104 sums a thread) one block per SM, whose 255
// registers hold four rows.
template <int P, bool kStd>
constexpr int kFwdRows = !kStd ? kRowsInFlight<P> : (P == 1 ? 2 : 4);
template <int P, bool kStd>
constexpr int kFwdBlocks = (kStd && P > 1) ? 1 : kCentFwdBlocksPerSM;

// Tiles of the forward's persistent grid: the rows a block takes a step.
template <int F, int P, bool kStd>
struct FwdTiles {
  static constexpr int kRows = kFwdRows<P, kStd> * (kThreads / (F / 8));
  static constexpr int kSmemBytes = 0;
};

// One thread's partial sums: its 8 features of every (partition, class),
// and, on the row's first thread, the weights and the certain rows; with
// kStd also w * x^2 of its 8 features of every class.
template <int P, int C, bool kStd>
struct Acc {
  float sum[P * C][8];
  float cnt[P * C];
  float n_cert;
  float sq[kStd ? C : 1][8];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < P * C; ++i) {
      cnt[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum[i][j] = 0.f;
    }
    n_cert = 0.f;
    if constexpr (kStd) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) sq[c][j] = 0.f;
    }
  }

  // one row: its 8 features x, probs p and partition id
  __device__ __forceinline__ void add(const float (&x)[8], const float (&p)[C], int id,
                                      bool first, float thd, int use_thd, int weighted) {
    float w[C], cert, in_part;
    int part;
    weights_of<P, C>(p, id, thd, use_thd, weighted, w, cert, in_part, part);
#pragma unroll
    for (int pp = 0; pp < P; ++pp) {
      if (pp == part) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int j = 0; j < 8; ++j) sum[pp * C + c][j] = fmaf(w[c], x[j], sum[pp * C + c][j]);
          if (first) cnt[pp * C + c] += w[c];
        }
      }
    }
    if (first) n_cert += cert;
    if constexpr (kStd) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) sq[c][j] = fmaf(w[c] * x[j], x[j], sq[c][j]);
    }
  }

  // The block's sums into part_out, value-major (value i of block b at
  // i * gridDim.x + b): the warp folds its rows with shuffles (lanes with
  // the same sub hold the same features), then the block adds its warps,
  // both in a fixed order. Every thread of the block must call it.
  template <int F>
  __device__ __forceinline__ void store(float* __restrict__ part_out) const {
    constexpr int TPR = F / 8;
    constexpr int NPC = P * C;
    constexpr int NV = NPC * F + NPC + 1 + (kStd ? C * F : 0);
    __shared__ float s_acc[kWarps][NV];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < NPC; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = sum[i][j];
#pragma unroll
        for (int off = TPR; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < TPR) s_acc[warp][i * F + lane * 8 + j] = v;
      }
      float v = cnt[i];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) s_acc[warp][NPC * F + i] = v;
    }
    float v = n_cert;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) s_acc[warp][NPC * F + NPC] = v;
    if constexpr (kStd) {   // S2 after the certain count
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float q = sq[c][j];
#pragma unroll
          for (int off = TPR; off < 32; off <<= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
          if (lane < TPR) s_acc[warp][NPC * F + NPC + 1 + c * F + lane * 8 + j] = q;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < NV; i += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int wq = 0; wq < kWarps; ++wq) s += s_acc[wq][i];
      part_out[(size_t)i * gridDim.x + blockIdx.x] = s;
    }
  }
};

// The streaming pass: a persistent grid, each thread starting
// kRowsInFlight<P> rows' loads before it accumulates.
template <typename T, int F, int P, int C, bool kStd>
__global__ void __launch_bounds__(kThreads, (kFwdBlocks<P, kStd>))
centroids_fwd_partial(const T* __restrict__ feats, const float* __restrict__ probs,
                      const int* __restrict__ assign, int M, float thd, int use_thd,
                      int weighted, float* __restrict__ part_out) {
  static_assert(C == 4, "a row's probs are read as one float4");
  constexpr int TPR = F / 8;
  constexpr int RPB = kThreads / TPR;
  constexpr int kRows = kFwdRows<P, kStd>;
  constexpr int kTile = FwdTiles<F, P, kStd>::kRows;
  const int sub = threadIdx.x % TPR;
  const int r = threadIdx.x / TPR;
  Acc<P, C, kStd> acc;
  acc.clear();
  for (long long base = (long long)blockIdx.x * kTile; base < M;
       base += (long long)gridDim.x * kTile) {
    float x[kRows][8];
    float4 pv[kRows];
    int id[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long row = base + j * RPB + r;
      id[j] = 0;
      if (row < M) {
        slcl::load8(feats + (size_t)row * F + sub * 8, x[j]);
        pv[j] = __ldg(reinterpret_cast<const float4*>(probs) + row);
        if constexpr (P > 1) id[j] = assign[row];
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (base + j * RPB + r < M) {
        const float p[C] = {pv[j].x, pv[j].y, pv[j].z, pv[j].w};
        acc.add(x[j], p, id[j], sub == 0, thd, use_thd, weighted);
      }
    }
  }
  acc.template store<F>(part_out);
}

// Blocks of the streaming pass's persistent launch: at most kMaxBlocks, so
// that no lane of the final pass adds more than 32 partials.
template <typename T, int F, int P, bool kStd>
int fwd_grid_of(int M, int* g) {
  const int rc = slcl::ring_grid<FwdTiles<F, P, kStd>,
                                 centroids_fwd_partial<T, F, P, slcl::kC, kStd>>(M, g);
  if (rc == 0 && *g > slcl::kMaxBlocks) *g = slcl::kMaxBlocks;
  return rc;
}

// One class's S2 and std, by a whole block of the final pass: every thread
// adds its share of the block partials (the threads stride them; at most
// kMaxBlocks / kThreads each, their loads all issued together) of the
// class's F S2 sums, F partition-0 sums and P counts, kChunk values at a
// time; the warps fold their lanes with shuffles and the block adds its
// warps, all in a fixed order. Then one warp takes the variance of each
// feature around partition 0's centroid and their mean.
template <int F, int P, int C>
__device__ __forceinline__ void std_block(const float* __restrict__ part_in, int nparts,
                                          int k, float* __restrict__ s2,
                                          float* __restrict__ stdv) {
  constexpr int NPC = P * C;
  constexpr int NK = 2 * F + P;   // S2[k][f], sums[0][k][f], counts[p][k]
  constexpr int kChunk = 32;
  constexpr int kIters = slcl::kMaxBlocks / kThreads;
  __shared__ float s_w[kWarps][NK];
  __shared__ float s_tot[NK];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  auto value_of = [&](int s) {
    return s < F ? NPC * F + NPC + 1 + k * F + s
                 : (s < 2 * F ? k * F + (s - F) : NPC * F + (s - 2 * F) * C + k);
  };
#pragma unroll
  for (int s0 = 0; s0 < NK; s0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) acc[u] = 0.f;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int b = threadIdx.x + it * kThreads;
      if (b < nparts) {
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (s0 + u < NK) acc[u] += part_in[(size_t)value_of(s0 + u) * nparts + b];
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (s0 + u < NK) {
        float v = acc[u];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) s_w[warp][s0 + u] = v;
      }
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < NK; s += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int wq = 0; wq < kWarps; ++wq) t += s_w[wq][s];
    s_tot[s] = t;
  }
  __syncthreads();
  if (warp != 0) return;
  float wsum = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) wsum += s_tot[2 * F + p];
  const float wk = wsum + 1e-7f;
  const float n0 = s_tot[2 * F] + 1e-7f;
  float v = 0.f;
  for (int f = lane; f < F; f += 32) {
    const float q = s_tot[f];
    const float c0 = s_tot[F + f] / n0;
    s2[k * F + f] = q;
    v += fmaxf(q / wk - c0 * c0, 0.f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) stdv[k] = sqrtf(v / static_cast<float>(F) + 1e-7f);
}

// The final pass: a warp per value. Its lanes stride the nparts block
// partials of the value (nparts <= 1024: at most 32 additions a lane), a
// shuffle tree adds the lanes, and the warp of a centroid value sums its
// class's count the same way to divide by it. With kStd, C more blocks
// after the values' give each class's S2 and std (std_block).
template <int F, int P, int C, bool kStd>
__global__ void __launch_bounds__(kThreads)
centroids_fwd_final(const float* __restrict__ part_in, int nparts, int M,
                    float* __restrict__ cents, float* __restrict__ counts,
                    float* __restrict__ ratio, float* __restrict__ s2,
                    float* __restrict__ stdv) {
  constexpr int NPC = P * C;
  constexpr int NV = NPC * F + NPC + 1;
  if constexpr (kStd) {
    constexpr int kValueBlocks = (NV + kWarps - 1) / kWarps;
    if (blockIdx.x >= kValueBlocks) {
      std_block<F, P, C>(part_in, nparts, blockIdx.x - kValueBlocks, s2, stdv);
      return;
    }
  }
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= NV) return;
  auto total = [&](int value) {
    float s = 0.f;
    for (int b = lane; b < nparts; b += 32) s += part_in[(size_t)value * nparts + b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    return s;
  };
  const float v = total(i);
  if (i < NPC * F) {
    const float n = total(NPC * F + i / F);
    if (lane == 0) cents[i] = v / (n + 1e-7f);
  } else if (lane == 0) {
    if (i < NPC * F + NPC) counts[i - NPC * F] = v;
    else ratio[0] = v / static_cast<float>(M);
  }
}

// W[c] = sum over partitions of counts[p][c] + 1e-7: all weight of class c
template <int P, int C>
__device__ __forceinline__ float weight_total(const float* __restrict__ counts, int c) {
  float w = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) w += counts[p * C + c];
  return w + 1e-7f;
}

// The backward's body, with or without the std's terms (kStd); the two
// kernels below differ only in what they ask of ptxas.
template <typename T, int F, int P, int C, bool kStd>
__device__ __forceinline__ void bwd_rows(const T* __restrict__ feats,
                                         const float* __restrict__ probs,
                                         const int* __restrict__ assign, int M, float thd,
                                         int use_thd, int weighted,
                                         const float* __restrict__ dcents,
                                         const float* __restrict__ cents,
                                         const float* __restrict__ counts,
                                         T* __restrict__ dfeats, float* __restrict__ dprobs,
                                         const float* __restrict__ gstd,
                                         const float* __restrict__ s2,
                                         const float* __restrict__ stdv) {
  constexpr int TPR = F / 8;
  constexpr int RPB = kThreads / TPR;
  constexpr int NPC = P * C;
  // with kStd, a[c][f] and a[c][f] / W[c] follow the dsums
  __shared__ float s_dsum[NPC * F + (kStd ? 2 * C * F : 0)];
  __shared__ float s_dcnt[NPC];
  if constexpr (kStd) {
    float* s_a = s_dsum + NPC * F;
    float* s_aw = s_a + C * F;
    for (int i = threadIdx.x; i < C * F; i += kThreads) {
      const int c = i / F;
      const float wk = weight_total<P, C>(counts, c);
      const float var = s2[i] / wk - cents[i] * cents[i];
      const float dvar = var > 0.f ? 1.f : (var == 0.f ? 0.5f : 0.f);
      const float a = gstd[c] * dvar / (2.f * stdv[c] * static_cast<float>(F));
      s_a[i] = a;
      s_aw[i] = a / wk;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < NPC * F; i += kThreads) {
    float d = dcents[i];
    if constexpr (kStd) {
      if (i < C * F) d = fmaf(-2.f * s_dsum[NPC * F + i], cents[i], d);
    }
    s_dsum[i] = d / (counts[i / F] + 1e-7f);
  }
  for (int i = threadIdx.x; i < NPC; i += kThreads) {
    float v = 0.f;
    for (int f = 0; f < F; ++f) {
      float d = dcents[i * F + f];
      if constexpr (kStd) {
        if (i < C) d = fmaf(-2.f * s_dsum[NPC * F + i * F + f], cents[i * F + f], d);
      }
      v = fmaf(d, cents[i * F + f], v);
    }
    s_dcnt[i] = -v / (counts[i] + 1e-7f);
    if constexpr (kStd) {   // - sum_f a S2 / W^2, whatever the row's partition
      const int c = i % C;
      const float wk = weight_total<P, C>(counts, c);
      float b = 0.f;
      for (int f = 0; f < F; ++f) b = fmaf(s_dsum[NPC * F + c * F + f], s2[c * F + f], b);
      s_dcnt[i] -= b / (wk * wk);
    }
  }
  __syncthreads();
  const int sub = threadIdx.x % TPR;
  const int r = threadIdx.x / TPR;
  // every thread of the block runs the same number of iterations, so the
  // shuffles below always see the whole warp
  for (long long base = (long long)blockIdx.x * RPB; base < M;
       base += (long long)gridDim.x * RPB) {
    const int row = static_cast<int>(base) + r;
    const bool valid = row < M;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float w[C], cert = 0.f, in_part = 0.f;
    int part = 0;
    if (valid) {
      if constexpr (kStd) {   // the std's gradient reads the features
        slcl::load8(feats + (size_t)row * F + sub * 8, x);
      } else {
        // the features enter only dprobs: dfeats needs just the weights
        if (dprobs != nullptr) slcl::load8(feats + (size_t)row * F + sub * 8, x);
      }
      row_weights<P, C>(probs, assign, row, thd, use_thd, weighted, w, cert, in_part, part);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) w[c] = 0.f;
    }
    const float* ds = s_dsum + part * C * F + sub * 8;
    float dx[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) v = fmaf(w[c], ds[c * F + j], v);
      if constexpr (kStd) {   // a / W after a, at C * F past the dsums
        const float* as = s_dsum + NPC * F + C * F + sub * 8;
        float u = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) u = fmaf(w[c], as[c * F + j], u);
        v = fmaf(2.f * x[j], u, v);
      }
      dx[j] = v;
    }
    if (valid) slcl::store8(dfeats + (size_t)row * F + sub * 8, dx);
    if (dprobs != nullptr) {
      float dw[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) v = fmaf(ds[c * F + j], x[j], v);
        if constexpr (kStd) {
          const float* as = s_dsum + NPC * F + C * F + sub * 8;
#pragma unroll
          for (int j = 0; j < 8; ++j) v = fmaf(as[c * F + j] * x[j], x[j], v);
        }
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        dw[c] = v;
      }
      if (valid && sub == 0) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          dprobs[(size_t)row * C + c] = (dw[c] + s_dcnt[part * C + c]) * cert * in_part;
      }
    }
  }
}

// Without the std: the kernel as it was before the std variant existed.
template <typename T, int F, int P, int C>
__global__ void __launch_bounds__(kThreads)
centroids_bwd(const T* __restrict__ feats, const float* __restrict__ probs,
              const int* __restrict__ assign, int M, float thd, int use_thd,
              int weighted, const float* __restrict__ dcents,
              const float* __restrict__ cents, const float* __restrict__ counts,
              T* __restrict__ dfeats, float* __restrict__ dprobs) {
  bwd_rows<T, F, P, C, false>(feats, probs, assign, M, thd, use_thd, weighted, dcents, cents,
                              counts, dfeats, dprobs, nullptr, nullptr, nullptr);
}

// With the std: three blocks per SM asked (80 registers), two at F = 8.
// Left to itself ptxas held the bf16 F = 32 P = 1 instantiation at 64
// registers and spilled 8 bytes; the same request of the std-free kernel
// took it from 48 to 76 registers and 0.0325 to 0.0384 ms, so it has its own.
template <typename T, int F, int P, int C>
__global__ void __launch_bounds__(kThreads, (F == 8 ? 2 : 3))
centroids_bwd_std(const T* __restrict__ feats, const float* __restrict__ probs,
                  const int* __restrict__ assign, int M, float thd, int use_thd,
                  int weighted, const float* __restrict__ dcents,
                  const float* __restrict__ cents, const float* __restrict__ counts,
                  T* __restrict__ dfeats, float* __restrict__ dprobs,
                  const float* __restrict__ gstd, const float* __restrict__ s2,
                  const float* __restrict__ stdv) {
  bwd_rows<T, F, P, C, true>(feats, probs, assign, M, thd, use_thd, weighted, dcents, cents,
                             counts, dfeats, dprobs, gstd, s2, stdv);
}

#define SLCL_DISPATCH_P(P, ...)                                 \
  switch (P) {                                                  \
    case 1: { constexpr int kP = 1; __VA_ARGS__; } break;       \
    case 2: { constexpr int kP = 2; __VA_ARGS__; } break;       \
    default: return -1;                                         \
  }
// ... and on whether the std sums are taken (kStd)
#define SLCL_DISPATCH_STD(S, ...)                                  \
  if (S) { constexpr bool kS = true; __VA_ARGS__; }                \
  else { constexpr bool kS = false; __VA_ARGS__; }

using slcl::kC;

template <typename T>
int launch_fwd(const void* feats, const float* probs, const int* assign, int M,
               int F, int P, float thd, int use_thd, int weighted, float* partials,
               float* cents, float* counts, float* ratio, float* s2, float* stdv,
               cudaStream_t st) {
  SLCL_DISPATCH_F(F, SLCL_DISPATCH_P(P, SLCL_DISPATCH_STD(s2 != nullptr, {
    int grid = 0;
    const int rc = fwd_grid_of<T, kF, kP, kS>(M, &grid);
    if (rc != 0) return rc;
    centroids_fwd_partial<T, kF, kP, kC, kS><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(feats), probs, assign, M, thd, use_thd, weighted, partials);
    constexpr int kNV = kP * kC * kF + kP * kC + 1;
    constexpr int kBlocks = (kNV + kWarps - 1) / kWarps + (kS ? kC : 0);
    centroids_fwd_final<kF, kP, kC, kS><<<kBlocks, kThreads, 0, st>>>(
        partials, grid, M, cents, counts, ratio, s2, stdv);
  })));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_grid(int M, int F, int P, int with_std, int* grid) {
  SLCL_DISPATCH_F(F, SLCL_DISPATCH_P(P, SLCL_DISPATCH_STD(
      with_std, return (fwd_grid_of<T, kF, kP, kS>(M, grid)))));
  return -1;
}

template <typename T>
int launch_bwd(const void* feats, const float* probs, const int* assign, int M,
               int F, int P, float thd, int use_thd, int weighted,
               const float* dcents, const float* cents, const float* counts,
               void* dfeats, float* dprobs, const float* gstd, const float* s2,
               const float* stdv, cudaStream_t st) {
  SLCL_DISPATCH_F(F, SLCL_DISPATCH_P(P, SLCL_DISPATCH_STD(gstd != nullptr, {
    const int grid = slcl::grid_for(M, kThreads / (kF / 8));
    if constexpr (kS)
      centroids_bwd_std<T, kF, kP, kC><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(feats), probs, assign, M, thd, use_thd, weighted,
          dcents, cents, counts, static_cast<T*>(dfeats), dprobs, gstd, s2, stdv);
    else
      centroids_bwd<T, kF, kP, kC><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(feats), probs, assign, M, thd, use_thd, weighted,
          dcents, cents, counts, static_cast<T*>(dfeats), dprobs);
  })));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy_of(int bwd, int F, int P, int with_std, int* blocks_per_sm,
                 int* smem_bytes) {
  SLCL_DISPATCH_F(F, SLCL_DISPATCH_P(P, SLCL_DISPATCH_STD(with_std, {
    if (!bwd)
      return slcl::occupancy(centroids_fwd_partial<T, kF, kP, kC, kS>, 0, blocks_per_sm,
                             smem_bytes);
    if constexpr (kS)
      return slcl::occupancy(centroids_bwd_std<T, kF, kP, kC>, 0, blocks_per_sm, smem_bytes);
    else
      return slcl::occupancy(centroids_bwd<T, kF, kP, kC>, 0, blocks_per_sm, smem_bytes);
  })));
  return -1;
}

}  // namespace

extern "C" {

// *n = the floats the forward's partial buffer must hold: values per block
// x the blocks of its persistent grid on the current device (with_std: the
// std variant's). Returns a cudaError_t; -1 for an unsupported shape.
int soft_centroids_partials_size(int feats_bf16, int M, int F, int P, int C, int with_std,
                                 int* n) {
  if (C != kC) return -1;
  int grid = 0;
  const int rc = feats_bf16 ? fwd_grid<__nv_bfloat16>(M, F, P, with_std, &grid)
                            : fwd_grid<float>(M, F, P, with_std, &grid);
  *n = (P * C * F + P * C + 1 + (with_std ? C * F : 0)) * grid;
  return rc;
}

// Returns cudaGetLastError() after the launches; -1 for an unsupported
// shape (F in {8, 16, 32, 64}, P in {1, 2}, C = 4). assign may be null when
// P = 1. s2 (C, F) and stdv (C,) both null: no std; both given: the std
// variant writes them.
int soft_centroids_fwd(const void* feats, int feats_bf16, const void* probs,
                       const void* assign, int M, int F, int C, int P,
                       float threshold, int weighted, void* partials, void* cents,
                       void* counts, void* ratio, void* s2, void* stdv, void* stream) {
  if (C != kC || (s2 == nullptr) != (stdv == nullptr)) return -1;
  const int use_thd = threshold > 0.f && threshold < 1.f;
  auto st = static_cast<cudaStream_t>(stream);
  auto pr = static_cast<const float*>(probs);
  auto as = static_cast<const int*>(assign);
  auto pt = static_cast<float*>(partials);
  auto ce = static_cast<float*>(cents);
  auto co = static_cast<float*>(counts);
  auto ra = static_cast<float*>(ratio);
  auto q = static_cast<float*>(s2);
  auto sd = static_cast<float*>(stdv);
  return feats_bf16
             ? launch_fwd<__nv_bfloat16>(feats, pr, as, M, F, P, threshold, use_thd,
                                         weighted, pt, ce, co, ra, q, sd, st)
             : launch_fwd<float>(feats, pr, as, M, F, P, threshold, use_thd, weighted,
                                 pt, ce, co, ra, q, sd, st);
}

// dprobs may be null (hard weights, or probs needs no gradient). dstd (C,)
// null: no std gradient; given, s2 and stdv are the forward's.
int soft_centroids_bwd(const void* feats, int feats_bf16, const void* probs,
                       const void* assign, int M, int F, int C, int P,
                       float threshold, int weighted, const void* dcents,
                       const void* cents, const void* counts, void* dfeats,
                       void* dprobs, const void* dstd, const void* s2, const void* stdv,
                       void* stream) {
  if (C != kC || (dstd != nullptr && (s2 == nullptr || stdv == nullptr))) return -1;
  const int use_thd = threshold > 0.f && threshold < 1.f;
  auto st = static_cast<cudaStream_t>(stream);
  auto pr = static_cast<const float*>(probs);
  auto as = static_cast<const int*>(assign);
  auto dc = static_cast<const float*>(dcents);
  auto ce = static_cast<const float*>(cents);
  auto co = static_cast<const float*>(counts);
  auto dp = static_cast<float*>(dprobs);
  auto gs = static_cast<const float*>(dstd);
  auto q = static_cast<const float*>(s2);
  auto sd = static_cast<const float*>(stdv);
  return feats_bf16
             ? launch_bwd<__nv_bfloat16>(feats, pr, as, M, F, P, threshold, use_thd,
                                         weighted, dc, ce, co, dfeats, dp, gs, q, sd, st)
             : launch_bwd<float>(feats, pr, as, M, F, P, threshold, use_thd, weighted,
                                 dc, ce, co, dfeats, dp, gs, q, sd, st);
}

// Blocks per SM and shared memory per block of the forward's partial kernel
// (bwd = 0) or of the backward (bwd = 1), with or without the std, from the
// CUDA runtime. Returns a cudaError_t; -1 for an unsupported F or P.
int soft_centroids_occupancy(int bwd, int feats_bf16, int F, int P, int with_std,
                             int* blocks_per_sm, int* smem_bytes) {
  return feats_bf16
             ? occupancy_of<__nv_bfloat16>(bwd, F, P, with_std, blocks_per_sm, smem_bytes)
             : occupancy_of<float>(bwd, F, P, with_std, blocks_per_sm, smem_bytes);
}

}  // extern "C"
