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
//
// The backward (centroids_bwd; centroids_bwd_std adds the std's terms) is
// one ring loop, bwd_ring: a persistent grid over 256-row tiles fed by a
// bulk-copy ring (ring.cuh), the block's dsums and dcounts formed once in
// dynamic shared memory while the first stages land, F/8 threads a row,
// each owning 8 features, the per-row arithmetic that of the first version
// (outputs bit for bit the same). That version, a grid-stride loop with
// one row's loads in flight a thread and four scalar probs loads by every
// thread of the row, ran at 58-67% of its bound. Now:
// - without dprobs (the slcl step's hard call) the features are not read:
//   the stages are thin, up to kMaxThinStages tiles of probs (4 KB each),
//   and each thread stores its dfeats as a 16-byte vector;
// - with dprobs a thread writes its dfeats over its features and the
//   row's first thread dprobs over the row's probs in the stage; each warp
//   fences its writes for the async proxy and arrives, and thread 0 stores
//   the tile with one shared -> global bulk copy each and waits until the
//   store has read the stage before it fills it again; since a stage is
//   held that much longer, the ring keeps one more;
// - the dsums of every partition at the thread's features sit in
//   registers, the row's picked by a select: 6-9% faster than reading them
//   from shared memory at P = 1; at P = 2 (64 floats, 122 registers) as
//   fast with direct stores, and only with them in registers did the bulk
//   store beat direct stores there (by 5%).
// Against its bound, with a copy_ of the same bytes in brackets (NVIDIA
// H100 80GB HBM3 at 700.00 W, chip_smoke.py phase 2): hard P = 1
// 0.0272-0.0273 ms, 70% (0.0245); soft P = 1 0.0494-0.0500 ms, 77-78%
// (0.0454-0.0456); soft P = 2 0.0532-0.0533 ms, 74% (0.0467-0.0468); the
// first version took 0.0325-0.0326 / 0.0560-0.0566 / 0.0672-0.0679 ms.
//
// The std variant has kernels of its own (the std_* functions and the two
// *_std kernels): its C x 8 more sums a thread left the std-free design no
// registers for rows in flight (as instantiations of the std-free kernels
// they ran at 38-47% of their bound). Both read their rows through a bulk-
// copy ring (ring.cuh), whose bytes in flight cost no registers:
// - forward (centroids_fwd_std_partial): kStages tiles of 256 rows
//   (features, probs and, with two partitions, ids) in flight, ~64 KB of
//   features a block, two blocks per SM. Each warp takes 32 rows of a tile:
//   one lane a row first turns the row's probs and id into its weights in
//   each partition and its certain flag (once a row, not once a thread of
//   the row), then F/4 lanes a row, each owning 4 features, add w * x to
//   the partition sums without a branch and w * x^2 to S2. At P = 2 that
//   took it from 0.049 to 0.039 ms: a branch per row over both partitions,
//   and the weights taken by every thread of the row, had cost the rest.
// - its final pass gives each class's std a block whose warps each sum a
//   few of the class's 2F + P values, every load of a batch issued together.
// - backward (centroids_bwd_std): the std-free backward's ring loop with
//   2-3 stages; a thread holds a / W at its 8 features in registers (and
//   at P = 1 the dsums too) and takes dfeats and the C dprobs partials in
//   one pass over them (std_bwd_row); it stores in bulk at P = 1 and
//   directly at P = 2, where its rows read their dsums from shared memory
//   (0.0540-0.0541 ms, 71%; 0.0607 ms, 65%). On direct loads with 2 or 4
//   rows in flight a thread it ran 17-25% slower (tools/ring_variants.py,
//   std_bwd_direct).
// No float atomics, and the order of every sum is fixed by the launch shape:
// two runs on the same inputs give bit-identical results. C is fixed at
// compile time (slcl::kC).
//
// General family (centroids_gen.cuh): centroids_gen_fwd_partial /
// _fwd_final and centroids_gen_bwd, with or without the std, take any C, P
// and F at run time, for the shapes the templated kernels above do not
// take (soft_centroids_gen_* below).
#include "centroids_gen.cuh"
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

// rows a thread of the forward loads before it accumulates: what 128
// registers hold beside its P * C * 8 partial sums without spilling
template <int P>
constexpr int kRowsInFlight = P == 1 ? 4 : 2;
constexpr int kCentFwdBlocksPerSM = 2;  // 128 registers a thread

// Tiles of the forward's persistent grid: the rows a block takes a step.
template <int F, int P>
struct FwdTiles {
  static constexpr int kRows = kRowsInFlight<P> * (kThreads / (F / 8));
  static constexpr int kSmemBytes = 0;
};

// One thread's partial sums: its V features of every (partition, class),
// and, on the row's first thread, the weights and the certain rows.
template <int P, int C, int V = 8>
struct Acc {
  float sum[P * C][V];
  float cnt[P * C];
  float n_cert;

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < P * C; ++i) {
      cnt[i] = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) sum[i][j] = 0.f;
    }
    n_cert = 0.f;
  }

  // one row: its V features x, probs p and partition id
  __device__ __forceinline__ void add(const float (&x)[V], const float (&p)[C], int id,
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
          for (int j = 0; j < V; ++j) sum[pp * C + c][j] = fmaf(w[c], x[j], sum[pp * C + c][j]);
          if (first) cnt[pp * C + c] += w[c];
        }
      }
    }
    if (first) n_cert += cert;
  }

  // The block's sums into part_out, value-major (value i of block b at
  // i * gridDim.x + b): the warp folds its rows with shuffles (lanes with
  // the same sub hold the same features), then the block adds its warps,
  // both in a fixed order. Every thread of the block must call it.
  template <int F>
  __device__ __forceinline__ void store(float* __restrict__ part_out) const {
    constexpr int TPR = F / V;
    constexpr int NPC = P * C;
    constexpr int NV = NPC * F + NPC + 1;
    __shared__ float s_acc[kWarps][NV];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < NPC; ++i) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = sum[i][j];
#pragma unroll
        for (int off = TPR; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < TPR) s_acc[warp][i * F + lane * V + j] = v;
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
template <typename T, int F, int P, int C>
__global__ void __launch_bounds__(kThreads, kCentFwdBlocksPerSM)
centroids_fwd_partial(const T* __restrict__ feats, const float* __restrict__ probs,
                      const int* __restrict__ assign, int M, float thd, int use_thd,
                      int weighted, float* __restrict__ part_out) {
  static_assert(C == 4, "a row's probs are read as one float4");
  constexpr int TPR = F / 8;
  constexpr int RPB = kThreads / TPR;
  constexpr int kRows = kRowsInFlight<P>;
  constexpr int kTile = FwdTiles<F, P>::kRows;
  const int sub = threadIdx.x % TPR;
  const int r = threadIdx.x / TPR;
  Acc<P, C> acc;
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
template <typename T, int F, int P>
int fwd_grid_of(int M, int* g) {
  const int rc = slcl::ring_grid<FwdTiles<F, P>,
                                 centroids_fwd_partial<T, F, P, slcl::kC>>(M, g);
  if (rc == 0 && *g > slcl::kMaxBlocks) *g = slcl::kMaxBlocks;
  return rc;
}

// ---- the std variant's forward ----

// Features a thread of the std forward owns: 4, which halves its sums
// against 8 (at P = 2, 8 took 104 sums a thread and one block per SM at 198
// registers). Blocks per SM: two, within 128 registers. The bytes in flight
// are the ring's, whatever the registers hold.
template <int P>
constexpr int kStdFwdVec = 4;
template <int P>
constexpr int kStdFwdBlocks = 2;

// V consecutive values of a row in shared memory -> f32 registers
template <int V>
__device__ __forceinline__ void std_load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 8) {
    slcl::load8(p, x);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
}

template <int V>
__device__ __forceinline__ void std_load_vec(const __nv_bfloat16* p, float (&x)[V]) {
  if constexpr (V == 8) {
    slcl::load8(p, x);
  } else {   // a bf16 is the top half of an f32
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(u.x << 16);
    x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16);
    x[3] = __uint_as_float(u.y & 0xffff0000u);
  }
}

// The std forward's read-only ring: tiles of 256 rows, each stage holding
// their features, their probs (a float4 a row) and, with two partitions,
// their ids; 2-4 stages, ~64 KB of features in all.
template <typename T, int F, int P>
struct StdFwdRing {
  static constexpr int kRowBytes = F * static_cast<int>(sizeof(T));
  static constexpr int kRows = kThreads;
  static constexpr int kFeatBytes = kRows * kRowBytes;
  static constexpr int kProbBytes = kRows * 16;
  static constexpr int kIdBytes = P > 1 ? kRows * 4 : 0;
  static constexpr int kStageBytes = kFeatBytes + kProbBytes + kIdBytes;
  static constexpr int kStages =
      65536 / kFeatBytes < 2 ? 2 : (65536 / kFeatBytes > 4 ? 4 : 65536 / kFeatBytes);
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8;
  static_assert(kRowBytes % 16 == 0, "bulk copies of whole rows");
};

// One row of the std forward on a thread's V features x, given the row's
// weights in each partition wp (w where the row lies, 0 elsewhere) and its
// certain flag: w * x into the partition sums and w * x^2 into S2. The
// partition sums take no branch, though a warp's rows lie in both
// partitions: the other partition's sums gain an exact 0.
template <int P, int C, int V>
__device__ __forceinline__ void std_fwd_row(Acc<P, C, V>& acc, float (&sq)[C][V],
                                            const float (&x)[V], const float4 (&wp)[P],
                                            float cert, bool first) {
  float w[C] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int pp = 0; pp < P; ++pp) {
    const float wc[C] = {wp[pp].x, wp[pp].y, wp[pp].z, wp[pp].w};
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc.sum[pp * C + c][j] = fmaf(wc[c], x[j], acc.sum[pp * C + c][j]);
      if (first) acc.cnt[pp * C + c] += wc[c];
      w[c] += wc[c];
    }
  }
  if (first) acc.n_cert += cert;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float x2 = x[j] * x[j];
#pragma unroll
    for (int c = 0; c < C; ++c) sq[c][j] = fmaf(w[c], x2, sq[c][j]);
  }
}

// The std forward's S2 sums (C x V a thread) into part_out as values
// NV0 + c * F + f, folded as Acc::store folds its sums. Every thread of the
// block must call it.
template <int F, int C, int V, int NV0>
__device__ __forceinline__ void std_store_sq(const float (&sq)[C][V],
                                             float* __restrict__ part_out) {
  constexpr int TPR = F / V;
  __shared__ float s_sq[kWarps][C * F];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float q = sq[c][j];
#pragma unroll
      for (int off = TPR; off < 32; off <<= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
      if (lane < TPR) s_sq[warp][c * F + lane * V + j] = q;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C * F; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int wq = 0; wq < kWarps; ++wq) s += s_sq[wq][i];
    part_out[(size_t)(NV0 + i) * gridDim.x + blockIdx.x] = s;
  }
}

// The std forward's streaming pass: a persistent grid over 256-row tiles
// fed by the ring. Thread 0 fills the stages (ids in whole groups of four
// rows; a ragged tile's last 1-3 ids are read from memory). Each warp takes
// 32 rows of a tile: first a lane a row, which turns the row's probs and id
// into its weights in each partition and its certain flag, in the warp's
// own shared memory (once a row, not once a thread of the row); then TPR
// lanes a row, a pass at a time. The warp then arrives on the stage's empty
// barrier.
template <typename T, int F, int P, int C>
__global__ void __launch_bounds__(kThreads, kStdFwdBlocks<P>)
centroids_fwd_std_partial(const T* __restrict__ feats, const float* __restrict__ probs,
                          const int* __restrict__ assign, int M, float thd, int use_thd,
                          int weighted, float* __restrict__ part_out) {
  static_assert(C == 4, "a row's probs are one float4");
  using G = StdFwdRing<T, F, P>;
  static_assert(G::kRows == kThreads, "32 rows a warp");
  constexpr int V = kStdFwdVec<P>;
  constexpr int TPR = F / V;
  constexpr int RPW = 32 / TPR;   // rows a warp takes a pass
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kStages * G::kStageBytes);
  uint64_t* empty = full + G::kStages;
  // a row's weights in each partition and its certain flag, per warp
  __shared__ float4 s_wp[kWarps][32][P];
  __shared__ float s_cert[kWarps][32];
  const int ntiles = (M + G::kRows - 1) / G::kRows;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane % TPR;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      slcl::mbar_init(&full[s], 1);
      slcl::mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto fill = [&](int stage, int tile) {
    const int row0 = tile * G::kRows;
    const int rows = min(G::kRows, M - row0);
    unsigned char* st = smem + stage * G::kStageBytes;
    const uint32_t fbytes = rows * G::kRowBytes;
    const uint32_t pbytes = rows * 16;
    const uint32_t ibytes = P > 1 ? (rows & ~3) * 4 : 0;
    slcl::mbar_expect_tx(&full[stage], fbytes + pbytes + ibytes);
    slcl::bulk_copy(st, feats + (size_t)row0 * F, fbytes, &full[stage]);
    slcl::bulk_copy(st + G::kFeatBytes, probs + (size_t)row0 * C, pbytes, &full[stage]);
    if (ibytes)
      slcl::bulk_copy(st + G::kFeatBytes + G::kProbBytes, assign + row0, ibytes, &full[stage]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < ntiles) fill(s, tile);
    }
  }
  Acc<P, C, V> acc;
  acc.clear();
  float sq[C][V];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < V; ++j) sq[c][j] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int stage = it % G::kStages;
    const uint32_t parity = (it / G::kStages) & 1;
    const int row0 = tile * G::kRows;
    const int rows = min(G::kRows, M - row0);
    slcl::mbar_wait(&full[stage], parity);
    const unsigned char* st = smem + stage * G::kStageBytes;
    const T* s_feat = reinterpret_cast<const T*>(st);
    const float4* s_prob = reinterpret_cast<const float4*>(st + G::kFeatBytes);
    const int* s_id = reinterpret_cast<const int*>(st + G::kFeatBytes + G::kProbBytes);
    const int rw = warp * 32;   // the warp's rows of the tile
    if (rw + lane < rows) {
      const int rr = rw + lane;
      int id = 0;
      if constexpr (P > 1) id = rr < (rows & ~3) ? s_id[rr] : assign[row0 + rr];
      const float4 pv = s_prob[rr];
      const float p[C] = {pv.x, pv.y, pv.z, pv.w};
      float w[C], cert, in_part;
      int part;
      weights_of<P, C>(p, id, thd, use_thd, weighted, w, cert, in_part, part);
#pragma unroll
      for (int pp = 0; pp < P; ++pp) {
        const float on = pp == part ? 1.f : 0.f;
        s_wp[warp][lane][pp] = make_float4(w[0] * on, w[1] * on, w[2] * on, w[3] * on);
      }
      s_cert[warp][lane] = cert;
    }
    __syncwarp();
#pragma unroll 2
    for (int q = 0; q < 32 / RPW; ++q) {
      const int l = q * RPW + lane / TPR;   // the row's lane in the first step
      if (rw + l < rows) {
        float x[V];
        std_load_vec<V>(s_feat + (rw + l) * F + sub * V, x);
        std_fwd_row<P, C, V>(acc, sq, x, s_wp[warp][l], s_cert[warp][l], sub == 0);
      }
    }
    __syncwarp();
    if (lane == 0) slcl::mbar_arrive(&empty[stage]);
    if (threadIdx.x == 0) {
      const int next = tile + G::kStages * gridDim.x;
      if (next < ntiles) {
        slcl::mbar_wait(&empty[stage], parity);
        fill(stage, next);
      }
    }
  }
  acc.template store<F>(part_out);
  std_store_sq<F, C, V, P * C * F + P * C + 1>(sq, part_out);
}

// The std forward's persistent grid, at most kMaxBlocks as the std-free one.
template <typename T, int F, int P>
int std_fwd_grid_of(int M, int* g) {
  const int rc = slcl::ring_grid<StdFwdRing<T, F, P>,
                                 centroids_fwd_std_partial<T, F, P, slcl::kC>>(M, g);
  if (rc == 0 && *g > slcl::kMaxBlocks) *g = slcl::kMaxBlocks;
  return rc;
}

// One class's S2 and std, by a whole block of the final pass. The class's
// 2F + P values (S2[k][f], partition 0's sums[k][f], counts[p][k]) go to the
// warps, kPer a warp; a lane adds its share of the nparts block partials of
// each, kBatch partials a value (96 loads a lane) with every load of the
// batch issued together, and a shuffle tree adds the lanes, all in a fixed
// order. Then one warp takes the variance of each feature around
// partition 0's centroid and their mean.
template <int F, int P, int C>
__device__ __forceinline__ void std_block(const float* __restrict__ part_in, int nparts,
                                          int k, float* __restrict__ s2,
                                          float* __restrict__ stdv) {
  constexpr int NPC = P * C;
  constexpr int NK = 2 * F + P;   // S2[k][f], sums[0][k][f], counts[p][k]
  constexpr int kPer = (NK + kWarps - 1) / kWarps;
  constexpr int kBatch = 96 / kPer;   // a lane's partials of one value a batch
  __shared__ float s_tot[NK];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  auto value_of = [&](int s) {
    return s < F ? NPC * F + NPC + 1 + k * F + s
                 : (s < 2 * F ? k * F + (s - F) : NPC * F + (s - 2 * F) * C + k);
  };
  float acc[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) acc[u] = 0.f;
  for (int b0 = 0; b0 < nparts; b0 += 32 * kBatch) {
    float v[kPer][kBatch];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int s = warp + u * kWarps;
      const float* src = part_in + (size_t)value_of(s < NK ? s : 0) * nparts;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int b = b0 + i * 32 + lane;
        v[u][i] = (s < NK && b < nparts) ? src[b] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u)
#pragma unroll
      for (int i = 0; i < kBatch; ++i) acc[u] += v[u][i];
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    float t = acc[u];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    const int s = warp + u * kWarps;
    if (lane == 0 && s < NK) s_tot[s] = t;
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

// ---- the backward: one ring loop (bwd_ring), std-free and std ----

constexpr int kBwdBlocksPerSM = 2;
constexpr int kBwdStdBlocksPerSM = 2;

// Whether a backward with dprobs writes its rows' dfeats over their
// features and dprobs over their probs in the stage and stores the tile
// with one bulk copy each, or each thread stores its values directly. The
// bulk store measured 3-11% faster than direct stores with one partition,
// in both backwards, and 5% faster with two in the std-free one, whose rows
// take their dsums from registers; the std one, whose rows read theirs from
// shared memory there, ran 5% slower with it (tools/ring_variants.py,
// bwd_soft_direct and bwd_soft_bulk_p2).
template <int P, bool kStd>
constexpr bool kBulkStore = !kStd || P == 1;

// Stages of the ring when they carry no features (the std-free backward
// without dprobs): the probs and ids of a tile each, at most this many.
constexpr int kMaxThinStages = 8;

// A backward's ring: tiles of 256 rows, each stage holding their features
// (then their dfeats), their probs a float4 a row (then their dprobs) and,
// with two partitions, their ids, after the coefficients in dynamic shared
// memory: dsums (P*C, F), with the std a and a / W (C, F), and dcounts
// (P*C). The std-free one keeps 2-4 stages (~64 KB of features; 2-5, ~80
// KB, where it stores in bulk), the std one 2-3 (~48 KB). Without features
// the same bytes hold up to kMaxThinStages thin stages of probs and ids.
template <typename T, int F, int P, bool kStd>
struct BwdRing {
  static constexpr int kRowBytes = F * static_cast<int>(sizeof(T));
  static constexpr int kRows = kThreads;
  static constexpr int kFeatBytes = kRows * kRowBytes;
  static constexpr int kProbBytes = kRows * 16;
  static constexpr int kIdBytes = P > 1 ? kRows * 4 : 0;
  static constexpr int kStageBytes = kFeatBytes + kProbBytes + kIdBytes;
  // a bulk store holds its stage until it has read it out: with bulk
  // stores the std-free ring keeps one stage more
  static constexpr int kBudget = kStd ? 49152 : (kBulkStore<P, kStd> ? 81920 : 65536);
  static constexpr int kMaxStages = kStd ? 3 : (kBulkStore<P, kStd> ? 5 : 4);
  static constexpr int kStages =
      kBudget / kFeatBytes < 2 ? 2
                               : (kBudget / kFeatBytes > kMaxStages ? kMaxStages
                                                                    : kBudget / kFeatBytes);
  // without features: a stage's probs and ids, as many as the ring holds
  static constexpr int kThinBytes = kProbBytes + kIdBytes;
  static constexpr int kThinFit = kStages * kStageBytes / kThinBytes;
  static constexpr int kThinStages = kThinFit < kMaxThinStages ? kThinFit : kMaxThinStages;
  static constexpr int kBarriers = kStages > kThinStages ? kStages : kThinStages;
  static constexpr int kDcntAt = P * slcl::kC * F + (kStd ? 2 * slcl::kC * F : 0);
  static constexpr int kCoefPad = ((kDcntAt + P * slcl::kC) * 4 + 127) / 128 * 128;
  static constexpr int kSmemBytes = kCoefPad + kStages * kStageBytes + 2 * kBarriers * 8;
  static_assert(kRowBytes % 16 == 0, "bulk copies of whole rows");
};

template <typename T, int F, int P>
using BwdTiles = BwdRing<T, F, P, false>;
template <typename T, int F, int P>
using BwdStdTiles = BwdRing<T, F, P, true>;

// The std-free backward's coefficients, once a block, in shared memory:
// dsums = dcents / (counts + 1e-7), and dcounts = -sum_f dcents * cents /
// (counts + 1e-7), a thread each over f ascending.
template <int F, int P, int C>
__device__ __forceinline__ void bwd_coefs(const float* __restrict__ dcents,
                                          const float* __restrict__ cents,
                                          const float* __restrict__ counts, float* s_dsum,
                                          float* s_dcnt) {
  constexpr int NPC = P * C;
  for (int i = threadIdx.x; i < NPC * F; i += kThreads) {
    float d = dcents[i];
    s_dsum[i] = d / (counts[i / F] + 1e-7f);
  }
  for (int i = threadIdx.x; i < NPC; i += kThreads) {
    float v = 0.f;
    for (int f = 0; f < F; ++f) {
      float d = dcents[i * F + f];
      v = fmaf(d, cents[i * F + f], v);
    }
    s_dcnt[i] = -v / (counts[i] + 1e-7f);
  }
  __syncthreads();
}

// One row of the std-free backward on its thread's 8 features x (zeros when
// the features are not read): dx = sum_c w[c] ds[c] over c ascending,
// handed to store_x before the dprobs are folded; with dprobs, on the row's
// first thread, dp = (dw + dcount) * certain * in_part, dw the dot of ds[c]
// with x over the thread's features folded over the row's threads by xor
// shuffles. ds: the dsums of the row's partition at the thread's features,
// picked from dsr, every partition's there in registers (6-9% faster than
// reading the row's from shared memory with one partition, as fast with
// two; tools/ring_variants.py, bwd_soft_dsum_smem). Every thread of the
// warp must call it.
template <int F, int P, int C, typename StoreX>
__device__ __forceinline__ void bwd_row(const float (&x)[8], const float4& pv, int id,
                                        float thd, int use_thd, int weighted,
                                        const float (&dsr)[P * C][8], const float* s_dcnt,
                                        int sub, bool with_dprobs,
                                        StoreX&& store_x, float4& dp) {
  constexpr int TPR = F / 8;
  const float p[C] = {pv.x, pv.y, pv.z, pv.w};
  float w[C], cert, in_part;
  int part;
  weights_of<P, C>(p, id, thd, use_thd, weighted, w, cert, in_part, part);
  float dx[8], dw[C];
#pragma unroll
  for (int j = 0; j < 8; ++j) dx[j] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float ds[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ds[j] = dsr[c][j];
#pragma unroll
      for (int pp = 1; pp < P; ++pp)
        if (part == pp) ds[j] = dsr[pp * C + c][j];
    }
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dx[j] = fmaf(w[c], ds[j], dx[j]);
      v = fmaf(ds[j], x[j], v);
    }
    dw[c] = v;
  }
  store_x(dx);
  if (with_dprobs) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) dw[c] += __shfl_xor_sync(0xffffffffu, dw[c], off);
    if (sub == 0) {
      const float* dc = s_dcnt + part * C;
      dp = make_float4((dw[0] + dc[0]) * cert * in_part, (dw[1] + dc[1]) * cert * in_part,
                       (dw[2] + dc[2]) * cert * in_part, (dw[3] + dc[3]) * cert * in_part);
    }
  }
}

// The std backward's coefficients, once a block, in shared memory: a and
// a / W, the dsums with dcents[0] -= 2 a cents[0], and the dcounts with
// - sum_f a S2 / W^2 (a warp each, its lanes over the features).
template <int F, int P, int C>
__device__ __forceinline__ void std_bwd_coefs(const float* __restrict__ dcents,
                                              const float* __restrict__ cents,
                                              const float* __restrict__ counts,
                                              const float* __restrict__ gstd,
                                              const float* __restrict__ s2,
                                              const float* __restrict__ stdv, float* s_dsum,
                                              float* s_a, float* s_aw, float* s_dcnt) {
  constexpr int NPC = P * C;
  static_assert(NPC <= kWarps, "a warp per dcount");
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
  for (int i = threadIdx.x; i < NPC * F; i += kThreads) {
    float d = dcents[i];
    if (i < C * F) d = fmaf(-2.f * s_a[i], cents[i], d);
    s_dsum[i] = d / (counts[i / F] + 1e-7f);
  }
  const int lane = threadIdx.x % 32, i = threadIdx.x / 32;
  if (i < NPC) {
    const int c = i % C;
    float v = 0.f, b = 0.f;
    for (int f = lane; f < F; f += 32) {
      float d = dcents[i * F + f];
      if (i < C) d = fmaf(-2.f * s_a[i * F + f], cents[i * F + f], d);
      v = fmaf(d, cents[i * F + f], v);
      b = fmaf(s_a[c * F + f], s2[c * F + f], b);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      const float wk = weight_total<P, C>(counts, c);
      s_dcnt[i] = -v / (counts[i] + 1e-7f) - b / (wk * wk);
    }
  }
  __syncthreads();
}

// One row of the std backward on its thread's 8 features x, in one pass
// over them: dx = sum_c w ds + 2 x sum_c w a / W, handed to store_x; then
// with dprobs the C partials sum_f ds x + a / W x^2, folded over the row's
// threads, and (dw + dcount) * certain * in_part on the row's first thread
// (dp). aw: a / W at the thread's features; dsr: at P = 1 the dsums there
// (at P = 2 they are read from s_dsum, two float4 a class). Every thread
// of the warp must call it.
template <int F, int P, int C, typename StoreX>
__device__ __forceinline__ void std_bwd_row(const float (&x)[8], const float4& pv, int id,
                                            float thd, int use_thd, int weighted,
                                            const float (&aw)[C][8],
                                            const float (&dsr)[P == 1 ? C : 1][8],
                                            const float* s_dsum, const float* s_dcnt,
                                            int sub, bool with_dprobs, StoreX&& store_x,
                                            float4& dp) {
  constexpr int TPR = F / 8;
  const float p[C] = {pv.x, pv.y, pv.z, pv.w};
  float w[C], cert, in_part;
  int part;
  weights_of<P, C>(p, id, thd, use_thd, weighted, w, cert, in_part, part);
  float dx[8], dw[C];
  if constexpr (P == 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) dw[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float x2 = x[k] * x[k];
      float v = 0.f, u = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v = fmaf(w[c], dsr[c][k], v);
        u = fmaf(w[c], aw[c][k], u);
        dw[c] = fmaf(dsr[c][k], x[k], dw[c]);
        dw[c] = fmaf(aw[c][k], x2, dw[c]);
      }
      dx[k] = fmaf(2.f * x[k], u, v);
    }
  } else {
    float u[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) dx[k] = u[k] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float ds[8];
      slcl::load8(s_dsum + (part * C + c) * F + sub * 8, ds);
      float d = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        dx[k] = fmaf(w[c], ds[k], dx[k]);
        u[k] = fmaf(w[c], aw[c][k], u[k]);
        d = fmaf(ds[k], x[k], d);
        d = fmaf(aw[c][k], x[k] * x[k], d);
      }
      dw[c] = d;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) dx[k] = fmaf(2.f * x[k], u[k], dx[k]);
  }
  store_x(dx);
  if (with_dprobs) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) dw[c] += __shfl_xor_sync(0xffffffffu, dw[c], off);
    if (sub == 0) {
      const float g = cert * in_part;
      const float* dc = s_dcnt + part * C;
      dp = make_float4((dw[0] + dc[0]) * g, (dw[1] + dc[1]) * g, (dw[2] + dc[2]) * g,
                       (dw[3] + dc[3]) * g);
    }
  }
}

// The backward, std-free or std (kStd): a persistent grid over 256-row
// tiles fed by the ring. Thread 0 fills the stages (ids in whole groups of
// four rows; a ragged tile's last 1-3 ids are read from memory) as soon as
// the barriers exist, while the block forms its coefficients. Without
// dprobs the std-free backward reads no features: its stages are thin,
// probs and ids alone, and more of them. The threads take their rows from
// the stage a pass at a time (F/8 threads a row, 8 features each). With a
// bulk store (kBulkStore: the std-free backward with dprobs, the std one
// at P = 1) they write dfeats over the row's features and dprobs over its
// probs, each warp fences its writes for the async proxy before it arrives
// on the stage's empty barrier, and thread 0 then stores the tile with one
// bulk copy each for dfeats and dprobs and waits until the store has read
// the stage before it fills the stage again. Otherwise each thread stores its dfeats (16
// bytes) and the row's first thread its dprobs (a float4) directly.
template <typename T, int F, int P, int C, bool kStd>
__device__ __forceinline__ void bwd_ring(const T* __restrict__ feats,
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
  static_assert(C == 4, "a row's probs and dprobs are one float4");
  using G = BwdRing<T, F, P, kStd>;
  constexpr int TPR = F / 8;
  constexpr int RPB = kThreads / TPR;
  constexpr int NPC = P * C;
  constexpr bool kAllFeats = kStd;   // the std's dfeats need the features
  constexpr int kDsr = kStd ? (P == 1 ? C : 1) : P * C;
  constexpr int kAw = kStd ? C : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_dsum = reinterpret_cast<float*>(smem);
  float* s_dcnt = s_dsum + G::kDcntAt;
  unsigned char* ring = smem + G::kCoefPad;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::kStages * G::kStageBytes);
  uint64_t* empty = full + G::kBarriers;
  const int ntiles = (M + G::kRows - 1) / G::kRows;
  const int lane = threadIdx.x % 32;
  const bool with_dprobs = dprobs != nullptr;
  const bool read_feats = kAllFeats || with_dprobs;
  const bool bulk = kBulkStore<P, kStd> && with_dprobs;
  // a stage: its features (when read or written there), then its probs,
  // then its ids
  const bool thin = !read_feats && !bulk;
  const int nstages = thin ? G::kThinStages : G::kStages;
  const int stage_bytes = thin ? G::kThinBytes : G::kStageBytes;
  const int prob_at = thin ? 0 : G::kFeatBytes;
  auto fill = [&](int stage, int tile) {
    const int row0 = tile * G::kRows;
    const int rows = min(G::kRows, M - row0);
    unsigned char* st = ring + stage * stage_bytes;
    const uint32_t fbytes = read_feats ? rows * G::kRowBytes : 0;
    const uint32_t pbytes = rows * 16;
    const uint32_t ibytes = P > 1 ? (rows & ~3) * 4 : 0;
    slcl::mbar_expect_tx(&full[stage], fbytes + pbytes + ibytes);
    if (fbytes) slcl::bulk_copy(st, feats + (size_t)row0 * F, fbytes, &full[stage]);
    slcl::bulk_copy(st + prob_at, probs + (size_t)row0 * C, pbytes, &full[stage]);
    if (ibytes)
      slcl::bulk_copy(st + prob_at + G::kProbBytes, assign + row0, ibytes, &full[stage]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < nstages; ++s) {
      slcl::mbar_init(&full[s], 1);
      slcl::mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < nstages; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < ntiles) fill(s, tile);
    }
  }
  const int sub = threadIdx.x % TPR;
  const int r = threadIdx.x / TPR;
  // the same for every row, in registers: the dsums at this thread's
  // features (std: at P = 1 only) and the std's a / W there
  float dsr[kDsr][8];
  float aw[kAw][8];
  if constexpr (kStd) {
    float* s_a = s_dsum + NPC * F;
    float* s_aw = s_a + C * F;
    std_bwd_coefs<F, P, C>(dcents, cents, counts, gstd, s2, stdv, s_dsum, s_a, s_aw, s_dcnt);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      slcl::load8(s_aw + c * F + sub * 8, aw[c]);
      if constexpr (P == 1) slcl::load8(s_dsum + c * F + sub * 8, dsr[c]);
    }
  } else {
    bwd_coefs<F, P, C>(dcents, cents, counts, s_dsum, s_dcnt);
#pragma unroll
    for (int i = 0; i < NPC; ++i) slcl::load8(s_dsum + i * F + sub * 8, dsr[i]);
  }
  int stage = 0;
  uint32_t parity = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * G::kRows;
    const int rows = min(G::kRows, M - row0);
    slcl::mbar_wait(&full[stage], parity);
    unsigned char* st = ring + stage * stage_bytes;
    T* s_feat = reinterpret_cast<T*>(st);
    float4* s_prob = reinterpret_cast<float4*>(st + prob_at);
    const int* s_id = reinterpret_cast<const int*>(st + prob_at + G::kProbBytes);
#pragma unroll 1
    for (int q = 0; q < G::kRows / RPB; ++q) {
      const int rr = q * RPB + r;
      const bool valid = rr < rows;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float4 pv = make_float4(0.f, 0.f, 0.f, 0.f);
      int id = 0;
      if (valid) {
        if (read_feats) slcl::load8(s_feat + rr * F + sub * 8, x);
        pv = s_prob[rr];
        if constexpr (P > 1) id = rr < (rows & ~3) ? s_id[rr] : __ldg(assign + row0 + rr);
      }
      // dfeats as soon as it is known: over the thread's own features in
      // the stage, or to memory
      auto store_x = [&](const float (&dx)[8]) {
        if (!valid) return;
        if (bulk) slcl::store8(s_feat + rr * F + sub * 8, dx);
        else slcl::store8(dfeats + (size_t)(row0 + rr) * F + sub * 8, dx);
      };
      float4 dp = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kStd) {
        std_bwd_row<F, P, C>(x, pv, id, thd, use_thd, weighted, aw, dsr, s_dsum, s_dcnt, sub,
                             with_dprobs, store_x, dp);
      } else {
        bwd_row<F, P, C>(x, pv, id, thd, use_thd, weighted, dsr, s_dcnt, sub, with_dprobs,
                         store_x, dp);
      }
      if (bulk) {
        __syncwarp();   // every thread of the row has read its probs
        if (valid && sub == 0) s_prob[rr] = dp;
      } else if (with_dprobs && valid && sub == 0) {
        reinterpret_cast<float4*>(dprobs)[row0 + rr] = dp;
      }
    }
    if (bulk) slcl::fence_proxy_async();
    __syncwarp();
    if (lane == 0) slcl::mbar_arrive(&empty[stage]);
    if (threadIdx.x == 0) {
      const int next = tile + nstages * gridDim.x;
      if (bulk) {
        slcl::mbar_wait(&empty[stage], parity);
        slcl::bulk_store(dfeats + (size_t)row0 * F, st, rows * G::kRowBytes);
        if (with_dprobs) slcl::bulk_store(dprobs + (size_t)row0 * C, s_prob, rows * 16);
        slcl::bulk_commit();
        if (next < ntiles) {
          slcl::bulk_wait_read<0>();   // the store has read the stage
          fill(stage, next);
        }
      } else if (next < ntiles) {
        slcl::mbar_wait(&empty[stage], parity);
        fill(stage, next);
      }
    }
    if (++stage == nstages) {
      stage = 0;
      parity ^= 1u;
    }
  }
  // the block's shared memory must outlive its last stores
  if (bulk && threadIdx.x == 0) slcl::bulk_wait_all();
}

// The std-free backward: dfeats, and with soft weights dprobs.
template <typename T, int F, int P, int C>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
centroids_bwd(const T* __restrict__ feats, const float* __restrict__ probs,
              const int* __restrict__ assign, int M, float thd, int use_thd,
              int weighted, const float* __restrict__ dcents,
              const float* __restrict__ cents, const float* __restrict__ counts,
              T* __restrict__ dfeats, float* __restrict__ dprobs) {
  bwd_ring<T, F, P, C, false>(feats, probs, assign, M, thd, use_thd, weighted, dcents, cents,
                              counts, dfeats, dprobs, nullptr, nullptr, nullptr);
}

// The std backward: the same with the std's terms.
template <typename T, int F, int P, int C>
__global__ void __launch_bounds__(kThreads, kBwdStdBlocksPerSM)
centroids_bwd_std(const T* __restrict__ feats, const float* __restrict__ probs,
                  const int* __restrict__ assign, int M, float thd, int use_thd,
                  int weighted, const float* __restrict__ dcents,
                  const float* __restrict__ cents, const float* __restrict__ counts,
                  T* __restrict__ dfeats, float* __restrict__ dprobs,
                  const float* __restrict__ gstd, const float* __restrict__ s2,
                  const float* __restrict__ stdv) {
  bwd_ring<T, F, P, C, true>(feats, probs, assign, M, thd, use_thd, weighted, dcents, cents,
                             counts, dfeats, dprobs, gstd, s2, stdv);
}

// The backwards' persistent grids.
template <typename T, int F, int P>
int bwd_grid_of(int M, int* g) {
  return slcl::ring_grid<BwdTiles<T, F, P>, centroids_bwd<T, F, P, slcl::kC>>(M, g);
}

template <typename T, int F, int P>
int std_bwd_grid_of(int M, int* g) {
  return slcl::ring_grid<BwdStdTiles<T, F, P>, centroids_bwd_std<T, F, P, slcl::kC>>(M, g);
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

// The streaming pass alone; *nparts = its blocks (the partials it wrote).
template <typename T>
int launch_partial(const void* feats, const float* probs, const int* assign, int M,
                   int F, int P, float thd, int use_thd, int weighted, int with_std,
                   float* partials, int* nparts, cudaStream_t st) {
  SLCL_DISPATCH_F(F, SLCL_DISPATCH_P(P, SLCL_DISPATCH_STD(with_std, {
    int grid = 0;
    if constexpr (kS) {
      const int rc = std_fwd_grid_of<T, kF, kP>(M, &grid);
      if (rc != 0) return rc;
      constexpr int kSmem = StdFwdRing<T, kF, kP>::kSmemBytes;
      centroids_fwd_std_partial<T, kF, kP, kC><<<grid, kThreads, kSmem, st>>>(
          static_cast<const T*>(feats), probs, assign, M, thd, use_thd, weighted, partials);
    } else {
      const int rc = fwd_grid_of<T, kF, kP>(M, &grid);
      if (rc != 0) return rc;
      centroids_fwd_partial<T, kF, kP, kC><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(feats), probs, assign, M, thd, use_thd, weighted, partials);
    }
    *nparts = grid;
  })));
  return static_cast<int>(cudaGetLastError());
}

// The final pass over nparts blocks' partials of M rows in all.
int launch_final(const float* partials, int nparts, int M, int F, int P, float* cents,
                 float* counts, float* ratio, float* s2, float* stdv, cudaStream_t st) {
  SLCL_DISPATCH_F(F, SLCL_DISPATCH_P(P, SLCL_DISPATCH_STD(s2 != nullptr, {
    constexpr int kNV = kP * kC * kF + kP * kC + 1;
    constexpr int kBlocks = (kNV + kWarps - 1) / kWarps + (kS ? kC : 0);
    centroids_fwd_final<kF, kP, kC, kS><<<kBlocks, kThreads, 0, st>>>(
        partials, nparts, M, cents, counts, ratio, s2, stdv);
  })));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* feats, const float* probs, const int* assign, int M,
               int F, int P, float thd, int use_thd, int weighted, float* partials,
               float* cents, float* counts, float* ratio, float* s2, float* stdv,
               cudaStream_t st) {
  int grid = 0;
  const int rc = launch_partial<T>(feats, probs, assign, M, F, P, thd, use_thd, weighted,
                                   s2 != nullptr, partials, &grid, st);
  if (rc != 0) return rc;
  return launch_final(partials, grid, M, F, P, cents, counts, ratio, s2, stdv, st);
}

template <typename T>
int fwd_grid(int M, int F, int P, int with_std, int* grid) {
  SLCL_DISPATCH_F(F, SLCL_DISPATCH_P(P, SLCL_DISPATCH_STD(with_std, {
    if constexpr (kS) return std_fwd_grid_of<T, kF, kP>(M, grid);
    else return fwd_grid_of<T, kF, kP>(M, grid);
  })));
  return -1;
}

template <typename T>
int launch_bwd(const void* feats, const float* probs, const int* assign, int M,
               int F, int P, float thd, int use_thd, int weighted,
               const float* dcents, const float* cents, const float* counts,
               void* dfeats, float* dprobs, const float* gstd, const float* s2,
               const float* stdv, cudaStream_t st) {
  SLCL_DISPATCH_F(F, SLCL_DISPATCH_P(P, SLCL_DISPATCH_STD(gstd != nullptr, {
    int grid = 0;
    if constexpr (!kS) {
      const int rc = bwd_grid_of<T, kF, kP>(M, &grid);
      if (rc != 0) return rc;
      constexpr int kSmem = BwdTiles<T, kF, kP>::kSmemBytes;
      centroids_bwd<T, kF, kP, kC><<<grid, kThreads, kSmem, st>>>(
          static_cast<const T*>(feats), probs, assign, M, thd, use_thd, weighted,
          dcents, cents, counts, static_cast<T*>(dfeats), dprobs);
    } else {
      const int rc = std_bwd_grid_of<T, kF, kP>(M, &grid);
      if (rc != 0) return rc;
      constexpr int kSmem = BwdStdTiles<T, kF, kP>::kSmemBytes;
      centroids_bwd_std<T, kF, kP, kC><<<grid, kThreads, kSmem, st>>>(
          static_cast<const T*>(feats), probs, assign, M, thd, use_thd, weighted,
          dcents, cents, counts, static_cast<T*>(dfeats), dprobs, gstd, s2, stdv);
    }
  })));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy_of(int bwd, int F, int P, int with_std, int* blocks_per_sm,
                 int* smem_bytes) {
  SLCL_DISPATCH_F(F, SLCL_DISPATCH_P(P, SLCL_DISPATCH_STD(with_std, {
    if constexpr (kS) {
      if (!bwd)
        return slcl::occupancy(centroids_fwd_std_partial<T, kF, kP, kC>,
                               StdFwdRing<T, kF, kP>::kSmemBytes, blocks_per_sm, smem_bytes);
      return slcl::occupancy(centroids_bwd_std<T, kF, kP, kC>,
                             BwdStdTiles<T, kF, kP>::kSmemBytes, blocks_per_sm, smem_bytes);
    } else {
      if (!bwd)
        return slcl::occupancy(centroids_fwd_partial<T, kF, kP, kC>, 0, blocks_per_sm,
                               smem_bytes);
      return slcl::occupancy(centroids_bwd<T, kF, kP, kC>, BwdTiles<T, kF, kP>::kSmemBytes,
                             blocks_per_sm, smem_bytes);
    }
  })));
  return -1;
}

// ---- the general family (centroids_gen.cuh): any C, P and F ----

// The general forward's instantiation of a plan: its form (kForm), from
// gen_fwd_plan (centroids_gen_plan.cuh)
#define SLCL_GEN_FWD_FORM(plan, ...)                                                        \
  if ((plan).form == slcl::kGenFwdRing) {                                                  \
    constexpr int kForm = slcl::kGenFwdRing; __VA_ARGS__;                                 \
  } else if ((plan).form == slcl::kGenFwdNarrow) {                                         \
    constexpr int kForm = slcl::kGenFwdNarrow; __VA_ARGS__;                               \
  } else {                                                                                 \
    constexpr int kForm = slcl::kGenFwdGrouped; __VA_ARGS__;                              \
  }

// The general forward's grid: the ring forms' persistent grid from
// ring_grid (tiles of plan.rows rows at the plan's shared memory), capped
// as the templated forwards' at kMaxBlocks; the grouped form's gen_grid, a
// group a row.
template <typename T, bool kS, int kForm>
int gen_fwd_grid(const slcl::GenFwdPlan& plan, int M, int F, int* grid) {
  if constexpr (kForm != slcl::kGenFwdGrouped) {
    const int rc = slcl::ring_grid<slcl::centroids_gen_fwd_partial<T, kS, kForm>>(
        M, plan.rows, plan.smem, grid);
    if (rc == 0 && *grid > slcl::kMaxBlocks) *grid = slcl::kMaxBlocks;
    return rc;
  } else {
    *grid = slcl::gen_grid(M, slcl::gen_cent_groups(F));
    return slcl::gen_prepare<slcl::centroids_gen_fwd_partial<T, kS, kForm>>(plan.smem);
  }
}

template <typename T>
int gen_launch_partial(const void* feats, const float* probs, const int* assign, int M, int F,
                       int C, int P, float thd, int use_thd, int weighted, int with_std,
                       float* partials, int* nparts, cudaStream_t st) {
  SLCL_DISPATCH_STD(with_std, {
    const slcl::GenFwdPlan plan = slcl::gen_fwd_plan(C, P, F, kS, sizeof(T));
    SLCL_GEN_FWD_FORM(plan, {
      int grid = 0;
      const int rc = gen_fwd_grid<T, kS, kForm>(plan, M, F, &grid);
      if (rc != 0) return rc;
      slcl::centroids_gen_fwd_partial<T, kS, kForm><<<grid, kThreads, plan.smem, st>>>(
          static_cast<const T*>(feats), probs, assign, M, F, C, P, thd, use_thd, weighted,
          partials, plan);
      *nparts = grid;
      return static_cast<int>(cudaGetLastError());
    });
  });
  return -1;
}

// The floats of the general forward's partial buffer: values a block x the
// blocks of its grid on the current device.
template <typename T>
int gen_partials_size(int M, int F, int C, int P, int with_std, int* n) {
  SLCL_DISPATCH_STD(with_std, {
    const slcl::GenFwdPlan plan = slcl::gen_fwd_plan(C, P, F, kS, sizeof(T));
    SLCL_GEN_FWD_FORM(plan, {
      int grid = 0;
      const int rc = gen_fwd_grid<T, kS, kForm>(plan, M, F, &grid);
      if (rc != 0) return rc;
      const long long size =
          static_cast<long long>(slcl::gen_cent_values(C, P, F, kS)) * grid;
      if (size > 0x7fffffffLL) return -1;
      *n = static_cast<int>(size);
      return 0;
    });
  });
  return -1;
}

int gen_launch_final(const float* partials, int nparts, int M, int F, int C, int P,
                     float* cents, float* counts, float* ratio, float* s2, float* stdv,
                     cudaStream_t st) {
  const int nv = slcl::gen_cent_values(C, P, F, false);
  const int blocks = (nv + slcl::kGenWarps - 1) / slcl::kGenWarps;
  SLCL_DISPATCH_STD(s2 != nullptr, {
    const int smem = kS ? slcl::gen_cent_final_smem(P, F) : 0;
    const int rc = slcl::gen_prepare<slcl::centroids_gen_fwd_final<kS>>(smem);
    if (rc != 0) return rc;
    slcl::centroids_gen_fwd_final<kS><<<blocks + (kS ? C : 0), kThreads, smem, st>>>(
        partials, nparts, M, F, C, P, cents, counts, ratio, s2, stdv);
  });
  return static_cast<int>(cudaGetLastError());
}

// The general backward's instantiation of a plan: its form (kForm) and
// the features a chunk owns (kV), from gen_bwd_plan (centroids_gen_plan.cuh)
#define SLCL_GEN_BWD_FORM(plan, ...)                                                        \
  if ((plan).form == slcl::kGenDirect) {                                                   \
    constexpr int kV = 1, kForm = slcl::kGenDirectRows; __VA_ARGS__;                      \
  } else if ((plan).V == 8 && (plan).regs) {                                               \
    constexpr int kV = 8, kForm = slcl::kGenRegCoefs; __VA_ARGS__;                        \
  } else if ((plan).V == 8) {                                                              \
    constexpr int kV = 8, kForm = slcl::kGenSmemCoefs; __VA_ARGS__;                       \
  } else if ((plan).V == 4) {                                                              \
    constexpr int kV = 4, kForm = slcl::kGenSmemCoefs; __VA_ARGS__;                       \
  } else {                                                                                 \
    constexpr int kV = 1, kForm = slcl::kGenSmemCoefs; __VA_ARGS__;                       \
  }

// One general backward launch: its persistent grid from ring_grid (a tile
// of plan.rows rows, or a thread a row in the direct form) at the plan's
// shared memory.
template <typename T, bool kS, int kV, int kForm>
int gen_bwd_launch(const slcl::GenBwdPlan& plan, const void* feats, const float* probs,
                   const int* assign, int M, int F, int C, int P, float thd, int use_thd,
                   int weighted, const float* dcents, const float* cents, const float* counts,
                   void* dfeats, float* dprobs, const float* gstd, const float* s2,
                   const float* stdv, cudaStream_t st) {
  int grid = 0;
  const int rc = slcl::ring_grid<slcl::centroids_gen_bwd<T, kS, kV, kForm>>(
      M, plan.rows, plan.smem, &grid);
  if (rc != 0) return rc;
  slcl::centroids_gen_bwd<T, kS, kV, kForm><<<grid, kThreads, plan.smem, st>>>(
      static_cast<const T*>(feats), probs, assign, M, F, C, P, thd, use_thd, weighted, dcents,
      cents, counts, static_cast<T*>(dfeats), dprobs, gstd, s2, stdv, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gen_launch_bwd(const void* feats, const float* probs, const int* assign, int M, int F,
                   int C, int P, float thd, int use_thd, int weighted, const float* dcents,
                   const float* cents, const float* counts, void* dfeats, float* dprobs,
                   const float* gstd, const float* s2, const float* stdv, cudaStream_t st) {
  SLCL_DISPATCH_STD(gstd != nullptr, {
    const slcl::GenBwdPlan plan = slcl::gen_bwd_plan(C, P, F, kS, sizeof(T), dprobs != nullptr);
    SLCL_GEN_BWD_FORM(plan, {
      return gen_bwd_launch<T, kS, kV, kForm>(plan, feats, probs, assign, M, F, C, P, thd,
                                              use_thd, weighted, dcents, cents, counts, dfeats,
                                              dprobs, gstd, s2, stdv, st);
    });
  });
  return -1;
}

template <typename T>
int gen_occupancy_of(int bwd, int F, int C, int P, int with_std, int with_dprobs,
                     int* blocks_per_sm, int* smem_bytes) {
  SLCL_DISPATCH_STD(with_std, {
    if (bwd) {
      const slcl::GenBwdPlan plan = slcl::gen_bwd_plan(C, P, F, kS, sizeof(T), with_dprobs);
      SLCL_GEN_BWD_FORM(plan, {
        return slcl::gen_occupancy<slcl::centroids_gen_bwd<T, kS, kV, kForm>>(
            plan.smem, blocks_per_sm, smem_bytes);
      });
    }
    const slcl::GenFwdPlan plan = slcl::gen_fwd_plan(C, P, F, kS, sizeof(T));
    SLCL_GEN_FWD_FORM(plan, {
      return slcl::gen_occupancy<slcl::centroids_gen_fwd_partial<T, kS, kForm>>(
          plan.smem, blocks_per_sm, smem_bytes);
    });
  });
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

// The forward in two calls, for a caller that sums the partials of several
// processes in between (data parallelism): the streaming pass (*nparts =
// the blocks whose partials it wrote; the same on every process for the
// same M and card), then the final pass over nparts blocks' partials with M
// the rows of all processes. Together they give soft_centroids_fwd.
int soft_centroids_fwd_partial(const void* feats, int feats_bf16, const void* probs,
                               const void* assign, int M, int F, int C, int P,
                               float threshold, int weighted, int with_std, void* partials,
                               int* nparts, void* stream) {
  if (C != kC) return -1;
  const int use_thd = threshold > 0.f && threshold < 1.f;
  auto st = static_cast<cudaStream_t>(stream);
  auto pr = static_cast<const float*>(probs);
  auto as = static_cast<const int*>(assign);
  auto pt = static_cast<float*>(partials);
  return feats_bf16
             ? launch_partial<__nv_bfloat16>(feats, pr, as, M, F, P, threshold, use_thd,
                                             weighted, with_std, pt, nparts, st)
             : launch_partial<float>(feats, pr, as, M, F, P, threshold, use_thd, weighted,
                                     with_std, pt, nparts, st);
}

int soft_centroids_fwd_final(const void* partials, int nparts, int M, int F, int C, int P,
                             void* cents, void* counts, void* ratio, void* s2, void* stdv,
                             void* stream) {
  if (C != kC || (s2 == nullptr) != (stdv == nullptr)) return -1;
  return launch_final(static_cast<const float*>(partials), nparts, M, F, P,
                      static_cast<float*>(cents), static_cast<float*>(counts),
                      static_cast<float*>(ratio), static_cast<float*>(s2),
                      static_cast<float*>(stdv), static_cast<cudaStream_t>(stream));
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

// ---- the general family: the same calls at any C, P >= 1 and F >= 1;
// -1 where a kernel's shared memory (centroids_gen_plan.cuh: gen_fwd_plan,
// gen_bwd_plan; centroids_gen.cuh: gen_cent_final_smem) does not fit a
// block of this device ----

int soft_centroids_gen_partials_size(int feats_bf16, int M, int F, int P, int C, int with_std,
                                     int* n) {
  if (C < 1 || P < 1 || F < 1) return -1;
  return feats_bf16 ? gen_partials_size<__nv_bfloat16>(M, F, C, P, with_std, n)
                    : gen_partials_size<float>(M, F, C, P, with_std, n);
}

int soft_centroids_gen_fwd_partial(const void* feats, int feats_bf16, const void* probs,
                                   const void* assign, int M, int F, int C, int P,
                                   float threshold, int weighted, int with_std, void* partials,
                                   int* nparts, void* stream) {
  if (C < 1 || P < 1 || F < 1) return -1;
  const int use_thd = threshold > 0.f && threshold < 1.f;
  auto st = static_cast<cudaStream_t>(stream);
  auto pr = static_cast<const float*>(probs);
  auto as = static_cast<const int*>(assign);
  auto pt = static_cast<float*>(partials);
  return feats_bf16 ? gen_launch_partial<__nv_bfloat16>(feats, pr, as, M, F, C, P, threshold,
                                                        use_thd, weighted, with_std, pt,
                                                        nparts, st)
                    : gen_launch_partial<float>(feats, pr, as, M, F, C, P, threshold,
                                                use_thd, weighted, with_std, pt, nparts, st);
}

int soft_centroids_gen_fwd_final(const void* partials, int nparts, int M, int F, int C, int P,
                                 void* cents, void* counts, void* ratio, void* s2, void* stdv,
                                 void* stream) {
  if (C < 1 || P < 1 || F < 1 || (s2 == nullptr) != (stdv == nullptr)) return -1;
  return gen_launch_final(static_cast<const float*>(partials), nparts, M, F, C, P,
                          static_cast<float*>(cents), static_cast<float*>(counts),
                          static_cast<float*>(ratio), static_cast<float*>(s2),
                          static_cast<float*>(stdv), static_cast<cudaStream_t>(stream));
}

int soft_centroids_gen_bwd(const void* feats, int feats_bf16, const void* probs,
                           const void* assign, int M, int F, int C, int P, float threshold,
                           int weighted, const void* dcents, const void* cents,
                           const void* counts, void* dfeats, void* dprobs, const void* dstd,
                           const void* s2, const void* stdv, void* stream) {
  if (C < 1 || P < 1 || F < 1 || (dstd != nullptr && (s2 == nullptr || stdv == nullptr)))
    return -1;
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
             ? gen_launch_bwd<__nv_bfloat16>(feats, pr, as, M, F, C, P, threshold, use_thd,
                                             weighted, dc, ce, co, dfeats, dp, gs, q, sd, st)
             : gen_launch_bwd<float>(feats, pr, as, M, F, C, P, threshold, use_thd, weighted,
                                     dc, ce, co, dfeats, dp, gs, q, sd, st);
}

// Blocks per SM and shared memory per block of the general forward's
// streaming kernel (bwd = 0) or backward (bwd = 1) at (C, P, F, std); the
// backward's form and shared memory also depend on whether it takes dprobs.
int soft_centroids_gen_occupancy(int bwd, int feats_bf16, int F, int C, int P, int with_std,
                                 int with_dprobs, int* blocks_per_sm, int* smem_bytes) {
  if (C < 1 || P < 1 || F < 1) return -1;
  return feats_bf16
             ? gen_occupancy_of<__nv_bfloat16>(bwd, F, C, P, with_std, with_dprobs,
                                               blocks_per_sm, smem_bytes)
             : gen_occupancy_of<float>(bwd, F, C, P, with_std, with_dprobs, blocks_per_sm,
                                       smem_bytes);
}

}  // extern "C"
