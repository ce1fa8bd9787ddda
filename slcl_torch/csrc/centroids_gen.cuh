// The general (runtime-shape) family of the soft centroids, for Hopper
// (sm_90a): forward (with or without MCCL's stddevs), its final pass, and
// the backward, at any class count C, partition count P and feature width
// F, all given at run time. As the templated kernels of soft_centroids.cu
// do, it replaces
// slcl_tpu/ops/pallas/centroid_kernel.py::soft_centroids_fused, whose
// kernel loops `for p in range(P)` over a block of the whole C and F (its
// backward, jnp autodiff, too); the wrappers route a shape here unless C = 4,
// P <= 2 and F is one of 8, 16, 32, 64 (slcl_torch/ops/cuda/__init__.py::
// route). The functions are soft_centroids.cu's (its header states them):
// weights w = probs (soft) or onehot(first argmax) (hard), times certain
// (max prob >= thd when 0 < thd < 1) and times whether the row's partition
// id lies in [0, P); per partition the sums of w * feats and of w, the
// certain rows, and with the std the sums of w * feats^2 over all
// partitions; cents = sums / (counts + 1e-7); std = sqrt(mean_f max(S2 / W -
// cents[0]^2, 0) + 1e-7).
//
// Design.
// - Forward (centroids_gen_fwd_partial): bound by bytes (each element read
//   once, 2 bytes in bf16) but with P*C weighted sums an element, plus C
//   for S2: at P = 4, C = 5 with the std 25 multiply-adds a 2-byte
//   feature, more than the CUDA cores give at the memory rate. So the sums
//   are a product on the tensor cores: a tile's sums are X^T W, W (rows,
//   P*C + ...) holding each row's weights in its partition's columns and
//   zeros elsewhere, so P costs padding, not multiply-adds. Every product
//   is exact: a weight is three bf16 terms (hi + mid + lo = w), a bf16
//   feature one, its square two (f32 features three, their squares
//   three), and each k-step's products are added from zero and then to
//   f32 totals on the CUDA cores, so only the order of the sums differs
//   from the plain version's. The counts and the certain rows are the
//   product of a row of ones (feature F) with the same columns. Rows come
//   through a bulk-copy ring (ring.cuh) on a persistent grid (ring_grid);
//   one thread a row turns its probs and id into its weights once, into a
//   table the product reads with ldmatrix. The launch plan
//   (centroids_gen_plan.cuh, gen_fwd_plan) sets from the shape alone the
//   warps' split of the (m-tile, n-tile) totals, the tile rows, the stages
//   and every table's place; at most 2 x 132 partials a value. Where no
//   ring fits, the grouped form (the first design, groups of F threads a
//   row accumulating in shared memory, 4 * G * (P*C*F + P*C + 1 +
//   std*C*F) bytes, G = max(1, 256 / F)) takes the shape. The block's
//   partial of every value is stored value-major, as the templated
//   forward stores them, so the same final pass and the same data-parallel
//   reduce (a sum of the partials over the ranks) apply.
// - Final pass (centroids_gen_fwd_final): a warp a value, its lanes
//   striding the blocks' partials and a shuffle tree adding the lanes; with
//   the std, C more blocks, one a class, take the class's 2F + P totals the
//   same way, 16 values a warp with their loads in flight together, into
//   shared memory (4 * (2F + P) bytes) and its std.
// - Backward (centroids_gen_bwd): far below the card's ridge (C multiply-
//   adds for dfeats and C for dprobs an element against 4 bytes moved), so
//   bound by bytes in principle; its design is the templated backward's
//   ring (soft_centroids.cu, bwd_ring) at a runtime C, P and F. Its plan
//   (centroids_gen_plan.cuh, gen_bwd_plan) sets, from the shape alone, the
//   features V a thread-chunk owns (8, 4 or 1, the largest that divides F,
//   so a chunk is one vector), the rows R of a tile (8 warps' rows, so
//   every bulk copy starts and ends on 16 bytes), the stages (two) and
//   every table's place. Rows come through a bulk-copy ring on a
//   persistent grid (ring_grid), one copy an array a tile whatever F is.
//   One lane a row turns its probs and id into its weights, partition and
//   g once, into row tables (soft weights without a threshold need no
//   argmax); then a lane keeps one chunk across the rows it takes, with
//   that chunk's dsums (std-free, P = 1, C <= 6) or a / W (the std, C <=
//   5) in registers, and forms dfeats and the row's C partial dot products
//   in one pass over its features; the partials of a row are added in a
//   fixed order by one lane a (row, class): no shuffle a row, and no
//   barrier of the block a tile (each warp takes its own rows). The lanes
//   store dfeats and dprobs directly. dfeats are the first design's bits
//   (the same multiply-adds in the same order); dprobs differ only in the
//   order of the sum over f. Where not even two stages fit under the
//   limit, the direct form (a thread a row straight from memory, the first
//   design's arithmetic) takes the shape with the coefficients alone in
//   shared memory, 4 * (P*C*F + P*C + std*2*C*F).
//   On an NVIDIA H100 80GB HBM3 at 700.00 W (tools/ring_variants.py, bf16,
//   M = 802,816, C = 5): hard, P = 1, F = 24 0.029-0.031 ms (53-56% of its
//   bytes' bound); soft, P = 1, F = 48 0.080-0.081 ms (69%); std, P = 4, F
//   = 48 0.122-0.124 ms (46-47%); the first design took 0.222 / 0.725 /
//   0.797 ms. The std call is held back by its instructions (21 multiply-
//   adds an element, the row's dsums read from shared memory) at 16 warps
//   an SM: the kernel needs ~120 registers a thread, so 2 blocks an SM; at
//   3 it spills.
// Every block's shared memory must fit one block (227 KB on an H100, less
// the kernel's static shared memory); the wrappers check it before a
// launch. The forward's grid is fixed by M, the shape and the card (a
// persistent grid) or by M and F alone (gen_grid, the grouped form); the
// backward's grid does not enter any sum. Every sum is in a fixed order and
// there are no float atomics: two launches give bit-identical results.
#pragma once

#include "centroids_gen_plan.cuh"
#include "common.cuh"
#include "ring.cuh"

namespace slcl {

constexpr int kGenWarps = kThreads / 32;

// Groups of a forward block, and the values of one block's partials: sums
// (P*C*F), counts (P*C), certain rows (1), with the std S2 (C*F).
__host__ __device__ constexpr int gen_cent_groups(int F) {
  return F >= kThreads ? 1 : kThreads / F;
}
__host__ __device__ constexpr int gen_cent_values(int C, int P, int F, bool with_std) {
  return P * C * F + P * C + 1 + (with_std ? C * F : 0);
}
__host__ __device__ constexpr int gen_cent_final_smem(int P, int F) { return 4 * (2 * F + P); }

// One row's weights: first-occurrence argmax am of its C probs, its
// partition (0 for an id outside [0, P)), its certain flag and g = certain
// times whether the id lies in [0, P).
struct GenRow {
  int am, part;
  float cert, g;
};

__device__ __forceinline__ GenRow gen_row_of(const float* p, int C, int id, int P, float thd,
                                             int use_thd) {
  float mx = p[0];
  int am = 0;
  for (int c = 1; c < C; ++c)
    if (p[c] > mx) {
      mx = p[c];
      am = c;
    }
  const float cert = (!use_thd || mx >= thd) ? 1.f : 0.f;
  const bool in_part = id >= 0 && id < P;
  return GenRow{am, in_part ? id : 0, cert, in_part ? cert : 0.f};
}

// w[c] of a row: probs (soft) or onehot(argmax) (hard), times g.
__device__ __forceinline__ float gen_weight(const float* p, int c, const GenRow& r,
                                            int weighted) {
  return (weighted ? p[c] : (c == r.am ? 1.f : 0.f)) * r.g;
}

// Sum of v over the warp's lanes in a fixed shuffle-tree order.
__device__ __forceinline__ float gen_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- the forward's streaming pass ----

// bf16 1.0 in both halves of a register
constexpr uint32_t kBf16Ones = 0x3f803f80u;

// D += A B on the tensor cores: A (16 x 16, row-major) and B (16 x 8,
// column-major) bf16, D (16 x 8) f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives the
// row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Two 8 x 8 bf16 matrices from shared memory: lanes 0-15 give the row
// addresses.
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p))
               : "memory");
}

// a * a + c on two bf16 lanes, rounded once to bf16.
__device__ __forceinline__ uint32_t bf16x2_fma_sq(uint32_t a, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %1, %2;" : "=r"(d) : "r"(a), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// v = t[0] + t[1] + t[2] exactly (for v = 0 or 2^-110 <= |v| < 2^128):
// each term is v's rest rounded to bf16, so each product of a term with a
// bf16 value is exact in f32.
__device__ __forceinline__ void bf16_terms(float v, __nv_bfloat16 (&t)[3]) {
  t[0] = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(t[0]);
  t[1] = __float2bfloat16_rn(r1);
  t[2] = __float2bfloat16_rn(r1 - __bfloat162float(t[1]));
}

// The forward's streaming pass: each block's partial of every value into
// part_out, value-major (value i of block b at i * gridDim.x + b), in the
// form (kForm) gen_fwd_plan sets.
//
// Ring form (kGenFwdRing): a persistent grid (ring_grid) over tiles of
// plan.rows rows. The wm * wn warps that share a tile's rows (a k-group:
// the warps' k-steps are their rows) take their RG rows of every tile
// through their own slice of each stage: their leader fills it with one
// bulk copy an array on the group's own full barrier, and the group syncs
// among its own warps only (__syncwarp, or a named barrier), so no barrier
// of the block holds the groups to one another's pace. When a slice lands:
// - the row step: a thread an item (one of the group's rows, 8 of the
//   table's columns) turns the row's probs and id into its weights,
//   certain flag and partition and writes them, split into three bf16
//   terms (two columns at a time, cvt.rn.bf16x2; one term for hard
//   weights, which are 0 or 1), into the tile's weight table, the B
//   operand: row r's columns side by side, each term's 8 columns one
//   16-byte store;
// - one barrier of the group; its warps are then past the previous tile,
//   so the leader fills the group's slice of that tile's stage again at
//   once (no empty barrier);
// - each warp takes the group's k-steps: the A operand (16 features x 16
//   rows) by ldmatrix.trans from the stage where F % 8 == 0 in bf16, else
//   element by element (f32 features as three bf16 terms), the row of
//   ones at feature F, and with the std x^2 as two bf16 terms (three for
//   f32: x^2 rounded as the plain version's); B by ldmatrix.trans from the
//   table; for each of its (m-tile, n-tile) pairs it chains the products of
//   every term from zero and adds the result to its f32 totals in
//   registers: every product is exact, each k-step's 16 rows are summed on
//   the tensor cores and the k-steps in order on the CUDA cores.
// The warps' totals are then added in warp order into one partial a block.
// Narrow form (kGenFwdNarrow; one n-tile): the ring form with a 4 x 1
// register tile a warp, at three blocks an SM.
// Grouped form (kGenFwdGrouped; shapes with no ring, gen_fwd_plan): a block
// is G = max(1, 256 / F) groups of min(F, 256) threads; a group takes one
// row a step, a thread the row's feature j (and j + 256, ...), adding w * x
// into its group's own accumulators in shared memory, the group's first
// thread the row's weights and certain flag; then the groups' sums in
// group order.
template <typename T, bool kStd, int kForm>
__global__ void __launch_bounds__(kThreads, kForm == kGenFwdGrouped || sizeof(T) == 4
                                                  ? 1
                                                  : (kForm == kGenFwdNarrow ? kGenFwdNarrowBlocks
                                                                            : kGenFwdBlocks))
centroids_gen_fwd_partial(const T* __restrict__ feats, const float* __restrict__ probs,
                          const int* __restrict__ assign, int M, int F, int C, int P, float thd,
                          int use_thd, int weighted, float* __restrict__ part_out,
                          const GenFwdPlan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NPC = P * C;
  if constexpr (kForm == kGenFwdGrouped) {
    float* acc_all = reinterpret_cast<float*>(smem);
    const int G = gen_cent_groups(F);
    const int NV = gen_cent_values(C, P, F, kStd);
    const int width = F < kThreads ? F : kThreads;   // threads of a group
    const int grp = threadIdx.x / width, j0 = threadIdx.x % width;
    for (int i = threadIdx.x; i < G * NV; i += kThreads) acc_all[i] = 0.f;
    __syncthreads();
    if (grp < G) {
      float* acc = acc_all + grp * NV;
      float* sq = acc + NPC * F + NPC + 1;   // the std's S2 (C, F)
      for (long long t = blockIdx.x; t * G < M; t += gridDim.x) {
        const long long row = t * G + grp;
        if (row >= M) break;
        const float* p = probs + row * C;
        const GenRow r = gen_row_of(p, C, P > 1 ? assign[row] : 0, P, thd, use_thd);
        const T* x = feats + row * F;
        float* sums = acc + r.part * C * F;
        for (int j = j0; j < F; j += width) {
          const float xv = to_f32(x[j]);
          for (int c = 0; c < C; ++c) {
            const float w = gen_weight(p, c, r, weighted);
            sums[c * F + j] = fmaf(w, xv, sums[c * F + j]);
            if constexpr (kStd) sq[c * F + j] = fmaf(w, xv * xv, sq[c * F + j]);
          }
        }
        if (j0 == 0) {
          for (int c = 0; c < C; ++c) acc[NPC * F + r.part * C + c] += gen_weight(p, c, r, weighted);
          acc[NPC * F + NPC] += r.cert;
        }
      }
    }
    __syncthreads();
    for (int v = threadIdx.x; v < NV; v += kThreads) {
      float s = 0.f;
      for (int g = 0; g < G; ++g) s += acc_all[g * NV + v];
      part_out[(size_t)v * gridDim.x + blockIdx.x] = s;
    }
  } else {
    constexpr int es = static_cast<int>(sizeof(T));
    constexpr bool kBf16 = es == 2;
    constexpr int kXT = kBf16 ? 1 : 3;   // bf16 terms of a feature
    constexpr int kQT = kBf16 ? 2 : 3;   // ... of a squared feature
    // m-tiles and n-tiles a warp holds (gen_fwd_mt_cap, a host function)
    constexpr int kMT = kBf16 && kForm == kGenFwdRing ? kGenFwdMTWide : kGenFwdMT;
    constexpr int kNT = kForm == kGenFwdNarrow ? 1 : kGenFwdNT;
    const int R = plan.rows, S = plan.stages, BS = plan.b_stride;
    const int NS = plan.ns, NTS = plan.nt_s, NT = plan.nt;
    const int terms = weighted ? 3 : 1;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int WM = plan.wm, WN = plan.wn, WK = plan.wk;
    const int wm = warp % WM, wn = (warp / WM) % WN, wk = warp / (WM * WN);
    // the k-groups: the wm * wn warps of one wk take rows RG * wk ..
    // RG * (wk + 1) - 1 of every tile and synchronise among themselves
    const int RG = R / WK, gsize = WM * WN * 32, gt = threadIdx.x - wk * gsize;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.bar_at);   // (S)
    uint64_t* empty = full + S;   // (S): every warp done with the stage
    int* s_part = reinterpret_cast<int*>(smem + plan.part_at);   // (2, R): rows' partitions
    unsigned char* ring = smem + plan.ring_at;
    const int ntiles = static_cast<int>((static_cast<long long>(M) + R - 1) / R);
    auto group_sync = [&]() {
      if (gsize == 32) __syncwarp();
      else asm volatile("bar.sync %0, %1;" ::"r"(1 + wk), "r"(gsize) : "memory");
    };
    // a whole tile into a stage: one bulk copy an array
    auto fill = [&](int stage, int tile) {
      const long long row0 = static_cast<long long>(tile) * R;
      const int rows = static_cast<int>(min(static_cast<long long>(R), M - row0));
      unsigned char* st = ring + stage * plan.stage_bytes;
      const uint32_t fb = (rows * F * es) & ~15u;
      const uint32_t pb = (rows * C * 4) & ~15u;
      const uint32_t ib = P > 1 ? (rows * 4) & ~15u : 0u;
      slcl::mbar_expect_tx(&full[stage], fb + pb + ib);
      if (fb) slcl::bulk_copy(st, feats + row0 * F, fb, &full[stage]);
      if (pb) slcl::bulk_copy(st + plan.feat_bytes, probs + row0 * C, pb, &full[stage]);
      if (ib)
        slcl::bulk_copy(st + plan.feat_bytes + plan.prob_bytes, assign + row0, ib,
                        &full[stage]);
    };
    // thread 0's refills: the tile each stage waits for (-1: none) and the
    // parity of the empty phase that frees it; poll() fills every stage
    // whose warps are all done with it, without waiting
    constexpr int kMaxStages = 4;
    int pend[kMaxStages];
    uint32_t epar[kMaxStages];
#pragma unroll
    for (int s = 0; s < kMaxStages; ++s) {
      pend[s] = -1;
      epar[s] = 0u;
    }
    auto poll = [&]() {
#pragma unroll
      for (int s = 0; s < kMaxStages; ++s) {
        if (s < S && pend[s] >= 0 && slcl::mbar_test(&empty[s], epar[s])) {
          fill(s, pend[s]);
          pend[s] = -1;
          epar[s] ^= 1u;
        }
      }
    };
    // both weight tables zero, every row in partition 0: the row step then
    // clears only the columns a row filled two tiles before
    for (int i = threadIdx.x; i < plan.b_bytes / 8; i += kThreads)
      reinterpret_cast<uint4*>(smem + plan.b_at)[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < 2 * R; i += kThreads) s_part[i] = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        slcl::mbar_init(&full[s], 1);
        slcl::mbar_init(&empty[s], kGenWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int s = 0; s < S; ++s) {
        const int tile = blockIdx.x + s * gridDim.x;
        if (tile < ntiles) fill(s, tile);
      }
    }
    __syncthreads();
    const bool argmax = !weighted || use_thd;
    const bool ldsm = kBf16 && F % 8 == 0;
    float tot[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[i][j][e] = 0.f;
    int stage = 0, buf = 0;
    uint32_t parity = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long long row0 = static_cast<long long>(tile) * R;
      const int trows = static_cast<int>(min(static_cast<long long>(R), M - row0));
      const int rows = min(max(trows - wk * RG, 0), RG);   // the group's valid rows
      if (threadIdx.x == 0) {
        // thread 0 refills stages while it waits (it may be the one the
        // other warps wait on); a lost copy traps after 2^26 polls
        for (uint32_t n = 0; !slcl::mbar_test(&full[stage], parity); ++n) {
          poll();
          if (n == (1u << 26)) __trap();
        }
      }
      slcl::mbar_wait(&full[stage], parity);
      unsigned char* st = ring + stage * plan.stage_bytes;
      const T* s_feat = reinterpret_cast<const T*>(st);
      const float* s_prob = reinterpret_cast<const float*>(st + plan.feat_bytes);
      const int* s_id = reinterpret_cast<const int*>(st + plan.feat_bytes + plan.prob_bytes);
      if (rows < RG) {
        // the ragged last tile, in the group's rows: the bytes past each
        // array's 16-byte multiple, which no bulk copy brought (a group's
        // rows start on 16 bytes, so they lie in one group's), and zero
        // features past M (their weights are zero, and 0 * NaN is not)
        auto tail = [&](unsigned char* dst, const void* src, int row_bytes, bool zero) {
          const int end = trows * row_bytes, lo = wk * RG * row_bytes, hi = lo + RG * row_bytes;
          for (int b = max(end & ~15, lo) + gt; b < min(end, hi); b += gsize)
            dst[b] = static_cast<const unsigned char*>(src)[b];
          if (zero)
            for (int b = max(end, lo) + gt; b < hi; b += gsize) dst[b] = 0;
        };
        tail(st, feats + row0 * F, F * es, true);
        tail(st + plan.feat_bytes, probs + row0 * C, C * 4, false);
        if (P > 1) tail(st + plan.feat_bytes + plan.prob_bytes, assign + row0, 4, false);
        group_sync();
      }
      // the row step: a thread a row of the group turns its probs and id
      // into its weights, clears the columns of the partition the row had
      // in this table two tiles ago and writes its C weights there, split
      // into terms (column n's rows side by side), with its certain flag
      // and, with the std, its weights again in the S2 columns
      __nv_bfloat16* tab = reinterpret_cast<__nv_bfloat16*>(smem + plan.b_at) +
                           static_cast<size_t>(buf) * (plan.b_bytes / 2);
      int* part_of = s_part + buf * R;
      const int plane = plan.nt * 8 * BS;
      for (int rl = gt; rl < RG; rl += gsize) {
        const int r = wk * RG + rl;
        const float* pr = s_prob + r * C;
        GenRow w{0, 0, 0.f, 0.f};
        if (rl < rows) {
          const int id = P > 1 ? s_id[r] : 0;
          const bool in_part = id >= 0 && id < P;
          w = argmax ? gen_row_of(pr, C, id, P, thd, use_thd)
                     : GenRow{0, in_part ? id : 0, 1.f, in_part ? 1.f : 0.f};
        }
        __nv_bfloat16* col = tab + r;   // column n of row r at col[n * BS]
        const int old = part_of[r];
        if (old != w.part) {
          const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
          for (int c = 0; c < C; ++c)
            for (int t = 0; t < terms; ++t) col[t * plane + (old * C + c) * BS] = zero;
        }
        for (int c = 0; c < C; ++c) {
          const float x = rl < rows ? gen_weight(pr, c, w, weighted) : 0.f;
          __nv_bfloat16 t3[3];
          if (weighted) {
            bf16_terms(x, t3);
          } else {
            t3[0] = __float2bfloat16_rn(x);
          }
          for (int t = 0; t < terms; ++t) {
            col[t * plane + (w.part * C + c) * BS] = t3[t];
            if constexpr (kStd) col[t * plane + (NS + c) * BS] = t3[t];
          }
        }
        col[NPC * BS] = __float2bfloat16_rn(w.cert);
        part_of[r] = w.part;
      }
      group_sync();
      // the product: this warp's k-steps of the tile
      for (int l = 0; l < plan.kpw; ++l) {
        const int k0 = wk * RG + l * 16;
        // B of the warp's n-tiles, every term: (k 0-7, k 8-15) of column
        // nt * 8 + gid by ldmatrix (lanes 0-7 and 8-15 give the columns)
        uint32_t b[kNT][3][2];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int nt = wn + j * WN;
          if (j < plan.nw && nt < NT) {
            const __nv_bfloat16* src = tab + (nt * 8 + (lane & 7)) * BS + k0 + (lane & 8);
#pragma unroll
            for (int t = 0; t < 3; ++t)
              if (t < terms) ldsm_x2(b[j][t][0], b[j][t][1], src + t * plane);
          }
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const int mt = wm + i * WM;
          if (i < plan.mw && mt < plan.mt) {
            const int f0 = mt * 16;
            // A: features f0 + gid (+ 8) of rows k0 + 2 tig (+ 1, + 8, + 9);
            // feature F is the row of ones, features past it zero
            uint32_t a[kXT][4];
            const bool real = f0 < F;
            const int xterms = real ? kXT : 1;
            if (!real) {
#pragma unroll
              for (int x = 0; x < kXT; ++x)
                a[x][0] = a[x][1] = a[x][2] = a[x][3] = 0u;
              if (f0 + gid == F) a[0][0] = a[0][2] = kBf16Ones;
            } else if (ldsm) {
              // matrix q = lane / 8: rows k0 + (q / 2) * 8 + lane % 8,
              // features f0 + (q % 2) * 8 (f0 where those lie past F)
              const int q = lane >> 3;
              const int fq = f0 + (q & 1) * 8;
              ldsm_x4_trans(a[0], s_feat + (k0 + (q >> 1) * 8 + (lane & 7)) * F +
                                       (fq < F ? fq : f0));
              if (f0 + 8 >= F) a[0][1] = a[0][3] = f0 + 8 + gid == F ? kBf16Ones : 0u;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int f = f0 + gid + (e & 1) * 8;
                const int k = k0 + 2 * tig + (e >> 1) * 8;
                float v[2];
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  v[h] = f < F ? to_f32(s_feat[(k + h) * F + f]) : (f == F ? 1.f : 0.f);
                if constexpr (kBf16) {
                  a[0][e] = pack_bf16(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
                } else {
                  __nv_bfloat16 t0[3], t1[3];
                  bf16_terms(v[0], t0);
                  bf16_terms(v[1], t1);
#pragma unroll
                  for (int x = 0; x < 3; ++x) a[x][e] = pack_bf16(t0[x], t1[x]);
                }
              }
            }
            // with the std, x^2 in terms: bf16 x^2 = hi + lo exactly; f32 x^2
            // rounded to f32, as the plain version squares, then three terms
            uint32_t q2[kStd ? kQT : 1][4];
            if constexpr (kStd) {
              if (real) {
                if constexpr (kBf16) {
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    q2[0][e] = bf16x2_fma_sq(a[0][e], 0x80008000u);
                    q2[1][e] = bf16x2_fma_sq(a[0][e], q2[0][e] ^ 0x80008000u);
                  }
                } else {
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const int f = f0 + gid + (e & 1) * 8;
                    const int k = k0 + 2 * tig + (e >> 1) * 8;
                    __nv_bfloat16 t0[3], t1[3];
                    float v[2];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                      const float x = f < F ? to_f32(s_feat[(k + h) * F + f]) : (f == F ? 1.f : 0.f);
                      v[h] = x * x;
                    }
                    bf16_terms(v[0], t0);
                    bf16_terms(v[1], t1);
#pragma unroll
                    for (int x = 0; x < 3; ++x) q2[x][e] = pack_bf16(t0[x], t1[x]);
                  }
                }
              }
            }
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              const int nt = wn + j * WN;
              // (the row of ones has no S2)
              if (j < plan.nw && nt < NT && (nt < NTS || real)) {
                float d[4] = {0.f, 0.f, 0.f, 0.f};
                if (nt < NTS) {
#pragma unroll
                  for (int x = 0; x < kXT; ++x)
#pragma unroll
                    for (int t = 0; t < 3; ++t)
                      if (x < xterms && t < terms) mma_bf16(d, a[x], b[j][t][0], b[j][t][1]);
                } else if constexpr (kStd) {
                  // x^2's first term in d, the others in a chain of their own
                  float d2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                  for (int x = 0; x < kQT; ++x)
#pragma unroll
                    for (int t = 0; t < 3; ++t)
                      if (t < terms) mma_bf16(x == 0 ? d : d2, q2[x], b[j][t][0], b[j][t][1]);
#pragma unroll
                  for (int e = 0; e < 4; ++e) tot[i][j][e] += d2[e];
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) tot[i][j][e] += d[e];
              }
            }
          }
        }
      }
      // the warp is done with the stage
      __syncwarp();
      if (lane == 0) slcl::mbar_arrive(&empty[stage]);
      if (threadIdx.x == 0) {
        const int next = tile + S * static_cast<int>(gridDim.x);
        if (next < ntiles) {
#pragma unroll
          for (int s = 0; s < kMaxStages; ++s)
            if (s == stage) pend[s] = next;
        }
        poll();
      }
      buf ^= 1;
      if (++stage == S) {
        stage = 0;
        parity ^= 1u;
      }
    }
    // the warps' totals, added in warp order (wk ascending) in the tables'
    // place: red[f][n], f < mt * 16, n < nt * 8
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem + plan.b_at);
    const int NCOL = NT * 8;
    for (int round = 0; round < WK; ++round) {
      if (wk == round) {
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const int mt = wm + i * WM;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int nt = wn + j * WN;
            if (i < plan.mw && mt < plan.mt && j < plan.nw && nt < NT) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float* o = red + (mt * 16 + gid + (e >> 1) * 8) * NCOL + nt * 8 + 2 * tig +
                           (e & 1);
                *o = round == 0 ? tot[i][j][e] : *o + tot[i][j][e];
              }
            }
          }
        }
      }
      __syncthreads();
    }
    // value-major out: sums (p, c, f) at column p * C + c, counts and the
    // certain rows from the row of ones, S2 (c, f) at column NS + c
    const int NV = gen_cent_values(C, P, F, kStd);
    for (int v = threadIdx.x; v < NV; v += kThreads) {
      float s;
      if (v < NPC * F) {
        s = red[(v % F) * NCOL + v / F];
      } else if (v <= NPC * F + NPC) {
        s = red[F * NCOL + (v - NPC * F)];
      } else {
        const int u = v - (NPC * F + NPC + 1);
        s = red[(u % F) * NCOL + NS + u / F];
      }
      part_out[(size_t)v * gridDim.x + blockIdx.x] = s;
    }
  }
}

// The final pass: a warp a value (the blocks' partials of the value summed
// by its lanes, then a shuffle tree), dividing a centroid value by its
// class's count summed the same way; with kStd, C more blocks after the
// values' give each class's S2 and std.
template <bool kStd>
__global__ void __launch_bounds__(kThreads)
centroids_gen_fwd_final(const float* __restrict__ part_in, int nparts, int M, int F, int C,
                        int P, float* __restrict__ cents, float* __restrict__ counts,
                        float* __restrict__ ratio, float* __restrict__ s2,
                        float* __restrict__ stdv) {
  const int NPC = P * C;
  const int NV = NPC * F + NPC + 1;   // the std-free values; S2 follows
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  auto total = [&](int value) {
    float s = 0.f;
    for (int b = lane; b < nparts; b += 32) s += part_in[(size_t)value * nparts + b];
    return gen_warp_sum(s);
  };
  const int value_blocks = (NV + kGenWarps - 1) / kGenWarps;
  if constexpr (kStd) {
    if (blockIdx.x >= value_blocks) {
      // class k's S2[k][f], partition 0's sums[k][f] and counts[p][k]
      extern __shared__ __align__(128) unsigned char smem[];
      float* s_tot = reinterpret_cast<float*>(smem);
      const int k = blockIdx.x - value_blocks;
      // a warp kPer of the class's 2F + P values at a time (values warp,
      // warp + 8, ...), kBatch partials of each a lane a batch, every load
      // of a batch issued together; a lane's partials of a value added in
      // the order total() adds them
      constexpr int kPer = 16, kBatch = 6;
      const int NK = 2 * F + P;
      for (int s0 = warp; s0 < NK; s0 += kPer * kGenWarps) {
        float acc[kPer];
        size_t base[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int s = s0 + u * kGenWarps;
          const int value = s < F ? NV + k * F + s
                                  : (s < 2 * F ? k * F + (s - F) : NPC * F + (s - 2 * F) * C + k);
          base[u] = static_cast<size_t>(s < NK ? value : 0) * nparts;
          acc[u] = 0.f;
        }
        for (int b0 = 0; b0 < nparts; b0 += 32 * kBatch) {
          float v[kPer][kBatch];
#pragma unroll
          for (int u = 0; u < kPer; ++u)
#pragma unroll
            for (int j = 0; j < kBatch; ++j) {
              const int b = b0 + lane + 32 * j;
              v[u][j] = s0 + u * kGenWarps < NK && b < nparts ? part_in[base[u] + b] : 0.f;
            }
#pragma unroll
          for (int u = 0; u < kPer; ++u)
#pragma unroll
            for (int j = 0; j < kBatch; ++j) acc[u] += v[u][j];
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int s = s0 + u * kGenWarps;
          const float t = gen_warp_sum(acc[u]);
          if (lane == 0 && s < NK) s_tot[s] = t;
        }
      }
      __syncthreads();
      if (warp != 0) return;
      float wsum = 0.f;
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
      v = gen_warp_sum(v);
      if (lane == 0) stdv[k] = sqrtf(v / static_cast<float>(F) + 1e-7f);
      return;
    }
  }
  const int i = blockIdx.x * kGenWarps + warp;
  if (i >= NV) return;
  const float v = total(i);
  if (i < NPC * F) {
    const float n = total(NPC * F + i / F);
    if (lane == 0) cents[i] = v / (n + 1e-7f);
  } else if (lane == 0) {
    if (i < NPC * F + NPC) counts[i - NPC * F] = v;
    else ratio[0] = v / static_cast<float>(M);
  }
}

// ---- the backward ----

// Whether thread 0 fills a stage again one tile after its bulk store
// (waiting then on the store of the tile before this one) instead of at
// once, so that it does not wait on the store it has just issued.
constexpr bool kGenDeferFill = true;

// Forms of centroids_gen_bwd (its kForm), chosen by gen_bwd_plan from the
// shape alone: the ring with the chunk's coefficients read from shared
// memory, the ring with them in registers, and the direct form.
constexpr int kGenSmemCoefs = 0;
constexpr int kGenRegCoefs = 1;
constexpr int kGenDirectRows = 2;

// V consecutive values of a row -> f32 registers, and back (bf16 rounds to
// nearest even). p is aligned to min(16, V * sizeof(T)) bytes.
template <int V>
__device__ __forceinline__ void gen_load(const float* p, float (&x)[V]) {
  if constexpr (V == 8) {
    load8(p, x);
  } else if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
    static_assert(V == 1, "8, 4 or 1 features a chunk");
    x[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void gen_load(const __nv_bfloat16* p, float (&x)[V]) {
  if constexpr (V == 8) {
    load8(p, x);
  } else if constexpr (V == 4) {   // a bf16 is the top half of an f32
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(u.x << 16);
    x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16);
    x[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    static_assert(V == 1, "8, 4 or 1 features a chunk");
    x[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void gen_store(float* p, const float (&x)[V]) {
  if constexpr (V == 8) {
    store8(p, x);
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    static_assert(V == 1, "8, 4 or 1 features a chunk");
    p[0] = x[0];
  }
}

template <int V>
__device__ __forceinline__ void gen_store(__nv_bfloat16* p, const float (&x)[V]) {
  if constexpr (V == 8) {
    store8(p, x);
  } else if constexpr (V == 4) {
    uint2 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    h[0] = __floats2bfloat162_rn(x[0], x[1]);
    h[1] = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    static_assert(V == 1, "8, 4 or 1 features a chunk");
    p[0] = __float2bfloat16_rn(x[0]);
  }
}

// The backward's coefficients, once a block, in shared memory: with the std
// a and a / W (C, F); the dsums (P*C, F), dsums = dcents / (counts + 1e-7)
// (std: dcents[0] -= 2 a cents[0] first), a thread each; and the dcounts
// (P*C), -sum_f dcents * cents / (counts + 1e-7) (std: - sum_f a S2 / W^2),
// a warp each, its lanes over the features, in a fixed shuffle-tree order.
// Every thread of the block must call it.
template <bool kStd>
__device__ __forceinline__ void gen_bwd_coefs(int F, int C, int P,
                                              const float* __restrict__ dcents,
                                              const float* __restrict__ cents,
                                              const float* __restrict__ counts,
                                              const float* __restrict__ gstd,
                                              const float* __restrict__ s2,
                                              const float* __restrict__ stdv, float* s_dsum,
                                              float* s_a, float* s_aw, float* s_dcnt) {
  const int NPC = P * C;
  // W[c] = sum over partitions of counts[p][c] + 1e-7
  auto weight_total = [&](int c) {
    float w = 0.f;
    for (int p = 0; p < P; ++p) w += counts[p * C + c];
    return w + 1e-7f;
  };
  if constexpr (kStd) {
    for (int i = threadIdx.x; i < C * F; i += kThreads) {
      const int c = i / F;
      const float wk = weight_total(c);
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
      if (i < C * F) d = fmaf(-2.f * s_a[i], cents[i], d);
    }
    s_dsum[i] = d / (counts[i / F] + 1e-7f);
  }
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x / 32; i < NPC; i += kGenWarps) {
    float v = 0.f, b = 0.f;
    for (int f = lane; f < F; f += 32) {
      float d = dcents[i * F + f];
      if constexpr (kStd) {
        if (i < C) d = fmaf(-2.f * s_a[i * F + f], cents[i * F + f], d);
        b = fmaf(s_a[(i % C) * F + f], s2[(i % C) * F + f], b);
      }
      v = fmaf(d, cents[i * F + f], v);
    }
    v = gen_warp_sum(v);
    float dc = -v / (counts[i] + 1e-7f);
    if constexpr (kStd) {
      b = gen_warp_sum(b);
      const float wk = weight_total(i % C);
      dc -= b / (wk * wk);
    }
    if (lane == 0) s_dcnt[i] = dc;
  }
  __syncthreads();
}

// The backward: dfeats, and with dprobs given dprobs; the form (kForm) and
// the features a chunk owns (V) as gen_bwd_plan sets them, its tile rows,
// stages and tables in `plan`.
//
// Ring form: a persistent grid (ring_grid) over tiles of plan.rows rows.
// Thread 0 fills the stages with one bulk copy an array (each array's
// 16-byte multiple; a ragged last tile's last bytes come from memory) while
// the block forms its coefficients. Each warp takes its own plan.rw rows of
// a tile, with no barrier of the block a tile, in three steps:
// - a lane a row turns the row's probs and id into its C weights, its
//   partition and g, in the row tables, so that no lane of the row derives
//   them again;
// - a lane owns one V-feature chunk of a row (tpr lanes a row, rpw rows a
//   pass; the chunk the same for every row it takes, and + 32, ... when a
//   row has more than 32) and forms, in one pass over its features, dx =
//   sum_c w_c ds[c] (over c ascending; with the std then + 2 x sum_c w_c
//   a/W[c]: the arithmetic of the first design, so dfeats are its bits)
//   and, with dprobs, the row's C partial dot products sum_f ds[c] x (+
//   a/W x^2), summed over its chunks in its slot of a table of partials;
// - with dprobs, a lane a (row, class) adds the row's tpr partials in a
//   fixed order (a class's partials of a row lie side by side, read four
//   at a time into four running sums), adds the dcount and times g.
// The lanes store dfeats and dprobs directly (16-byte vectors, 480 bytes a
// warp-pass at F = 48); each warp arrives on the stage's empty barrier once
// it is done with the stage (without features, the hard std-free call, as
// soon as its rows' weights are taken), and thread 0 fills it again once
// every warp has. plan.bulk = 1, kept for measuring it, writes them back
// over the stage instead and stores each tile with one bulk copy an array:
// each warp fences its writes for the async proxy before it arrives, thread
// 0 stores once every warp has and fills the stage again one tile later,
// once the store has read it (kGenDeferFill); it measured 5-40% slower
// (tools/ring_variants.py gen_bwd_bulk, gen_bwd_bulk_at_once).
//
// Direct form: a thread a row, its features and probs read from memory,
// the arithmetic of the first design (dfeats its bits); for shapes whose
// coefficients leave no room for two stages.
template <typename T, bool kStd, int V, int kForm>
__global__ void __launch_bounds__(kThreads, 2)
centroids_gen_bwd(const T* __restrict__ feats, const float* __restrict__ probs,
                  const int* __restrict__ assign, int M, int F, int C, int P, float thd,
                  int use_thd, int weighted, const float* __restrict__ dcents,
                  const float* __restrict__ cents, const float* __restrict__ counts,
                  T* __restrict__ dfeats, float* __restrict__ dprobs,
                  const float* __restrict__ gstd, const float* __restrict__ s2,
                  const float* __restrict__ stdv, const GenBwdPlan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NPC = P * C;
  float* s_dsum = reinterpret_cast<float*>(smem);   // (P*C, F)
  float* s_a = s_dsum + NPC * F;                    // the std's a (C, F)
  float* s_aw = s_a + (kStd ? C * F : 0);           // and a / W
  float* s_dcnt = s_aw + (kStd ? C * F : 0);        // (P*C)
  const bool with_dprobs = dprobs != nullptr;
  if constexpr (kForm == kGenDirectRows) {
    gen_bwd_coefs<kStd>(F, C, P, dcents, cents, counts, gstd, s2, stdv, s_dsum, s_a, s_aw,
                        s_dcnt);
    const bool need_x = kStd || with_dprobs;
    const long long step = static_cast<long long>(gridDim.x) * kThreads;
    for (long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
         row < M; row += step) {
      const float* p = probs + row * C;
      const GenRow r = gen_row_of(p, C, P > 1 ? assign[row] : 0, P, thd, use_thd);
      const T* x = feats + row * F;
      const float* ds = s_dsum + r.part * C * F;
      for (int f = 0; f < F; ++f) {
        const float xv = need_x ? to_f32(x[f]) : 0.f;
        float v = 0.f, u = 0.f;
        for (int c = 0; c < C; ++c) {
          const float w = gen_weight(p, c, r, weighted);
          v = fmaf(w, ds[c * F + f], v);
          if constexpr (kStd) u = fmaf(w, s_aw[c * F + f], u);
        }
        if constexpr (kStd) v = fmaf(2.f * xv, u, v);
        dfeats[row * F + f] = from_f32<T>(v);
      }
      if (with_dprobs) {
        for (int c = 0; c < C; ++c) {
          float d = 0.f;
          for (int f = 0; f < F; ++f) {
            const float xv = to_f32(x[f]);
            d = fmaf(ds[c * F + f], xv, d);
            if constexpr (kStd) d = fmaf(s_aw[c * F + f], xv * xv, d);
          }
          dprobs[row * C + c] = (d + s_dcnt[r.part * C + c]) * r.g;
        }
      }
    }
  } else {
    constexpr int es = static_cast<int>(sizeof(T));
    const int R = plan.rows, S = plan.stages;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.bar_at);
    uint64_t* empty = full + S;
    float* s_w = reinterpret_cast<float*>(smem + plan.w_at);     // (R, C)
    int* s_part = reinterpret_cast<int*>(smem + plan.part_at);   // (R)
    float* s_g = reinterpret_cast<float*>(smem + plan.g_at);     // (R)
    unsigned char* ring = smem + plan.ring_at;
    const int ntiles = static_cast<int>((static_cast<long long>(M) + R - 1) / R);
    // a stage: its features (when read), then its probs, then its ids
    auto fill = [&](int stage, int tile) {
      const long long row0 = static_cast<long long>(tile) * R;
      const int rows = static_cast<int>(min(static_cast<long long>(R), M - row0));
      unsigned char* st = ring + stage * plan.stage_bytes;
      const uint32_t fb = plan.feats ? (rows * F * es) & ~15u : 0u;
      const uint32_t pb = (rows * C * 4) & ~15u;
      const uint32_t ib = P > 1 ? (rows * 4) & ~15u : 0u;
      slcl::mbar_expect_tx(&full[stage], fb + pb + ib);
      if (fb) slcl::bulk_copy(st, feats + row0 * F, fb, &full[stage]);
      if (pb) slcl::bulk_copy(st + plan.feat_bytes, probs + row0 * C, pb, &full[stage]);
      if (ib)
        slcl::bulk_copy(st + plan.feat_bytes + plan.prob_bytes, assign + row0, ib,
                        &full[stage]);
    };
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        slcl::mbar_init(&full[s], 1);
        slcl::mbar_init(&empty[s], kGenWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int s = 0; s < S; ++s) {
        const int tile = blockIdx.x + s * gridDim.x;
        if (tile < ntiles) fill(s, tile);
      }
    }
    if (with_dprobs) {
      // the partials' padding lanes stay 0 (gen_bwd_coefs ends on a barrier)
      float* pt = reinterpret_cast<float*>(smem + plan.pt_at);
      const int n = R * plan.cs * ((plan.tpr + 3) & ~3);
      for (int i = threadIdx.x; i < n; i += kThreads) pt[i] = 0.f;
    }
    gen_bwd_coefs<kStd>(F, C, P, dcents, cents, counts, gstd, s2, stdv, s_dsum, s_a, s_aw,
                        s_dcnt);
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int slot = lane / plan.tpr, k0 = lane % plan.tpr;
    const bool active = slot < plan.rpw;
    // the dprobs partials (R, cs, tp4): a row's class c has its lanes'
    // partials side by side, tp4 = tpr rounded up to 4, the last zeros
    float* s_pt = reinterpret_cast<float*>(smem + plan.pt_at);
    const int tp4 = (plan.tpr + 3) & ~3;
    // the same for every row, in registers: the chunk's dsums (std-free, P
    // = 1) or a / W (std), class c at creg[c]
    constexpr int kRegClasses = kStd ? kGenRegClassesStd : kGenRegClasses;
    float creg[kForm == kGenRegCoefs ? kRegClasses : 1][V];
    if constexpr (kForm == kGenRegCoefs) {
      const float* src = kStd ? s_aw : s_dsum;
#pragma unroll
      for (int c = 0; c < kRegClasses; ++c) {
        if (c >= C) break;
        if (active) gen_load<V>(src + c * F + k0 * V, creg[c]);
      }
    }
    const bool with_dx_out = plan.feats && plan.bulk;   // dfeats over the stage
    int stage = 0;
    uint32_t parity = 0;
    int held = -1, held_tile = 0;   // thread 0: a stored stage not yet filled again
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long long row0 = static_cast<long long>(tile) * R;
      const int rows = static_cast<int>(min(static_cast<long long>(R), M - row0));
      // this warp's rows of the tile
      const int wr0 = warp * plan.rw, wr1 = min(wr0 + plan.rw, rows);
      slcl::mbar_wait(&full[stage], parity);
      unsigned char* st = ring + stage * plan.stage_bytes;
      T* s_feat = reinterpret_cast<T*>(st);
      float* s_prob = reinterpret_cast<float*>(st + plan.feat_bytes);
      const int* s_id = reinterpret_cast<const int*>(st + plan.feat_bytes + plan.prob_bytes);
      if (rows < R && wr0 < wr1) {
        // the ragged last tile: the bytes of this warp's rows past each
        // array's 16-byte multiple, which no bulk copy brought
        auto tail = [&](unsigned char* dst, const void* src, int row_bytes) {
          const int end = rows * row_bytes;
          const int b0 = max(end & ~15, wr0 * row_bytes), b1 = min(end, wr1 * row_bytes);
          if (b0 + lane < b1) dst[b0 + lane] = static_cast<const unsigned char*>(src)[b0 + lane];
        };
        if (plan.feats) tail(st, feats + row0 * F, F * es);
        tail(st + plan.feat_bytes, probs + row0 * C, C * 4);
        if (P > 1) tail(st + plan.feat_bytes + plan.prob_bytes, assign + row0, 4);
        __syncwarp();
      }
      // a lane a row: the row's weights, partition and g, once (soft
      // weights without a threshold need no argmax: every row is certain)
      const bool argmax = !weighted || use_thd;
      for (int r = wr0 + lane; r < wr1; r += 32) {
        const float* pr = s_prob + r * C;
        const int id = P > 1 ? s_id[r] : 0;
        const bool in_part = id >= 0 && id < P;
        const GenRow w = argmax ? gen_row_of(pr, C, id, P, thd, use_thd)
                                : GenRow{0, in_part ? id : 0, 1.f, in_part ? 1.f : 0.f};
        for (int c = 0; c < C; ++c) s_w[r * C + c] = gen_weight(pr, c, w, weighted);
        s_part[r] = w.part;
        s_g[r] = w.g;
      }
      __syncwarp();
      if (lane == 0 && !plan.feats) {
        // the stage's probs and ids are in the row tables: the warp is done
        // with it
        slcl::mbar_arrive(&empty[stage]);
      }
      // one chunk of row r: dx = sum_c w_c ds[c] (+ 2 x sum_c w_c aw[c])
      // to out, and with dprobs the lane's partials of the row in its slot
      // (its first chunk sets them, the next add to them)
      auto chunk = [&](int r, int k, const float (&x)[V], T* out) {
        const int part = s_part[r];
        const float* w = s_w + r * C;
        const int f0 = k * V;
        float* pt = s_pt + r * plan.cs * tp4 + k0;
        float dx[V], u[V];
#pragma unroll
        for (int j = 0; j < V; ++j) dx[j] = u[j] = 0.f;
        // class c's terms on the chunk: its dsums ds and a / W aw there
        auto add = [&](int c, const float (&ds)[V], const float (&aw)[V]) {
          const float wc = w[c];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            dx[j] = fmaf(wc, ds[j], dx[j]);
            if constexpr (kStd) u[j] = fmaf(wc, aw[j], u[j]);
          }
          if (with_dprobs) {
            float d = 0.f;
#pragma unroll
            for (int j = 0; j < V; ++j) {
              // ds x (std: + aw x^2 = x (ds + aw x), no product of x alone)
              if constexpr (kStd) d = fmaf(fmaf(aw[j], x[j], ds[j]), x[j], d);
              else d = fmaf(ds[j], x[j], d);
            }
            pt[c * tp4] = (kForm == kGenRegCoefs || k == k0) ? d : pt[c * tp4] + d;
          }
        };
        if constexpr (kForm == kGenRegCoefs) {
#pragma unroll
          for (int c = 0; c < kRegClasses; ++c) {
            if (c >= C) break;
            if constexpr (kStd) {
              float ds[V];
              gen_load<V>(s_dsum + (part * C + c) * F + f0, ds);
              add(c, ds, creg[c]);
            } else {
              add(c, creg[c], creg[c]);
            }
          }
        } else {
          for (int c = 0; c < C; ++c) {
            float ds[V];
            gen_load<V>(s_dsum + (part * C + c) * F + f0, ds);
            if constexpr (kStd) {
              float aw[V];
              gen_load<V>(s_aw + c * F + f0, aw);
              add(c, ds, aw);
            } else {
              add(c, ds, ds);
            }
          }
        }
        if constexpr (kStd) {
#pragma unroll
          for (int j = 0; j < V; ++j) dx[j] = fmaf(2.f * x[j], u[j], dx[j]);
        }
        gen_store<V>(out, dx);
      };
      for (int q = 0; q < plan.npw; ++q) {
        const int r = wr0 + q * plan.rpw + slot;
        if (active && r < wr1) {
          for (int k = k0; k < plan.nch; k += 32) {
            float x[V];
#pragma unroll
            for (int j = 0; j < V; ++j) x[j] = 0.f;
            if (plan.feats) gen_load<V>(s_feat + r * F + k * V, x);
            chunk(r, k, x, with_dx_out ? s_feat + r * F + k * V
                                       : dfeats + (row0 + r) * F + k * V);
          }
        }
      }
      if (with_dprobs) {
        __syncwarp();   // every partial of the warp's rows is in the table
        // a lane a (row, class): the row's tpr partials in lane order, the
        // dcount, times g; into the stage (bulk stores) or memory
        // item i = r * C + c, the lane's first and then 32 on, walked
        // without a division an item
        const int lane_r = lane / C, step_r = 32 / C, step_c = 32 - step_r * C;
        int r = wr0 + lane_r, c = lane - lane_r * C;
        for (int i = wr0 * C + lane; i < wr1 * C; i += 32) {
          const float4* pt = reinterpret_cast<const float4*>(s_pt + (r * plan.cs + c) * tp4);
          float4 a = pt[0];
          for (int k = 1; k < tp4 / 4; ++k) {
            const float4 v = pt[k];
            a.x += v.x;
            a.y += v.y;
            a.z += v.z;
            a.w += v.w;
          }
          const float d = (a.x + a.y) + (a.z + a.w);
          const float dp = (d + s_dcnt[s_part[r] * C + c]) * s_g[r];
          if (plan.bulk) s_prob[i] = dp;
          else dprobs[row0 * C + i] = dp;
          r += step_r;
          c += step_c;
          if (c >= C) {
            c -= C;
            ++r;
          }
        }
      }
      if (plan.bulk) {
        slcl::fence_proxy_async();
        __syncwarp();
        if (lane == 0) slcl::mbar_arrive(&empty[stage]);
        if (threadIdx.x == 0) {
          slcl::mbar_wait(&empty[stage], parity);
          const int fb = rows * F * es, pb = rows * C * 4;
          if (fb >= 16) slcl::bulk_store(dfeats + row0 * F, st, fb & ~15);
          if (with_dprobs && pb >= 16) slcl::bulk_store(dprobs + row0 * C, s_prob, pb & ~15);
          slcl::bulk_commit();
          // a ragged tile's last bytes, past the 16-byte multiples
          unsigned char* gf = reinterpret_cast<unsigned char*>(dfeats + row0 * F);
          for (int b = fb & ~15; b < fb; ++b) gf[b] = st[b];
          if (with_dprobs) {
            unsigned char* gp = reinterpret_cast<unsigned char*>(dprobs + row0 * C);
            const unsigned char* sp = reinterpret_cast<const unsigned char*>(s_prob);
            for (int b = pb & ~15; b < pb; ++b) gp[b] = sp[b];
          }
          const int next = tile + S * gridDim.x;
          if constexpr (kGenDeferFill) {
            // the previous tile's store has read its stage (all but this
            // tile's group): fill that stage, and hold this one
            if (held >= 0) {
              slcl::bulk_wait_read<1>();
              fill(held, held_tile);
            }
            held = next < ntiles ? stage : -1;
            held_tile = next;
          } else if (next < ntiles) {
            slcl::bulk_wait_read<0>();   // the store has read the stage
            fill(stage, next);
          }
        }
      } else {
        if (plan.feats) {
          // the warp read its features from the stage until now
          __syncwarp();
          if (lane == 0) slcl::mbar_arrive(&empty[stage]);
        }
        if (threadIdx.x == 0) {
          const int next = tile + S * gridDim.x;
          if (next < ntiles) {
            slcl::mbar_wait(&empty[stage], parity);
            fill(stage, next);
          }
        }
      }
      if (++stage == S) {
        stage = 0;
        parity ^= 1u;
      }
    }
    // the block's shared memory must outlive its last stores
    if (plan.bulk && threadIdx.x == 0) slcl::bulk_wait_all();
  }
}

}  // namespace slcl
