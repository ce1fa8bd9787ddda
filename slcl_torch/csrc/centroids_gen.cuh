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
// Design. The forwards are simple, not yet fast; the backward is built for
// the card's memory rate.
// - Forward (centroids_gen_fwd_partial): a block is G = max(1, 256 / F)
//   groups of min(F, 256) threads; a group takes one row a step, a thread
//   the row's feature j (and j + 256, ... when F > 256), and adds w * x
//   into its group's own accumulators in shared memory, which no other
//   thread touches; the group's first thread adds the row's weights and
//   certain flag. The block then adds its groups' accumulators in group
//   order into one partial a value, value-major as the templated forward
//   stores them, so the same final pass layout and the same data-parallel
//   reduce (a sum of the partials over the ranks) apply. Shared memory:
//     gen_cent_fwd_smem(C, P, F, std) = 4 * G * (P*C*F + P*C + 1 + std*C*F).
// - Final pass (centroids_gen_fwd_final): a warp a value, its lanes
//   striding the blocks' partials and a shuffle tree adding the lanes; with
//   the std, C more blocks, one a class, take the class's 2F + P totals the
//   same way into shared memory (4 * (2F + P) bytes) and its std.
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
// launch. The forwards' grids are fixed by M and F alone (gen_grid); the
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
// dynamic shared memory of each kernel, bytes
__host__ __device__ constexpr int gen_cent_fwd_smem(int C, int P, int F, bool with_std) {
  return 4 * gen_cent_groups(F) * gen_cent_values(C, P, F, with_std);
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

// The forward's streaming pass: each block's partial of every value into
// part_out, value-major (value i of block b at i * gridDim.x + b).
template <typename T, bool kStd>
__global__ void __launch_bounds__(kThreads)
centroids_gen_fwd_partial(const T* __restrict__ feats, const float* __restrict__ probs,
                          const int* __restrict__ assign, int M, int F, int C, int P, float thd,
                          int use_thd, int weighted, float* __restrict__ part_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc_all = reinterpret_cast<float*>(smem);
  const int G = gen_cent_groups(F);
  const int NV = gen_cent_values(C, P, F, kStd);
  const int NPC = P * C;
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
      for (int s = warp; s < 2 * F + P; s += kGenWarps) {
        const int value = s < F ? NV + k * F + s
                                : (s < 2 * F ? k * F + (s - F) : NPC * F + (s - 2 * F) * C + k);
        const float t = total(value);
        if (lane == 0) s_tot[s] = t;
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
