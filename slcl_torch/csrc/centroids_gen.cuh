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
// Design: simple, not yet fast.
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
// - Backward (centroids_gen_bwd): the coefficients of soft_centroids.cu's
//   backward (dsums, dcounts; with the std a and a / W) once a block in
//   shared memory, 4 * (P*C*F + P*C + std*2*C*F) bytes; then a warp a row,
//   its lanes over the features: dfeats, and with soft weights the C dprobs
//   as shuffle-tree sums of the lanes' dot products.
// Every block's shared memory must fit one block (227 KB on an H100, less
// the kernel's static shared memory); the wrappers check it before a
// launch. Grids are fixed by M and F alone (gen_grid), every sum is in a
// fixed order, and there are no float atomics: two launches give
// bit-identical results.
#pragma once

#include "common.cuh"

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
__host__ __device__ constexpr int gen_cent_bwd_smem(int C, int P, int F, bool with_std) {
  return 4 * (P * C * F + P * C + (with_std ? 2 * C * F : 0));
}

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

// The backward: dfeats (and with dprobs given, dprobs), a warp a row.
template <typename T, bool kStd>
__global__ void __launch_bounds__(kThreads)
centroids_gen_bwd(const T* __restrict__ feats, const float* __restrict__ probs,
                  const int* __restrict__ assign, int M, int F, int C, int P, float thd,
                  int use_thd, int weighted, const float* __restrict__ dcents,
                  const float* __restrict__ cents, const float* __restrict__ counts,
                  T* __restrict__ dfeats, float* __restrict__ dprobs,
                  const float* __restrict__ gstd, const float* __restrict__ s2,
                  const float* __restrict__ stdv) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NPC = P * C;
  float* s_dsum = reinterpret_cast<float*>(smem);   // (P*C, F)
  float* s_dcnt = s_dsum + NPC * F;                 // (P*C)
  float* s_a = s_dcnt + NPC;                        // the std's a (C, F)
  float* s_aw = s_a + C * F;                        // and a / W
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
  // dsums = dcents / (counts + 1e-7) (std: dcents[0] -= 2 a cents[0]), and
  // dcounts = -sum_f dcents * cents / (counts + 1e-7) (std: - sum_f a S2 /
  // W^2), a thread each over f ascending
  for (int i = threadIdx.x; i < NPC * F; i += kThreads) {
    float d = dcents[i];
    if constexpr (kStd) {
      if (i < C * F) d = fmaf(-2.f * s_a[i], cents[i], d);
    }
    s_dsum[i] = d / (counts[i / F] + 1e-7f);
  }
  for (int i = threadIdx.x; i < NPC; i += kThreads) {
    float v = 0.f, b = 0.f;
    for (int f = 0; f < F; ++f) {
      float d = dcents[i * F + f];
      if constexpr (kStd) {
        if (i < C) d = fmaf(-2.f * s_a[i * F + f], cents[i * F + f], d);
        b = fmaf(s_a[(i % C) * F + f], s2[(i % C) * F + f], b);
      }
      v = fmaf(d, cents[i * F + f], v);
    }
    float dc = -v / (counts[i] + 1e-7f);
    if constexpr (kStd) {
      const float wk = weight_total(i % C);
      dc -= b / (wk * wk);
    }
    s_dcnt[i] = dc;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool need_x = kStd || dprobs != nullptr;
  const long long step = static_cast<long long>(gridDim.x) * kGenWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kGenWarps + warp; row < M;
       row += step) {
    const float* p = probs + row * C;
    const GenRow r = gen_row_of(p, C, P > 1 ? assign[row] : 0, P, thd, use_thd);
    const T* x = feats + row * F;
    const float* ds = s_dsum + r.part * C * F;
    for (int j = lane; j < F; j += 32) {
      const float xv = need_x ? to_f32(x[j]) : 0.f;
      float v = 0.f, u = 0.f;
      for (int c = 0; c < C; ++c) {
        const float w = gen_weight(p, c, r, weighted);
        v = fmaf(w, ds[c * F + j], v);
        if constexpr (kStd) u = fmaf(w, s_aw[c * F + j], u);
      }
      if constexpr (kStd) v = fmaf(2.f * xv, u, v);
      dfeats[row * F + j] = from_f32<T>(v);
    }
    if (dprobs != nullptr) {
      for (int c = 0; c < C; ++c) {
        float d = 0.f;
        for (int j = lane; j < F; j += 32) {
          const float xv = to_f32(x[j]);
          d = fmaf(ds[c * F + j], xv, d);
          if constexpr (kStd) d = fmaf(s_aw[c * F + j], xv * xv, d);
        }
        d = gen_warp_sum(d);
        if (lane == 0) dprobs[row * C + c] = (d + s_dcnt[r.part * C + c]) * r.g;
      }
    }
  }
}

}  // namespace slcl
