// Per-row MPCL arithmetic of every kernel in mpcl.cu, mpcl_pseudo.cu and
// pseudo_label.cu, so all run the same math: L2 normalisation
// (rsqrt(sum x^2 + 1e-24)) and cosines against the (C, F) normalised
// prototypes (stream_cosines), the pseudo-label rule (row_pseudo_label),
// and the ArcFace margin softmax on the label column (margin_softmax). The
// tile loops (mpcl_fwd_tile.cuh, mpcl_bwd_tile.cuh) are the callers.
#pragma once

#include "common.cuh"

namespace slcl {

struct Margin {
  float T, cos_m, sin_m, th, mm;
  int easy;
};

// A chunk of n <= 8 consecutive values -> f32 registers: with the width
// known at compile time (F > 0) one 16-byte-aligned chunk of 8 (load8);
// with F = 0 (the general kernels: any width, rows at any 2-byte address)
// one value a load, zeros past n.
template <int F, typename T>
__device__ __forceinline__ void load_chunk(const T* p, float* x, int n) {
  if constexpr (F > 0) {
    load8(p, x);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = i < n ? to_f32(p[i]) : 0.f;
  }
}

// cosv[c] = <x, cent[c]> / ||x||; inv = 1/||x||, of a row taken in 8-value
// chunks: ss and each class's dot product are one sequential fmaf chain
// over k, whoever calls and however the chunk loop is unrolled. The
// backward streams a row staged in shared memory one chunk at a time
// (kUnroll = 1: a few registers); the forwards hold the row's raw bytes in
// registers and unroll every chunk (kUnroll = F / 8), so that no index is
// left at run time. Every kernel that derives a label or a mask from a row
// must take its cosines here and its rule from row_pseudo_label: the
// pseudo-label kernel's mask, the fused forward's count of selected rows
// and the fused backward's zero rows agree only because all do.
// The templated kernels give F and C = kC at compile time. The general
// kernels (general.cuh) pass F = 0 and C = 0 and the width f and class
// count nc at run time: the row is then read a value at a time (the last
// chunk holds f mod 8 values) and its classes go in groups of kC, each
// group one pass over the row that takes ss again, the same chain. The
// chains are the same either way, so at C = 4 and F in {8, 16, 32, 64} both
// families give every row the same cosines bit for bit.
template <typename T, int F, int kUnroll = 1, int C = kC>
__device__ __forceinline__ void stream_cosines(const T* row, const float* s_cent,
                                               float* cosv, float& inv, int f = F,
                                               int nc = C) {
  static_assert((F > 0 && C == kC) || (F == 0 && C == 0), "both shapes fixed, or neither");
  const int fw = F > 0 ? F : f;
  const int nw = C > 0 ? C : nc;
  for (int c0 = 0; c0 < nw; c0 += kC) {   // once at C = kC
    float ss = 0.f, d[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) d[c] = 0.f;
#pragma unroll(kUnroll)
    for (int k = 0; k < fw; k += 8) {
      const int n = F > 0 ? 8 : min(8, fw - k);
      float x[8];
      load_chunk<F>(row + k, x, n);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < n) ss = fmaf(x[i], x[i], ss);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c0 + c < nw) {
          float cc[8];
          load_chunk<F>(s_cent + (c0 + c) * fw + k, cc, n);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (i < n) d[c] = fmaf(x[i], cc[i], d[c]);
        }
      }
    }
    inv = rsqrtf(ss + 1e-24f);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (c0 + c < nw) cosv[c0 + c] = d[c] * inv;
  }
}

// Margin softmax of one row from its cosines. Returns mlpp (the log-prob of
// the label column); fills e[c] = exp(mixed[c]) and z = sum(e) + 1e-4.
template <int C>
__device__ __forceinline__ float margin_softmax(const float* cosv, int lab,
                                                const Margin& mg, float* e, float& z) {
  float logit[C], phil[C];
  float lmax = -INFINITY, pmax = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float cs = cosv[c];
    const float sine = sqrtf(fminf(fmaxf(1.f - cs * cs, 1e-4f), 1.f));
    float phi = cs * mg.cos_m - sine * mg.sin_m;
    if (mg.easy) phi = cs > 0.f ? phi : cs;
    else phi = cs > mg.th ? phi : cs - mg.mm;
    logit[c] = cs / mg.T;
    phil[c] = phi / mg.T;
    lmax = fmaxf(lmax, logit[c]);
    pmax = fmaxf(pmax, phil[c]);
  }
  float mixed_lab = 0.f;
  z = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float mixed = (c == lab) ? phil[c] - pmax : logit[c] - lmax;
    if (c == lab) mixed_lab = mixed;
    e[c] = expf(mixed);
    z += e[c];
  }
  z += 1e-4f;
  // a label outside [0, C) selects no column: mlpp = 0, as one_hot gives
  return (lab >= 0 && lab < C) ? mixed_lab - logf(z) : 0.f;
}

// Label and sel of one row from its cosines: first-occurrence argmax;
// sel = 1 where top1 - second > sel_th, second being the largest cosine
// among the other columns (a tie gives a gap of 0).
// C = 0: nc classes, at run time (the general kernels).
template <int C>
__device__ __forceinline__ int row_pseudo_label(const float* cosv, float sel_th, float& sel,
                                                int nc = C) {
  float best = -INFINITY, second = -INFINITY;
  int arg = 0;
#pragma unroll
  for (int c = 0; c < (C > 0 ? C : nc); ++c) {
    const float cs = cosv[c];
    if (cs > best) {
      second = best;
      best = cs;
      arg = c;
    } else if (cs > second) {
      second = cs;
    }
  }
  sel = (best - second > sel_th) ? 1.f : 0.f;
  return arg;
}

// out = [loss, sum(sel*mlpp), den] from per-block (num, den) pairs, added
// in a fixed order; den = sum(sel) + 1e-4 when use_sel, else M.
__global__ void __launch_bounds__(kThreads)
mpcl_fwd_final(const float* __restrict__ part, int nparts, int M, int use_sel,
               float scale, float* __restrict__ out) {
  __shared__ float s_red[kThreads];
  float num = 0.f, den = 0.f;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
    num += part[2 * i];
    den += part[2 * i + 1];
  }
  num = block_sum(num, s_red);
  den = block_sum(den, s_red);
  if (threadIdx.x == 0) {
    const float d = use_sel ? den + 1e-4f : static_cast<float>(M);
    out[0] = -scale * num / d;
    out[1] = num;
    out[2] = d;
  }
}

}  // namespace slcl
