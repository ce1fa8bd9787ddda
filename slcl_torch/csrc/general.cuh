// The general (runtime-shape) family of the row kernels, for Hopper
// (sm_90a): the MPCL forward and backward (mpcl.cu), the fused target
// branch (mpcl_pseudo.cu) and the pseudo-labels (pseudo_label.cu) at any
// class count C and feature width F, both given at run time. They replace
// the same Pallas functions as the templated kernels beside them, whose
// blocks take the whole C and F:
//   slcl_tpu/ops/pallas/mpcl_kernel.py::mpcl_loss_fused
//   slcl_tpu/ops/pallas/mpcl_pseudo_kernel.py::mpcl_pseudo_fused
//   slcl_tpu/ops/pallas/pseudo_label_kernel.py::pseudo_label_fused
// The wrappers route a shape here unless C = 4 and F is one of 8, 16, 32,
// 64 (slcl_torch/ops/cuda/__init__.py::route).
//
// Per row the arithmetic of the templated kernels: the cosines from
// stream_cosines (mpcl_row.cuh) with F = C = 0, so a row's cosines, label
// and mask are theirs bit for bit; the margin softmax and its gradient
// with the same terms, the row's logits taken again in a later pass
// instead of held in registers.
//
// Design: simple, not yet fast. One thread a row, a grid-stride loop over
// the rows; a row read from memory a value at a time (any width, any
// 2-byte alignment: a bf16 row of F = 20 is 40 bytes); the prototypes, and
// a slice of C cosines a thread (C rounded up to odd, so that the slices
// of a warp's threads fall in distinct banks), in dynamic shared memory:
//   gen_rows_smem(C, F) = 4 * (C * F + kThreads * (C | 1)) bytes,
// which must fit one block's shared memory (227 KB on an H100 less the
// kernel's static shared memory; the wrappers check it first). The grid is
// min(ceil(M / kThreads), kMaxBlocks) blocks whatever the device, so the
// forwards' per-block sums and their final pass (mpcl_fwd_final, the
// templated family's) add in the same order on every card; no float
// atomics; two launches give bit-identical results.
#pragma once

#include "mpcl_row.cuh"

namespace slcl {

// Dynamic shared memory of a general row kernel (see above).
__host__ __device__ constexpr int gen_rows_smem(int C, int F) {
  return 4 * (C * F + kThreads * (C | 1));
}

// ArcFace terms of one class from its cosine: the logit cs / T and the
// label column's phi / T (margin_softmax's).
__device__ __forceinline__ void gen_margin_terms(float cs, const Margin& mg, float& logit,
                                                 float& phil) {
  const float sine = sqrtf(fminf(fmaxf(1.f - cs * cs, 1e-4f), 1.f));
  float phi = cs * mg.cos_m - sine * mg.sin_m;
  if (mg.easy) phi = cs > 0.f ? phi : cs;
  else phi = cs > mg.th ? phi : cs - mg.mm;
  logit = cs / mg.T;
  phil = phi / mg.T;
}

// margin_softmax's mlpp (the label column's log-prob) over nc cosines.
__device__ __forceinline__ float gen_margin_softmax(const float* cosv, int nc, int lab,
                                                    const Margin& mg) {
  float lmax = -INFINITY, pmax = -INFINITY;
  for (int c = 0; c < nc; ++c) {
    float logit, phil;
    gen_margin_terms(cosv[c], mg, logit, phil);
    lmax = fmaxf(lmax, logit);
    pmax = fmaxf(pmax, phil);
  }
  float z = 0.f, mixed_lab = 0.f;
  for (int c = 0; c < nc; ++c) {
    float logit, phil;
    gen_margin_terms(cosv[c], mg, logit, phil);
    const float mixed = (c == lab) ? phil - pmax : logit - lmax;
    if (c == lab) mixed_lab = mixed;
    z += expf(mixed);
  }
  z += 1e-4f;
  return (lab >= 0 && lab < nc) ? mixed_lab - logf(z) : 0.f;
}

// margin_grad's terms of one class (its fast forms): logit and phi over T.
__device__ __forceinline__ void gen_grad_terms(float cs, const Margin& mg, float invT,
                                               float& logit, float& phil) {
  const float cl2 = fminf(fmaxf(1.f - cs * cs, 1e-4f), 1.f);
  float phi = cs * mg.cos_m - cl2 * rsqrtf(cl2) * mg.sin_m;
  if (mg.easy) phi = cs > 0.f ? phi : cs;
  else phi = cs > mg.th ? phi : cs - mg.mm;
  logit = cs * invT;
  phil = phi * invT;
}

// margin_grad over nc cosines, in place: cg[c] goes in as cos[c] and comes
// out as gcos[c] = g * d mlpp / d cos[c]. Returns <gcos, cos>.
__device__ __forceinline__ float gen_margin_grad(float* cg, int nc, int lab, const Margin& mg,
                                                 float invT, float g) {
  float lmax = -INFINITY, pmax = -INFINITY, cl = 0.f;
  for (int c = 0; c < nc; ++c) {
    float logit, phil;
    gen_grad_terms(cg[c], mg, invT, logit, phil);
    lmax = fmaxf(lmax, logit);
    pmax = fmaxf(pmax, phil);
    if (c == lab) cl = cg[c];
  }
  float z = 0.f;
  for (int c = 0; c < nc; ++c) {
    float logit, phil;
    gen_grad_terms(cg[c], mg, invT, logit, phil);
    z += __expf(c == lab ? phil - pmax : logit - lmax);
  }
  const float rz = (lab >= 0 && lab < nc) ? __fdividef(1.f, z + 1e-4f) : 0.f;
  const float one_m = 1.f - cl * cl;
  const bool sat = one_m <= 1e-4f || one_m >= 1.f;
  const float dphi_on = sat ? mg.cos_m : mg.cos_m + mg.sin_m * cl * rsqrtf(one_m);
  const float dphi = cl > (mg.easy ? 0.f : mg.th) ? dphi_on : 1.f;
  const float gT = g * invT;
  float proj = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float cs = cg[c];
    float logit, phil;
    gen_grad_terms(cs, mg, invT, logit, phil);
    const float e = __expf(c == lab ? phil - pmax : logit - lmax);
    const float gc = c == lab ? gT * (1.f - e * rz) * dphi : gT * -(e * rz);
    proj = fmaf(gc, cs, proj);
    cg[c] = gc;
  }
  return proj;
}

// The general row loop: the prototypes into shared memory, then a thread
// a row over the grid; each(row, cosv, inv, s_cent) gets the row's
// cosines in the thread's slice (which it may overwrite).
template <typename T, typename Each>
__device__ __forceinline__ void gen_rows(const T* __restrict__ feats,
                                         const float* __restrict__ centers, int M, int F, int C,
                                         Each&& each) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_cent = reinterpret_cast<float*>(smem);
  float* cosv = s_cent + C * F + threadIdx.x * (C | 1);
  for (int i = threadIdx.x; i < C * F; i += kThreads) s_cent[i] = centers[i];
  __syncthreads();
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; row < M;
       row += step) {
    float inv;
    stream_cosines<T, 0, 1, 0>(feats + row * F, s_cent, cosv, inv, F, C);
    each(row, cosv, inv, s_cent);
  }
}

// This thread's sums over its rows: num = sum(sel * mlpp), den = sum(sel),
// as mpcl_fwd_tiles. With kPseudo, label and sel come from the row's
// cosines; otherwise they are given, and sel may be null (all 1).
template <typename T, bool kPseudo>
__device__ __forceinline__ void gen_mpcl_fwd_sums(const T* __restrict__ feats,
                                                  const int* __restrict__ labels,
                                                  const float* __restrict__ sel,
                                                  const float* __restrict__ centers, int M,
                                                  int F, int C, const Margin& mg, float sel_th,
                                                  float& num, float& den) {
  float n = 0.f, d = 0.f;
  gen_rows<T>(feats, centers, M, F, C, [&](long long row, float* cosv, float, const float*) {
    int lab = 0;
    float s = 1.f;
    if constexpr (kPseudo) {
      lab = row_pseudo_label<0>(cosv, sel_th, s, C);
    } else {
      lab = labels[row];
      if (sel) s = sel[row];
    }
    if (s != 0.f) {   // rows without weight skip the softmax
      n = fmaf(s, gen_margin_softmax(cosv, C, lab, mg), n);
      d += s;
    }
  });
  num = n;
  den = d;
}

// dfeats of every row, as mpcl_bwd_tiles: rows with sel = 0 or a label
// outside [0, C) get zeros; otherwise dx = (dfn - x * inv * <gcos, cos>) *
// inv, dfn[k] = sum_c gcos[c] * cent[c][k] over c ascending.
template <typename T, bool kPseudo>
__device__ __forceinline__ void gen_mpcl_bwd_dfeats(const T* __restrict__ feats,
                                                  const int* __restrict__ labels,
                                                  const float* __restrict__ sel,
                                                  const float* __restrict__ centers, int M,
                                                  int F, int C, const Margin& mg, float sel_th,
                                                  float coef, T* __restrict__ dfeats) {
  const float invT = 1.f / mg.T;
  gen_rows<T>(feats, centers, M, F, C,
              [&](long long row, float* cg, float inv, const float* s_cent) {
    int lab = 0;
    float s = 1.f;
    if constexpr (kPseudo) {
      lab = row_pseudo_label<0>(cg, sel_th, s, C);
    } else {
      lab = labels[row];
      if (sel) s = sel[row];
    }
    T* out = dfeats + row * F;
    if (s == 0.f) {
      for (int k = 0; k < F; ++k) out[k] = from_f32<T>(0.f);
      return;
    }
    const float xs = inv * gen_margin_grad(cg, C, lab, mg, invT, coef * s);
    const T* x = feats + row * F;
    for (int k = 0; k < F; ++k) {
      float dfn = 0.f;
      for (int c = 0; c < C; ++c) dfn = fmaf(cg[c], s_cent[c * F + k], dfn);
      out[k] = from_f32<T>((dfn - to_f32(x[k]) * xs) * inv);
    }
  });
}

// labels[row], mask[row] of every row, as pseudo_label_tiles.
template <typename T>
__device__ __forceinline__ void gen_pseudo_label_rows(const T* __restrict__ feats,
                                                      const float* __restrict__ centers, int M,
                                                      int F, int C, float sel_th,
                                                      int* __restrict__ labels,
                                                      float* __restrict__ mask) {
  gen_rows<T>(feats, centers, M, F, C, [&](long long row, float* cosv, float, const float*) {
    float s;
    labels[row] = row_pseudo_label<0>(cosv, sel_th, s, C);
    mask[row] = s;
  });
}

}  // namespace slcl
