#!/usr/bin/env python3
"""Time variants of the port's ring kernels on one CUDA card.

Run from the root of a checkout, on a machine with the card:

    python3 tools/ring_variants.py [bwd | fwd | std | bwd_soft | gen_bwd | gen_fwd |
                                    variant ...] [--parent DIR]

Each variant is a set of text edits of ``slcl_torch/csrc``; the script
copies the sources into ``slcl_torch/_build/variants/<name>`` (git-ignored),
applies the edits, builds the libraries the variant concerns with the port's
nvcc flags (all builds started together), and times its kernels at the main
path's shapes (M = 16*224*224, F = 32, C = 4, bf16) with
``chip_smoke.time_ms``, three times each, then once more in reverse order.
"base" is the source as it stands; the others show what its parameters buy.

- ``bwd`` variants edit ``mpcl_bwd_tile.cuh`` and time ``mpcl_bwd`` and
  ``mpcl_pseudo_bwd``;
- ``fwd_*`` variants edit ``mpcl_fwd_tile.cuh`` and ``soft_centroids.cu``
  and time the kernels that only read their rows, all on direct loads:
  ``mpcl_pseudo_fwd``; ``mpcl_fwd`` without sel, the step's call, and with
  sel, the two-op route's; ``pseudo_label``; and ``soft_centroids_fwd``
  (P = 1, hard weights: the step's call; and P = 2). ``fwd_ring*`` put the
  first four on a bulk-copy ring like the backward's.
- ``std_*`` variants edit ``soft_centroids.cu`` and time the centroids' std
  kernels (soft weights, dprobs, P = 1 and 2: MCCL's stdmin call is P = 2):
  ``std_half`` is the forward on direct loads with half-width ownership (4
  features a thread), ``std_bwd_direct*`` the backward on direct loads with
  rows in flight (the design the ring replaced).
- ``bwd_soft_*`` variants edit ``soft_centroids.cu`` and time the
  centroids' backward ring: the std-free kernel's three forms (the slcl
  step's hard P = 1 call, the mccl step's soft P = 1 and P = 2 calls with
  dprobs) and, where the edit reaches them, the std backward's two rows:
  ``bwd_soft_direct`` stores each thread's values directly instead of one
  bulk store a tile, ``bwd_soft_bulk_p2`` stores the std backward's in bulk
  at P = 2 too, ``bwd_soft_thick`` gives the hard form its features' stages, and
  ``bwd_soft_dsum_smem`` reads a row's dsums from shared memory instead of
  picking them from every partition's in registers.
- ``gen_bwd_*`` variants edit ``centroids_gen_plan.cuh`` and time the
  general centroid backward (``centroids_gen_bwd``) at its cells' three
  calls, C = 5, bf16: ``mccl_p4_c5_f48_std``'s std call (soft, P = 4, F =
  48) and ``img_t_aug`` call (soft, P = 1, F = 48), ``slcl_c5_f24``'s hard
  call (P = 1, F = 24): ``gen_bwd_smem_coefs`` reads the coefficients from
  shared memory instead of registers, ``gen_bwd_bulk`` holds a stage until
  its tile is done and stores dfeats and dprobs from it with one bulk copy
  each (``gen_bwd_bulk_at_once``: filling it again as soon as the store has
  read it, not one tile later), ``gen_bwd_tile10k`` / ``gen_bwd_tile40k``
  aim tiles at half / twice the bytes, ``gen_bwd_four_stages`` /
  ``gen_bwd_three_stages`` keep four / three stages (two here),
  ``gen_bwd_v4_three_blocks`` takes four features a chunk, their
  coefficients in registers, at three blocks an SM,
  ``gen_bwd_three_blocks`` takes three blocks an SM; ``gen_bwd_memonly``,
  ``gen_bwd_no_store`` and
  ``gen_bwd_no_reduce`` drop the class terms, the bulk stores or the sum
  of a row's partials (wrong outputs: they show where the time goes).
- ``gen_fwd_*`` variants edit ``centroids_gen_plan.cuh`` and
  ``centroids_gen.cuh`` and time the general centroid forward
  (``centroids_gen_fwd_partial``'s ring form and its final pass) at its
  cells' three calls (the std, soft P = 4, F = 48 and soft P = 1, F = 48 at
  C = 5; hard P = 1, F = 24) and at the main shape's two forced calls (hard
  P = 1 and the std at P = 2, C = 4, F = 32): ``gen_fwd_two_stages`` /
  ``gen_fwd_four_stages`` keep two / four stages (three here),
  ``gen_fwd_tile10k`` / ``gen_fwd_tile40k`` aim tiles at half / twice the
  bytes, ``gen_fwd_one_block`` takes one block an SM (two here),
  ``gen_fwd_narrow_two_blocks`` the narrow form (the std-free calls, one
  n-tile) at two blocks an SM (three here), ``gen_fwd_wide4`` the bf16
  ring form's warps holding 4 m-tiles (2 here; the std calls),
  ``gen_fwd_no_promote`` keeps the sums in the tensor cores' accumulators
  across k-steps instead of adding each k-step's to f32 totals;
  ``gen_fwd_memonly``, ``gen_fwd_no_rows`` and ``gen_fwd_no_product`` drop
  the row step and the product, the row step, or the product (wrong
  outputs: they show where the time goes). Each call's record has its
  max |kernel - float64 sums| of the centroids (and stddevs), and a
  ``torch.sum`` of its bytes is the read-only yardstick.
  With ``--parent DIR`` (a checkout of an earlier commit), the variant
  ``parent`` builds that checkout's sources unedited and times every
  kernel ``base`` times (``base --parent DIR``: the two trees' templated
  kernels and the general backward's and forward's calls in one call, in
  turns, their outputs held to each other: the templated kernels' and the
  general backward's dfeats bit for bit, the general dprobs within the plain
  version's tolerance, the general forward's centroids and stddevs within
  phase 2's; the script exits 1 if they are not).
  A ptxas report is looked up by the current source's symbols.

A variant that does not compile is reported and left out; the others run.

Yardsticks for what the card's memory allows, timed the same way: one
``copy_`` of the features into a tensor of their shape (read + write) and
one ``torch.sum`` over them (read only), and a ``copy_`` of as many bytes
as each centroid backward form moves. Prints one JSON line per variant
and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BWD, FWD, CEN = "mpcl_bwd_tile.cuh", "mpcl_fwd_tile.cuh", "soft_centroids.cu"
_PLAN, _GEN = "centroids_gen_plan.cuh", "centroids_gen.cuh"
_TILE = "kGenTileBytes = 20 * 1024;"
_GFWD_TILE = "kGenFwdTileBytes = 20 * 1024;"
_GFWD_STAGES = "constexpr int kGenFwdMaxStages = 3;"
_GFWD_BLOCKS = "constexpr int kGenFwdBlocks = 2;"
_GFWD_ROWS = "      for (int rl = gt; rl < RG; rl += gsize) {"
_GFWD_PRODUCT = "      for (int l = 0; l < plan.kpw; ++l) {"
_GFWD_NO_ROWS = (_GEN, _GFWD_ROWS, _GFWD_ROWS.replace("rl < RG;", "rl < 0;"))
_GFWD_NO_PRODUCT = (_GEN, _GFWD_PRODUCT, _GFWD_PRODUCT.replace("l < plan.kpw", "l < 0"))
_STAGES2 = "const int max_stages = 2;"
_STAGES = ("32768 / kFeatBytes < 2 ? 2 : (32768 / kFeatBytes > 4 ? 4 : 32768 / kFeatBytes);")
_FWD_BLOCKS = "kBlocksPerSM = kRowBytes <= 128 ? 3 : 2;"
_CEN_ROWS = "constexpr int kRowsInFlight = P == 1 ? 4 : 2;"
_CEN_BLOCKS = "constexpr int kCentFwdBlocksPerSM = 2;"
_CEN_BLOCKS3 = (CEN, _CEN_BLOCKS, "constexpr int kCentFwdBlocksPerSM = 3;")
_CEN_MEMONLY = (CEN, "        acc.add(x[j], p, id[j], sub == 0, thd, use_thd, weighted);\n",
                "        for (int i = 0; i < 8; ++i) acc.sum[0][i] += x[j][i];\n"
                "        acc.cnt[0] += p[0] + id[j];\n")
BWD_KERNELS = ("mpcl_bwd", "mpcl_pseudo_bwd")
STD_KERNELS = ("soft_centroids_fwd_std", "soft_centroids_fwd_std_p2", "soft_centroids_bwd_std",
               "soft_centroids_bwd_std_p2")
# the std-free centroid backward's three forms: the slcl step's call (hard,
# P = 1, no features read, no dprobs) and the mccl step's two (soft weights,
# dprobs, P = 1 on img_t_aug and P = 2 on img_t)
CEN_BWD = ("soft_centroids_bwd", "soft_centroids_bwd_soft", "soft_centroids_bwd_p2")
MPCL_FWD = ("mpcl_fwd", "mpcl_fwd_sel")   # labels given: without sel, with sel
ROW_FWD = ("mpcl_pseudo_fwd", *MPCL_FWD, "pseudo_label")   # on mpcl_fwd_tile.cuh
CEN_FWD = ("soft_centroids_fwd", "soft_centroids_fwd_p2")
FWD_KERNELS = ROW_FWD + CEN_FWD
# the general centroid backward's calls: (P, F, soft, std) at C = 5
GEN_BWD_CALLS = {"soft_centroids_bwd_std_general": (4, 48, True, True),
                 "soft_centroids_bwd_general_soft": (1, 48, True, False),
                 "soft_centroids_bwd_general": (1, 24, False, False)}
GEN_BWD = tuple(GEN_BWD_CALLS)
GEN_C = 5
# the general centroid forward's calls: (C, P, F, soft, std): the two general
# cells' three, then the forced main-shape pair of chip_smoke.py phase 2
GEN_FWD_CALLS = {"soft_centroids_fwd_std_general": (5, 4, 48, True, True),
                 "soft_centroids_fwd_general_soft": (5, 1, 48, True, False),
                 "soft_centroids_fwd_general": (5, 1, 24, False, False),
                 "soft_centroids_fwd_general_forced": (4, 1, 32, False, False),
                 "soft_centroids_fwd_std_general_forced": (4, 2, 32, True, True)}
GEN_FWD = tuple(GEN_FWD_CALLS)
PARENT_KERNELS = (BWD_KERNELS + FWD_KERNELS + STD_KERNELS + CEN_BWD + GEN_BWD
                  + GEN_FWD)   # --parent
LIB_OF = {"mpcl_bwd": "mpcl", "mpcl_pseudo_bwd": "mpcl_pseudo",
          "mpcl_pseudo_fwd": "mpcl_pseudo", "mpcl_fwd": "mpcl", "mpcl_fwd_sel": "mpcl",
          "pseudo_label": "pseudo_label", "soft_centroids_fwd": "soft_centroids",
          "soft_centroids_fwd_p2": "soft_centroids",
          **dict.fromkeys(STD_KERNELS + CEN_BWD + GEN_BWD + GEN_FWD, "soft_centroids")}
# ptxas entry-function name parts of each timed kernel's instantiation
SYMBOL_OF = {"mpcl_bwd": "mpcl_bwdI13__nv_bfloat16Li32E",
             "mpcl_pseudo_bwd": "mpcl_pseudo_bwdI13__nv_bfloat16Li32E",
             "mpcl_pseudo_fwd": "mpcl_pseudo_fwd_partialI13__nv_bfloat16Li32E",
             "mpcl_fwd": "mpcl_fwd_partialI13__nv_bfloat16Li32E",
             "mpcl_fwd_sel": "mpcl_fwd_partialI13__nv_bfloat16Li32E",
             "pseudo_label": "pseudo_label_kernelI13__nv_bfloat16Li32E",
             "soft_centroids_fwd": "centroids_fwd_partialI13__nv_bfloat16Li32ELi1ELi4EE",
             "soft_centroids_fwd_p2": "centroids_fwd_partialI13__nv_bfloat16Li32ELi2ELi4EE",
             "soft_centroids_fwd_std": "centroids_fwd_std_partialI13__nv_bfloat16Li32ELi1ELi4EE",
             "soft_centroids_fwd_std_p2":
                 "centroids_fwd_std_partialI13__nv_bfloat16Li32ELi2ELi4EE",
             "soft_centroids_bwd_std": "centroids_bwd_stdI13__nv_bfloat16Li32ELi1ELi4EE",
             "soft_centroids_bwd_std_p2": "centroids_bwd_stdI13__nv_bfloat16Li32ELi2ELi4EE",
             "soft_centroids_bwd": "centroids_bwdI13__nv_bfloat16Li32ELi1ELi4EE",
             "soft_centroids_bwd_soft": "centroids_bwdI13__nv_bfloat16Li32ELi1ELi4EE",
             "soft_centroids_bwd_p2": "centroids_bwdI13__nv_bfloat16Li32ELi2ELi4EE",
             # the general backward's form at these calls: V = 8, registers
             "soft_centroids_bwd_std_general": "centroids_gen_bwdI13__nv_bfloat16Lb1ELi8ELi1EE",
             "soft_centroids_bwd_general_soft": "centroids_gen_bwdI13__nv_bfloat16Lb0ELi8ELi1EE",
             "soft_centroids_bwd_general": "centroids_gen_bwdI13__nv_bfloat16Lb0ELi8ELi1EE",
             # the general forward's form: the ring with the std, else narrow
             **{k: "centroids_gen_fwd_partialI13__nv_bfloat16Lb%dELi%dEE" % (v[4], 0 if v[4] else 2)
                for k, v in GEN_FWD_CALLS.items()}}


def _section(f: str, start: str, end: str) -> str:
    """The text of ``csrc/<f>`` from ``start`` through the next ``end``: the
    old side of an edit that replaces a whole passage."""
    text = (ROOT / "slcl_torch" / "csrc" / f).read_text()
    a = text.index(start)
    return text[a:text.index(end, a) + len(end)]


# The forwards' tile loop through a read-only bulk-copy ring with the
# backward's shape, in place of the direct loads: 256-row tiles, two 16 KB
# stages, one elected thread filling them, a thread streaming its row from
# shared memory a chunk at a time, the warp freeing the stage before the
# softmax. A row's label and sel are plain loads started before the wait.
_RING = (FWD, _section(FWD, "template <typename T, int F>\nstruct FwdTile {",
                       "      side_cur = side_nxt;\n    }\n  }\n}\n"), """\
template <typename T, int F>
struct FwdTile {
  static constexpr int kRowBytes = F * static_cast<int>(sizeof(T));
  static constexpr int kRows = kThreads;
  static constexpr int kFeatBytes = kRows * kRowBytes;
  static constexpr int kStages =
      32768 / kFeatBytes < 2 ? 2 : (32768 / kFeatBytes > 4 ? 4 : 32768 / kFeatBytes);
  static constexpr int kStageBytes = kFeatBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + kC * F * 4 + 2 * kStages * 8;
  static constexpr int kBlocksPerSM = 3;
};

template <typename T, int F, typename Side, typename Each>
__device__ __forceinline__ void fwd_rows(const T* __restrict__ feats,
                                         const float* __restrict__ centers, int M,
                                         Side&& side, Each&& each) {
  using G = FwdTile<T, F>;
  using S = decltype(side(0));
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
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int stage = it % G::kStages;
    const uint32_t parity = (it / G::kStages) & 1;
    const int row = tile * G::kRows + static_cast<int>(threadIdx.x);
    const bool live = row < M;
    S sd{};
    if (live) sd = side(row);
    mbar_wait(&full[stage], parity);
    float cosv[kC], inv;
    if (live)
      stream_cosines<T, F>(reinterpret_cast<const T*>(smem + stage * G::kStageBytes) +
                               threadIdx.x * F,
                           s_cent, cosv, inv);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (live) each(row, cosv, sd);
    if (threadIdx.x == 0) {
      const int next = tile + G::kStages * gridDim.x;
      if (next < ntiles) {
        mbar_wait(&empty[stage], parity);
        fill(stage, next);
      }
    }
  }
}
""")
# On that ring, a given label and sel ride in a side area of the stage,
# bulk-copied in whole groups of four rows (the backward's way), a ragged
# tail from memory. These edits apply after _RING, to mpcl.cu's forward only.
_RING_SIDE = [
    (FWD, "  static constexpr int kStageBytes = kFeatBytes;\n",
     "  static constexpr int kStageBytes = kFeatBytes + 2 * kRows * 4;\n"),
    (FWD, "                                         Side&& side, Each&& each) {\n"
          "  using G = FwdTile<T, F>;\n  using S = decltype(side(0));\n  constexpr int kWarps",
     "                                         Side&& side, Each&& each,\n"
     "                                         const int* side_lab = nullptr,\n"
     "                                         const float* side_sel = nullptr) {\n"
     "  using G = FwdTile<T, F>;\n  using S = decltype(side(0));\n  constexpr int kWarps"),
    (FWD, "    const uint32_t fbytes = min(G::kRows, M - row0) * G::kRowBytes;\n"
          "    mbar_expect_tx(&full[stage], fbytes);\n",
     "    const int rows = min(G::kRows, M - row0);\n"
     "    const uint32_t fbytes = rows * G::kRowBytes;\n"
     "    const uint32_t sbytes = side_lab ? (rows & ~3) * 4 : 0;\n"
     "    unsigned char* area = smem + stage * G::kStageBytes + G::kFeatBytes;\n"
     "    mbar_expect_tx(&full[stage], fbytes + sbytes * (side_sel ? 2u : 1u));\n"
     "    if (sbytes) {\n"
     "      bulk_copy(area, side_lab + row0, sbytes, &full[stage]);\n"
     "      if (side_sel)\n"
     "        bulk_copy(area + G::kRows * 4, side_sel + row0, sbytes, &full[stage]);\n"
     "    }\n"),
    (FWD, "    if (live) sd = side(row);\n    mbar_wait(&full[stage], parity);\n",
     "    mbar_wait(&full[stage], parity);\n"
     "    if (live) {\n"
     "      const int r = threadIdx.x;\n"
     "      const unsigned char* area = smem + stage * G::kStageBytes + G::kFeatBytes;\n"
     "      if (side_lab && r < (min(G::kRows, M - tile * G::kRows) & ~3)) {\n"
     "        sd.lab = reinterpret_cast<const int*>(area)[r];\n"
     "        sd.sel = side_sel ? reinterpret_cast<const float*>(area + G::kRows * 4)[r]\n"
     "                          : 1.f;\n"
     "      } else {\n"
     "        sd = side(row);\n"
     "      }\n"
     "    }\n"),
    (FWD, "      });\n  num = n;\n", "      }, kPseudo ? nullptr : labels, sel);\n  num = n;\n"),
]

# The std forward on direct loads with half-width ownership, design (b): a
# thread owns 4 features (8-byte loads of bf16, F/4 threads a row), which
# halves its sums (48 at P = 2, so 2 blocks per SM at both P), and starts
# four rows' loads before it accumulates. It keeps the ring's tile type's
# name, which the grid and the launch ask.
_STD_HALF = [
    (CEN, _section(CEN, "// The std forward's read-only ring: tiles of 256 rows",
                   "bulk copies of whole rows\");\n};\n"),
     """\
constexpr int kHalfRows = 4;
template <typename T, int F, int P>
struct StdFwdRing {
  static constexpr int kRows = kHalfRows * (kThreads / (F / 4));
  static constexpr int kSmemBytes = 0;
};

__device__ __forceinline__ void half_load4(const float* p, float (&x)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ void half_load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  x[0] = __uint_as_float(u.x << 16); x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16); x[3] = __uint_as_float(u.y & 0xffff0000u);
}
"""),
    (CEN, _section(CEN, "// The std forward's streaming pass: a persistent grid",
                   "  std_store_sq<F, C, V, P * C * F + P * C + 1>(sq, part_out);\n}\n"), """\
template <typename T, int F, int P, int C>
__global__ void __launch_bounds__(kThreads, kStdFwdBlocks<P>)
centroids_fwd_std_partial(const T* __restrict__ feats, const float* __restrict__ probs,
                          const int* __restrict__ assign, int M, float thd, int use_thd,
                          int weighted, float* __restrict__ part_out) {
  constexpr int TPR = F / 4;
  constexpr int RPB = kThreads / TPR;
  constexpr int kTile = StdFwdRing<T, F, P>::kRows;
  const int sub = threadIdx.x % TPR;
  const int r = threadIdx.x / TPR;
  Acc<P, C, 4> acc;
  acc.clear();
  float sq[C][4];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) sq[c][j] = 0.f;
  for (long long base = (long long)blockIdx.x * kTile; base < M;
       base += (long long)gridDim.x * kTile) {
    float x[kHalfRows][4];
    float4 pv[kHalfRows];
    int id[kHalfRows];
#pragma unroll
    for (int j = 0; j < kHalfRows; ++j) {
      const long long row = base + j * RPB + r;
      id[j] = 0;
      if (row < M) {
        half_load4(feats + (size_t)row * F + sub * 4, x[j]);
        pv[j] = __ldg(reinterpret_cast<const float4*>(probs) + row);
        if constexpr (P > 1) id[j] = assign[row];
      }
    }
#pragma unroll
    for (int j = 0; j < kHalfRows; ++j) {
      if (base + j * RPB + r < M) {
        const float p[C] = {pv[j].x, pv[j].y, pv[j].z, pv[j].w};
        float w[C], cert, in_part;
        int part;
        weights_of<P, C>(p, id[j], thd, use_thd, weighted, w, cert, in_part, part);
        float4 wp[P];
#pragma unroll
        for (int pp = 0; pp < P; ++pp) {
          const float on = pp == part ? 1.f : 0.f;
          wp[pp] = make_float4(w[0] * on, w[1] * on, w[2] * on, w[3] * on);
        }
        std_fwd_row<P, C, 4>(acc, sq, x[j], wp, cert, sub == 0);
      }
    }
  }
  acc.template store<F>(part_out);
  std_store_sq<F, C, 4, P * C * F + P * C + 1>(sq, part_out);
}
""")]
# The std backward on direct loads, the design the ring replaced: a thread
# loads kBwdStdRows<P> rows (16-byte features, a float4 of probs, the id)
# before it computes the first, on a persistent grid of tiles of that many
# passes, with the coefficients alone in dynamic shared memory.
_STD_BWD_DIRECT = [
    (CEN, "template <typename T, int F, int P>\nusing BwdStdTiles = BwdRing<T, F, P, true>;\n", """\
// Rows a thread of the std backward loads before it computes the first:
// what 128 registers hold beside its coefficients (a / W at its 8
// features; at P = 1 the dsums too)
template <int P>
constexpr int kBwdStdRows = P == 1 ? 2 : 4;

// Tiles of the std backward's persistent grid, and its dynamic shared
// memory: dsums (P*C, F), a and a / W (C, F), dcounts (P*C).
template <typename T, int F, int P>
struct BwdStdTiles {
  static constexpr int kRows = kBwdStdRows<P> * (kThreads / (F / 8));
  static constexpr int kSmemBytes = (P * slcl::kC * F + 2 * slcl::kC * F + P * slcl::kC) * 4;
};

// 8 values of T as loaded, unconverted: one 16-byte vector of bf16 or two
// of f32. A bf16 is the top half of an f32, so its conversion is exact.
template <typename T>
constexpr int kRaw = static_cast<int>(sizeof(T)) / 2;

template <typename T>
__device__ __forceinline__ void std_raw_load(const T* p, uint4 (&u)[kRaw<T>]) {
#pragma unroll
  for (int v = 0; v < kRaw<T>; ++v) u[v] = __ldg(reinterpret_cast<const uint4*>(p) + v);
}

__device__ __forceinline__ void std_raw_unpack(const uint4 (&u)[1], float (&x)[8]) {
  const uint32_t h[4] = {u[0].x, u[0].y, u[0].z, u[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(h[i] << 16);
    x[2 * i + 1] = __uint_as_float(h[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void std_raw_unpack(const uint4 (&u)[2], float (&x)[8]) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    x[4 * v] = __uint_as_float(u[v].x);
    x[4 * v + 1] = __uint_as_float(u[v].y);
    x[4 * v + 2] = __uint_as_float(u[v].z);
    x[4 * v + 3] = __uint_as_float(u[v].w);
  }
}
"""),
    (CEN, """  bwd_ring<T, F, P, C, true>(feats, probs, assign, M, thd, use_thd, weighted, dcents, cents,
                             counts, dfeats, dprobs, gstd, s2, stdv);
""", """\
  constexpr int TPR = F / 8;
  constexpr int RPB = kThreads / TPR;
  constexpr int NPC = P * C;
  constexpr int R = kBwdStdRows<P>;
  using G = BwdStdTiles<T, F, P>;
  extern __shared__ __align__(16) float s_co[];
  float* s_dsum = s_co;
  float* s_a = s_dsum + NPC * F;
  float* s_aw = s_a + C * F;
  float* s_dcnt = s_aw + C * F;
  std_bwd_coefs<F, P, C>(dcents, cents, counts, gstd, s2, stdv, s_dsum, s_a, s_aw, s_dcnt);
  const int sub = threadIdx.x % TPR;
  const int r = threadIdx.x / TPR;
  float aw[C][8];
  float dsr[P == 1 ? C : 1][8];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    slcl::load8(s_aw + c * F + sub * 8, aw[c]);
    if constexpr (P == 1) slcl::load8(s_dsum + c * F + sub * 8, dsr[c]);
  }
  for (long long base = (long long)blockIdx.x * G::kRows; base < M;
       base += (long long)gridDim.x * G::kRows) {
    uint4 raw[R][kRaw<T>];
    float4 pv[R];
    int id[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long long row = base + j * RPB + r;
      id[j] = 0;
      pv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int v = 0; v < kRaw<T>; ++v) raw[j][v] = make_uint4(0u, 0u, 0u, 0u);
      if (row < M) {
        std_raw_load(feats + (size_t)row * F + sub * 8, raw[j]);
        pv[j] = __ldg(reinterpret_cast<const float4*>(probs) + row);
        if constexpr (P > 1) id[j] = __ldg(assign + row);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long long row = base + j * RPB + r;
      float x[8];
      float4 dp = make_float4(0.f, 0.f, 0.f, 0.f);
      std_raw_unpack(raw[j], x);
      std_bwd_row<F, P, C>(x, pv[j], id[j], thd, use_thd, weighted, aw, dsr, s_dsum, s_dcnt,
                           sub, dprobs != nullptr, [&](const float (&dx)[8]) {
                             if (row < M) slcl::store8(dfeats + (size_t)row * F + sub * 8, dx);
                           }, dp);
      if (dprobs != nullptr && row < M && sub == 0) reinterpret_cast<float4*>(dprobs)[row] = dp;
    }
  }
""")]

# The centroid backward's rows reading their partition's dsums from shared
# memory instead of picking them from every partition's in registers
_BWD_DSUM_SMEM = [
    (CEN, "const float (&dsr)[P * C][8], const float* s_dcnt,\n",
     "const float (&dsr)[P * C][8], const float* s_dsum,\n"
     "                                        const float* s_dcnt,\n"),
    (CEN, """#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ds[j] = dsr[c][j];
#pragma unroll
      for (int pp = 1; pp < P; ++pp)
        if (part == pp) ds[j] = dsr[pp * C + c][j];
    }
""", "    slcl::load8(s_dsum + (part * C + c) * F + sub * 8, ds);\n"),
    (CEN, "bwd_row<F, P, C>(x, pv, id, thd, use_thd, weighted, dsr, s_dcnt,",
     "bwd_row<F, P, C>(x, pv, id, thd, use_thd, weighted, dsr, s_dsum, s_dcnt,")]

_BWD_STORE = "constexpr bool kBulkStore = !kStd || P == 1;"
_BWD_DIRECT = (CEN, _BWD_STORE, "constexpr bool kBulkStore = false;")
_BWD_BUDGET = "kBudget = kStd ? 49152 : (kBulkStore<P, kStd> ? 81920 : 65536);"
_BWD_MAX = "kMaxStages = kStd ? 3 : (kBulkStore<P, kStd> ? 5 : 4);"

_STD_ROW = "        std_fwd_row<P, C, V>(acc, sq, x, s_wp[warp][l], s_cert[warp][l], sub == 0);\n"
_STD_PASS = "#pragma unroll 2\n    for (int q = 0; q < 32 / RPW; ++q) {\n"
_STD_SQ = ("#pragma unroll\n  for (int j = 0; j < V; ++j) {\n    const float x2 = x[j] * x[j];\n"
           "#pragma unroll\n    for (int c = 0; c < C; ++c) sq[c][j] = fmaf(w[c], x2, sq[c][j]);\n  }\n")

# name -> (kernels it concerns, [(file, old text, new text)])
VARIANTS = {
    "base": (PARENT_KERNELS, []),
    # the ring alone: each row is scaled and written back, no MPCL math
    "memonly": (BWD_KERNELS, [
        (BWD, "  // one chunk at a time, and the row and prototypes read again below: held\n",
         "  if (true) {\n    for (int k = 0; k < F; k += 8) {\n      float x[8];\n"
         "      load8(row + k, x);\n      for (int i = 0; i < 8; ++i) x[i] *= coef;\n"
         "      store8(row + k, x);\n    }\n    return;\n  }\n")]),
    # the cosine loop cut to its first chunk: what the cosine phase costs
    # (it is shared with the forwards, so this variant concerns them too)
    "nocos": (BWD_KERNELS + ROW_FWD, [
        ("mpcl_row.cuh", "#pragma unroll(kUnroll)\n    for (int k = 0; k < fw; k += 8) {",
         "#pragma unroll(kUnroll)\n    for (int k = 0; k < 8; k += 8) {")]),
    "stages3": (BWD_KERNELS, [(BWD, _STAGES, "3;")]),
    "stages4": (BWD_KERNELS, [(BWD, _STAGES, "4;")]),
    "blocks4": (BWD_KERNELS, [(BWD, "constexpr int kRingBlocksPerSM = 3;",
                               "constexpr int kRingBlocksPerSM = 4;")]),
    # the forwards' feeds alone: every loaded vector is folded into one
    # value, no cosines, softmax or weights
    "fwd_memonly": (FWD_KERNELS, [
        (FWD, "      stream_cosines<T, F, F / 8>(reinterpret_cast<const T*>(cur), s_cent, cosv,"
              " inv);\n",
         "      uint32_t u = 0;\n#pragma unroll\n      for (int v = 0; v < G::kVec; ++v)\n"
         "        u ^= cur[v].x ^ cur[v].y ^ cur[v].z ^ cur[v].w;\n"
         "      cosv[0] = __uint_as_float(u & 0x3fffffffu) + s_cent[0];\n"
         "      cosv[1] = cosv[2] = cosv[3] = inv = 0.f;\n"),
        (FWD, "        if (r.sel != 0.f) {  // rows without weight skip the softmax\n",
         "        n += cosv[0];\n        if (false) {\n"),
        _CEN_MEMONLY]),
    # one row in flight a thread: a row is loaded where it is used
    "fwd_1row": (ROW_FWD, [(FWD, "kTwoRows = kRowBytes <= 64;", "kTwoRows = false;")]),
    "fwd_blocks2": (ROW_FWD, [(FWD, _FWD_BLOCKS, "kBlocksPerSM = 2;")]),
    # the prototypes in static shared memory (ptxas then spills)
    "fwd_static": (ROW_FWD, [
        (FWD, "  extern __shared__ __align__(128) unsigned char smem[];\n"
              "  float* s_cent = reinterpret_cast<float*>(smem);\n",
         "  __shared__ __align__(16) float s_cent[kC * F];\n")]),
    "fwd_blocks4": (ROW_FWD, [(FWD, _FWD_BLOCKS, "kBlocksPerSM = 4;")]),
    # the same kernels fed by a bulk-copy ring (see _RING); with 3 stages;
    # with label and sel through a side area of the stage
    "fwd_ring": (ROW_FWD, [_RING]),
    "fwd_ring_stages3": (ROW_FWD, [_RING, (FWD, _STAGES, "3;")]),
    "fwd_ring_side": (MPCL_FWD, [_RING, *_RING_SIDE]),
    # the centroids' rows in flight a thread and blocks per SM: two rows at
    # P = 1 (at 3 blocks per SM, 80 registers), four rows at 3 blocks per SM,
    # and four rows at P = 2
    "fwd_rows2": (CEN_FWD[:1], [(CEN, _CEN_ROWS, "constexpr int kRowsInFlight = 2;"),
                                _CEN_BLOCKS3]),
    "fwd_cen_blocks3": (CEN_FWD[:1], [_CEN_BLOCKS3]),
    "fwd_rows4_p2": (CEN_FWD[1:], [(CEN, _CEN_ROWS, "constexpr int kRowsInFlight = 4;")]),
    # the centroids' std kernels: design (b) for the forward; the ring
    # forward with 8 features a thread (one block per SM at P = 2); the
    # backward on direct loads, also
    # with one row more a thread; the ring backward with 4 stages
    "std_half": (STD_KERNELS[:2], _STD_HALF),
    "std_vec8": (STD_KERNELS[:2], [
        (CEN, "constexpr int kStdFwdVec = 4;", "constexpr int kStdFwdVec = 8;"),
        (CEN, "constexpr int kStdFwdBlocks = 2;", "constexpr int kStdFwdBlocks = P == 1 ? 2 : 1;")]),
    # the ring's feed alone (each row folded into one sum), and the kernel
    # without the S2 sums: what the feed and the std's own sums cost
    "std_memonly": (STD_KERNELS[:2], [
        (CEN, _STD_ROW, "        for (int j = 0; j < V; ++j) acc.sum[0][j] += x[j];\n"
                        "        acc.cnt[0] += s_wp[warp][l][0].x + s_cert[warp][l];\n")]),
    "std_nosq": (STD_KERNELS[:2], [(CEN, _STD_SQ, "")]),
    # the passes over a warp's rows unrolled less and more
    "std_unroll1": (STD_KERNELS[:2], [(CEN, _STD_PASS, _STD_PASS.replace("unroll 2", "unroll 1"))]),
    "std_unroll4": (STD_KERNELS[:2], [(CEN, _STD_PASS, _STD_PASS.replace("unroll 2", "unroll 4"))]),
    "std_bwd_direct": (STD_KERNELS[2:], _STD_BWD_DIRECT),
    "std_bwd_direct_rows": (STD_KERNELS[2:], [
        *_STD_BWD_DIRECT, (CEN, "constexpr int kBwdStdRows = P == 1 ? 2 : 4;",
                           "constexpr int kBwdStdRows = P == 1 ? 3 : 5;")]),
    "std_bwd_stages4": (STD_KERNELS[2:], [
        (CEN, _BWD_BUDGET, _BWD_BUDGET.replace("kStd ? 49152", "kStd ? 65536")),
        (CEN, _BWD_MAX, _BWD_MAX.replace("kStd ? 3", "kStd ? 4"))]),
    # the centroids' backward ring (both kernels share it): each thread
    # storing its dfeats and dprobs directly (no bulk store a tile); the std
    # one's bulk stores at P = 2 too; the hard form's thin stages as thick ones; the
    # std-free one's dsums read from shared memory
    "bwd_soft_direct": (CEN_BWD + STD_KERNELS[2:], [_BWD_DIRECT]),
    "bwd_soft_bulk_p2": (STD_KERNELS[3:], [
        (CEN, _BWD_STORE, "constexpr bool kBulkStore = true;")]),
    "bwd_soft_thick": (CEN_BWD[:1], [(CEN, "const bool thin = !read_feats && !bulk;",
                                      "const bool thin = false;")]),
    "bwd_soft_dsum_smem": (CEN_BWD, _BWD_DSUM_SMEM),
    # the general centroid backward's plan (csrc/centroids_gen_plan.cuh):
    # coefficients from shared memory; direct stores; tiles of half and
    # twice the bytes; two stages
    "gen_bwd_smem_coefs": (GEN_BWD, [(_PLAN, "  p.regs = p.nch <= 32 && p.V == 8 &&",
                                      "  p.regs = false && p.nch <= 32 && p.V == 8 &&")]),
    # the stage held until the tile is done and stored with one bulk copy an
    # array (the stage filled again one tile later, or at once)
    "gen_bwd_bulk": (GEN_BWD[:2], [(_PLAN, "  p.bulk = 0;", "  p.bulk = p.feats;")]),
    "gen_bwd_bulk_at_once": (GEN_BWD[:2], [
        (_PLAN, "  p.bulk = 0;", "  p.bulk = p.feats;"),
        (_GEN, "constexpr bool kGenDeferFill = true;", "constexpr bool kGenDeferFill = false;")]),
    "gen_bwd_tile10k": (GEN_BWD, [(_PLAN, _TILE, "kGenTileBytes = 10 * 1024;")]),
    "gen_bwd_tile40k": (GEN_BWD, [(_PLAN, _TILE, "kGenTileBytes = 40 * 1024;")]),
    # the dsums of up to eight classes in registers (six here); the argmax
    # taken for soft weights without a threshold too
    "gen_bwd_reg8": (GEN_BWD[1:], [(_PLAN, "constexpr int kGenRegClasses = 6;",
                                    "constexpr int kGenRegClasses = 8;")]),
    "gen_bwd_argmax": (GEN_BWD[:2], [(_GEN, "      const bool argmax = !weighted || use_thd;",
                                      "      const bool argmax = true;")]),
    "gen_bwd_four_stages": (GEN_BWD, [(_PLAN, _STAGES2, "const int max_stages = 4;")]),
    "gen_bwd_three_stages": (GEN_BWD, [(_PLAN, _STAGES2, "const int max_stages = 3;")]),
    # four features a chunk with the chunk's coefficients in registers, at
    # three blocks an SM (fewer registers a lane, more warps)
    "gen_bwd_v4_three_blocks": (GEN_BWD, [
        (_PLAN, "  return F % 8 == 0 ? 8 : (F % 4 == 0 ? 4", "  return F % 4 == 0 ? 4 : (F % 8 == 0 ? 8"),
        (_PLAN, "  p.regs = p.nch <= 32 && p.V == 8 &&", "  p.regs = p.nch <= 32 && p.V == 4 &&"),
        (_PLAN, "kGenBwdBudget = 110 * 1024;", "kGenBwdBudget = 72 * 1024;"),
        (_GEN, "__global__ void __launch_bounds__(kThreads, 2)\ncentroids_gen_bwd(",
         "__global__ void __launch_bounds__(kThreads, 3)\ncentroids_gen_bwd("),
        (CEN, "  } else if ((plan).V == 4) {",
         "  } else if ((plan).V == 4 && (plan).regs) {                                               \\\n"
         "    constexpr int kV = 4, kForm = slcl::kGenRegCoefs; __VA_ARGS__;                        \\\n"
         "  } else if ((plan).V == 4) {")]),
    # three blocks an SM: a smaller budget and a tighter register cap
    "gen_bwd_three_blocks": (GEN_BWD, [
        (_PLAN, "kGenBwdBudget = 110 * 1024;", "kGenBwdBudget = 72 * 1024;"),
        (_GEN, "__global__ void __launch_bounds__(kThreads, 2)\ncentroids_gen_bwd(",
         "__global__ void __launch_bounds__(kThreads, 3)\ncentroids_gen_bwd(")]),
    # where the time goes (wrong outputs): no class terms at all (the ring,
    # the weights and the stores alone); no stores of dfeats and dprobs; the
    # probs for weights (no argmax, certain flag or partition); dprobs from
    # a row's first four partials
    "gen_bwd_memonly": (GEN_BWD, [
        (_GEN, "        if constexpr (kForm == kGenRegCoefs) {\n#pragma unroll\n"
               "          for (int c = 0; c < kRegClasses; ++c) {",
         "        if constexpr (false && kForm == kGenRegCoefs) {\n#pragma unroll\n"
         "          for (int c = 0; c < kRegClasses; ++c) {"),
        (_GEN, "          for (int c = 0; c < C; ++c) {\n            float ds[V];",
         "          for (int c = 0; c < 0; ++c) {\n            float ds[V];")]),
    "gen_bwd_no_store": (GEN_BWD[:2], [
        (_GEN, "        gen_store<V>(out, dx);", "        if (dx[0] == 1.25e-30f) gen_store<V>(out, dx);"),
        (_GEN, "          else dprobs[row0 * C + i] = dp;",
         "          else if (dp == 1.25e-30f) dprobs[row0 * C + i] = dp;")]),
    "gen_bwd_no_weights": (GEN_BWD, [
        (_GEN, "        for (int c = 0; c < C; ++c) s_w[r * C + c] = gen_weight(pr, c, w, weighted);\n"
               "        s_part[r] = w.part;\n        s_g[r] = w.g;",
         "        for (int c = 0; c < C; ++c) s_w[r * C + c] = pr[c];\n"
         "        s_part[r] = 0;\n        s_g[r] = 1.f;")]),
    "gen_bwd_no_reduce": (GEN_BWD[:2], [
        (_GEN, "          for (int k = 1; k < tp4 / 4; ++k) {", "          for (int k = 1; k < 1; ++k) {")]),
}


VARIANTS.update({
    # the general centroid forward's plan (csrc/centroids_gen_plan.cuh) and
    # ring form: two or four stages (three here); tiles of half and twice
    # the bytes; one block an SM (two here; registers up to 255)
    "gen_fwd_two_stages": (GEN_FWD, [(_PLAN, _GFWD_STAGES, "constexpr int kGenFwdMaxStages = 2;")]),
    "gen_fwd_four_stages": (GEN_FWD, [(_PLAN, _GFWD_STAGES, "constexpr int kGenFwdMaxStages = 4;")]),
    "gen_fwd_tile10k": (GEN_FWD, [(_PLAN, _GFWD_TILE, "kGenFwdTileBytes = 10 * 1024;")]),
    "gen_fwd_tile40k": (GEN_FWD, [(_PLAN, _GFWD_TILE, "kGenFwdTileBytes = 40 * 1024;")]),
    "gen_fwd_one_block": (GEN_FWD, [(_PLAN, _GFWD_BLOCKS, "constexpr int kGenFwdBlocks = 1;")]),
    # the narrow form at two blocks an SM (three here), the ring's budget
    "gen_fwd_narrow_two_blocks": (GEN_FWD[1:4], [
        (_PLAN, "constexpr int kGenFwdNarrowBlocks = 3;", "constexpr int kGenFwdNarrowBlocks = 2;"),
        (_PLAN, "constexpr int kGenFwdNarrowBudget = 72 * 1024;",
         "constexpr int kGenFwdNarrowBudget = 110 * 1024;")]),
    # the bf16 ring form's warps holding 4 m-tiles (2 here): fewer warps
    # split over m, more registers
    "gen_fwd_wide4": (GEN_FWD[0:1] + GEN_FWD[4:5], [
        (_PLAN, "constexpr int kGenFwdMTWide = 2;", "constexpr int kGenFwdMTWide = 4;")]),
    # the tensor cores' accumulators kept across k-steps (no f32 totals on
    # the CUDA cores)
    "gen_fwd_no_promote": (GEN_FWD, [
        (_GEN, "                float d[4] = {0.f, 0.f, 0.f, 0.f};",
         "                float (&d)[4] = tot[i][j];"),
        (_GEN, "#pragma unroll\n                for (int e = 0; e < 4; ++e) tot[i][j][e] += d[e];\n",
         "")]),
    # where the time goes (wrong outputs): the ring alone; without the
    # product; without the row step
    "gen_fwd_memonly": (GEN_FWD, [_GFWD_NO_ROWS, _GFWD_NO_PRODUCT]),
    "gen_fwd_no_product": (GEN_FWD, [_GFWD_NO_PRODUCT]),
    "gen_fwd_no_rows": (GEN_FWD, [_GFWD_NO_ROWS]),
})


def ptxas_of(log: str, symbol: str) -> list:
    """[registers, spill-store bytes, stack-frame bytes] of the entry
    function whose name holds ``symbol`` in one nvcc log."""
    fn, spill, stack = "", 0, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
            stack = int(line.split("bytes stack frame")[0].split()[-1])
        elif "Used" in line and symbol in fn:
            return [int(line.split("Used")[1].split()[0]), spill, stack]
    return []


def build_variants(names, parent=None):
    """Build each variant's libraries; returns (directory, the variants that
    built). One that nvcc refuses is reported on stderr and left out.
    ``parent``: the checkout whose sources the variant "parent" builds."""
    from slcl_torch.ops.cuda import build
    out = build.BUILD_DIR / "variants"
    shutil.rmtree(out, ignore_errors=True)
    procs = []
    for name in names:
        kernels, edits = VARIANTS[name] if name != "parent" else (PARENT_KERNELS, [])
        d = out / name
        shutil.copytree(Path(parent) / "slcl_torch" / "csrc" if name == "parent" else build.CSRC,
                        d)
        for f, old, new in edits:
            text = (d / f).read_text()
            if old not in text:
                raise SystemExit(f"variant {name}: edit does not apply to {f}")
            (d / f).write_text(text.replace(old, new))
        for lib in sorted({LIB_OF[k] for k in kernels}):
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / f"{lib}.so"),
                   str(d / f"{lib}.cu")]
            procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)))
    failed = set()
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            if name == "base":
                raise SystemExit(f"nvcc failed for {lib}.cu\n{log}")
            failed.add(name)
            print(f"variant {name}: nvcc failed for {lib}.cu, left out\n{log}",
                  file=sys.stderr)
        (out / name / f"{lib}.log").write_text(log)
    return out, [n for n in names if n not in failed]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs only on a card", file=sys.stderr)
        return 2
    from chip_smoke import C, F, M, time_ms
    from slcl_torch.ops.cuda import mpcl as K
    from slcl_torch.ops.cuda import mpcl_pseudo as KP
    from slcl_torch.ops.cuda import pseudo_label as KL
    from slcl_torch.ops.cuda import ptr, raise_on_error, stream_of
    from slcl_torch.ops.cuda import soft_centroids as KC

    args, parent = sys.argv[1:], None
    if "--parent" in args:
        i = args.index("--parent")
        parent = args[i + 1]
        del args[i:i + 2]
    group = {"fwd": "fwd_", "std": "std_", "bwd_soft": "bwd_soft_", "gen_bwd": "gen_bwd_",
             "gen_fwd": "gen_fwd_"}
    names = []
    for arg in args or list(VARIANTS):
        if arg in ("bwd", "fwd", "std", "bwd_soft", "gen_bwd", "gen_fwd"):
            names += [n for n in VARIANTS if n != "base" and (
                n.startswith(group[arg]) if arg in group
                else not n.startswith(tuple(group.values())))]
        else:
            names.append(arg)
    names = ["base", *dict.fromkeys(n for n in names if n != "base")]
    if parent:
        names.append("parent")
    out, names = build_variants(names, parent)
    kernels_of = {n: VARIANTS[n][0] if n != "parent" else PARENT_KERNELS for n in names}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn(M, F, generator=g, device=dev).to(torch.bfloat16)
    labels = torch.randint(0, C, (M,), generator=g, device=dev, dtype=torch.int32)
    sel = torch.randint(0, 2, (M,), generator=g, device=dev).float()
    centers = torch.randn(C, F, generator=g, device=dev)
    centers = centers / centers.norm(dim=1, keepdim=True)
    probs = torch.softmax(torch.randn(M, C, generator=g, device=dev), dim=-1)
    assign = torch.randint(0, 2, (M,), generator=g, device=dev, dtype=torch.int32)
    T, scale, margin, tm, th = 0.1, 0.1, 0.4, 0.2, 0.25
    grad = torch.ones(1, device=dev)
    stats = K.mpcl_fwd_cuda(feats, labels, centers, sel, T, margin, False, scale)
    pstats = KP.mpcl_pseudo_fwd_cuda(feats, centers, T, tm, False, scale, th)
    d1, d2 = torch.empty_like(feats), torch.empty_like(feats)
    args = K._args(feats, labels, centers, sel, T, margin, False, scale)
    args_nosel = K._args(feats, labels, centers, None, T, margin, False, scale)
    pargs = KP._args(feats, centers, T, tm, False, scale, th)
    stream = stream_of(feats)
    fstats = torch.empty(3, device=dev)
    mstats = {k: torch.empty(3, device=dev) for k in MPCL_FWD}
    plab = torch.empty(M, dtype=torch.int32, device=dev)
    pmask = torch.empty(M, device=dev)
    cen_out = {P: (torch.empty(P, C, F, device=dev), torch.empty(P * C, device=dev),
                   torch.empty((), device=dev)) for P in (1, 2)}
    # the std kernels' outputs (std, S2) and their inputs: the forward's
    # results from the wrapper, soft weights, dcents and dstd from a seed
    std_out = {P: (torch.empty(C, device=dev), torch.empty(C, F, device=dev)) for P in (1, 2)}
    std_in = {}
    for P in (1, 2):
        a = assign if P > 1 else None
        cents, counts, _, std, s2 = KC.soft_centroids_fwd_cuda(feats, probs, a, P, 0.0, True,
                                                               with_std=True)
        std_in[P] = (cents, counts, std, s2, torch.randn(P, C, F, generator=g, device=dev),
                     torch.randn(C, generator=g, device=dev))
    std_d = {P: (torch.empty_like(feats), torch.empty_like(probs)) for P in (1, 2)}
    # the std-free backward's: the forward's results, dcents from the seed
    bwd_in = {}
    for kernel in CEN_BWD:
        P, soft = (2 if kernel.endswith("_p2") else 1), kernel != "soft_centroids_bwd"
        cents, counts, _ = KC.soft_centroids_fwd_cuda(feats, probs, assign if P > 1 else None,
                                                      P, 0.0, soft)
        bwd_in[kernel] = (P, soft, cents, counts, torch.randn(P, C, F, generator=g, device=dev),
                          torch.empty_like(feats), torch.empty_like(probs) if soft else None)
    # the general backward's: C = 5 rows of their own, the forward's results
    # (the general family, by shape), dcents and dstd from the seed
    gen_in = {}
    for kernel, (P, f, soft, std) in GEN_BWD_CALLS.items():
        fe = torch.randn(M, f, generator=g, device=dev).to(torch.bfloat16)
        pr = torch.softmax(torch.randn(M, GEN_C, generator=g, device=dev), dim=-1)
        a = (torch.randint(0, P, (M,), generator=g, device=dev, dtype=torch.int32)
             if P > 1 else None)
        fo = KC.soft_centroids_fwd_cuda(fe, pr, a, P, 0.0, soft, std)
        gen_in[kernel] = dict(
            P=P, f=f, soft=soft, feats=fe, probs=pr, assign=a, cents=fo[0], counts=fo[1],
            std=fo[3] if std else None, s2=fo[4] if std else None,
            dc=torch.randn(P, GEN_C, f, generator=g, device=dev),
            dstd=torch.randn(GEN_C, generator=g, device=dev) if std else None,
            dfeats=torch.empty_like(fe), dprobs=torch.empty_like(pr) if soft else None)
    # the general forward's: rows of their own, its outputs, and the sums in
    # float64 (chip_smoke.centroids_f64) its error is taken against
    from chip_smoke import centroids_f64
    gen_fwd_in = {}
    for kernel, (c_, P, f, soft, std) in GEN_FWD_CALLS.items():
        fe = torch.randn(M, f, generator=g, device=dev).to(torch.bfloat16)
        pr = torch.softmax(torch.randn(M, c_, generator=g, device=dev), dim=-1)
        a = (torch.randint(0, P, (M,), generator=g, device=dev, dtype=torch.int32)
             if P > 1 else None)
        gen_fwd_in[kernel] = dict(
            C=c_, P=P, f=f, soft=soft, std=std, feats=fe, probs=pr, assign=a,
            ref=centroids_f64(fe, pr, a, P, 0.0, soft, std),
            cents=torch.empty(P, c_, f, device=dev), counts=torch.empty(P * c_, device=dev),
            ratio=torch.empty((), device=dev),
            stdv=torch.empty(c_, device=dev) if std else None,
            s2=torch.empty(c_, f, device=dev) if std else None)
    # what each kernel leaves behind, to hold a variant against base
    result = {"mpcl_bwd": lambda: d1, "mpcl_pseudo_bwd": lambda: d2,
              "mpcl_pseudo_fwd": lambda: fstats, "mpcl_fwd": lambda: mstats["mpcl_fwd"],
              "mpcl_fwd_sel": lambda: mstats["mpcl_fwd_sel"],
              "pseudo_label": lambda: pmask + plab, "soft_centroids_fwd": lambda: cen_out[1][0],
              "soft_centroids_fwd_p2": lambda: cen_out[2][0],
              "soft_centroids_fwd_std": lambda: std_out[1][0],
              "soft_centroids_fwd_std_p2": lambda: std_out[2][0],
              "soft_centroids_bwd_std": lambda: std_d[1][0],
              "soft_centroids_bwd_std_p2": lambda: std_d[2][0],
              **{k: (lambda k=k: torch.cat([bwd_in[k][5].float().flatten(), *(
                  [] if bwd_in[k][6] is None else [bwd_in[k][6].flatten()])]))
                 for k in CEN_BWD},
              **{k: (lambda k=k: torch.cat([gen_in[k]["dfeats"].float().flatten(), *(
                  [] if gen_in[k]["dprobs"] is None else [gen_in[k]["dprobs"].flatten()])]))
                 for k in GEN_BWD},
              **{k: (lambda k=k: torch.cat([gen_fwd_in[k]["cents"].flatten(), *(
                  [gen_fwd_in[k]["stdv"]] if gen_fwd_in[k]["std"] else [])]))
                 for k in GEN_FWD}}

    def loaded(path, sigs):
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in sigs.items():
            if not hasattr(lib, fn):    # an older tree's library (--parent)
                continue
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = list(argtypes)
        return lib

    def checked(name, kernel, call):
        def run():
            rc = call()
            if rc:
                raise RuntimeError(f"{name}: {kernel} returned {rc}")
        return run

    calls = {}
    for name in names:
        libs = {lib: loaded(out / name / f"{lib}.so", mod._SIGS)
                for lib, mod in (("mpcl", K), ("mpcl_pseudo", KP), ("pseudo_label", KL),
                                 ("soft_centroids", KC))
                if (out / name / f"{lib}.so").exists()}
        calls[name] = {}
        for kernel in kernels_of[name]:
            lib = libs[LIB_OF[kernel]]
            if kernel == "mpcl_bwd":
                call = lambda lib=lib: lib.mpcl_bwd(  # noqa: E731
                    *args, ptr(grad), ptr(stats), ptr(d1), stream)
            elif kernel == "mpcl_pseudo_bwd":
                call = lambda lib=lib: lib.mpcl_pseudo_bwd(  # noqa: E731
                    *pargs, ptr(grad), ptr(pstats), ptr(d2), stream)
            elif kernel == "mpcl_pseudo_fwd":
                n = ctypes.c_int()
                raise_on_error(lib.mpcl_pseudo_num_partials(1, M, F, ctypes.byref(n)), name)
                parts = torch.empty(2 * n.value, device=dev)
                call = lambda lib=lib, parts=parts: lib.mpcl_pseudo_fwd(  # noqa: E731
                    *pargs, ptr(parts), ptr(fstats), stream)
            elif kernel in MPCL_FWD:
                n = ctypes.c_int()
                raise_on_error(lib.mpcl_num_partials(1, M, F, ctypes.byref(n)), name)
                parts = torch.empty(2 * n.value, device=dev)
                a = args if kernel == "mpcl_fwd_sel" else args_nosel
                call = lambda lib=lib, parts=parts, a=a, o=mstats[kernel]: (  # noqa: E731
                    lib.mpcl_fwd(*a, ptr(parts), ptr(o), stream))
            elif kernel == "pseudo_label":
                call = lambda lib=lib: lib.pseudo_label(  # noqa: E731
                    ptr(feats), 1, ptr(centers), M, F, C, th, ptr(plab), ptr(pmask), stream)
            elif kernel in GEN_FWD:
                r = gen_fwd_in[kernel]
                n, grid = ctypes.c_int(), ctypes.c_int()
                raise_on_error(lib.soft_centroids_gen_partials_size(
                    1, M, r["f"], r["P"], r["C"], int(r["std"]), ctypes.byref(n)), name)
                parts = torch.empty(n.value, device=dev)
                call = lambda lib=lib, r=r, parts=parts, grid=grid: (  # noqa: E731
                    lib.soft_centroids_gen_fwd_partial(
                        ptr(r["feats"]), 1, ptr(r["probs"]), ptr(r["assign"]), M, r["f"],
                        r["C"], r["P"], 0.0, int(r["soft"]), int(r["std"]), ptr(parts),
                        ctypes.byref(grid), stream)
                    or lib.soft_centroids_gen_fwd_final(
                        ptr(parts), grid.value, M, r["f"], r["C"], r["P"], ptr(r["cents"]),
                        ptr(r["counts"]), ptr(r["ratio"]), ptr(r["s2"]), ptr(r["stdv"]),
                        stream))
            elif kernel.startswith("soft_centroids_fwd_std"):
                P = 2 if kernel.endswith("_p2") else 1
                n = ctypes.c_int()
                raise_on_error(lib.soft_centroids_partials_size(1, M, F, P, C, 1,
                                                                ctypes.byref(n)), name)
                parts = torch.empty(n.value, device=dev)
                o = torch.empty(P, C, F, device=dev), torch.empty(P * C, device=dev)
                call = lambda lib=lib, parts=parts, P=P, o=o: lib.soft_centroids_fwd(  # noqa
                    ptr(feats), 1, ptr(probs), ptr(assign) if P > 1 else None, M, F, C, P,
                    0.0, 1, ptr(parts), ptr(o[0]), ptr(o[1]), ptr(cen_out[P][2]),
                    ptr(std_out[P][1]), ptr(std_out[P][0]), stream)
            elif kernel in CEN_BWD:
                P, soft, cents, counts, dc, dfe, dpr = bwd_in[kernel]
                call = lambda lib=lib, P=P, soft=soft, cents=cents, counts=counts, dc=dc, \
                    dfe=dfe, dpr=dpr: lib.soft_centroids_bwd(  # noqa: E731
                        ptr(feats), 1, ptr(probs), ptr(assign) if P > 1 else None, M, F, C,
                        P, 0.0, int(soft), ptr(dc), ptr(cents), ptr(counts), ptr(dfe),
                        ptr(dpr), None, None, None, stream)
            elif kernel in GEN_BWD:
                r = gen_in[kernel]
                call = lambda lib=lib, r=r: lib.soft_centroids_gen_bwd(  # noqa: E731
                    ptr(r["feats"]), 1, ptr(r["probs"]), ptr(r["assign"]), M, r["f"], GEN_C,
                    r["P"], 0.0, int(r["soft"]), ptr(r["dc"]), ptr(r["cents"]),
                    ptr(r["counts"]), ptr(r["dfeats"]), ptr(r["dprobs"]), ptr(r["dstd"]),
                    ptr(r["s2"]), ptr(r["std"]), stream)
            elif kernel.startswith("soft_centroids_bwd_std"):
                P = 2 if kernel.endswith("_p2") else 1
                cents, counts, std, s2, dc, dstd = std_in[P]
                call = lambda lib=lib, P=P, cents=cents, counts=counts, std=std, s2=s2, \
                    dc=dc, dstd=dstd: lib.soft_centroids_bwd(  # noqa: E731
                        ptr(feats), 1, ptr(probs), ptr(assign) if P > 1 else None, M, F, C,
                        P, 0.0, 1, ptr(dc), ptr(cents), ptr(counts), ptr(std_d[P][0]),
                        ptr(std_d[P][1]), ptr(dstd), ptr(s2), ptr(std), stream)
            else:
                P = 2 if kernel.endswith("_p2") else 1
                n = ctypes.c_int()
                raise_on_error(lib.soft_centroids_partials_size(1, M, F, P, C, 0,
                                                                ctypes.byref(n)), name)
                parts = torch.empty(n.value, device=dev)
                call = lambda lib=lib, parts=parts, P=P: lib.soft_centroids_fwd(  # noqa: E731
                    ptr(feats), 1, ptr(probs), ptr(assign) if P > 1 else None, M, F, C, P,
                    0.0, 0, ptr(parts), *(ptr(t) for t in cen_out[P]), None, None, stream)
            calls[name][kernel] = checked(name, kernel, call)

    print(json.dumps({"variant": "copy_ yardstick (read + write)",
                      "ms": [time_ms(lambda: d1.copy_(feats), iters=50) for _ in range(3)]}),
          flush=True)
    # a copy_ of as many bytes as each centroid backward form moves: the hard
    # form reads probs and writes dfeats, the soft ones also read the
    # features and write dprobs (and at P = 2 read the ids)
    for kernel, nbytes in (("soft_centroids_bwd", M * (2 * F + 16)),
                           ("soft_centroids_bwd_soft", 2 * M * (2 * F + 16)),
                           ("soft_centroids_bwd_p2", 2 * M * (2 * F + 16) + 4 * M)):
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        print(json.dumps({"variant": f"copy_ yardstick of {kernel}'s bytes",
                          "ms": [time_ms(lambda: dst.copy_(src), iters=50) for _ in range(3)]}),
              flush=True)
        del src, dst
    for kernel, r in gen_in.items():   # the general backward's calls' bytes
        # the hard call reads probs and writes dfeats; the soft ones also
        # read the features and write dprobs (and at P > 1 read the ids)
        nbytes = (M * (r["f"] * 2 + 4 * GEN_C) * (2 if r["soft"] else 1)
                  + (4 * M if r["P"] > 1 else 0))
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        print(json.dumps({"variant": f"copy_ yardstick of {kernel}'s bytes",
                          "ms": [time_ms(lambda: dst.copy_(src), iters=50) for _ in range(3)]}),
              flush=True)
        del src, dst
    for kernel, r in gen_fwd_in.items():   # the general forward's calls' bytes, read
        nbytes = M * (r["f"] * 2 + 4 * r["C"] + (4 if r["P"] > 1 else 0))
        src = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
        print(json.dumps({"variant": f"torch.sum yardstick of {kernel}'s bytes (read only)",
                          "ms": [time_ms(lambda: torch.sum(src), iters=50) for _ in range(3)]}),
              flush=True)
        del src
    print(json.dumps({"variant": "torch.sum yardstick (read only)",
                      "ms": [time_ms(lambda: torch.sum(feats, dtype=torch.float32), iters=50)
                             for _ in range(3)]}), flush=True)
    ref, faults = {}, []
    for name in names:
        rec = {"variant": name}
        for kernel, run in calls[name].items():
            run()
            torch.cuda.synchronize()
            got = result[kernel]().clone()
            ref.setdefault(kernel, got)
            log = (out / name / f"{LIB_OF[kernel]}.log").read_text()
            rec[kernel] = {
                "ms": [time_ms(run, iters=50) for _ in range(3)],
                "max_diff_from_base": float((got.float() - ref[kernel].float()).abs().max()),
                "registers_spills_stack": ptxas_of(log, SYMBOL_OF[kernel])}
            if kernel in GEN_BWD:
                # dfeats bit for bit; dprobs, whose sum over f may take
                # another order, within the plain version's tolerance
                n = M * gen_in[kernel]["f"]
                dx, dp = got[:n], got[n:]
                dx_ref, dp_ref = ref[kernel][:n], ref[kernel][n:]
                rec[kernel]["dfeats_max_diff_from_base"] = float((dx - dx_ref).abs().max())
                if dp.numel():
                    lim = 2e-3 * dp_ref.abs() + 1e-3 * float(dp_ref.abs().max())
                    rec[kernel]["dprobs_max_diff_from_base"] = float((dp - dp_ref).abs().max())
                    rec[kernel]["dprobs_within_tolerance"] = bool(
                        ((dp - dp_ref).abs() <= lim).all())
                if name == "parent" and (rec[kernel]["dfeats_max_diff_from_base"] != 0.0
                                         or not rec[kernel].get("dprobs_within_tolerance",
                                                                True)):
                    faults.append(kernel)
            elif kernel in GEN_FWD:
                # another order of the sums: within phase 2's tolerance of
                # base, and each one's error against the float64 sums
                r = gen_fwd_in[kernel]
                nc = r["cents"].numel()
                rec[kernel]["err_f64_cents"] = float(
                    (got[:nc].double() - r["ref"]["cents"].flatten()).abs().max())
                if r["std"]:
                    rec[kernel]["err_f64_std"] = float(
                        (got[nc:].double() - r["ref"]["std"]).abs().max())
                base = ref[kernel]
                rec[kernel]["within_tolerance_of_base"] = bool(
                    ((got - base).abs() <= 1e-5 + 1e-4 * base.abs()).all())
                if name == "parent" and not rec[kernel]["within_tolerance_of_base"]:
                    faults.append(kernel)
            elif name == "parent" and rec[kernel]["max_diff_from_base"] != 0.0:
                faults.append(kernel)
        print(json.dumps(rec), flush=True)
    for name in reversed(names):
        print(json.dumps({"variant": name, "again_ms": {
            kernel: time_ms(run, iters=50) for kernel, run in calls[name].items()}}),
            flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    if faults:
        print(json.dumps({"parent_outputs_differ": faults}), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
