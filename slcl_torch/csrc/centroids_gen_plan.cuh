// The general centroid backward's launch plan (centroids_gen.cuh,
// centroids_gen_bwd): its form, the features a thread owns, the rows of a
// ring tile, the stages and the shared memory of every table, from the shape
// alone (C, P, F, std, the feature type's size and whether dprobs is taken).
// Plain C++ with no CUDA header, so that the CPU tests compile it and hold
// ops/cuda/__init__.py::gen_bwd_plan, its Python mirror, to it.
//
// - V, the features a thread-chunk owns: 8 where F % 8 == 0, else 4 where
//   F % 4 == 0, else 1 (no form of 2: fewer instantiations to build). A
//   row is nch = F / V chunks; a chunk's
//   bytes start at a multiple of min(16, V * sizeof(T)), so a thread reads
//   and writes its chunk as one vector (two 16-byte ones for 8 floats).
// - A warp takes its own rows of a tile: tpr = min(nch, 32) lanes a row,
//   rpw = 32 / tpr rows a pass, npw passes, rw = rpw * npw rows a tile; a
//   lane keeps chunk lane % tpr (and + 32, ... when nch > 32) of every row
//   it takes. A tile is R = 8 * rw rows, a multiple of 8, so every stage's
//   bulk copies start and end on 16 bytes (R*F*sizeof(T), R*C*4, R*4).
// - The lanes store dfeats and dprobs directly (plan.bulk = 0; 1 writes
//   them back over the stage and stores each tile with one bulk copy an
//   array, kept for measuring).
// - Registers: where nch <= 32 and V = 8, a lane keeps its chunk's
//   coefficients in registers across rows: the dsums (std-free, P = 1
//   only: a runtime partition cannot index registers; C <=
//   kGenRegClasses) or a / W (the std; C <= kGenRegClassesStd, which
//   leaves room for a row's dsums beside them). Otherwise they are read
//   from shared memory.
// - npw: the power of two <= 8 that brings a tile nearest below
//   kGenTileBytes of rows (features when read, probs, ids), then halved
//   until two stages fit, first under kGenBwdBudget (two blocks an SM),
//   then under kGenSmemLimit.
// - Shared memory of the ring form, in this order: the coefficients
//   (gen_bwd_coef_bytes, rounded up to 16), the stages' full and empty
//   barriers (16 * S), the row tables (weights R*C, partition R, g R; 4
//   bytes each), the dprobs partials (R * (C|1) * tp4 floats, tp4 = tpr
//   rounded up to 4, a lane's chunks of a row summed in its slot; with
//   dprobs only), rounded up to
//   128, then S stages of R rows' features (when read: with the std or
//   dprobs), probs and, with P > 1, ids, S = 2 (more measured slower:
//   tools/ring_variants.py gen_bwd).
// - Where not even two stages of 8 rows fit under kGenSmemLimit, the
//   direct form: a thread a row straight from device memory, its shared
//   memory the coefficients alone, gen_bwd_coef_bytes.
#pragma once

namespace slcl {

// dynamic shared memory a general kernel may take a block, bytes: the
// ops/cuda/__init__.py::SMEM_LIMIT of the Python side
constexpr int kGenSmemLimit = 227 * 1024 - 1024;
// a ring form's budget, if it fits: two blocks an SM
constexpr int kGenBwdBudget = 110 * 1024;
// a tile's bytes of rows the plan aims at
constexpr int kGenTileBytes = 20 * 1024;
// classes whose coefficients a lane keeps in registers, V floats each:
// std-free, std
constexpr int kGenRegClasses = 6;
constexpr int kGenRegClassesStd = 5;
constexpr int kGenBwdThreads = 256;   // = kThreads
constexpr int kGenWarpsPerBlock = kGenBwdThreads / 32;

enum GenBwdForm { kGenRing = 0, kGenDirect = 1 };

struct GenBwdPlan {
  int form;                   // kGenRing or kGenDirect
  int V, nch, tpr, rpw, npw;  // features a chunk, chunks a row, lanes a row,
                              // rows a warp-pass, passes a warp a tile
  int rw, cs;                 // rows a warp a tile; the partials' stride (C | 1)
  int regs;                   // 1: the chunk's coefficients in registers
  int feats, bulk;            // the stages carry features; outputs stored in bulk
  int rows, stages;           // R rows a tile, S stages
  int feat_bytes, prob_bytes, id_bytes, stage_bytes;   // of a whole tile
  int bar_at, w_at, part_at, g_at, pt_at, ring_at, smem;
};

// the coefficients: dsums (P*C, F), dcounts (P*C), with the std a and a / W
// (C, F), 4 bytes each: the whole shared memory of the direct form
inline constexpr int gen_bwd_coef_bytes(int C, int P, int F, bool with_std) {
  return 4 * (P * C * F + P * C + (with_std ? 2 * C * F : 0));
}

inline constexpr int gen_bwd_vec(int F) {
  return F % 8 == 0 ? 8 : (F % 4 == 0 ? 4 : 1);
}

inline constexpr long long gen_round_up(long long v, int to) {
  return (v + to - 1) / to * to;
}

// The plan of one call; es = sizeof(T) (2 or 4).
inline GenBwdPlan gen_bwd_plan(int C, int P, int F, bool with_std, int es, bool dprobs) {
  GenBwdPlan p{};
  p.V = gen_bwd_vec(F);
  p.nch = F / p.V;
  p.tpr = p.nch < 32 ? p.nch : 32;
  p.rpw = 32 / p.tpr;
  p.cs = C | 1;
  p.regs = p.nch <= 32 && p.V == 8 &&
           (with_std ? C <= kGenRegClassesStd : (P == 1 && C <= kGenRegClasses));
  p.feats = with_std || dprobs;
  p.bulk = 0;
  const long long coef = gen_bwd_coef_bytes(C, P, F, with_std);
  const long long row_bytes = (p.feats ? static_cast<long long>(F) * es : 0) + 4 * C +
                              (P > 1 ? 4 : 0);
  int npw0 = 8;
  while (npw0 > 1 && kGenWarpsPerBlock * p.rpw * npw0 * row_bytes > kGenTileBytes) npw0 /= 2;
  const int max_stages = 2;
  const int budgets[2] = {kGenBwdBudget, kGenSmemLimit};
  for (int budget : budgets) {
    for (int npw = npw0; npw >= 1; npw /= 2) {
      const long long R = static_cast<long long>(kGenWarpsPerBlock) * p.rpw * npw;
      const long long fb = p.feats ? R * F * es : 0, pb = R * C * 4, ib = P > 1 ? R * 4 : 0;
      const long long stage = fb + pb + ib;
      const long long tables = R * C * 4 + R * 4 + R * 4;
      const long long pt = dprobs ? R * p.cs * ((p.tpr + 3) / 4 * 4) * 4 : 0;
      for (int S = max_stages; S >= 2; --S) {
        const long long bar_at = gen_round_up(coef, 16);
        const long long w_at = bar_at + 16 * S;
        const long long pt_at = w_at + tables;
        const long long ring_at = gen_round_up(pt_at + pt, 128);
        const long long smem = ring_at + S * stage;
        if (smem > budget) continue;
        p.form = kGenRing;
        p.npw = npw;
        p.rw = p.rpw * npw;
        p.rows = static_cast<int>(R);
        p.stages = S;
        p.feat_bytes = static_cast<int>(fb);
        p.prob_bytes = static_cast<int>(pb);
        p.id_bytes = static_cast<int>(ib);
        p.stage_bytes = static_cast<int>(stage);
        p.bar_at = static_cast<int>(bar_at);
        p.w_at = static_cast<int>(w_at);
        p.part_at = static_cast<int>(w_at + R * C * 4);
        p.g_at = static_cast<int>(w_at + R * C * 4 + R * 4);
        p.pt_at = static_cast<int>(pt_at);
        p.ring_at = static_cast<int>(ring_at);
        p.smem = static_cast<int>(smem);
        return p;
      }
    }
  }
  p.form = kGenDirect;
  p.regs = 0;
  p.bulk = 0;
  p.rows = kGenBwdThreads;   // a thread a row
  p.smem = coef > 0x7fffffffLL ? 0x7fffffff : static_cast<int>(coef);
  return p;
}

}  // namespace slcl
