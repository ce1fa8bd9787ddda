// The general centroid backward's and forward's launch plans
// (centroids_gen.cuh). The backward's (centroids_gen_bwd): its form, the
// features a thread owns, the rows of a ring tile, the stages and the
// shared memory of every table, from the shape alone (C, P, F, std, the
// feature type's size and whether dprobs is taken).
// Plain C++ with no CUDA header, so that the CPU tests compile it and hold
// ops/cuda/__init__.py::gen_bwd_plan and gen_fwd_plan, its Python
// mirrors, to it.
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
//
// The general centroid forward's plan (centroids_gen_fwd_partial), from
// (C, P, F, std, the feature type's size) alone:
// - The product. A tile's sums are X^T W on tensor cores (mma.sync
//   m16n8k16, bf16 in, f32 accumulators): X^T is (F, rows), 16 features an
//   m-tile, with one more row of ones at feature F (its products are the
//   counts), so mt = F / 16 + 1 m-tiles; W is (rows, columns): P*C weights
//   (zero outside the row's partition), the certain flag, zeros up to ns =
//   a multiple of 8, then with the std the C weights summed over the
//   partitions (their product with x^2 is S2), zeros up to a multiple of
//   8: nt_s = ns / 8 n-tiles of sums, nt n-tiles in all.
// - The warps. A warp holds the f32 totals of at most gen_fwd_mt_cap
//   m-tiles (4; 2 in the bf16 ring form) by kGenFwdNT n-tiles in registers
//   (by 1 in the narrow form): the
//   8 warps are wm x wn x wk, the fewest wm * wn (then the most wm) with
//   mw = ceil(mt / wm) <= that cap and nw = ceil(nt / wn) <= kGenFwdNT; warp (a, b, c) owns m-tiles a,
//   a + wm, ..., n-tiles b, b + wn, ... and the tile's k-steps (16 rows)
//   c, c + wk, ...: kpw of them, so R = 16 * wk * kpw rows a tile (a
//   multiple of 16: every bulk copy starts and ends on 16 bytes).
// - The narrow form: where nt = 1 (P*C + 1 <= 8, no std) a warp's
//   register tile is 4 x 1, so the kernel takes three blocks an SM: its
//   budget is kGenFwdNarrowBudget first.
// - kpw: the largest of 4, 2, 1 whose tile (features, probs, ids) lies
//   within kGenFwdTileBytes (else 1), then halved until the shared memory
//   fits, with 3 stages, then 2, first under the narrow budget (narrow
//   form), then kGenFwdBudget (two blocks an SM), then kGenSmemLimit.
// - Shared memory, in this order: the stages' full and empty barriers (16
//   * S); each table's row partitions (2 * R ints), rounded up to 128; two weight
//   tables (a tile's rows are written into one while the other may still
//   be read), each 3 bf16 terms x nt * 8 columns x b_stride = R + 8 (a
//   column's rows side by side; 8 more so that ldmatrix reads no bank
//   twice), then S stages of R rows' features, probs and, with P > 1, ids.
//   After the last tile the block's totals (mt * 16 features x nt * 8
//   columns, f32) are summed over its warps in the tables' place: smem is
//   at least b_at + that.
// - Where no warp split or no two stages fit, the grouped form (the first
//   design: groups of F threads a row, sums in shared memory), whose
//   shared memory is gen_fwd_grouped_bytes.
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

// ---- the forward ----

// m-tiles and n-tiles whose totals a warp holds in registers; the bf16 ring
// form (two blocks an SM) holds fewer m-tiles: at 4 x 4 it spills under
// their 128 registers
constexpr int kGenFwdMT = 4;
constexpr int kGenFwdMTWide = 2;
constexpr int kGenFwdNT = 4;
inline constexpr int gen_fwd_mt_cap(bool narrow, int es) {
  return es == 2 && !narrow ? kGenFwdMTWide : kGenFwdMT;
}
// the ring form's blocks an SM (its register cap) and its budget of shared
// memory, if it fits: two blocks an SM
constexpr int kGenFwdBlocks = 2;
constexpr int kGenFwdBudget = 110 * 1024;
// the same for the narrow form (one n-tile: a 4 x 1 register tile): three
// blocks an SM
constexpr int kGenFwdNarrowBlocks = 3;
constexpr int kGenFwdNarrowBudget = 72 * 1024;
constexpr int kGenFwdMaxStages = 3;   // at most 4 (the kernel's)
// a tile's bytes of rows the forward's plan aims at
constexpr int kGenFwdTileBytes = 20 * 1024;

enum GenFwdForm { kGenFwdRing = 0, kGenFwdGrouped = 1, kGenFwdNarrow = 2 };

struct GenFwdPlan {
  int form;                   // kGenFwdRing, kGenFwdNarrow or kGenFwdGrouped
  int mt, ns, nt_s, nt;       // m-tiles; sum columns, their n-tiles; all n-tiles
  int wm, wn, wk, mw, nw;     // warps along m, n, k; m- and n-tiles a warp owns
  int kpw, rows, stages;      // k-steps a warp a tile; R rows a tile; S stages
  int feat_bytes, prob_bytes, id_bytes, stage_bytes;   // of a whole tile
  int b_stride, b_bytes;      // bf16 between two columns of a table; one table
  int red_bytes;              // the block's totals (f32)
  int bar_at, part_at, b_at, ring_at, smem;
};

// the grouped form's shared memory: G = max(1, 256 / F) groups' sums
// (P*C*F), counts (P*C), certain rows (1) and with the std S2 (C*F), f32
inline constexpr long long gen_fwd_grouped_bytes(int C, int P, int F, bool with_std) {
  return 4LL * (F >= kGenBwdThreads ? 1 : kGenBwdThreads / F) *
         (static_cast<long long>(P) * C * F + P * C + 1 + (with_std ? static_cast<long long>(C) * F : 0));
}

// The plan of one forward call; es = sizeof(T) (2 or 4).
inline GenFwdPlan gen_fwd_plan(int C, int P, int F, bool with_std, int es) {
  GenFwdPlan p{};
  p.mt = F / 16 + 1;
  p.ns = static_cast<int>(gen_round_up(static_cast<long long>(P) * C + 1, 8));
  p.nt_s = p.ns / 8;
  p.nt = p.nt_s + (with_std ? static_cast<int>(gen_round_up(C, 8)) / 8 : 0);
  // one n-tile: the narrow form, its register tile 4 x 1
  const bool narrow = p.nt == 1;
  const int mt_cap = gen_fwd_mt_cap(narrow, es);
  bool split = false;
  for (int prod = 1; prod <= kGenWarpsPerBlock && !split; prod *= 2) {
    for (int wm = prod; wm >= 1; wm /= 2) {
      const int wn = prod / wm;
      if ((p.mt + wm - 1) / wm <= mt_cap && (p.nt + wn - 1) / wn <= kGenFwdNT) {
        p.wm = wm;
        p.wn = wn;
        split = true;
        break;
      }
    }
  }
  if (split) {
    p.wk = kGenWarpsPerBlock / (p.wm * p.wn);
    p.mw = (p.mt + p.wm - 1) / p.wm;
    p.nw = (p.nt + p.wn - 1) / p.wn;
    const long long row_bytes = static_cast<long long>(F) * es + 4LL * C + (P > 1 ? 4 : 0);
    int kpw0 = 4;
    while (kpw0 > 1 && 16LL * p.wk * kpw0 * row_bytes > kGenFwdTileBytes) kpw0 /= 2;
    // the narrow form: three blocks an SM if they fit
    const int budgets[3] = {narrow ? kGenFwdNarrowBudget : kGenFwdBudget, kGenFwdBudget,
                            kGenSmemLimit};
    for (int budget : budgets) {
      for (int kpw = kpw0; kpw >= 1; kpw /= 2) {
        const long long R = 16LL * p.wk * kpw;
        const long long fb = R * F * es, pb = R * C * 4, ib = P > 1 ? R * 4 : 0;
        const long long stage = fb + pb + ib;
        const long long table = 3LL * p.nt * 8 * (R + 8) * 2;
        const long long red = 4LL * p.mt * 16 * p.nt * 8;
        for (int S = kGenFwdMaxStages; S >= 2; --S) {
          const long long part_at = 16LL * S;
          const long long b_at = gen_round_up(part_at + 8 * R, 128);
          const long long ring_at = gen_round_up(b_at + 2 * table, 128);
          long long smem = ring_at + S * stage;
          if (b_at + red > smem) smem = b_at + red;
          if (smem > budget) continue;
          p.form = narrow ? kGenFwdNarrow : kGenFwdRing;
          p.kpw = kpw;
          p.rows = static_cast<int>(R);
          p.stages = S;
          p.feat_bytes = static_cast<int>(fb);
          p.prob_bytes = static_cast<int>(pb);
          p.id_bytes = static_cast<int>(ib);
          p.stage_bytes = static_cast<int>(stage);
          p.b_stride = static_cast<int>(R + 8);
          p.b_bytes = static_cast<int>(table);
          p.red_bytes = static_cast<int>(red);
          p.bar_at = 0;
          p.part_at = static_cast<int>(part_at);
          p.b_at = static_cast<int>(b_at);
          p.ring_at = static_cast<int>(ring_at);
          p.smem = static_cast<int>(smem);
          return p;
        }
      }
    }
  }
  GenFwdPlan g{};
  g.form = kGenFwdGrouped;
  g.rows = F >= kGenBwdThreads ? 1 : kGenBwdThreads / F;   // a group a row
  const long long smem = gen_fwd_grouped_bytes(C, P, F, with_std);
  g.smem = smem > 0x7fffffffLL ? 0x7fffffff : static_cast<int>(smem);
  return g;
}

}  // namespace slcl
