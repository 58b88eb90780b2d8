// Homotopy-continuation path tracker for the trifocal 2op1p 30x30 system,
// persistent warps over a queue of paths, for sm_90a (H100).
//
// Replaces the TPU kernel ops/fused.py::_make_kernel of the JAX package (the
// `kernel` closure that build_kernel_caller launches through pl.pallas_call):
// up to `niter` HC steps per path on resumable state -- end-zone clamp,
// TrunPaths depth pruning, an RK4 predictor (4 x fill P, evaluate, solve), a
// Newton corrector (<= max_correction_steps x evaluate, solve) and the
// adaptive step size.  The plain PyTorch twin is ops/fused.py::track_plain in
// this package; both execute the same host-built plan (FusedConstants).
//
// The solve is a program of pivot steps read from that plan, one of two:
//  * "reduced" replaces the reference's condensed elimination
//    (_fam_forward -> _reduce_forward -> _reduce_backsub): family stages
//    of 3 or 2 candidates through per-level row maps, then the 14-step
//    reduced schedule;
//  * "schedule" replaces its 30-stage static schedule (_solve ->
//    _eliminate, _backsub): one level, 30 steps of 2 to 30 candidates.
// A step takes up to 32 candidates, one lane each, so the pivot search is
// one integer max reduction plus a ballot whatever the program.
//
// The step variants of the JAX kernel are compile-time choices, one build
// each (ops/_kernels.py passes -D flags; no flag builds the default):
//  * HC_ORDER 3 or 2: Kutta's third-order rule or the midpoint rule in place
//    of RK4 (its rk3/rk2 branches);
//  * HC_CJR, HC_CPH, HC_RKJ: the users of its _resolve_rhs /
//    _reduce_resolve_rhs, which replay a kept elimination on a new rhs --
//    corrector iterations from the cjr-th on (modified Newton), RK stage 1
//    after a step in which no path of its tile rolled back (the corrector
//    -> predictor handoff; a tile of one path in hc_track_kernel, of
//    HCConfig.tile paths in hc_track_tile_kernel, taken at launch), RK
//    stages 2-4 (frozen-Jacobian stages, schedule program);
//  * HC_SPLIT2: eval_precision "split3_rk2", where the JAX kernel's RK-stage
//    evaluations take every constant matmul's input as two bf16 terms
//    h + l1 (about 16 significant bits; _sdot2/_kdot2 there): here the
//    point and the quadratic and cubic monomials pass through r2() and each
//    entry sums its terms' h and l1 apart.  The corrector stays FP32;
//  * HC_ABC: pair_coef_basis "abc", P(t) = (A t + B) t + C (its fill_P's
//    abc branch) in place of the two-point basis.
// eval_structure "gathered" and "merged" are other matmul forms of the same
// evaluation on the TPU and run the build of their other knobs.
// hc_phase_kernel (below) runs the tracker's phases alone, for timing them.
// A replaying build keeps the elimination where the forward pass leaves
// it: the pivot rows in the system itself (no later step writes a pivot
// row) and the pivots in s.piv, plus each candidate's multiplier in a
// per-path area of dynamic shared memory (one slot per candidate, offsets
// in the plan).  replay() re-walks the pivot program on the rhs column with
// the forward pass's own update, so on the rhs the elimination started from
// it gives that solve's x bit for bit; every later full solve overwrites
// what it keeps, so a replay always uses the last full solve.
//
// What bounds it on the card: neither bytes nor operations.  A path reads
// ~3 KB of state and coefficients once (the plan, ~16 KB, stays in L1/L2),
// and it needs ~22,000 FP32 operations per evaluate + solve (the bound's
// count, ops/bound.solve_flops), ~3.5 ms for a round at the FP32 peak.
// What it waits on is latency: a step is ~6 evaluate+solve rounds, and a
// solve is 30 dependent pivot steps (max reduction, ballot, broadcast, row
// updates) plus 30 dependent back-substitution dot products, each a
// shuffle butterfly.  Hiding that latency takes resident warps, and a warp's
// augmented system lives in shared memory, which caps them: 5 blocks of 4
// warps per SM (4 for a replaying build, with 2.8 KB more per warp).
//
// What the design does about it:
//  * Persistent warps.  The grid is the blocks that fit on the card at
//    once (the occupancy query below).  Each warp takes its next path from
//    a counter in device memory (lane 0's atomicAdd, broadcast) and runs it
//    to its end or `niter` steps, so a finished path frees its warp at once
//    and a slow path holds no block's other slots; the only tail is the
//    last one.  Which warp runs a path changes nothing in its arithmetic.
//  * One warp per path keeps every dependent chain inside a warp (shuffles
//    and __syncwarp, never __syncthreads).
//  * The evaluation forms each of its monomials once per evaluation into
//    a per-warp table (about 9 per lane), then walks a packed plan: the 200
//    entries (170 Hx nonzeros, 30 rhs rows) dealt to the lanes largest
//    first, lane i's k-th term in word 32 k + i (one coalesced 128-byte load
//    per warp and term), each term one complex product P[q] * monomial, a
//    scale and an add.  The critical lane runs 48 terms where the mean is
//    45.4.  A replay's rhs has a plan of its own.
//  * The elimination walks the ballot of live candidates only, two at a
//    time, each one's multiplier and row a broadcast read from shared
//    memory.  The pivot's maximum is one __reduce_max_sync on integer keys
//    that order as |Re|+|Im| does.
//  * Back-substitution keeps x in registers: every lane forms each step's
//    value (a butterfly sum is the same in every lane) and the column's
//    lane keeps it, with no shared-memory round trip on the chain; the next
//    pivot row and the reciprocal are formed while the sum runs.
//  * The system's rows are 32 complex wide with the column XOR the row (a
//    swizzle, no pad column): a column's rows fall in distinct banks, and
//    the monomial table still fits at 5 blocks per SM,
//    with the evaluation point and a step's multipliers sharing one
//    32-entry array and the solve's row maps the monomial table's room.
// No tensor cores: the evaluation is a 0.8 %-dense integer matrix times the
// monomials, a sparse product per path, and the solve a chain of dependent
// pivots; dense bf16 products would do ~100x the arithmetic and round
// differently.  No FMA contraction (built with -fmad=false), no TF32, no
// fast-math: every product and sum rounds once, in the order track_plain
// writes it out, so the kernel and its twin agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef HC_ORDER
#define HC_ORDER 4
#endif
#ifndef HC_CJR
#define HC_CJR 0
#endif
#ifndef HC_CPH
#define HC_CPH 0
#endif
#ifndef HC_RKJ
#define HC_RKJ 0
#endif
#ifndef HC_SPLIT2
#define HC_SPLIT2 0
#endif
#ifndef HC_ABC
#define HC_ABC 0
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int NV = 30;        // variables = equations
constexpr int RHS = 30;       // right-hand-side column of the augmented row
constexpr int W = 32;         // row width (complex), swizzled
constexpr int WARPS = 4;      // warps per block
constexpr int QMAX = 64;      // parameter pairs per path
constexpr int MMAX = 288;     // monomials per evaluation (fused.MMAX)
constexpr int STEP_INTS = 36; // [level, col, ncand, fslot, cand[32]]
constexpr int FSLOTS = 352;   // kept multipliers per path (fused.FSLOTS)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned LAST = 1u << 15;  // packed term: its entry's last

constexpr int ORDER = HC_ORDER;
constexpr bool CJR = HC_CJR != 0, CPH = HC_CPH != 0, RKJ = HC_RKJ != 0;
constexpr bool REPLAY = CJR || CPH || RKJ;
constexpr bool SPLIT2 = HC_SPLIT2 != 0, ABC = HC_ABC != 0;
// Resident blocks per SM that shared memory allows; registers are held to
// the same count (__launch_bounds__).
constexpr int MIN_BLOCKS = REPLAY ? 4 : 5;
static_assert(ORDER == 2 || ORDER == 3 || ORDER == 4, "HC_ORDER is 2, 3 or 4");
static_assert(!(CPH && RKJ), "the handoff and frozen RK stages exclude each other");

// Plan header (see FusedConstants.kernel_plan).
enum {
  H_N = 0, H_Q, H_NSTEP, H_NMAP,
  H_MAP0, H_STEPS, H_MAPS, H_MONO, H_EVAL, H_EVALR, H_DEPTH,
  H_NQUAD, H_NMONO
};

struct Params {
  int niter, mcs, steps_inc, truncate;
  float ez_factor, t_eps, tol_sq, inf_sq;
  int cjr;  // CJR: the first corrector iteration that replays
};

struct WarpSmem {
  float2 m[NV * W];     // augmented system, entry (r, c) at at(r, c)
  float2 pr[2 * QMAX];  // pair products P, then R: dP/dt (RK) or P again
  // The evaluation point (v[NV] = 1, the homogeneous slot), then a step's
  // multipliers during the elimination: never both at once.
  float2 v[32];
  union {
    float2 mono[MMAX];  // the evaluation's monomials (fused.monomials order)
    struct {
      int map[2][32];   // current / next level row maps
      int rows[32];     // a step's candidate rows
    } sv;               // the solve's, after the evaluation
  } u;
  int piv[32];          // pivot row of every step
};

// Entry (r, c) of the system: rows of 32, the column XOR the row.
__device__ __forceinline__ int at(int r, int c) { return r * W + (c ^ r); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return make_float2(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src));
}

// v rounded to bf16 (to nearest, ties to even) and back.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The 2-term split's value h + l1: h = bf16(v), l1 = bf16(v - h).
__device__ __forceinline__ float r2(float v) {
  const float h = round_bf16(v);
  return h + round_bf16(v - h);
}

__device__ __forceinline__ float2 r2(float2 v) {
  return make_float2(r2(v.x), r2(v.y));
}

// acc += coef * v, or under the split (S2) hi += coef * h(v) and
// lo += coef * l1(v), summed apart and added at the end.
template <bool S2>
__device__ __forceinline__ void accumulate(float2& hi, float2& lo, float coef,
                                           float2 v) {
  if constexpr (S2) {
    const float hx = round_bf16(v.x), hy = round_bf16(v.y);
    hi.x += coef * hx;
    hi.y += coef * hy;
    lo.x += coef * round_bf16(v.x - hx);
    lo.y += coef * round_bf16(v.y - hy);
  } else {
    hi.x += coef * v.x;
    hi.y += coef * v.y;
  }
}

template <bool S2>
__device__ __forceinline__ float2 total(float2 hi, float2 lo) {
  if constexpr (S2) return make_float2(hi.x + lo.x, hi.y + lo.y);
  return hi;
}

// A monomial as a constant matmul's input: itself, or its split's value.
template <bool S2>
__device__ __forceinline__ float2 operand(float2 v) {
  if constexpr (S2) return r2(v);
  return v;
}

// This warp's multiplier area in dynamic shared memory (replaying builds).
__device__ __forceinline__ float2* keep_area(int warp) {
  extern __shared__ float2 keep_all[];
  return keep_all + warp * FSLOTS;
}

// P(t) = t^2 E + t(1-t) F + (1-t)^2 G per pair (exactly E at t = 1), or
// under ABC (A t + B) t + C with (A, B, C) in the (E, F, G) slots; the rhs
// half takes dP/dt for RK stages and P itself for the corrector.
__device__ void fill(WarpSmem& s, const float2 (&e)[2], const float2 (&f)[2],
                     const float2 (&g)[2], float t, bool rk, int q_n,
                     int lane) {
  const float v = 1.0f - t, tt = t * t, tv = t * v, vv = v * v;
  const float t2 = 2.0f * t, a = 1.0f - t2, b = 2.0f * v;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = lane + 32 * j;
    if (q < q_n) {
      if constexpr (ABC) {
        const float2 pq = make_float2((e[j].x * t + f[j].x) * t + g[j].x,
                                      (e[j].y * t + f[j].y) * t + g[j].y);
        s.pr[q] = pq;
        s.pr[QMAX + q] = rk ? make_float2((2.0f * e[j].x) * t + f[j].x,
                                          (2.0f * e[j].y) * t + f[j].y)
                            : pq;
      } else {
        float2 pq = make_float2(tt * e[j].x + (tv * f[j].x + vv * g[j].x),
                                tt * e[j].y + (tv * f[j].y + vv * g[j].y));
        s.pr[q] = pq;
        s.pr[QMAX + q] = rk ? make_float2(t2 * e[j].x + (a * f[j].x - b * g[j].x),
                                          t2 * e[j].y + (a * f[j].y - b * g[j].y))
                            : pq;
      }
    }
  }
}

// The monomials from index `first` on at the point in s.v, each once:
// x[a] x[b], times x[c] for a cubic one (S2: the split's value of each).
template <bool S2>
__device__ __forceinline__ void monomials(WarpSmem& s,
                                          const int* __restrict__ plan,
                                          int first, int lane) {
  const int* defs = plan + plan[H_MONO];
  const int n_mono = plan[H_NMONO];
  for (int i = first + lane; i < n_mono; i += 32) {
    const int d = defs[i];
    float2 v = cmul(s.v[d & 31], s.v[(d >> 5) & 31]);
    const int c = (d >> 10) & 31;
    if (c != 31) v = cmul(v, s.v[c]);
    s.u.mono[i] = operand<S2>(v);
  }
  __syncwarp();
}

// Walk a packed term plan (FusedConstants._packed_terms): each lane sums
// its entries' terms coef * P[q] * monomial in order and writes each entry
// where its last term says; a cubic monomial marks an rhs term (R, and -Ht
// unless want_h).  BF (the phase kernel's "walk_bf16" only): P[q] and the
// monomial each rounded to bf16 before their product, the sum in FP32.
template <bool S2, bool BF = false>
__device__ __forceinline__ void walk_terms(WarpSmem& s,
                                           const int* __restrict__ part,
                                           int n_quad, bool want_h,
                                           int lane) {
  const int count = part[lane];
  const unsigned* words = reinterpret_cast<const unsigned*>(part) + 32 + lane;
  // Distinct arrays: a later term's reads need not wait for an entry's store.
  float2* __restrict__ m = s.m;
  const float2* __restrict__ pr = s.pr;
  const float2* __restrict__ mono_t = s.u.mono;
  float2 acc = make_float2(0.f, 0.f), lo = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int k = 0; k < count; ++k) {
    const unsigned w = __ldg(words + 32 * k);
    const int mono = w & 511;
    const bool rhs = mono >= n_quad;
    const int q = ((w >> 9) & 63) + (rhs ? QMAX : 0);
    const float coef = (float)((int)w >> 26);
    if constexpr (BF) {
      const float2 p = pr[q], v = mono_t[mono];
      accumulate<S2>(acc, lo, coef,
                     cmul(make_float2(round_bf16(p.x), round_bf16(p.y)),
                          make_float2(round_bf16(v.x), round_bf16(v.y))));
    } else {
      accumulate<S2>(acc, lo, coef, cmul(pr[q], mono_t[mono]));
    }
    if (w & LAST) {
      const float2 sum = total<S2>(acc, lo);
      m[(w >> 16) & 1023] =
          rhs && !want_h ? make_float2(-sum.x, -sum.y) : sum;
      acc = lo = make_float2(0.f, 0.f);
    }
  }
  __syncwarp();
}

// Augmented system at the point in s.v: the Hx nonzeros and the rhs, H
// (want_h) or -Ht.
template <bool S2 = false>
__device__ void assemble(WarpSmem& s, const int* __restrict__ plan,
                         bool want_h, int lane) {
  for (int i = lane; i < NV * W; i += 32) s.m[i] = make_float2(0.f, 0.f);
  monomials<S2>(s, plan, 0, lane);
  walk_terms<S2>(s, plan + plan[H_EVAL], plan[H_NQUAD], want_h, lane);
}

// No work: the default `ready` of assemble_rhs and hc_step.
struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};

// The rhs column alone (a replay's input; the rest of s.m is the kept
// elimination): the cubic monomials and the rhs entries' own plan.
// ready() runs before the first write to s.m (the tiled tracker waits
// there for its copy of the kept elimination to land).
template <bool S2 = false, typename Ready = NoWait>
__device__ void assemble_rhs(WarpSmem& s, const int* __restrict__ plan,
                             bool want_h, int lane, Ready ready = Ready()) {
  const int n_quad = plan[H_NQUAD];
  monomials<S2>(s, plan, n_quad, lane);
  ready();
  walk_terms<S2>(s, plan + plan[H_EVALR], n_quad, want_h, lane);
}

// Next level's rows: the k-th unused row of each entry's sources.
__device__ __forceinline__ void next_level(WarpSmem& s, const int* maps,
                                           int level, unsigned used, int& cur,
                                           int lane) {
  const int* mp = maps + (level * 32 + lane) * 4;
  int out = -1;
  if (mp[0] >= 0) {
    int cnt = 0;
    for (int j = 0; j < 3 && mp[j] >= 0; ++j) {
      const int pr = s.u.sv.map[cur][mp[j]];
      if (!((used >> pr) & 1u)) {
        if (cnt == mp[3]) out = pr;
        ++cnt;
      }
    }
  }
  s.u.sv.map[cur ^ 1][lane] = out;
  __syncwarp();
  cur ^= 1;
}

// Back-substitution over the pivot rows, last step first; returns lane v's
// entry of x.  x stays in registers, lane v holding entry v (and lane RHS
// the rhs's -1): each step's butterfly sum comes out the same in every
// lane, so every lane forms the step's x value and the lane of its column
// keeps it.  The next step's pivot row and pivot are read while this
// step's sum runs, and each step's reciprocal is formed off that chain.
__device__ __forceinline__ float2 backsub(WarpSmem& s,
                                          const int* __restrict__ plan,
                                          int lane) {
  const int n_step = plan[H_NSTEP];
  const int* steps = plan + plan[H_STEPS];
  float2 xs = make_float2(lane == RHS ? -1.0f : 0.0f, 0.0f);
  int p = s.piv[n_step - 1];
  int col = steps[STEP_INTS * (n_step - 1) + 1];
  float2 row = s.m[at(p, lane)], pv = s.m[at(p, col)];
  for (int st = n_step - 1; st >= 0; --st) {
    float den = pv.x * pv.x + pv.y * pv.y;
    if (den == 0.0f) den = 1.0f;
    const float2 inv = make_float2(-pv.x / den, pv.y / den);
    const float2 a = cmul(row, xs);
    const int c = col;
    if (st > 0) {
      p = s.piv[st - 1];
      col = steps[STEP_INTS * (st - 1) + 1];
      row = s.m[at(p, lane)];
      pv = s.m[at(p, col)];
    }
    const float ar = warp_sum(a.x), ai = warp_sum(a.y);
    const float2 xv = cmul(make_float2(ar, ai), inv);
    if (lane == c) xs = xv;
  }
  return lane < NV ? xs : make_float2(0.f, 0.f);
}

// mv -= f * prow, as solve() and replay() update a row.
__device__ __forceinline__ void eliminate(float2& mv, float2 f, float2 prow) {
  mv.x -= f.x * prow.x - f.y * prow.y;
  mv.y -= f.x * prow.y + f.y * prow.x;
}

// Pivot step st of the plan's program on s.m, from the state (used rows,
// row-map level, current map) the earlier steps left.  With KEEP (a
// replaying build) each candidate's multiplier goes to `keep`.
template <bool KEEP>
__device__ __forceinline__ void pivot_step(WarpSmem& s, const int* steps,
                                           const int* maps, float2* keep,
                                           int st, unsigned& used, int& level,
                                           int& cur, int lane) {
  const int* sp = steps + STEP_INTS * st;
  const int want = sp[0], col = sp[1], nc = sp[2];
  for (; level < want; ++level) next_level(s, maps, level, used, cur, lane);
  int r = -1;
  float2 v = make_float2(0.f, 0.f);
  bool was = false, nan = false;
  unsigned key = 0u;  // 0: not a candidate, or a used row
  if (lane < nc) {
    r = s.u.sv.map[cur][sp[4 + lane]];
    v = s.m[at(r, col)];
    was = (used >> r) & 1u;
    const float metric = fabsf(v.x) + fabsf(v.y);
    // |Re|+|Im| >= +0 orders as its bits do: key 1 + bits.
    if (!was) key = __float_as_uint(metric) + 1u;
    nan = !was && metric != metric;
  }
  // Pivot: the first lane holding the maximum (a NaN wins, as in
  // torch.argmax); with no unused candidate, the first candidate.
  const unsigned nan_lanes = __ballot_sync(FULL, nan);
  const unsigned hit = nan_lanes ? nan_lanes
                                 : __ballot_sync(FULL, key == __reduce_max_sync(FULL, key));
  const int pl = __ffs(hit) - 1;
  const int p = __shfl_sync(FULL, r, pl);
  const float2 pv = shfl2(v, pl);
  if (lane == 0) s.piv[st] = p;
  float den = pv.x * pv.x + pv.y * pv.y;
  if (den == 0.0f) den = 1.0f;
  const float ir = pv.x / den, ii = -pv.y / den;
  const bool live = lane < nc && lane != pl && !was;
  const float2 f = live ? make_float2(v.x * ir - v.y * ii, v.x * ii + v.y * ir)
                        : make_float2(0.f, 0.f);
  if constexpr (KEEP) {
    if (lane < nc) keep[sp[3] + lane] = f;
  }
  used |= 1u << p;
  const float2 prow = s.m[at(p, lane)];
  // Each live candidate's multiplier and row, for broadcast reads.
  if (live) {
    s.v[lane] = f;
    s.u.sv.rows[lane] = r;
  }
  unsigned todo = __ballot_sync(FULL, live);
  __syncwarp();
  // Two candidates at a time, both rows read before either is written
  // (the rows are distinct).
  while (todo) {
    const int i = __ffs(todo) - 1;
    todo &= todo - 1;
    const float2 fi = s.v[i];
    const int ei = at(s.u.sv.rows[i], lane);
    if (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const float2 fj = s.v[j];
      const int ej = at(s.u.sv.rows[j], lane);
      float2 mi = s.m[ei], mj = s.m[ej];
      eliminate(mi, fi, prow);
      eliminate(mj, fj, prow);
      s.m[ei] = mi;
      s.m[ej] = mj;
    } else {
      float2 mi = s.m[ei];
      eliminate(mi, fi, prow);
      s.m[ei] = mi;
    }
  }
  __syncwarp();
}

// Restricted-pivoting solve of s.m by the plan's pivot program; returns
// lane v's entry of x.  With KEEP (a replaying build) each candidate's
// multiplier goes to `keep`.
template <bool KEEP>
__device__ float2 solve(WarpSmem& s, const int* __restrict__ plan,
                        float2* keep, int lane) {
  const int n_step = plan[H_NSTEP];
  const int* steps = plan + plan[H_STEPS];
  const int* maps = plan + plan[H_MAPS];
  if (lane < NV) s.u.sv.map[0][lane] = plan[plan[H_MAP0] + lane];
  __syncwarp();
  unsigned used = 0u;
  int level = 0, cur = 0;
  for (int st = 0; st < n_step; ++st)
    pivot_step<KEEP>(s, steps, maps, keep, st, used, level, cur, lane);
  return backsub(s, plan, lane);
}

// The solve's starting row map (level 0), for a phase that runs its pivot
// steps in parts.
__device__ __forceinline__ void begin_solve(WarpSmem& s,
                                            const int* __restrict__ plan,
                                            int lane) {
  if (lane < NV) s.u.sv.map[0][lane] = plan[plan[H_MAP0] + lane];
  __syncwarp();
}

// Pivot steps [st0, st1) of the plan's program, as solve() runs them.
template <bool KEEP>
__device__ __forceinline__ void forward(WarpSmem& s,
                                        const int* __restrict__ plan,
                                        float2* keep, int st0, int st1,
                                        unsigned& used, int& level, int& cur,
                                        int lane) {
  const int* steps = plan + plan[H_STEPS];
  const int* maps = plan + plan[H_MAPS];
  for (int st = st0; st < st1; ++st)
    pivot_step<KEEP>(s, steps, maps, keep, st, used, level, cur, lane);
}

// The last solve()'s elimination replayed on the rhs column assemble_rhs()
// wrote: each step takes its kept pivot and multipliers and updates its
// live candidates' rhs as solve() updates their rows, lane i candidate i
// at once (the rows are distinct, and the pivot row is not written, so
// there is no loop over candidates to shorten); then back-substitution.
__device__ float2 replay(WarpSmem& s, const int* __restrict__ plan,
                         const float2* keep, int lane) {
  const int n_step = plan[H_NSTEP];
  const int* steps = plan + plan[H_STEPS];
  const int* maps = plan + plan[H_MAPS];
  if (lane < NV) s.u.sv.map[0][lane] = plan[plan[H_MAP0] + lane];
  __syncwarp();
  unsigned used = 0u;
  int level = 0, cur = 0;
  for (int st = 0; st < n_step; ++st) {
    const int* sp = steps + STEP_INTS * st;
    const int want = sp[0], nc = sp[2];
    for (; level < want; ++level) next_level(s, maps, level, used, cur, lane);
    const int p = s.piv[st];
    const float2 prow = s.m[at(p, RHS)];
    if (lane < nc) {
      const int r = s.u.sv.map[cur][sp[4 + lane]];
      if (r != p && !((used >> r) & 1u)) {
        float2 mv = s.m[at(r, RHS)];
        eliminate(mv, keep[sp[3] + lane], prow);
        s.m[at(r, RHS)] = mv;
      }
    }
    used |= 1u << p;
    __syncwarp();
  }
  return backsub(s, plan, lane);
}

// The evaluation point (S2: its split's value; the homogeneous 1 stays 1).
template <bool S2 = false>
__device__ __forceinline__ void set_point(WarpSmem& s, float2 x, int lane) {
  s.v[lane] = lane < NV ? operand<S2>(x)
                        : make_float2(lane == NV ? 1.0f : 0.0f, 0.0f);
  __syncwarp();
}

__device__ __forceinline__ float2 axpy(float2 x, float a, float2 k) {
  return make_float2(x.x + a * k.x, x.y + a * k.y);
}

// A path's tracking state between steps: x, x_last and its 8 flags.
struct PathState {
  float2 xv, xlv;
  float t, dt, succ, ez, chk, inf, prn, nst;
};

__device__ __forceinline__ PathState load_path(const float2* __restrict__ x,
                                               const float2* __restrict__ xl,
                                               const float* __restrict__ flags,
                                               int path, int lane) {
  const float2 zero = make_float2(0.f, 0.f);
  const float* fl = flags + (size_t)path * 8;
  return PathState{lane < NV ? x[(size_t)path * NV + lane] : zero,
                   lane < NV ? xl[(size_t)path * NV + lane] : zero,
                   fl[0], fl[1], fl[2], fl[3], fl[4], fl[5], fl[6], fl[7]};
}

__device__ __forceinline__ void store_path(float2* __restrict__ x,
                                           float2* __restrict__ xl,
                                           float* __restrict__ flags,
                                           const PathState& ps, int path,
                                           int lane) {
  if (lane < NV) {
    x[(size_t)path * NV + lane] = ps.xv;
    xl[(size_t)path * NV + lane] = ps.xlv;
  }
  if (lane == 0) {
    float* fl = flags + (size_t)path * 8;
    fl[0] = ps.t; fl[1] = ps.dt; fl[2] = ps.succ; fl[3] = ps.ez;
    fl[4] = ps.chk; fl[5] = ps.inf; fl[6] = ps.prn; fl[7] = ps.nst;
  }
}

// The path's pair coefficients E, F, G, lane q and q + 32 of each.
__device__ __forceinline__ void load_coefs(const float2* __restrict__ efg,
                                           int q_n, int path, int lane,
                                           float2 (&e)[2], float2 (&f)[2],
                                           float2 (&g)[2]) {
  const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = lane + 32 * j;
    const float2* base = efg + (size_t)path * 3 * q_n;
    e[j] = q < q_n ? base[q] : zero;
    f[j] = q < q_n ? base[q_n + q] : zero;
    g[j] = q < q_n ? base[2 * q_n + q] : zero;
  }
}

__device__ __forceinline__ bool finished(const PathState& ps,
                                         const Params& prm) {
  return ps.t >= 1.0f || 1.0f - ps.t <= prm.t_eps || ps.inf > 0.5f ||
         ps.prn > 0.5f;
}

// One HC step of the path in `ps` with pair coefficients e, f, g.
// Returns false, having taken no step, for a path that is finished or is
// pruned now; otherwise sets `fail` (the corrector rolled the step back)
// and `iters` (the corrector iterations it ran).
// Under CPH with `handoff`, RK stage 1 replays the elimination that s and
// keep hold (the previous step's last full corrector solve), once
// kept_ready() has returned (assemble_rhs's `ready`).
template <typename Ready = NoWait>
__device__ __forceinline__ bool hc_step(WarpSmem& s, float2* keep,
                                        const int* __restrict__ plan,
                                        const Params& prm,
                                        const float2 (&e)[2],
                                        const float2 (&f)[2],
                                        const float2 (&g)[2], PathState& ps,
                                        bool handoff, bool& fail,
                                        int& iters, bool is_depth, int q_n,
                                        int lane,
                                        Ready kept_ready = Ready()) {
  // RK stage k >= 2 at point xp: a full solve, or (RKJ) stage 1's
  // elimination replayed on the -Ht there.  Every RK-stage evaluation
  // runs under the split of SPLIT2.
  auto stage = [&](float2 xp) {
    set_point<SPLIT2>(s, xp, lane);
    if constexpr (RKJ) {
      assemble_rhs<SPLIT2>(s, plan, false, lane);
      return replay(s, plan, keep, lane);
    } else {
      assemble<SPLIT2>(s, plan, false, lane);
      return solve<REPLAY>(s, plan, keep, lane);
    }
  };

  if (finished(ps, prm)) return false;
  if (fabsf(1.0f - ps.t) <= prm.ez_factor) ps.ez = 1.0f;
  if (prm.truncate) {
    // min over the depths <= 0, where a NaN depth makes the min NaN.
    const bool any_nan = __any_sync(FULL, is_depth && ps.xv.x != ps.xv.x);
    const bool any_bad = __any_sync(FULL, is_depth && ps.xv.x <= 0.0f);
    if (ps.chk > 0.5f && ps.t > 0.0f) ps.chk = (any_bad && !any_nan) ? 1.0f : 0.0f;
    if (ps.t > 0.95f && ps.chk > 0.5f) {
      ps.prn = 1.0f;
      return false;
    }
  }
  const float t = ps.t, dt = ps.dt;
  const float2 xv = ps.xv;
  const float dtc = ps.ez > 0.5f ? fminf(dt, fabsf(1.0f - t)) : fminf(dt, fabsf(0.95f - t));
  const float half = 0.5f * dtc;
  const float tb = t + half;
  const float tc = tb + half;

  // Predictor: RK4, or Kutta's rule (ORDER 3) or the midpoint rule (2).
  fill(s, e, f, g, t, true, q_n, lane);
  set_point<SPLIT2>(s, xv, lane);
  float2 k1;
  if (CPH && handoff) {
    assemble_rhs<SPLIT2>(s, plan, false, lane, kept_ready);
    k1 = replay(s, plan, keep, lane);
  } else {
    assemble<SPLIT2>(s, plan, false, lane);
    k1 = solve<REPLAY>(s, plan, keep, lane);
  }
  fill(s, e, f, g, tb, true, q_n, lane);
  const float2 k2 = stage(axpy(xv, half, k1));
  float2 cw;
  if constexpr (ORDER == 2) {
    cw = axpy(xv, dtc, k2);
  } else if constexpr (ORDER == 3) {
    fill(s, e, f, g, tc, true, q_n, lane);
    const float2 k3 = stage(make_float2(xv.x - dtc * k1.x + 2.0f * dtc * k2.x,
                                        xv.y - dtc * k1.y + 2.0f * dtc * k2.y));
    const float sixth = dtc / 6.0f;
    cw = make_float2(xv.x + sixth * (k1.x + 4.0f * k2.x + k3.x),
                     xv.y + sixth * (k1.y + 4.0f * k2.y + k3.y));
  } else {
    const float2 k3 = stage(axpy(xv, half, k2));
    fill(s, e, f, g, tc, true, q_n, lane);
    const float2 k4 = stage(axpy(xv, dtc, k3));
    const float sixth = dtc / 6.0f;
    cw = make_float2(xv.x + sixth * (k1.x + 2.0f * (k2.x + k3.x) + k4.x),
                     xv.y + sixth * (k1.y + 2.0f * (k2.y + k3.y) + k4.y));
  }

  // Newton corrector at frozen t_c; under CJR, iterations from the
  // cjr-th on replay the last full iteration's elimination.
  fill(s, e, f, g, tc, false, q_n, lane);
  bool ok = false, diverged = false;
  for (int ci = 0; ci < prm.mcs; ++ci) {
    iters = ci + 1;
    set_point(s, cw, lane);
    float2 dx;
    if (CJR && ci >= prm.cjr) {
      assemble_rhs(s, plan, true, lane);
      dx = replay(s, plan, keep, lane);
    } else {
      assemble(s, plan, true, lane);
      dx = solve<REPLAY>(s, plan, keep, lane);
    }
    cw = make_float2(cw.x - dx.x, cw.y - dx.y);
    const float sq_dx = warp_sum(dx.x * dx.x + dx.y * dx.y);
    const float sq_x = warp_sum(cw.x * cw.x + cw.y * cw.y);
    ok = sq_dx < prm.tol_sq * sq_x;
    diverged = sq_x > prm.inf_sq;
    if (ok || diverged) break;
  }

  // Outcome bookkeeping.
  const bool good = !diverged && ok;
  fail = !diverged && !ok;
  if (good || diverged) {
    ps.xv = cw;
    ps.t = tc;
  } else {
    ps.xv = ps.xlv;
  }
  if (good) ps.xlv = cw;
  const float succ2 = good ? ps.succ + 1.0f : (fail ? 0.0f : ps.succ);
  const bool bump = good && succ2 >= (float)prm.steps_inc;
  ps.dt = fail ? dtc * 0.5f : (bump ? dtc * 2.0f : dtc);
  ps.succ = bump ? 0.0f : succ2;
  if (diverged) ps.inf = 1.0f;
  ps.nst += 1.0f;
  return true;
}

// Whether this lane of the plan's 8 depth positions holds a depth.
__device__ __forceinline__ bool depth_lane(const int* __restrict__ plan,
                                           int lane) {
  bool is_depth = false;
  const int* depth = plan + plan[H_DEPTH];
  for (int d = 0; d < 8; ++d) is_depth |= depth[d] == lane;
  return is_depth;
}

__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
hc_track_kernel(float2* __restrict__ x, float2* __restrict__ xl,
                float* __restrict__ flags, const float2* __restrict__ efg,
                const int* __restrict__ plan, int n_paths, Params prm,
                int* __restrict__ next_path) {
  __shared__ WarpSmem smem[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpSmem& s = smem[warp];
  float2* keep = nullptr;
  if constexpr (REPLAY) keep = keep_area(warp);
  const int q_n = plan[H_Q];
  const bool is_depth = depth_lane(plan, lane);

  for (;;) {
    // The next path of the queue.
    int path = 0;
    if (lane == 0) path = atomicAdd(next_path, 1);
    path = __shfl_sync(FULL, path, 0);
    if (path >= n_paths) break;

    float2 e[2], f[2], g[2];
    load_coefs(efg, q_n, path, lane, e, f, g);
    PathState ps = load_path(x, xl, flags, path, lane);
    // CPH: whether s holds the last step's corrector elimination.  Nothing
    // is kept across paths or launches, as the JAX kernel resets its flag
    // at each launch.  This is the JAX kernel's handoff at a tile of one
    // path; hc_track_tile_kernel decides it per tile.
    bool handoff = false;
    for (int it = 0; it < prm.niter; ++it) {
      bool fail = false;
      int iters = 0;
      if (!hc_step(s, keep, plan, prm, e, f, g, ps, handoff, fail, iters,
                   is_depth, q_n, lane))
        break;
      if constexpr (CPH) handoff = !fail;  // no roll-back
    }
    store_path(x, xl, flags, ps, path, lane);
  }
}

#if HC_CPH
// The tiled handoff: hc_track_tile_kernel and the pieces it alone uses.
//
// The last corrector elimination of a path is kept in device memory
// between steps, one record of KEPT_BYTES a path: the system with its
// pivot rows, the pivots, the multipliers (s.m, s.piv and keep, moved by
// three bulk copies each way).
constexpr unsigned KEPT_M = NV * W * sizeof(float2);      // 7,680
constexpr unsigned KEPT_P = 32 * sizeof(int);             //   128
constexpr unsigned KEPT_F = FSLOTS * sizeof(float2);      // 2,816
constexpr unsigned KEPT_BYTES = KEPT_M + KEPT_P + KEPT_F;  // 10,624
static_assert(KEPT_M % 16 == 0 && KEPT_P % 16 == 0 && KEPT_F % 16 == 0,
              "a bulk copy moves a multiple of 16 bytes");
static_assert(offsetof(WarpSmem, piv) == KEPT_M + 1024 + 256 + 2304 &&
                  offsetof(WarpSmem, piv) % 16 == 0 &&
                  sizeof(WarpSmem) % 16 == 0,
              "bulk copies start on 16-byte boundaries");

// Warps per block of the tiled tracker, one block per SM (the replaying
// builds' 16 warps per SM); a tile runs on a cluster of blocks, its size
// chosen per launch.  Their per-warp areas are all dynamic shared memory
// (16 warps' pass the 48 KB of static shared memory): the warps'
// WarpSmem, then their multiplier areas.
constexpr int TILE_WARPS = 16;
constexpr int TILE_MIN_BLOCKS = MIN_BLOCKS * WARPS / TILE_WARPS;
constexpr int TILE_SMEM =
    TILE_WARPS * (int)(sizeof(WarpSmem) + FSLOTS * sizeof(float2));

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// A path's state as load_path reads it, but through L2 (ld.global.cg):
// another block of the cluster may have written it in the step before.
__device__ __forceinline__ PathState load_path_l2(const float2* x,
                                                  const float2* xl,
                                                  const float* flags,
                                                  int path, int lane) {
  const float2 zero = make_float2(0.f, 0.f);
  const float* fl = flags + (size_t)path * 8;
  return PathState{lane < NV ? __ldcg(x + (size_t)path * NV + lane) : zero,
                   lane < NV ? __ldcg(xl + (size_t)path * NV + lane) : zero,
                   __ldcg(fl), __ldcg(fl + 1), __ldcg(fl + 2), __ldcg(fl + 3),
                   __ldcg(fl + 4), __ldcg(fl + 5), __ldcg(fl + 6),
                   __ldcg(fl + 7)};
}

// One warp's bulk copies (the 1-D TMA copy, cp.async.bulk) of its kept
// elimination between its shared areas and a path's record.  Lane 0
// issues them; the proxy fences order them with the warp's own loads and
// stores.  A save runs behind the warp's next work and is waited for
// before the warp writes its system again (reuse) and, in device memory,
// before the step's barrier (drain); a fetch lands on the warp's
// mbarrier, waited for where the replay first writes the system.
struct KeptCopies {
  unsigned bar;     // the warp's mbarrier (shared address)
  unsigned parity;  // the phase of the bar the next fetch completes
  bool saving;      // a save may still read the shared areas
  bool fetching;    // a fetch may still write them

  __device__ void init(int lane) {
    if (lane == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
                   "r"(1u)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
  }

  // The shared areas free for the warp's writes.
  __device__ void reuse(int lane) {
    if (saving) {
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      __syncwarp();
      saving = false;
    }
  }

  // The warp's generic writes to the areas ordered before bulk copies.
  __device__ static void handover() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
  }

  __device__ void save(WarpSmem& s, const float2* keep, char* rec,
                       int lane) {
    handover();
    if (lane == 0) {
      const char* src[3] = {(const char*)s.m, (const char*)s.piv,
                            (const char*)keep};
      const unsigned len[3] = {KEPT_M, KEPT_P, KEPT_F};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                "l"(rec),
            "r"(smem_addr(src[k])), "r"(len[k])
            : "memory");
        rec += len[k];
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    saving = true;
  }

  __device__ void fetch(WarpSmem& s, float2* keep, const char* rec,
                        int lane) {
    reuse(lane);
    handover();
    if (lane == 0) {
      asm volatile("fence.proxy.async.global;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(KEPT_BYTES)
          : "memory");
      char* dst[3] = {(char*)s.m, (char*)s.piv, (char*)keep};
      const unsigned len[3] = {KEPT_M, KEPT_P, KEPT_F};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst[k])),
            "l"(rec), "r"(len[k]), "r"(bar)
            : "memory");
        rec += len[k];
      }
    }
    fetching = true;
  }

  // The fetch landed (every lane waits on the mbarrier's phase).
  __device__ void landed() {
    if (!fetching) return;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
        "@!p bra WAIT;\n\t}" ::"r"(bar),
        "r"(parity)
        : "memory");
    parity ^= 1u;
    fetching = false;
  }

  // The saves complete in device memory, for the other blocks after the
  // cluster's barrier.
  __device__ void drain(int lane) {
    if (lane == 0) {
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
      asm volatile("fence.proxy.async.global;" ::: "memory");
    }
    __syncwarp();
    saving = false;
  }
};

// A corrector iteration's full solve at the path's point and t, its update
// unused: the elimination that s and keep then hold is the one the JAX
// kernel keeps for a path whose corrector stopped before its tile's last
// full iteration (that lane, done, is factored again where it stands).
__device__ __forceinline__ void refactor(WarpSmem& s, float2* keep,
                                         const int* __restrict__ plan,
                                         const float2 (&e)[2],
                                         const float2 (&f)[2],
                                         const float2 (&g)[2],
                                         const PathState& ps, int q_n,
                                         int lane) {
  fill(s, e, f, g, ps.t, false, q_n, lane);
  set_point(s, ps.xv, lane);
  assemble(s, plan, true, lane);
  solve<REPLAY>(s, plan, keep, lane);
}

// Words of a tile's step in the cluster leader's shared memory: the path
// counters of the step and of its refactor pass, and the tile's "a path
// rolled back", "a path goes on" and most corrector iterations.
enum { T_NEXT = 0, T_REDO, T_FAILED, T_LIVE, T_MOST, T_WORDS };

// The handoff decided per tile of `tile` consecutive paths, as the JAX
// kernel decides it (its `cont[1] = max(failf) < 0.5`): RK stage 1 of a
// step replays only if no path of the tile rolled back in the step before,
// and never at a launch's first step.  Each path runs hc_step, the
// arithmetic of hc_track_kernel.  What differs from it is the handoff's
// validity and the elimination kept: the JAX kernel runs a tile's
// corrector until every lane is done and saves each full iteration's
// elimination for every lane, so a path that stopped before the tile's
// last full iteration (the m-th, under CJR no later than the cjr-th) keeps
// the one at its final point, which a second pass after the step's
// barrier computes (refactor) when the handoff holds.
//
// What bounds it beyond hc_track_kernel's latency: the lockstep.  Every
// step of a tile ends at a barrier that waits for its slowest path, so a
// tile's step lasts as long as the longest run of paths one of its warps
// takes: with few warps a tile is a long chain of path-steps, with one
// path a warp the step waits for the tile's slowest path-step alone.
//
// The design (the layout, cluster sizes and copies measured against
// each other on the H100: PERF.md, PR 12): a tile runs on a thread-block
// cluster of 16-warp blocks, sized per launch by ops/_kernels.tile_launch
// (each warp about 4 of the tile's paths a step, more warps when the
// tiles are too few to fill the card; at most the portable 8 blocks), on
// a persistent grid of whole clusters taking tiles from the counter
// *next_tile.
//  * The cluster's leader block (rank 0) holds the tile's words in its
//    shared memory; every warp of the cluster reaches them by distributed
//    shared memory (map_shared_rank), taking the tile's next path of the
//    step from its counter and adding its outcome with atomics there.
//  * The step's barrier is the cluster's hardware barrier (release /
//    acquire): a path's state and kept elimination, written to device
//    memory by one block, are then visible to whichever block takes the
//    path next.  The words come in three sets used in turn, so that one
//    barrier per step suffices: after step g's barrier the leader clears
//    the set of step g + 2, which every block read before it arrived.
//  * The refactor pass follows the barrier, dealt over all the cluster's
//    warps by a counter of its own, and ends at a second barrier.
//  * A path's state moves through L2 (ld.global.cg) and its kept
//    elimination (10,624 bytes) by bulk copies: the save after a step
//    runs behind the warp's next path, the fetch before a replay is
//    issued when the path is taken and waited for only where the replay
//    first writes the system (after the fill and the rhs's monomials).
//    With 16-warp blocks the copies gain 1-3 % on the warps' own loads
//    and stores.
__global__ void __launch_bounds__(32 * TILE_WARPS, TILE_MIN_BLOCKS)
hc_track_tile_kernel(float2* __restrict__ x, float2* __restrict__ xl,
                     float* __restrict__ flags, const float2* __restrict__ efg,
                     const int* __restrict__ plan, int n_paths, Params prm,
                     int tile, char* __restrict__ kept,
                     int* __restrict__ kept_it, int* __restrict__ next_tile) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  WarpSmem* const smem = reinterpret_cast<WarpSmem*>(tile_smem);
  __shared__ __align__(8) unsigned long long bars[TILE_WARPS];
  // The leader's alone are used: a step's words, three sets in turn, and
  // the tile's first path, two in turn.
  __shared__ int words[3][T_WORDS], firsts[2];
  cg::cluster_group cluster = cg::this_cluster();
  const bool leader = cluster.block_rank() == 0;
  int* const lead_words = cluster.map_shared_rank(&words[0][0], 0);
  const int* const lead_first = cluster.map_shared_rank(firsts, 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpSmem& s = smem[warp];
  float2* keep =
      reinterpret_cast<float2*>(smem + TILE_WARPS) + warp * FSLOTS;
  const int q_n = plan[H_Q];
  const bool is_depth = depth_lane(plan, lane);
  KeptCopies kc{smem_addr(&bars[warp]), 0u, false, false};
  kc.init(lane);
  if (threadIdx.x < 3 * T_WORDS) (&words[0][0])[threadIdx.x] = 0;
  cluster.sync();  // every block has started, the words are clear

  int gs = 0;  // the cluster's steps so far: step gs counts in set gs % 3
  for (int j = 0;; j ^= 1) {
    if (leader && threadIdx.x == 0)
      firsts[j] = atomicAdd(next_tile, 1) * tile;
    cluster.sync();
    const int first = lead_first[j];
    if (first >= n_paths) break;
    const int count = min(tile, n_paths - first);
    bool handoff = false;
    for (int it = 0; it < prm.niter; ++it) {
      int* const w = lead_words + (gs % 3) * T_WORDS;
      for (;;) {
        int i = 0;
        if (lane == 0) i = atomicAdd(w + T_NEXT, 1);
        i = __shfl_sync(FULL, i, 0);
        if (i >= count) break;
        const int path = first + i;
        PathState ps = load_path_l2(x, xl, flags, path, lane);
        if (finished(ps, prm)) continue;  // blocks nothing
        char* rec = kept + (size_t)path * KEPT_BYTES;
        if (handoff)
          kc.fetch(s, keep, rec, lane);
        else
          kc.reuse(lane);
        float2 e[2], f[2], g[2];
        load_coefs(efg, q_n, path, lane, e, f, g);
        bool fail = false;
        int iters = 0;
        const bool stepped =
            hc_step(s, keep, plan, prm, e, f, g, ps, handoff, fail, iters,
                    is_depth, q_n, lane, [&kc] { kc.landed(); });
        kc.landed();  // a path pruned before its predictor
        const bool goes_on = !finished(ps, prm);
        if (stepped && !fail && goes_on) kc.save(s, keep, rec, lane);
        store_path(x, xl, flags, ps, path, lane);
        if (lane == 0) {
          kept_it[path] = stepped ? iters : 0;
          if (fail) atomicOr(w + T_FAILED, 1);
          if (goes_on) atomicOr(w + T_LIVE, 1);
          if (stepped) atomicMax(w + T_MOST, iters);
        }
      }
      kc.drain(lane);
      cluster.sync();
      const bool any_failed = w[T_FAILED] != 0, any_live = w[T_LIVE] != 0;
      const int last = min(w[T_MOST], CJR ? prm.cjr : prm.mcs);
      if (leader && threadIdx.x < T_WORDS)
        words[(gs + 2) % 3][threadIdx.x] = 0;
      ++gs;
      handoff = !any_failed;
      if (!any_live) break;
      if (!handoff || last < 2) continue;
      // The tile's last full corrector iteration at each final point of a
      // path that stopped before it (fused.handoff_refactor).
      for (;;) {
        int i = 0;
        if (lane == 0) i = atomicAdd(w + T_REDO, 1);
        i = __shfl_sync(FULL, i, 0);
        if (i >= count) break;
        const int path = first + i;
        const int c = __ldcg(kept_it + path);
        if (c == 0 || c >= last) continue;
        const PathState ps = load_path_l2(x, xl, flags, path, lane);
        if (finished(ps, prm)) continue;
        float2 e[2], f[2], g[2];
        load_coefs(efg, q_n, path, lane, e, f, g);
        kc.reuse(lane);
        refactor(s, keep, plan, e, f, g, ps, q_n, lane);
        kc.save(s, keep, kept + (size_t)path * KEPT_BYTES, lane);
      }
      kc.drain(lane);
      cluster.sync();
    }
  }
  cluster.sync();  // no block leaves while another may read the leader
}

// The launch of the tiled tracker: `grid` blocks in clusters of
// `cluster` (the cluster's size a launch attribute).
struct TileLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;

  TileLaunch(int grid, int cluster, cudaStream_t stream) : attr{}, cfg{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(32 * TILE_WARPS);
    cfg.dynamicSmemBytes = TILE_SMEM;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  TileLaunch(const TileLaunch&) = delete;
};

// A call's error code, the error cleared if the runtime refused the call
// (so that no later cudaGetLastError() reports it).
int refused(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}
#endif

// The solve and its replay alone, one warp per system: solve the augmented
// system m[i] (30 rows x 32 columns, rhs in column 30), keeping the
// elimination, then replay it on rhs[i]; x_solve[i] and x_replay[i] in
// position order.  The twin is fused.solve_plain + fused.resolve_plain.
__global__ void __launch_bounds__(32 * WARPS)
solve_replay_kernel(const float2* __restrict__ m, const float2* __restrict__ rhs,
                    float2* __restrict__ x_solve, float2* __restrict__ x_replay,
                    const int* __restrict__ plan, int n_sys) {
  __shared__ WarpSmem smem[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= n_sys) return;
  WarpSmem& s = smem[warp];
  float2* keep = keep_area(warp);
  for (int row = 0; row < NV; ++row)
    s.m[at(row, lane)] = m[((size_t)i * NV + row) * 32 + lane];
  __syncwarp();
  const float2 xs = solve<true>(s, plan, keep, lane);
  if (lane < NV) {
    x_solve[(size_t)i * NV + lane] = xs;
    s.m[at(lane, RHS)] = rhs[(size_t)i * NV + lane];
  }
  __syncwarp();
  const float2 xr = replay(s, plan, keep, lane);
  if (lane < NV) x_replay[(size_t)i * NV + lane] = xr;
}

// K1's phases alone, one kernel per phase (a template: the phase is a
// compile-time choice, so no phase pays for another's registers).  Replaces
// the JAX round's per-phase microbenchmark kernel
// (tools/microbench_fused.py::build_phase_kernel), which runs a piece of the
// TPU kernel's step `niter` times on realistic state; the plain twins are
// in ops/phases.py.  Every phase runs K1's own device functions on K1's
// WarpSmem, one warp per path, on the persistent grid of hc_track_kernel,
// and in the same build as the tracker it times (the build's -D flags: the
// RK-stage evaluation of SPLIT2, the basis of ABC).  Iteration i runs at
// t = 0.31 + i 1e-7; a phase that takes no t adds d = i 1e-7 to one entry
// of its input instead (0 at i = 0), so nothing is loop-invariant.  Work
// done once per path before the loop (the fixed state a phase starts
// from) costs the same at every `niter` and cancels in the two-count
// timing.  Each iteration adds one value per lane of its result to a
// running sum; at the end each path writes its last result (PHASE_OUT
// entries per path, the layout in ops/_kernels.hc_phase), the pivots of
// an elimination and the sum.
enum Phase {
  PH_FILL = 0,   // P and dP/dt at t (fill)
  PH_MONO,       // the monomial table at x, entry 0 moved by d
  PH_WALK,       // the term walk over a fixed table, monomial 0 moved by d
  PH_WALK_BF16,  // the same with P and the monomial rounded to bf16
  PH_EVAL,       // fill + monomials + walk (no zeroing of the system)
  PH_EVRHS,      // fill + the rhs alone (assemble_rhs)
  PH_EVASM,      // fill + assemble
  PH_ELIM,       // fill + assemble + every forward pivot step
  PH_ELIMFAM,    // the family steps on a fixed system, rhs of row 0 moved
  PH_ELIMTAIL,   // the reduced steps, from the family steps' state
  PH_BACK,       // back-substitution on a fixed eliminated system
  PH_EVSOLVE,    // fill + assemble + solve
  PH_REPLAY,     // corrector fill + rhs + replay of a kept elimination
  N_PHASES
};
constexpr int PHASE_OUT = 1024;  // float2 per path of a phase's result

__device__ __forceinline__ void add2(float2& acc, float2 v) {
  acc.x += v.x;
  acc.y += v.y;
}

template <int PH>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
hc_phase_kernel(const float2* __restrict__ x, const float2* __restrict__ efg,
                const int* __restrict__ plan, int n_paths, int niter,
                float2* __restrict__ out, int* __restrict__ piv_out,
                float2* __restrict__ acc_out, int* __restrict__ next_path) {
  constexpr bool SYSTEM = PH == PH_WALK || PH == PH_WALK_BF16 ||
                          PH == PH_EVAL || PH == PH_EVASM || PH == PH_ELIM ||
                          PH == PH_ELIMFAM || PH == PH_ELIMTAIL;
  constexpr bool X_OUT = PH == PH_BACK || PH == PH_EVSOLVE || PH == PH_REPLAY;
  constexpr float T0 = 0.31f, DT = 1e-7f;
  __shared__ WarpSmem smem[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpSmem& s = smem[warp];
  float2* keep = nullptr;
  if constexpr (PH == PH_REPLAY) keep = keep_area(warp);
  const int q_n = plan[H_Q], n_step = plan[H_NSTEP];
  const int* steps = plan + plan[H_STEPS];
  // The family stages' steps come first (row-map levels below the last).
  int n_fam = 0;
  while (n_fam < n_step && steps[STEP_INTS * n_fam] < plan[H_NMAP]) ++n_fam;
  // The pivot steps an elimination phase runs.
  const int p0 = PH == PH_ELIMTAIL ? n_fam : 0;
  const int p1 = PH == PH_ELIMFAM ? n_fam : n_step;
  const float2 zero = make_float2(0.f, 0.f);

  for (;;) {
    int path = 0;
    if (lane == 0) path = atomicAdd(next_path, 1);
    path = __shfl_sync(FULL, path, 0);
    if (path >= n_paths) break;

    float2 e[2], f[2], g[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = lane + 32 * j;
      const float2* base = efg + (size_t)path * 3 * q_n;
      e[j] = q < q_n ? base[q] : zero;
      f[j] = q < q_n ? base[q_n + q] : zero;
      g[j] = q < q_n ? base[2 * q_n + q] : zero;
    }
    const float2 xv = lane < NV ? x[(size_t)path * NV + lane] : zero;
    float2 acc = zero, xs = zero, mono0 = zero;
    unsigned used0 = 0u;
    int level0 = 0, cur0 = 0;

    // The fixed state a phase starts from, once per path.
    if constexpr (PH == PH_WALK || PH == PH_WALK_BF16 || PH == PH_ELIMFAM ||
                  PH == PH_ELIMTAIL || PH == PH_BACK) {
      fill(s, e, f, g, T0, true, q_n, lane);
      set_point<SPLIT2>(s, xv, lane);
      assemble<SPLIT2>(s, plan, false, lane);
      mono0 = s.u.mono[0];
    }
    if constexpr (PH == PH_EVAL) {
      for (int i = lane; i < NV * W; i += 32) s.m[i] = zero;
    }
    if constexpr (PH == PH_ELIMTAIL || PH == PH_BACK) {
      begin_solve(s, plan, lane);
      forward<false>(s, plan, nullptr, 0, PH == PH_BACK ? n_step : n_fam,
                     used0, level0, cur0, lane);
    }
    if constexpr (PH == PH_REPLAY) {
      fill(s, e, f, g, T0, false, q_n, lane);
      set_point(s, xv, lane);
      assemble(s, plan, true, lane);
      solve<true>(s, plan, keep, lane);
    }

    for (int it = 0; it < niter; ++it) {
      const float d = (float)it * DT, t = T0 + d;
      __syncwarp();
      if constexpr (PH == PH_FILL) {
        fill(s, e, f, g, t, true, q_n, lane);
        if (lane < q_n)
          add2(acc, make_float2(s.pr[lane].x + s.pr[QMAX + lane].x,
                                s.pr[lane].y + s.pr[QMAX + lane].y));
      } else if constexpr (PH == PH_MONO) {
        set_point<SPLIT2>(s, lane == 0 ? make_float2(xv.x + d, xv.y) : xv,
                          lane);
        monomials<SPLIT2>(s, plan, 0, lane);
        add2(acc, s.u.mono[lane]);
      } else if constexpr (PH == PH_WALK || PH == PH_WALK_BF16) {
        if (lane == 0) s.u.mono[0] = make_float2(mono0.x + d, mono0.y);
        __syncwarp();
        walk_terms<SPLIT2, PH == PH_WALK_BF16>(s, plan + plan[H_EVAL],
                                               plan[H_NQUAD], false, lane);
      } else if constexpr (PH == PH_ELIMFAM || PH == PH_ELIMTAIL) {
        if (lane == 0) s.m[at(0, RHS)].x += d;
        __syncwarp();
        unsigned used = used0;
        int level = level0, cur = cur0;
        if constexpr (PH == PH_ELIMFAM) begin_solve(s, plan, lane);
        forward<false>(s, plan, nullptr, p0, p1, used, level, cur, lane);
      } else if constexpr (PH == PH_BACK) {
        if (lane == 0) s.m[at(s.piv[0], RHS)].x += d;
        __syncwarp();
        xs = backsub(s, plan, lane);
      } else if constexpr (PH == PH_REPLAY) {
        fill(s, e, f, g, t, false, q_n, lane);
        set_point(s, xv, lane);
        assemble_rhs(s, plan, true, lane);
        xs = replay(s, plan, keep, lane);
      } else {  // EVAL, EVRHS, EVASM, ELIM, EVSOLVE
        fill(s, e, f, g, t, true, q_n, lane);
        set_point<SPLIT2>(s, xv, lane);
        if constexpr (PH == PH_EVAL) {
          monomials<SPLIT2>(s, plan, 0, lane);
          walk_terms<SPLIT2>(s, plan + plan[H_EVAL], plan[H_NQUAD], false,
                             lane);
        } else if constexpr (PH == PH_EVRHS) {
          assemble_rhs<SPLIT2>(s, plan, false, lane);
        } else {
          assemble<SPLIT2>(s, plan, false, lane);
        }
        if constexpr (PH == PH_ELIM) {
          unsigned used = 0u;
          int level = 0, cur = 0;
          begin_solve(s, plan, lane);
          forward<false>(s, plan, nullptr, 0, n_step, used, level, cur,
                         lane);
        }
        if constexpr (PH == PH_EVSOLVE) xs = solve<false>(s, plan, nullptr,
                                                          lane);
      }
      if constexpr (SYSTEM) add2(acc, s.m[at(lane % NV, lane)]);
      if constexpr (PH == PH_EVRHS) add2(acc, s.m[at(lane % NV, RHS)]);
      if constexpr (X_OUT) add2(acc, xs);
    }

    // The last result, the pivots and the running sum.
    float2* o = out + (size_t)path * PHASE_OUT;
    const float2 sum = make_float2(warp_sum(acc.x), warp_sum(acc.y));
    if (lane == 0) acc_out[path] = sum;
    if constexpr (PH == PH_FILL) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = lane + 32 * j;
        if (q < q_n) {
          o[q] = s.pr[q];
          o[QMAX + q] = s.pr[QMAX + q];
        }
      }
    } else if constexpr (PH == PH_MONO) {
      for (int i = lane; i < plan[H_NMONO]; i += 32) o[i] = s.u.mono[i];
    } else if constexpr (PH == PH_EVRHS) {
      if (lane < NV) o[lane] = s.m[at(lane, RHS)];
    } else if constexpr (X_OUT) {
      if (lane < NV) o[lane] = xs;
    } else {
      for (int r = 0; r < NV; ++r) o[r * W + lane] = s.m[at(r, lane)];
      if constexpr (PH == PH_ELIM || PH == PH_ELIMFAM || PH == PH_ELIMTAIL) {
        if (lane >= p0 && lane < p1) piv_out[(size_t)path * 32 + lane] =
            s.piv[lane];
      }
    }
    __syncwarp();  // the next path's first writes to s come after
  }
}

// A phase kernel's dynamic shared memory (the replay's multipliers) and
// the largest shared-memory carveout, as configure_track.
template <int PH>
cudaError_t configure_phase(int* smem) {
  *smem = PH == PH_REPLAY ? WARPS * FSLOTS * (int)sizeof(float2) : 0;
  if (*smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        hc_phase_kernel<PH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        *smem);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(hc_phase_kernel<PH>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int PH>
cudaError_t phase_blocks(int* blocks) {
  int smem = 0;
  const cudaError_t err = configure_phase<PH>(&smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, hc_phase_kernel<PH>, 32 * WARPS, smem);
}

template <int PH>
cudaError_t phase_launch(const void* x, const void* efg, const void* plan,
                         int n_paths, int niter, void* out, void* piv,
                         void* acc, int blocks, void* next_path,
                         cudaStream_t stream) {
  int smem = 0;
  const cudaError_t err = configure_phase<PH>(&smem);
  if (err != cudaSuccess) return err;
  hc_phase_kernel<PH><<<blocks, 32 * WARPS, smem, stream>>>(
      (const float2*)x, (const float2*)efg, (const int*)plan, n_paths, niter,
      (float2*)out, (int*)piv, (float2*)acc, (int*)next_path);
  return cudaGetLastError();
}

#define HC_PHASES(X)                                                      \
  X(PH_FILL) X(PH_MONO) X(PH_WALK) X(PH_WALK_BF16) X(PH_EVAL) X(PH_EVRHS)  \
  X(PH_EVASM) X(PH_ELIM) X(PH_ELIMFAM) X(PH_ELIMTAIL) X(PH_BACK)           \
  X(PH_EVSOLVE) X(PH_REPLAY)

// A tracker kernel's dynamic shared memory (`smem` bytes) allowed above
// the default limit, and the largest shared-memory carveout.
template <typename K>
cudaError_t configure(K kernel, int smem) {
  if (smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// hc_track_kernel's dynamic shared memory (a replaying build's
// multipliers), configured.
cudaError_t configure_track(int* smem) {
  *smem = REPLAY ? WARPS * FSLOTS * (int)sizeof(float2) : 0;
  return configure(hc_track_kernel, *smem);
}

#if HC_CPH
cudaError_t configure_tile() {
  return configure(hc_track_tile_kernel, TILE_SMEM);
}
#endif

}  // namespace

// Resident blocks per SM on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and warps per block of
// the tracker a launch at `tile` runs: hc_track_kernel, or at tile > 1
// (the handoff build only) hc_track_tile_kernel; returns a CUDA error code
// (0 = success).
extern "C" int hc_track_blocks_per_sm(int tile, int* blocks, int* warps) {
  *warps = WARPS;
#if HC_CPH
  if (tile > 1) {
    *warps = TILE_WARPS;
    const cudaError_t err = configure_tile();
    if (err != cudaSuccess) return refused(err);
    return refused(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, hc_track_tile_kernel, 32 * TILE_WARPS, TILE_SMEM));
  }
#endif
  if (tile != 1) return (int)cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = configure_track(&smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, hc_track_kernel,
                                                      32 * WARPS, smem);
  return (int)err;
}

// Clusters of `cluster` blocks of the tiled tracker (the handoff build
// only) resident at once on the current device
// (cudaOccupancyMaxActiveClusters); returns a CUDA error code (0 =
// success), the runtime's refusal of a cluster size among them.
extern "C" int hc_track_tile_clusters(int cluster, int* clusters) {
#if HC_CPH
  if (cluster < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = configure_tile();
  if (err != cudaSuccess) return refused(err);
  TileLaunch l(cluster, cluster, 0);
  return refused(
      cudaOccupancyMaxActiveClusters(clusters, hc_track_tile_kernel, &l.cfg));
#else
  (void)cluster;
  *clusters = 0;
  return (int)cudaErrorInvalidValue;
#endif
}

// Launch `blocks` persistent blocks on `stream`, taking paths from the
// int32 counter *next_path (zero at launch): at tile 1 hc_track_kernel,
// at tile > 1 (the handoff build only) hc_track_tile_kernel, taking tiles
// of `tile` paths, in clusters of `cluster` blocks (`blocks` a multiple
// of it), with `kept` (n_paths x KEPT_BYTES, 16-byte aligned) and kept_it
// (n_paths int32) for the kept eliminations (unused at tile 1).  Returns
// the launch's CUDA error code (0 = launched; a refused cluster size
// among the errors), or -1 if the step variant asked for is not the one
// this library was built as.
extern "C" int hc_track_launch(void* x, void* xl, void* flags, const void* efg,
                               const void* plan, int n_paths, int niter,
                               int mcs, int steps_inc, int truncate,
                               float ez_factor, float t_eps, float tol_sq,
                               float inf_sq, int order, int cjr, int cph,
                               int rkj, int split2, int abc, int tile,
                               void* kept, void* kept_it, int blocks,
                               int cluster, void* next_path, void* stream) {
  if (order != ORDER || (cjr > 0) != CJR || (cph != 0) != CPH ||
      (rkj != 0) != RKJ || (split2 != 0) != SPLIT2 || (abc != 0) != ABC ||
      tile < 1 || (tile > 1 && !CPH))
    return -1;
  if (n_paths <= 0) return 0;
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  Params prm{niter, mcs, steps_inc, truncate, ez_factor, t_eps, tol_sq, inf_sq,
             cjr};
#if HC_CPH
  if (tile > 1) {
    if (cluster < 1 || blocks % cluster != 0)
      return (int)cudaErrorInvalidConfiguration;
    const cudaError_t err = configure_tile();
    if (err != cudaSuccess) return refused(err);
    TileLaunch l(blocks, cluster, (cudaStream_t)stream);
    const int launched = refused(cudaLaunchKernelEx(
        &l.cfg, hc_track_tile_kernel, (float2*)x, (float2*)xl, (float*)flags,
        (const float2*)efg, (const int*)plan, n_paths, prm, tile,
        (char*)kept, (int*)kept_it, (int*)next_path));
    return launched ? launched : (int)cudaGetLastError();
  }
#endif
  int smem = 0;
  const cudaError_t err = configure_track(&smem);
  if (err != cudaSuccess) return (int)err;
  hc_track_kernel<<<blocks, 32 * WARPS, smem, (cudaStream_t)stream>>>(
      (float2*)x, (float2*)xl, (float*)flags, (const float2*)efg,
      (const int*)plan, n_paths, prm, (int*)next_path);
  return (int)cudaGetLastError();
}

// solve_replay_kernel on `stream`; returns cudaGetLastError().
extern "C" int hc_solve_replay_launch(const void* m, const void* rhs,
                                      void* x_solve, void* x_replay,
                                      const void* plan, int n_sys,
                                      void* stream) {
  if (n_sys <= 0) return 0;
  const int smem = WARPS * FSLOTS * (int)sizeof(float2);
  const cudaError_t err = cudaFuncSetAttribute(
      solve_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  solve_replay_kernel<<<(n_sys + WARPS - 1) / WARPS, 32 * WARPS, smem,
                        (cudaStream_t)stream>>>(
      (const float2*)m, (const float2*)rhs, (float2*)x_solve,
      (float2*)x_replay, (const int*)plan, n_sys);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of phase kernel `phase` (the Phase order) on the
// current device; returns a CUDA error code, or -2 for no such phase.
extern "C" int hc_phase_blocks_per_sm(int phase, int* blocks) {
  switch (phase) {
#define X(P) \
  case P:    \
    return (int)phase_blocks<P>(blocks);
    HC_PHASES(X)
#undef X
  }
  return -2;
}

// Launch phase kernel `phase` for `niter` iterations on `blocks`
// persistent blocks on `stream`, taking paths from the int32 counter
// *next_path (zero at launch): x (n_paths, 30), efg (n_paths, 3, Q), out
// (n_paths, PHASE_OUT) float2, piv (n_paths, 32) int32, acc (n_paths)
// float2.  Returns cudaGetLastError() (0 = launched), -1 if split2/abc are
// not this library's build, -2 for no such phase.
extern "C" int hc_phase_launch(int phase, const void* x, const void* efg,
                               const void* plan, int n_paths, int niter,
                               void* out, void* piv, void* acc, int split2,
                               int abc, int blocks, void* next_path,
                               void* stream) {
  if ((split2 != 0) != SPLIT2 || (abc != 0) != ABC) return -1;
  if (n_paths <= 0) return 0;
  if (blocks <= 0 || niter <= 0) return (int)cudaErrorInvalidValue;
  switch (phase) {
#define X(P)                                                            \
  case P:                                                               \
    return (int)phase_launch<P>(x, efg, plan, n_paths, niter, out, piv, \
                                acc, blocks, next_path,                 \
                                (cudaStream_t)stream);
    HC_PHASES(X)
#undef X
  }
  return -2;
}
