// Homotopy-continuation path tracker for the trifocal 2op1p 30x30 system,
// one warp per path, for sm_90a (H100).
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
// one max butterfly plus a ballot whatever the program; the schedule's
// longer steps cost more row updates (the loop over live candidates), not
// more registers or shared memory.
//
// What bounds it on the card: not bytes -- a path reads ~3 KB of state and
// coefficients once and the tables stay in L1/L2 -- but issue latency.  Each
// step is ~7 evaluate+solve rounds, and a solve is 30 dependent pivot steps
// (shuffle reduction, broadcast, row updates) plus 30 dependent
// back-substitution dot products.  The per-path augmented system needs
// shared memory (30 x 33 complex, ~9.8 KB per warp with the rest), which
// caps resident warps per SM.
//
// What the design does about it: one warp per path keeps every dependent
// chain inside a warp (shuffles and __syncwarp, never __syncthreads), lane e
// owns equation row e while evaluating and column j while eliminating, and
// a warp leaves its loop the moment its path converges, diverges or is
// pruned, so a finished path costs nothing (the TPU's survivor compaction
// has no counterpart here).  Rows are padded to 33 complex so the row-owner
// writes of the evaluation do not collide in one shared-memory bank.
// FP32 throughout: no TF32, no fast-math, and no FMA contraction (built with
// -fmad=false): every product and sum rounds once, in the order track_plain
// writes it out, so the kernel and its twin agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NV = 30;        // variables = equations
constexpr int RHS = 30;       // right-hand-side column of the augmented row
constexpr int LD = 33;        // shared row stride (complex), bank padding
constexpr int WARPS = 4;      // paths per block
constexpr int QMAX = 64;      // parameter pairs per path
constexpr int STEP_INTS = 36; // [level, col, ncand, pad, cand[32]]
constexpr unsigned FULL = 0xffffffffu;

// Plan header (see FusedConstants.kernel_plan).
enum {
  H_N = 0, H_Q, H_NSTEP, H_NMAP,
  H_MAP0, H_STEPS, H_MAPS, H_HXOFF, H_HXT, H_RHSOFF, H_RHST, H_DEPTH
};

struct Params {
  int niter, mcs, steps_inc, truncate;
  float ez_factor, t_eps, tol_sq, inf_sq;
};

struct WarpSmem {
  float2 m[NV * LD];  // augmented system, rows = equations
  float2 xe[32];      // evaluation point; xe[NV] = 1 (homogeneous slot)
  float2 xs[32];      // back-substitution vector; xs[RHS] = -1
  float2 p[QMAX];     // pair products for Hx
  float2 r[QMAX];     // pair products (corrector) or derivatives (RK)
  int map[2][32];     // current / next level row maps
  int piv[32];        // pivot row of every step
};

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

// P(t) = t^2 E + t(1-t) F + (1-t)^2 G per pair (exactly E at t = 1); the rhs
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
      float2 pq = make_float2(tt * e[j].x + (tv * f[j].x + vv * g[j].x),
                              tt * e[j].y + (tv * f[j].y + vv * g[j].y));
      s.p[q] = pq;
      s.r[q] = rk ? make_float2(t2 * e[j].x + (a * f[j].x - b * g[j].x),
                                t2 * e[j].y + (a * f[j].y - b * g[j].y))
                  : pq;
    }
  }
}

// Augmented system at xe: lane e evaluates equation row e from its term
// lists -- Hx nonzeros (col, coef, q, a, b) and the rhs (coef, q, a, b, c).
__device__ void assemble(WarpSmem& s, const int* __restrict__ plan,
                         bool want_h, int lane) {
  for (int row = 0; row < NV; ++row) s.m[row * LD + lane] = make_float2(0.f, 0.f);
  __syncwarp();
  if (lane < NV) {
    const int* hx_off = plan + plan[H_HXOFF];
    const int* hx_t = plan + plan[H_HXT];
    int i = hx_off[lane];
    const int end = hx_off[lane + 1];
    while (i < end) {
      const int col = hx_t[5 * i];
      float2 acc = make_float2(0.f, 0.f);
      while (i < end && hx_t[5 * i] == col) {
        const int* tm = hx_t + 5 * i;
        const float coef = (float)tm[1];
        const float2 px = cmul(s.p[tm[2]], cmul(s.xe[tm[3]], s.xe[tm[4]]));
        acc.x += coef * px.x;
        acc.y += coef * px.y;
        ++i;
      }
      s.m[lane * LD + col] = acc;
    }
    const int* rhs_off = plan + plan[H_RHSOFF];
    const int* rhs_t = plan + plan[H_RHST];
    float2 acc = make_float2(0.f, 0.f);
    for (int k = rhs_off[lane]; k < rhs_off[lane + 1]; ++k) {
      const int* tm = rhs_t + 5 * k;
      const float coef = (float)tm[0];
      const float2 x3 = cmul(cmul(s.xe[tm[2]], s.xe[tm[3]]), s.xe[tm[4]]);
      const float2 px = cmul(s.r[tm[1]], x3);
      acc.x += coef * px.x;
      acc.y += coef * px.y;
    }
    s.m[lane * LD + RHS] = want_h ? acc : make_float2(-acc.x, -acc.y);
  }
  __syncwarp();
}

// Restricted-pivoting solve of s.m by the plan's pivot program; returns
// lane v's entry of x.
__device__ float2 solve(WarpSmem& s, const int* __restrict__ plan, int lane) {
  const int n_step = plan[H_NSTEP];
  const int* steps = plan + plan[H_STEPS];
  const int* maps = plan + plan[H_MAPS];
  if (lane < NV) s.map[0][lane] = plan[plan[H_MAP0] + lane];
  __syncwarp();
  unsigned used = 0u;
  int level = 0, cur = 0;
  for (int st = 0; st < n_step; ++st) {
    const int* sp = steps + STEP_INTS * st;
    const int want = sp[0], col = sp[1], nc = sp[2];
    while (level < want) {
      // Next level's rows: the k-th unused row of each entry's sources.
      const int* mp = maps + (level * 32 + lane) * 4;
      int out = -1;
      if (mp[0] >= 0) {
        int cnt = 0;
        for (int j = 0; j < 3 && mp[j] >= 0; ++j) {
          const int pr = s.map[cur][mp[j]];
          if (!((used >> pr) & 1u)) {
            if (cnt == mp[3]) out = pr;
            ++cnt;
          }
        }
      }
      s.map[cur ^ 1][lane] = out;
      __syncwarp();
      cur ^= 1;
      ++level;
    }
    int r = -1;
    float2 v = make_float2(0.f, 0.f);
    float metric = -2.0f;
    bool was = false;
    if (lane < nc) {
      r = s.map[cur][sp[4 + lane]];
      v = s.m[r * LD + col];
      was = (used >> r) & 1u;
      metric = was ? -1.0f : fabsf(v.x) + fabsf(v.y);
    }
    // Pivot: the first lane holding the maximum (a NaN wins, as in
    // torch.argmax).
    float mx = metric;
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    const unsigned nan_lanes = __ballot_sync(FULL, metric != metric);
    const unsigned hit =
        nan_lanes ? nan_lanes : __ballot_sync(FULL, metric >= mx);
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
    used |= 1u << p;
    const float2 prow = s.m[p * LD + lane];
    __syncwarp();
    for (int i = 0; i < nc; ++i) {
      const float2 fi = shfl2(f, i);
      const int ri = __shfl_sync(FULL, r, i);
      const bool li = __shfl_sync(FULL, (int)live, i);
      if (li) {
        float2 mv = s.m[ri * LD + lane];
        mv.x -= fi.x * prow.x - fi.y * prow.y;
        mv.y -= fi.x * prow.y + fi.y * prow.x;
        s.m[ri * LD + lane] = mv;
      }
    }
    __syncwarp();
  }
  // Back-substitution over the pivot rows, last step first.
  s.xs[lane] = make_float2(lane == RHS ? -1.0f : 0.0f, 0.0f);
  __syncwarp();
  for (int st = n_step - 1; st >= 0; --st) {
    const int p = s.piv[st];
    const int col = steps[STEP_INTS * st + 1];
    const float2 a = cmul(s.m[p * LD + lane], s.xs[lane]);
    const float ar = warp_sum(a.x), ai = warp_sum(a.y);
    const float2 pv = s.m[p * LD + col];
    float den = pv.x * pv.x + pv.y * pv.y;
    if (den == 0.0f) den = 1.0f;
    const float2 xv = cmul(make_float2(ar, ai), make_float2(-pv.x / den, pv.y / den));
    __syncwarp();
    if (lane == 0) s.xs[col] = xv;
    __syncwarp();
  }
  return lane < NV ? s.xs[lane] : make_float2(0.f, 0.f);
}

__device__ __forceinline__ void set_point(WarpSmem& s, float2 x, int lane) {
  s.xe[lane] = lane < NV ? x : make_float2(lane == NV ? 1.0f : 0.0f, 0.0f);
  __syncwarp();
}

__device__ __forceinline__ float2 axpy(float2 x, float a, float2 k) {
  return make_float2(x.x + a * k.x, x.y + a * k.y);
}

__global__ void __launch_bounds__(32 * WARPS)
hc_track_kernel(float2* __restrict__ x, float2* __restrict__ xl,
                float* __restrict__ flags, const float2* __restrict__ efg,
                const int* __restrict__ plan, int n_paths, Params prm) {
  __shared__ WarpSmem smem[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int path = blockIdx.x * WARPS + warp;
  if (path >= n_paths) return;
  WarpSmem& s = smem[warp];
  const int q_n = plan[H_Q];

  float2 e[2], f[2], g[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = lane + 32 * j;
    const float2* base = efg + (size_t)path * 3 * q_n;
    e[j] = q < q_n ? base[q] : make_float2(0.f, 0.f);
    f[j] = q < q_n ? base[q_n + q] : make_float2(0.f, 0.f);
    g[j] = q < q_n ? base[2 * q_n + q] : make_float2(0.f, 0.f);
  }
  const float2 zero = make_float2(0.f, 0.f);
  float2 xv = lane < NV ? x[(size_t)path * NV + lane] : zero;
  float2 xlv = lane < NV ? xl[(size_t)path * NV + lane] : zero;
  float* fl = flags + (size_t)path * 8;
  float t = fl[0], dt = fl[1], succ = fl[2], ez = fl[3], chk = fl[4];
  float inf = fl[5], prn = fl[6], nst = fl[7];

  bool is_depth = false;
  const int* depth = plan + plan[H_DEPTH];
  for (int d = 0; d < 8; ++d) is_depth |= depth[d] == lane;

  for (int it = 0; it < prm.niter; ++it) {
    const bool conv = t >= 1.0f || 1.0f - t <= prm.t_eps;
    if (conv || inf > 0.5f || prn > 0.5f) break;
    if (fabsf(1.0f - t) <= prm.ez_factor) ez = 1.0f;
    if (prm.truncate) {
      // min over the depths <= 0, where a NaN depth makes the min NaN.
      const bool any_nan = __any_sync(FULL, is_depth && xv.x != xv.x);
      const bool any_bad = __any_sync(FULL, is_depth && xv.x <= 0.0f);
      if (chk > 0.5f && t > 0.0f) chk = (any_bad && !any_nan) ? 1.0f : 0.0f;
      if (t > 0.95f && chk > 0.5f) {
        prn = 1.0f;
        break;
      }
    }
    const float dtc = ez > 0.5f ? fminf(dt, fabsf(1.0f - t)) : fminf(dt, fabsf(0.95f - t));
    const float half = 0.5f * dtc;
    const float tb = t + half;
    const float tc = tb + half;

    // RK4 predictor.
    fill(s, e, f, g, t, true, q_n, lane);
    set_point(s, xv, lane);
    assemble(s, plan, false, lane);
    const float2 k1 = solve(s, plan, lane);
    fill(s, e, f, g, tb, true, q_n, lane);
    set_point(s, axpy(xv, half, k1), lane);
    assemble(s, plan, false, lane);
    const float2 k2 = solve(s, plan, lane);
    set_point(s, axpy(xv, half, k2), lane);
    assemble(s, plan, false, lane);
    const float2 k3 = solve(s, plan, lane);
    fill(s, e, f, g, tc, true, q_n, lane);
    set_point(s, axpy(xv, dtc, k3), lane);
    assemble(s, plan, false, lane);
    const float2 k4 = solve(s, plan, lane);
    const float sixth = dtc / 6.0f;
    float2 cw = make_float2(xv.x + sixth * (k1.x + 2.0f * (k2.x + k3.x) + k4.x),
                            xv.y + sixth * (k1.y + 2.0f * (k2.y + k3.y) + k4.y));

    // Newton corrector at frozen t_c.
    fill(s, e, f, g, tc, false, q_n, lane);
    bool ok = false, diverged = false;
    for (int ci = 0; ci < prm.mcs; ++ci) {
      set_point(s, cw, lane);
      assemble(s, plan, true, lane);
      const float2 dx = solve(s, plan, lane);
      cw = make_float2(cw.x - dx.x, cw.y - dx.y);
      const float sq_dx = warp_sum(dx.x * dx.x + dx.y * dx.y);
      const float sq_x = warp_sum(cw.x * cw.x + cw.y * cw.y);
      ok = sq_dx < prm.tol_sq * sq_x;
      diverged = sq_x > prm.inf_sq;
      if (ok || diverged) break;
    }

    // Outcome bookkeeping.
    const bool good = !diverged && ok, fail = !diverged && !ok;
    if (good || diverged) {
      xv = cw;
      t = tc;
    } else {
      xv = xlv;
    }
    if (good) xlv = cw;
    const float succ2 = good ? succ + 1.0f : (fail ? 0.0f : succ);
    const bool bump = good && succ2 >= (float)prm.steps_inc;
    dt = fail ? dtc * 0.5f : (bump ? dtc * 2.0f : dtc);
    succ = bump ? 0.0f : succ2;
    if (diverged) inf = 1.0f;
    nst += 1.0f;
  }

  if (lane < NV) {
    x[(size_t)path * NV + lane] = xv;
    xl[(size_t)path * NV + lane] = xlv;
  }
  if (lane == 0) {
    fl[0] = t; fl[1] = dt; fl[2] = succ; fl[3] = ez;
    fl[4] = chk; fl[5] = inf; fl[6] = prn; fl[7] = nst;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int hc_track_launch(void* x, void* xl, void* flags, const void* efg,
                               const void* plan, int n_paths, int niter,
                               int mcs, int steps_inc, int truncate,
                               float ez_factor, float t_eps, float tol_sq,
                               float inf_sq, void* stream) {
  if (n_paths <= 0) return 0;
  Params prm{niter, mcs, steps_inc, truncate, ez_factor, t_eps, tol_sq, inf_sq};
  const int blocks = (n_paths + WARPS - 1) / WARPS;
  hc_track_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (float2*)x, (float2*)xl, (float*)flags, (const float2*)efg,
      (const int*)plan, n_paths, prm);
  return (int)cudaGetLastError();
}
