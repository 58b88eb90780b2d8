// TrunRANSAC boundary scoring of the segmented tracker, for sm_90a (H100):
// segmented._Run._score_new in one launch.
//
// Replaces no TPU kernel.  The JAX package scores at each boundary with XLA
// code inside its segment while loop (ops/segmented.py), not a Pallas kernel.
// The port ran it as eager PyTorch, about 370 small operations a boundary,
// whose host time set the pace of the abort round while the card idled.
// This kernel does the same scoring in one launch.  Its plain PyTorch twin
// is segmented._Run._score_plain, and the two agree bit for bit: the build
// has no multiply-add contraction (-fmad=false), so every product and sum
// rounds once, and division and sqrt are IEEE, as the eager operations are.
//
// At a boundary, over the paths in packed order:
//  1. the slots: the first S = min(128, B) paths that converged and are not
//     yet scored (the newly converged), then the first others to fill S
//     (score_slots' stable argsort; those slots are invalid);
//  2. the gate: every |imag| of the 12 pose components < imag_tol, in float32
//     (max |imag| < tol in the plain code; a NaN fails both);
//  3. R21, R31 from the Cayley parameters in cayley_to_rotation's order: the
//     unnormalised entries, each column divided by its norm
//     sqrt((m0j^2 + m1j^2) + m2j^2);
//  4. the inlier counts n21, n31 over all N edgels in ransac._pair_inliers'
//     order, err < thresh;
//  5. the outcome: ok = valid & gate; the first ok slot with n21 >= need and
//     n31 >= need (as floats) is the found path, kept once set; the first
//     largest min(n21, n31) of the ok slots replaces the best support if it
//     is strictly larger; every valid slot's path is marked scored.
//
// What bounds it: operations.  At the abort chunk's shape (B = 3,684 paths,
// 128 slots, N = 5,117 edgels) it reprojects 128 x 5,117 x 2 edgels at 39
// FP32 operations each, 51 MFLOP, 0.77 us at the card's FP32 peak; the bytes
// it must read (the flags' t, the scored marks, 128 poses, the edgels) are
// about 160 KB, 0.05 us at 3.35 TB/s.  A launch takes about 17 us on an H100
// (4.5 % of that bound): a chain of dependent phases (scan, pose, count,
// ticket, reduce), each a few round trips to L2, on one block an SM.  Its
// point is the host: one launch in place of the eager operations, which took
// 2.2 ms a boundary to the card's finish.
//
// The design: one block of 512 threads per slot, one wave on the card's 132
// SMs.  Each block finds its own slot's path by a block-wide scan of the B
// newly-converged flags (read from L2 after the first block), loads its pose
// with twelve threads, builds R21 and R31 with two, and counts its N edgels
// with all of them and a block reduction.  It writes its slot's path, counts
// and gate to a workspace and takes a ticket; the last block to finish
// reduces the S slots, a thread each (the first hit and the first largest
// support in slot order by block reductions of the slot index and of a key
// support << 32 | SLOTS - slot), writes the outcome and the scored marks (no
// block writes them earlier, since every block's scan reads them), and
// resets the ticket for the next launch.  Nothing in it is serial over the
// slots, the paths or the edgels: with the slots reduced by one thread (a
// chain of dependent L2 reads) and the pose loaded by one, a launch took
// 85 us.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// SLOTS, the slots a boundary, is segmented._SCORE_SLOTS, given by the
// build (-DSLOTS, _kernels.hc_score_job).
#ifndef SLOTS
#error "hc_score.cu is built with -DSLOTS=<slots a boundary>"
#endif
constexpr int THREADS = 512;
static_assert(SLOTS >= 1 && SLOTS <= THREADS,
              "the last block reduces the slots, a thread each");
constexpr int WARPS = THREADS / 32;
constexpr int FLAG_WORDS = 8;    // a path's flags row (fused.N_FLAGS)
constexpr int VARS = 30;         // a path's unknowns

// The workspace (int32): the ticket, then per slot its path (-1: no newly
// converged path), n21, n31 and its state (bit 0 valid, bit 1 gate).
constexpr int W_TICKET = 0;
constexpr int W_PATH = 1;
constexpr int W_N21 = W_PATH + SLOTS;
constexpr int W_N31 = W_N21 + SLOTS;
constexpr int W_STATE = W_N31 + SLOTS;
constexpr int W_WORDS = W_STATE + SLOTS;

__device__ __forceinline__ bool newly(const float* fl, const uint8_t* scored,
                                      int i, int t_col, float t_eps) {
  const float t = fl[(size_t)i * FLAG_WORDS + t_col];
  return (t >= 1.0f || 1.0f - t <= t_eps) && !scored[i];
}

// cayley_to_rotation: R row-major from the Cayley parameters (r1, r2, r3).
__device__ void cayley(float r1, float r2, float r3, float* R) {
  float m[9];
  m[0] = (1.0f + r1 * r1) - (r2 * r2 + r3 * r3);
  m[1] = 2.0f * (r1 * r2 - r3);
  m[2] = 2.0f * (r1 * r3 + r2);
  m[3] = 2.0f * (r1 * r2 + r3);
  m[4] = (1.0f + r2 * r2) - (r1 * r1 + r3 * r3);
  m[5] = 2.0f * (r2 * r3 - r1);
  m[6] = 2.0f * (r1 * r3 - r2);
  m[7] = 2.0f * (r2 * r3 + r1);
  m[8] = (1.0f + r3 * r3) - (r1 * r1 + r2 * r2);
  for (int c = 0; c < 3; ++c) {
    const float n = sqrtf((m[c] * m[c] + m[3 + c] * m[3 + c]) +
                          m[6 + c] * m[6 + c]);
    R[c] = m[c] / n;
    R[3 + c] = m[3 + c] / n;
    R[6 + c] = m[6 + c] / n;
  }
}

// _pair_inliers for one edgel: (x1, y1) in view 1, (x2, y2) in the other.
__device__ __forceinline__ int inlier(const float* R, const float* t, float x1,
                                      float y1, float x2, float y2, float rtt,
                                      float k00, float k11, float thresh) {
  const float rtg2 = (R[2] * x2 + R[5] * y2) + R[8];
  const float rho_num = t[2] * rtg2 - rtt;
  const float rg1_z = (R[6] * x1 + R[7] * y1) + R[8];
  const float rho_den = 1.0f - rg1_z * rtg2;
  const float rg1_x = (R[0] * x1 + R[1] * y1) + R[2];
  const float rg1_y = (R[3] * x1 + R[4] * y1) + R[5];
  const float pz = rho_num * rg1_z + rho_den * t[2];
  const float px = (rho_num * rg1_x + rho_den * t[0]) / pz;
  const float py = (rho_num * rg1_y + rho_den * t[1]) / pz;
  const float ex = (px - x2) * k00;
  const float ey = (py - y2) * k11;
  return sqrtf(ex * ex + ey * ey) < thresh;
}

// The block's reduction of v by op (associative and commutative), in every
// thread; part holds a value a warp.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* part, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();  // part's last reader is done
  if (lane == 0) part[warp] = v;
  __syncthreads();
  T r = part[0];
  for (int w = 1; w < WARPS; ++w) r = op(r, part[w]);
  return r;
}

struct Add {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Min {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct Max {
  __device__ long long operator()(long long a, long long b) const {
    return max(a, b);
  }
};

__global__ void __launch_bounds__(THREADS)
hc_score_kernel(const float2* __restrict__ x, const float* __restrict__ fl,
                uint8_t* scored, const int64_t* __restrict__ order,
                const int64_t* __restrict__ pose_rows,
                const float* __restrict__ edgels,
                const float* __restrict__ kmat, uint8_t* found,
                int64_t* found_path, int64_t* best_supp, int64_t* best_path,
                int* work, int n_paths, int n_edgels, int t_col, float t_eps,
                float imag_tol, float thresh, float need) {
  __shared__ int warp_part[WARPS];
  __shared__ long long warp_key[WARPS];
  __shared__ int s_path, s_last, s_paths[SLOTS];
  __shared__ float s_pose[12], s_rot[2][9], s_rtt[2];
  __shared__ int s_imag_ok[12];
  const int slot = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  // 1. This slot's path: the slot-th newly converged path, each thread
  // counting a run of consecutive paths, then an exclusive scan of the runs.
  const int run = (n_paths + THREADS - 1) / THREADS;
  const int lo = min(tid * run, n_paths), hi = min(lo + run, n_paths);
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += newly(fl, scored, i, t_col, t_eps);
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_part[warp] = incl;
  if (tid == 0) s_path = -1;
  __syncthreads();
  int before = incl - mine;
  for (int w = 0; w < warp; ++w) before += warp_part[w];
  if (slot >= before && slot < before + mine) {
    int k = slot - before;
    for (int i = lo; i < hi; ++i) {
      if (newly(fl, scored, i, t_col, t_eps) && k-- == 0) {
        s_path = i;
        break;
      }
    }
  }
  __syncthreads();
  const int p = s_path;

  // 2-4. The gate, the rotations and the inlier counts of a valid slot:
  // twelve threads load the pose, two build R21 and R31, all count.
  int n21 = 0, n31 = 0, gate = 0;
  if (p >= 0) {
    if (tid < 12) {
      const float2 v = x[(size_t)p * VARS + pose_rows[tid]];
      s_pose[tid] = v.x;
      s_imag_ok[tid] = fabsf(v.y) < imag_tol;
    }
    __syncthreads();
    if (tid < 2) {
      const float* t = s_pose + 3 * tid;
      float* R = s_rot[tid];
      cayley(s_pose[6 + 3 * tid], s_pose[7 + 3 * tid], s_pose[8 + 3 * tid],
             R);
      s_rtt[tid] = (R[2] * t[0] + R[5] * t[1]) + R[8] * t[2];
    }
    __syncthreads();
    gate = 1;
    for (int j = 0; j < 12; ++j) gate &= s_imag_ok[j];
    float R21[9], R31[9], t21[3], t31[3];
    for (int j = 0; j < 9; ++j) {
      R21[j] = s_rot[0][j];
      R31[j] = s_rot[1][j];
    }
    for (int j = 0; j < 3; ++j) {
      t21[j] = s_pose[j];
      t31[j] = s_pose[3 + j];
    }
    const float rtt21 = s_rtt[0], rtt31 = s_rtt[1];
    const float k00 = kmat[0], k11 = kmat[4];
    for (int e = tid; e < n_edgels; e += THREADS) {
      const float* g = edgels + (size_t)e * 6;
      const float x1 = g[0], y1 = g[1];
      n21 += inlier(R21, t21, x1, y1, g[2], g[3], rtt21, k00, k11, thresh);
      n31 += inlier(R31, t31, x1, y1, g[4], g[5], rtt31, k00, k11, thresh);
    }
  }
  n21 = block_reduce(n21, warp_part, Add());
  n31 = block_reduce(n31, warp_part, Add());

  // 5. The slot's results, then the ticket.
  if (tid == 0) {
    work[W_PATH + slot] = p;
    work[W_N21 + slot] = n21;
    work[W_N31 + slot] = n31;
    work[W_STATE + slot] = p >= 0 ? 1 | (gate << 1) : 0;
    __threadfence();
    s_last = atomicAdd(&work[W_TICKET], 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // The last block reduces the slots, thread s holding slot s: the first
  // hit in slot order, and the first largest min(n21, n31) of the ok slots
  // (as the key support << 32 | SLOTS - slot, -1 for a slot not ok).
  __threadfence();
  const volatile int* w = work;
  const int n_slots = (int)gridDim.x;
  int state = 0, path = -1, a = 0, b = 0;
  if (tid < n_slots) {
    state = w[W_STATE + tid];
    path = w[W_PATH + tid];
    a = w[W_N21 + tid];
    b = w[W_N31 + tid];
    s_paths[tid] = path;
  }
  if (state & 1) scored[path] = 1;
  const bool ok = (state & 3) == 3;
  const bool hit = ok && (float)a >= need && (float)b >= need;
  const int first = block_reduce(hit ? tid : SLOTS, warp_part, Min());
  const long long key = block_reduce(
      ok ? (long long)min(a, b) << 32 | (SLOTS - tid) : -1LL, warp_key,
      Max());
  if (tid != 0) return;
  if (!*found) *found_path = first < SLOTS ? order[s_paths[first]] : -1;
  *found = *found | (first < SLOTS);
  const int best = key < 0 ? -1 : (int)(key >> 32);
  if (best > *best_supp) {
    *best_supp = best;
    *best_path = order[s_paths[SLOTS - (int)(key & 0xffffffffLL)]];
  }
  work[W_TICKET] = 0;
}

}  // namespace

// The workspace's int32 words; a launch needs them zeroed once, before the
// first launch on it (each launch leaves its ticket at 0).
extern "C" int hc_score_work_words() { return W_WORDS; }

// hc_score_kernel over min(SLOTS, n_paths) blocks on `stream`; returns
// cudaGetLastError().
extern "C" int hc_score_launch(const void* x, const void* fl, void* scored,
                               const void* order, const void* pose_rows,
                               const void* edgels, const void* kmat,
                               void* found, void* found_path, void* best_supp,
                               void* best_path, void* work, int n_paths,
                               int n_edgels, int t_col, float t_eps,
                               float imag_tol, float thresh, float need,
                               void* stream) {
  if (n_paths <= 0 || n_edgels < 0 || t_col < 0 || t_col >= FLAG_WORDS)
    return (int)cudaErrorInvalidValue;
  const int slots = n_paths < SLOTS ? n_paths : SLOTS;
  hc_score_kernel<<<slots, THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)x, (const float*)fl, (uint8_t*)scored,
      (const int64_t*)order, (const int64_t*)pose_rows, (const float*)edgels,
      (const float*)kmat, (uint8_t*)found, (int64_t*)found_path,
      (int64_t*)best_supp, (int64_t*)best_path, (int*)work, n_paths, n_edgels,
      t_col, t_eps, imag_tol, thresh, need);
  return (int)cudaGetLastError();
}
