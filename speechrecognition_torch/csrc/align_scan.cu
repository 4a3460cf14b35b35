// Kernel E: one time chunk of the 0-1-2 forced-alignment Viterbi DP.
//
// Replaces speechrecognition_tpu/align/viterbi.py::_align_fwd_chunk, the
// banded DP that XLA fuses into one lax.scan (written op by op in PyTorch it
// costs about 25 launches per frame). Same inputs and outputs: the cost row
// entering the chunk prev [B, A], emission scores ams [B, C, A], the TDP
// table tdp [B, A, 3] (penalty into position a by jump j), pos_valid [B, A]
// (uint8), feat_len [B] and the chunk's first global frame t0; it writes the
// cost row after the chunk out [B, A] and the jump taken into every position
// at every frame, jumps [C, B, A] int8. A template on the score type: float
// for the f32 trainer, double for the f64 one (Hopper has native float64).
// BIG, its >= BIG/2 guards and the threshold are in the score type, as the
// reference casts them.
//
// Per frame t = t0 + i, exactly the reference's step:
//   * candidates c0 = prev[a] + tdp[a,0], c1 = prev[a-1] + tdp[a,1],
//     c2 = prev[a-2] + tdp[a,2] (BIG where a-j < 0); with pruning start from
//     c2 and take c1, then c0, only if strictly less (the largest jump wins
//     ties); without, start from c0 and take c1, then c2, if strictly less;
//   * cost = valid ? best + am : BIG, then min(cost, BIG) (the kernel
//     leaves the cap out: see step_cost);
//   * the row minimum (exact in any order; NaN where a cost is NaN, as
//     the reference's min(cost, BIG) and .min keep it); renormalise with
//     the >= BIG/2 guards; prune cost > thr when pruning;
//   * at t == 0 only position 0 is initialised (am), with no renormalisation
//     or pruning; rows with t >= feat_len keep their carry. The jump is
//     written at every frame, as the reference does.
// Every operation is an add, compare or select in the score type, so the
// kernel matches its plain PyTorch version bit for bit.
//
// What bounds it: one frame's chain of dependent work, not bytes or
// operations (a 256 x 320 x 70 chunk in float64 moves 52 MB, 0.016 ms at
// 3.35 TB/s). Each frame depends on the whole previous row through its
// minimum, and 256 utterances of 3 warps fill the card's 528 SM
// sub-partitions about one and a half times, so a chunk takes about C
// times one frame's chain: the neighbours' shuffles, the adds and
// selections, the row minimum, the barrier and the carry. Float64 adds,
// compares and selects have longer latencies than float32 ones, and the
// float64 frame is about twice the float32 one (0.62 against 0.30 us at
// A = 70 on an H100; the first design took 0.82 and 0.58 us). Whether the
// chain is the whole cost is open: chip_smoke.py's phase 13 times the warp
// instance at every warp count. Three instances, chosen in the C entry from
// A alone (sr_align_fwd_warps, sr_align_fwd_positions):
//   * A <= 128 (every SieTill automaton; the trainers' main path): the warp
//     instance, kernel F's layout. W = ceil(A/32) warps per utterance, one
//     position a lane, 8 / W utterances a block; the candidates from a-1
//     and a-2 come from the lanes below through __shfl_up_sync; the three
//     candidate compares are independent and the selection has no branch;
//     the warp's row minimum is redux.sync on an order-preserving key with
//     a NaN vote beside it (one for float; for double two, on the high and
//     then the low halves of the 64-bit key: exact; five float64 shuffles
//     and minima were no faster on the card); each warp publishes its
//     minimum and its last two costs (double-buffered by frame parity) and
//     one named barrier of the utterance's warps a frame makes them
//     visible; lanes 0 and 1 recompute the carry of the previous warp's
//     last two positions from the published costs (a "shadow", bit for bit
//     the owner's), so no second barrier; each lane keeps the next PREFETCH
//     frames' emissions in registers, so device-memory latency leaves the
//     chain; jumps are predicated byte stores.
//   * 128 < A <= 1024 (the Sprint path's state graphs, A 303): the wide
//     instance, kernel F's wide layout with one word a score and its own
//     rule of positions a lane. One block an utterance of wide_warps(A)
//     warps, wide_k(A) consecutive positions a lane (A 303: 4 warps of 3),
//     TDPs, validity, carry and the emission ring in registers; lane
//     0 takes a-1 and a-2 from the shadow of the previous warp's last two
//     positions; each lane folds its costs with keys::nan_min, the warp
//     takes warp_minimum_nan, and one __syncthreads a frame publishes the
//     W minima and the edge costs, which every thread folds in one order.
//     The row minimum is exact and NaN where any cost is, as jnp.minimum's,
//     so a NaN row takes the same branch-free frame (kernel F needs its
//     plain version's fold there; E does not).
//   * the block instance: one block of min(ceil(A/32)*32, 1024) threads per
//     utterance, each looping over ceil(A/1024) positions, two
//     __syncthreads a frame; past A = 1024 its row double-buffered by frame
//     parity in device scratch [B, 2, A] that the wrapper allocates
//     (sr_align_fwd_warps gives -1; a block's global writes are visible to
//     the block after __syncthreads). For 128 < A <= 1024 it is the first
//     design, its row in shared memory, launched only when the C entry gets
//     first_design = 1, so that the two can be timed in turns. Simple, not
//     tuned: each position's constants and cost are read from memory every
//     frame. No SieTill automaton reaches it.

#include <cuda_runtime.h>

#include "keys.cuh"

namespace {

using keys::warp_minimum_nan;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;          // warps a block of the warp instance holds
constexpr int PREFETCH = 4;           // frames of emissions in flight
constexpr int WARP_POSITIONS = 128;   // the warp instance's longest automaton (4 warps)
constexpr int SHARED_POSITIONS = 1024; // the wide instance's longest automaton; the longest
                                       // row the first design keeps in shared memory
constexpr int BLOCK_THREADS = 1024;   // threads per utterance of the block instance, at most

// the minimum of two costs, NaN where either is (jnp.minimum)
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return keys::nan_min(a, b); }

template <typename T>
__device__ __forceinline__ T big() { return T(1e30); }

// the candidates, the selection and the emission of one position; jump is
// the winning jump
template <typename T>
__device__ __forceinline__ T step_cost(T h0, T h1, T h2, T tw0, T tw1, T tw2, T am, int a,
                                       bool valid, bool tie_pruned, signed char& jump) {
  const T c0 = h0 + tw0;
  const T c1 = a >= 1 ? h1 + tw1 : big<T>();
  const T c2 = a >= 2 ? h2 + tw2 : big<T>();
  // the reference's sequential selection with its three compares made
  // independent, so that they overlap: start at the first candidate, take
  // the second if strictly less, then the third if strictly less than the
  // one held
  T best;
  if (tie_pruned) {  // c2, then c1, then c0
    const bool t1 = c1 < c2;
    const bool t0 = t1 ? c0 < c1 : c0 < c2;
    best = t0 ? c0 : t1 ? c1 : c2;
    jump = t0 ? 0 : t1 ? 1 : 2;
  } else {           // c0, then c1, then c2
    const bool t1 = c1 < c0;
    const bool t2 = t1 ? c2 < c1 : c2 < c0;
    best = t2 ? c2 : t1 ? c1 : c0;
    jump = t2 ? 2 : t1 ? 1 : 0;
  }
  // the reference then caps the cost at BIG; the cap is left out, because
  // it changes no output: a cost at or above BIG/2 is never a live row's
  // minimum (a dead row renormalises by 0 either way) and the carry turns
  // it into BIG
  return valid ? best + am : big<T>();
}

// renormalisation, pruning, the t == 0 initialisation and the carry of one
// position, given the row minimum (already 0 for a dead row)
template <typename T>
__device__ __forceinline__ T step_carry(T cost, T row_best, T am, T h, T thr, int a, bool valid,
                                        int t, int len, int use_pruning) {
  cost = cost >= big<T>() * T(0.5) ? big<T>() : cost - row_best;
  if (use_pruning && cost > thr) cost = big<T>();
  if (t == 0) cost = (a == 0 && valid) ? am : big<T>();
  return t < len ? cost : h;
}

// a byte store under a predicate, without a branch around it (a branch
// region would keep the scheduler from interleaving the positions' work)
__device__ __forceinline__ void store_if(signed char* p, signed char v, bool cond) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q st.global.s8 [%0], %1;\n\t}"
               :: "l"(p), "h"((short)v), "r"((unsigned)cond));
}

// W warps per utterance, one position a lane: position a = w*32 + lane;
// named barrier 1 + u for utterance u of the block (at most 4 with W > 1)
template <typename T, int W>
__global__ void __launch_bounds__(MAX_WARPS / W * W * 32)
align_fwd_warp_kernel(const T* __restrict__ prev, const T* __restrict__ ams,
                      const T* __restrict__ tdp, const unsigned char* __restrict__ pos_valid,
                      const int* __restrict__ feat_len, T* __restrict__ out,
                      signed char* __restrict__ jumps, int B, int C, int A, int t0, T thr,
                      int tie_pruned, int use_pruning) {
  constexpr int U = MAX_WARPS / W;  // utterances a block
  // per utterance and frame parity, per warp: its minimum and the costs of
  // its second-last and last positions
  __shared__ T s_pub[U][2][W][3];
  const int warp = threadIdx.x >> 5;
  const int u = warp / W;
  const int w = warp - u * W;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * U + u;
  if (b >= B) return;  // the utterance's W warps together
  const T BIG = big<T>();
  const int a = w * 32 + lane;
  const size_t urow = (size_t)b * A;
  const size_t row = urow + min(a, A - 1);  // the last position stands in past A
  const bool pos = a < A;
  const bool valid = pos && pos_valid[row] != 0;  // no position past A is valid
  const T tw0 = tdp[row * 3 + 0], tw1 = tdp[row * 3 + 1], tw2 = tdp[row * 3 + 2];
  T h = pos ? prev[row] : BIG;
  // the shadow: lane 0 follows position w*32-1 and lane 1 position w*32-2,
  // the previous warp's last two, from the costs that warp publishes
  const int sa = w * 32 - 1 - lane;
  T sh = T(0);
  if (W > 1 && w > 0) sh = prev[urow + max(sa, 0)];
  const int len = feat_len[b];
  // this lane's column of the utterance's emissions
  const T* am_col = ams + (size_t)b * C * A + min(a, A - 1);

  // the emissions of frames i .. i+PREFETCH-1, slot i % PREFETCH
  T ring[PREFETCH];
#pragma unroll
  for (int p = 0; p < PREFETCH; ++p) ring[p] = p < C ? am_col[(size_t)p * A] : T(0);

  for (int i0 = 0; i0 < C; i0 += PREFETCH) {
#pragma unroll
    for (int p = 0; p < PREFETCH; ++p) {
      const int i = i0 + p;
      if (i < C) {  // the same for the whole utterance
        const T am = ring[p];
        ring[p] = am_col[(size_t)min(i + PREFETCH, C - 1) * A];
        // positions a-1 and a-2: the lanes below, or the shadow
        T n1 = __shfl_up_sync(FULL, h, 1);
        T n2 = __shfl_up_sync(FULL, h, 2);
        if (W > 1) {
          const T sh_up = __shfl_up_sync(FULL, sh, 1);
          const T sh_down = __shfl_down_sync(FULL, sh, 1);
          if (lane == 0) { n1 = sh; n2 = sh_down; }
          if (lane == 1) n2 = sh_up;
        }
        const int t = t0 + i;
        signed char jump;
        const T cost = step_cost(h, n1, n2, tw0, tw1, tw2, am, a, valid, tie_pruned, jump);
        store_if(jumps + ((size_t)i * B + b) * A + a, jump, pos);

        // the exact row minimum: the warp's, then the utterance's
        T row_best = warp_minimum_nan(cost);
        if (W > 1) {
          T* pub = s_pub[u][i & 1][w];
          if (lane == 0) pub[0] = row_best;
          if (lane >= 30) pub[lane - 29] = cost;
          asm volatile("bar.sync %0, %1;" :: "r"(1 + u), "r"(W * 32) : "memory");
          row_best = s_pub[u][i & 1][0][0];
#pragma unroll
          for (int v = 1; v < W; ++v) {
            const T mv = s_pub[u][i & 1][v][0];
            row_best = tmin(row_best, mv);
          }
        }
        if (row_best >= BIG * T(0.5)) row_best = T(0);
        if (W > 1) {
          const T sc = s_pub[u][i & 1][max(w - 1, 0)][lane == 0 ? 2 : 1];
          sh = step_carry(sc, row_best, T(0), sh, thr, sa, false, t, len, use_pruning);
        }
        h = step_carry(cost, row_best, am, h, thr, a, valid, t, len, use_pruning);
      }
    }
  }
  if (pos) out[row] = h;
}

// ---- the wide instance (128 < A <= 1024): W warps an utterance, K positions a lane ----

constexpr int WIDE_WARPS = 8;  // warps an utterance, at most

// positions a lane (3 or 4) and warps an utterance (2-8) of the wide
// instance: 3 a lane up to A = 768, 4 beyond, so that an utterance's warps
// stay at most 8. Kernel F's rule (2 a lane up to 512) is slower here. On an
// H100 (B 130, C 320, A 303), in turns: 3 a lane on 4 warps 0.151-0.164 ms
// in float, 0.197-0.215 ms in double; 2 on 5 0.175-0.180 / 0.241-0.246; 1
// on 10 0.190-0.191 / 0.211-0.214; with another fold of the minima (3 on 4
// there 0.185-0.187 / 0.199-0.204), 4 on 3 0.192-0.194 / 0.239-0.246, 5 on 2
// 0.210 / 0.342-0.348, 10 on 1 0.329-0.332 / 0.455-0.461. E's step is a few
// adds and compares, so a lane's third position costs less than a fifth
// warp at the barrier; past 3 the lane's own work lengthens the frame
__host__ __device__ __forceinline__ int wide_k(int A) {
  const int k = (A + 8 * 32 - 1) / (8 * 32);
  return k < 3 ? 3 : k;
}

__host__ __device__ __forceinline__ int wide_warps(int A) {
  const int k = wide_k(A);
  return (A + 32 * k - 1) / (32 * k);
}

// One utterance a block of W = blockDim.x / 32 warps, K consecutive
// positions a lane: position a = (w*32 + lane)*K + k. The warp instance's
// design with K positions a lane: TDPs, validity and the carry in
// registers, the emissions PREFETCH frames ahead in a register ring,
// neighbours a-1 and a-2 of a lane's first position from the lane below
// (shuffles) or, in lane 0, from the shadow of the previous warp's last two
// positions; each lane folds its K costs, the warp takes their keyed
// minimum (NaN where any is), and every thread folds the W warps' minima in
// one order after the one barrier a frame. The row minimum is exact in any
// order and NaN where any cost is, so a NaN row needs nothing more.
template <typename T, int K>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
align_fwd_wide_kernel(const T* __restrict__ prev, const T* __restrict__ ams,
                      const T* __restrict__ tdp, const unsigned char* __restrict__ pos_valid,
                      const int* __restrict__ feat_len, T* __restrict__ out,
                      signed char* __restrict__ jumps, int B, int C, int A, int t0, T thr,
                      int tie_pruned, int use_pruning) {
  static_assert(K >= 2, "a lane's positions hold both neighbours of the next lane's first");
  // per frame parity and warp: its minimum and the costs of its
  // second-last and last positions
  __shared__ T s_pub[2][WIDE_WARPS][3];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const T BIG = big<T>();
  const int a0 = (warp * 32 + lane) * K;  // this lane's first position
  const size_t urow = (size_t)b * A;
  T tw0[K], tw1[K], tw2[K], h[K];
  bool valid[K], pos[K];
  int col[K];  // the position's column, the last one standing in past A
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = a0 + k;
    pos[k] = a < A;
    col[k] = min(a, A - 1);
    const size_t r = urow + col[k];
    valid[k] = pos[k] && pos_valid[r] != 0;  // no position past A is valid
    tw0[k] = tdp[r * 3 + 0];
    tw1[k] = tdp[r * 3 + 1];
    tw2[k] = tdp[r * 3 + 2];
    h[k] = pos[k] ? prev[r] : BIG;
  }
  // the shadow: positions w*32*K - 1 and w*32*K - 2, the previous warp's
  // last two, followed by every lane from the costs that warp publishes
  const int s1 = warp * 32 * K - 1, s2 = s1 - 1;
  T sh1 = BIG, sh2 = BIG;
  if (warp > 0) {
    sh1 = prev[urow + s1];
    sh2 = prev[urow + s2];
  }
  const int len = feat_len[b];
  const T* am_u = ams + (size_t)b * C * A;

  // the emissions of frames i .. i+PREFETCH-1, slot i % PREFETCH
  T ring[PREFETCH][K];
#pragma unroll
  for (int p = 0; p < PREFETCH; ++p)
#pragma unroll
    for (int k = 0; k < K; ++k) ring[p][k] = p < C ? am_u[(size_t)p * A + col[k]] : T(0);

  for (int i0 = 0; i0 < C; i0 += PREFETCH) {
#pragma unroll
    for (int p = 0; p < PREFETCH; ++p) {
      const int i = i0 + p;
      if (i < C) {  // the same for the whole block
        T am[K];
        const size_t nx = (size_t)min(i + PREFETCH, C - 1) * A;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          am[k] = ring[p][k];
          ring[p][k] = am_u[nx + col[k]];
        }
        // positions a0-1 and a0-2: the lane below, or the shadow
        const T below1 = __shfl_up_sync(FULL, h[K - 1], 1);
        const T below2 = __shfl_up_sync(FULL, h[K - 2], 1);
        const T up1 = lane == 0 ? sh1 : below1;
        const T up2 = lane == 0 ? sh2 : below2;
        const int t = t0 + i;
        T cost[K];
        T m;  // the lane's minimum
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const T n1 = k >= 1 ? h[k >= 1 ? k - 1 : 0] : up1;
          const T n2 = k >= 2 ? h[k >= 2 ? k - 2 : 0] : (k == 1 ? up1 : up2);
          signed char jump;
          cost[k] = step_cost(h[k], n1, n2, tw0[k], tw1[k], tw2[k], am[k], a0 + k, valid[k],
                              tie_pruned, jump);
          store_if(jumps + ((size_t)i * B + b) * A + a0 + k, jump, pos[k]);
          m = k == 0 ? cost[0] : tmin(m, cost[k]);
        }
        // the exact row minimum: the warp's, then the utterance's
        T row_best = warp_minimum_nan(m);
        T* pub = s_pub[i & 1][warp];
        if (lane == 0) pub[0] = row_best;
        if (lane == 31) {
          pub[1] = cost[K - 2];
          pub[2] = cost[K - 1];
        }
        __syncthreads();  // the minima and the edge costs are visible
        row_best = s_pub[i & 1][0][0];
        for (int v = 1; v < W; ++v) row_best = tmin(row_best, s_pub[i & 1][v][0]);
        if (row_best >= BIG * T(0.5)) row_best = T(0);
        if (warp > 0) {
          sh1 = step_carry(s_pub[i & 1][warp - 1][2], row_best, T(0), sh1, thr, s1, false, t,
                           len, use_pruning);
          sh2 = step_carry(s_pub[i & 1][warp - 1][1], row_best, T(0), sh2, thr, s2, false, t,
                           len, use_pruning);
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          h[k] = step_carry(cost[k], row_best, am[k], h[k], thr, a0 + k, valid[k], t, len,
                            use_pruning);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (pos[k]) out[urow + a0 + k] = h[k];
}

// one block of min(ceil(A/32)*32, 1024) threads per utterance, each thread
// looping over the positions a = threadIdx.x + k*blockDim.x; the row
// double-buffered by frame parity in lat [2][A]: shared memory where
// scratch is null, else the utterance's part of the wrapper's device
// scratch [B][2][A] (not restrict: the threads read one another's writes
// after each __syncthreads)
template <typename T>
__global__ void __launch_bounds__(BLOCK_THREADS)
align_fwd_block_kernel(const T* __restrict__ prev, const T* __restrict__ ams,
                       const T* __restrict__ tdp, const unsigned char* __restrict__ pos_valid,
                       const int* __restrict__ feat_len, T* __restrict__ out,
                       signed char* __restrict__ jumps, T* scratch, int B, int C, int A, int t0,
                       T thr, int tie_pruned, int use_pruning) {
  const T BIG = big<T>();
  extern __shared__ __align__(8) unsigned char smem_raw[];
  __shared__ T s_wmin[BLOCK_THREADS / 32];
  const int b = blockIdx.x;
  const int nwarps = blockDim.x / 32;
  const size_t urow = (size_t)b * A;
  T* lat = scratch != nullptr ? scratch + 2 * urow : reinterpret_cast<T*>(smem_raw);
  const int len = feat_len[b];
  for (int a = threadIdx.x; a < A; a += blockDim.x) lat[a] = prev[urow + a];
  __syncthreads();

  int buf = 0;
  for (int i = 0; i < C; ++i) {
    const int t = t0 + i;
    const T* cur = lat + (size_t)buf * A;
    T* nxt = lat + (size_t)(buf ^ 1) * A;
    const T* am_t = ams + ((size_t)b * C + i) * A;
    // (a) every position's cost before the renormalisation, into nxt
    T m = BIG;
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
      const size_t r = urow + a;
      const T h1 = a >= 1 ? cur[a - 1] : BIG;
      const T h2 = a >= 2 ? cur[a - 2] : BIG;
      signed char jump;
      const T cost = step_cost(cur[a], h1, h2, tdp[r * 3 + 0], tdp[r * 3 + 1], tdp[r * 3 + 2],
                               am_t[a], a, pos_valid[r] != 0, tie_pruned, jump);
      jumps[((size_t)i * B + b) * A + a] = jump;
      nxt[a] = cost;
      m = tmin(m, cost);
    }
    // the row minimum (exact in any order); a thread without a position
    // holds BIG, which every real row minimum already is or undercuts
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = tmin(m, __shfl_xor_sync(FULL, m, off));
    if ((threadIdx.x & 31) == 0) s_wmin[threadIdx.x >> 5] = m;
    __syncthreads();  // the per-warp minima are visible
    T row_best = s_wmin[0];
    for (int k = 1; k < nwarps; ++k) row_best = tmin(row_best, s_wmin[k]);
    if (row_best >= BIG * T(0.5)) row_best = T(0);
    // (b) each thread's own positions: the carry
    for (int a = threadIdx.x; a < A; a += blockDim.x)
      nxt[a] = step_carry(nxt[a], row_best, am_t[a], cur[a], thr, a, pos_valid[urow + a] != 0,
                          t, len, use_pruning);
    __syncthreads();  // the new row is visible; the minima may be rewritten
    buf ^= 1;
  }
  for (int a = threadIdx.x; a < A; a += blockDim.x) out[urow + a] = lat[(size_t)buf * A + a];
}

// warps per utterance of the warp instance (one position a lane) or of the
// wide instance for A positions; -1 for the block instance (its row in
// device scratch)
int warps_for(int A) {
  if (A <= WARP_POSITIONS) return (A + 31) / 32;
  return A <= SHARED_POSITIONS ? wide_warps(A) : -1;
}

// positions a lane of that instance: 1 (the warp instance), wide_k(A) (the
// wide instance), 0 (the block instance, whose threads loop over the
// positions)
int positions_for(int A) {
  if (A <= WARP_POSITIONS) return 1;
  return A <= SHARED_POSITIONS ? wide_k(A) : 0;
}

template <typename T>
int launch(const T* prev, const T* ams, const T* tdp, const unsigned char* pos_valid,
           const int* feat_len, T* out, signed char* jumps, T* scratch, int B, int C, int A,
           int t0, T thr, int tie_pruned, int use_pruning, int first_design, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || A == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
#define SR_WARPS(W)                                                                          \
  align_fwd_warp_kernel<T, W><<<(B + MAX_WARPS / W - 1) / (MAX_WARPS / W),                   \
                                MAX_WARPS / W * W * 32, 0, st>>>(                            \
      prev, ams, tdp, pos_valid, feat_len, out, jumps, B, C, A, t0, thr, tie_pruned,         \
      use_pruning)
#define SR_WIDE(K)                                                                           \
  align_fwd_wide_kernel<T, K><<<B, wide_warps(A) * 32, 0, st>>>(                             \
      prev, ams, tdp, pos_valid, feat_len, out, jumps, B, C, A, t0, thr, tie_pruned,         \
      use_pruning)
  const bool wide = A > WARP_POSITIONS && A <= SHARED_POSITIONS;
  if (wide && !first_design) {
    if (wide_k(A) == 3) SR_WIDE(3);
    else SR_WIDE(4);
  } else if (A <= WARP_POSITIONS) {
    switch (warps_for(A)) {
      case 1: SR_WARPS(1); break;
      case 2: SR_WARPS(2); break;
      case 3: SR_WARPS(3); break;
      default: SR_WARPS(4);
    }
  } else {
    // the block instance: its row in shared memory (the first design,
    // forced for 128 < A <= 1024) or in the scratch (past A = 1024)
    const bool in_scratch = A > SHARED_POSITIONS;
    if (in_scratch && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int threads = A < BLOCK_THREADS ? (A + 31) / 32 * 32 : BLOCK_THREADS;
    const size_t smem = in_scratch ? 0 : 2 * (size_t)A * sizeof(T);
    align_fwd_block_kernel<T><<<B, threads, smem, st>>>(
        prev, ams, tdp, pos_valid, feat_len, out, jumps, in_scratch ? scratch : nullptr, B, C,
        A, t0, thr, tie_pruned, use_pruning);
  }
#undef SR_WARPS
#undef SR_WIDE
  return (int)cudaGetLastError();
}

}  // namespace

// the instance the entries below launch for A positions: warps per
// utterance of the warp instance (1-4, one position a lane) or of the wide
// instance (2-8, sr_align_fwd_positions(A) positions a lane); the block
// instance with its row in device scratch of 2*B*A scores (-1). The block
// instance with its row in shared memory runs only as the first design,
// forced for 128 < A <= 1024.
extern "C" int sr_align_fwd_warps(int A) { return warps_for(A); }

// positions a lane of that instance: 1 (the warp instance), 3 or 4 (the
// wide instance), 0 (the block instance, whose threads loop over the
// positions)
extern "C" int sr_align_fwd_positions(int A) { return positions_for(A); }

extern "C" int sr_align_fwd(const float* prev, const float* ams, const float* tdp,
                            const unsigned char* pos_valid, const int* feat_len, float* out,
                            signed char* jumps, float* scratch, int B, int C, int A, int t0,
                            float thr, int tie_pruned, int use_pruning, int first_design,
                            int device, void* stream) {
  return launch<float>(prev, ams, tdp, pos_valid, feat_len, out, jumps, scratch, B, C, A, t0,
                       thr, tie_pruned, use_pruning, first_design, device, stream);
}

extern "C" int sr_align_fwd_f64(const double* prev, const double* ams, const double* tdp,
                                const unsigned char* pos_valid, const int* feat_len,
                                double* out, signed char* jumps, double* scratch, int B, int C,
                                int A, int t0, double thr, int tie_pruned, int use_pruning,
                                int first_design, int device, void* stream) {
  return launch<double>(prev, ams, tdp, pos_valid, feat_len, out, jumps, scratch, B, C, A, t0,
                        thr, tie_pruned, use_pruning, first_design, device, stream);
}
