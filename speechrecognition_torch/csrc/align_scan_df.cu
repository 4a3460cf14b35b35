// Kernel F: one time chunk of the forced-alignment Viterbi DP in double-float.
//
// Replaces speechrecognition_tpu/align/viterbi.py::_align_fwd_chunk_df, the
// (hi, lo) float32-pair twin of _align_fwd_chunk that the df32 trainer
// realigns with (XLA fuses it into one lax.scan). Kernel E's step
// (csrc/align_scan.cu), with every score a pair and df.cuh's exact add, sub
// and comparisons:
//   * candidates c_j = add(prev[a-j], tdp[a,j]), (BIG, 0) where a-j < 0;
//     selection with strict less() in the reference's tie order;
//   * cost = valid ? add(best, am) : (BIG, 0); (BIG, 0) where cost.hi >= BIG/2;
//   * the lexicographic (hi, lo) row minimum, exact in any order; a dead row
//     (minimum hi >= BIG/2) renormalises by (0, 0); shifted = sub(cost, min),
//     kept only where cost.hi < BIG/2;
//   * a row that holds a NaN takes the plain version's own reduction
//     (doublefloat.min_axis: pairwise halving, the first half against the
//     second by df::minimum, an odd last element carried), whose result
//     depends on where the NaNs lie: df::minimum keeps the second of a pair
//     unless the first is strictly less, so a NaN second survives and a NaN
//     first does not. An infinite TDP gives such rows: from_f64 splits inf
//     into (inf, NaN), and a candidate through it adds to (NaN, NaN). The
//     AN4 TDPs forbid the silence skip (inf); with tie_pruned the skip is
//     the first candidate, no other is strictly less than a NaN, so every
//     silence position past the first two is NaN every frame;
//   * pruning where !less_equal(cost, thr);
//   * t == 0 initialises position 0 only; rows with t >= feat_len keep
//     their carry.
// Inputs and outputs as kernel E's, each score array as separate hi and lo
// float32 arrays; thr is a (hi, lo) pair. The DP only adds, subtracts,
// compares and selects, and df.cuh's round-to-nearest intrinsics keep nvcc
// from contracting anything, so the kernel matches its plain PyTorch version
// bit for bit in both words.
//
// What bounds it: one frame's dependent work, not bytes or operations (a
// 256 x 320 x 70 chunk moves 51 MB, 0.016 ms at 3.35 TB/s). Each frame
// depends on the previous frame's whole row through its minimum, and 256
// utterances fill about one warp per SM sub-partition, so a chunk takes C x
// the time of one frame: three dependent double-float adds (candidate,
// emission, renormalisation; ~20 FP32 instructions each), the selection,
// the row minimum and the guards, issued by warps that have little else to
// interleave. The first design ran one block of ceil(A/32)*32 threads per
// utterance with two __syncthreads a frame and the frame's emissions loaded
// from device memory on the chain; one warp per utterance with ceil(A/32)
// positions a lane (no barrier, no shared memory) was no faster in trials on
// the card, because that one warp issues all its positions' work alone.
//
// Design (A <= 128, every SieTill automaton): W = ceil(A/32) warps per
// utterance, one position a lane, 8 / W utterances per block. The
// candidates from a-1 and a-2 come from the lanes below through
// __shfl_up_sync. The warp's row minimum is two redux.sync minima on an
// order-preserving 32-bit key: of hi, then of lo among the lanes whose hi
// equals the minimum, the exact lexicographic minimum. Each warp publishes
// its minimum and the costs of its last two positions in shared memory
// (double-buffered by frame parity), and one named barrier of the
// utterance's warps a frame makes them visible: every warp folds the W
// minima in the same order, and lanes 0 and 1 recompute the carry of the
// previous warp's last two positions from the published costs (a "shadow",
// bit for bit the owner's), so the next frame needs no second barrier. Each
// lane keeps the emissions of the next PREFETCH frames in a register ring,
// so device-memory latency leaves the chain; jumps are predicated byte
// stores, write-only. 128 < A <= 1024 (the Sprint trainer's automata, A 303
// at AN4's shape) takes the wide instance, the same design with K
// consecutive positions a lane: one block of W warps an utterance, K =
// max(2, ceil(A/256)) and W = ceil(A/(32K)) (A 303: 5 warps of 2), the
// TDPs, validity and carry in registers, the emissions in the ring, the
// previous warp's last two positions in a shadow that every lane follows,
// the warps' minima and edge costs published and one __syncthreads a frame,
// the minima folded by every thread. Longer automata take the block
// instance: one block of min(ceil(A/32)*32, 1024) threads per utterance,
// each looping over ceil(A/1024) positions, two __syncthreads a frame, the
// row double-buffered by frame parity in device scratch
// (sr_align_fwd_df_scratch pairs an utterance) that the wrapper allocates
// (simple, not tuned). The block instance was the first design for
// 128 < A <= 1024 too, its row in shared memory: the C entry's first_design
// launches it there, for timing in turns, and nothing else does.
// sr_align_fwd_df_warps and sr_align_fwd_df_positions hold the choice, from
// A alone. A NaN row (any position's cost NaN) takes the
// plain version's fold instead of the keyed minimum. The warp instance's
// frames stay branch-free: a ballot finds a warp's NaN, which it publishes
// as a NaN minimum, and after each group of PREFETCH frames a group that
// held a NaN row is done again from its carry, frame by frame, with the
// emissions read from device memory; there a NaN row is written to shared
// memory after a second barrier and each warp folds it in its own buffers.
// The wide instance does the same, its NaN rows folded by the whole block.
// The block instance finds a NaN row by __syncthreads_or and folds it stage
// by stage with a barrier a stage.

#include <cuda_runtime.h>

#include <type_traits>

#include "df.cuh"
#include "keys.cuh"

namespace {

using keys::key_value;
using keys::order_key;

constexpr float BIG = 1e30f;
constexpr float HALF_BIG = BIG * 0.5f;  // exact in float32
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;         // warps a block of the warp instance holds
constexpr int PREFETCH = 4;          // frames of emissions in flight
constexpr int WARP_POSITIONS = 128;  // the warp instance's longest automaton (4 warps)
constexpr int SHARED_POSITIONS = 1024;  // the longest row the block instance keeps in shared memory
constexpr int BLOCK_THREADS = 1024;     // threads per utterance of the block instance, at most
constexpr int FOLD_HALF = WARP_POSITIONS / 2;  // the warp instance's fold buffers, in pairs

__device__ __forceinline__ df::DF big() { return df::make(BIG, 0.f); }

// the candidates, the selection, the emission and the BIG guards of one
// position; jump is the winning jump
__device__ __forceinline__ df::DF step_cost(df::DF h0, df::DF h1, df::DF h2, df::DF tw0,
                                            df::DF tw1, df::DF tw2, df::DF am, int a,
                                            bool valid, bool tie_pruned, signed char& jump) {
  const df::DF c0 = df::add(h0, tw0);
  const df::DF c1 = a >= 1 ? df::add(h1, tw1) : big();
  const df::DF c2 = a >= 2 ? df::add(h2, tw2) : big();
  df::DF best;
  if (tie_pruned) {
    best = c2;
    jump = 2;
    if (df::less(c1, best)) { best = c1; jump = 1; }
    if (df::less(c0, best)) { best = c0; jump = 0; }
  } else {
    best = c0;
    jump = 0;
    if (df::less(c1, best)) { best = c1; jump = 1; }
    if (df::less(c2, best)) { best = c2; jump = 2; }
  }
  df::DF cost = valid ? df::add(best, am) : big();
  if (cost.hi >= HALF_BIG) cost = big();
  return cost;
}

// renormalisation, pruning, the t == 0 initialisation and the carry of one
// position, given the row minimum
__device__ __forceinline__ df::DF step_carry(df::DF cost, df::DF row_best, df::DF am,
                                             df::DF h, df::DF thr, int a, bool valid, int t,
                                             int len, int use_pruning) {
  const df::DF shifted = df::sub(cost, row_best);
  cost = cost.hi >= HALF_BIG ? big() : shifted;
  if (use_pruning && !df::less_equal(cost, thr)) cost = big();
  if (t == 0) cost = (a == 0 && valid) ? am : big();
  return t < len ? cost : h;
}

// a byte store under a predicate, without a branch around it (a branch
// region would keep the scheduler from interleaving the positions' work)
__device__ __forceinline__ void store_if(signed char* p, signed char v, bool cond) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q st.global.s8 [%0], %1;\n\t}"
               :: "l"(p), "h"((short)v), "r"((unsigned)cond));
}

// the exact lexicographic (hi, lo) minimum over the warp
__device__ __forceinline__ df::DF warp_minimum(df::DF m) {
  const unsigned kh = order_key(m.hi);
  const unsigned key_hi = __reduce_min_sync(FULL, kh);
  const unsigned key_lo = __reduce_min_sync(FULL, kh == key_hi ? order_key(m.lo) : 0xffffffffu);
  return df::make(key_value(key_hi), key_value(key_lo));
}

__device__ __forceinline__ bool is_nan(df::DF v) { return v.hi != v.hi || v.lo != v.lo; }

// the minimum a warp whose costs hold a NaN publishes
__device__ __forceinline__ float2 nan_pair() {
  return make_float2(__int_as_float(0x7fffffff), __int_as_float(0x7fffffff));
}

// One stage of the plain version's pairwise halving over n pairs in ``in``:
// out[i] = minimum(in[i], in[i + n/2]) for i < n/2, and the odd last
// element carried to out[n/2]; threads k, k + step, ... of the stage.
__device__ __forceinline__ int fold_stage(const float2* in, float2* out, int n, int k,
                                          int step) {
  const int half = n >> 1;
  const int m = half + (n & 1);
  for (int i = k; i < m; i += step) {
    if (i < half) {
      const df::DF v = df::minimum(df::make(in[i].x, in[i].y),
                                   df::make(in[i + half].x, in[i + half].y));
      out[i] = make_float2(v.hi, v.lo);
    } else {
      out[i] = in[2 * half];
    }
  }
  return m;
}

// the row minimum of the n <= 128 costs in ``row`` exactly as the plain
// version folds them, by one warp, through its two buffers of FOLD_HALF
// pairs (out of line: only an infinite TDP gives NaN rows)
__device__ __noinline__ df::DF fold_minimum_warp(const float2* row, int n,
                                                 float2 (*buf)[FOLD_HALF], int lane) {
  const float2* in = row;
  for (int s = 0; n > 1; s ^= 1) {
    n = fold_stage(in, buf[s], n, lane, 32);
    __syncwarp();
    in = buf[s];
  }
  return df::make(in[0].x, in[0].y);
}

// the same by the whole block, through two buffers of (n + 1) / 2 pairs
__device__ __noinline__ df::DF fold_minimum_block(const float2* row, int n, float2* buf0,
                                                  float2* buf1) {
  const float2* in = row;
  for (int s = 0; n > 1; s ^= 1) {
    float2* out = s ? buf1 : buf0;
    n = fold_stage(in, out, n, threadIdx.x, blockDim.x);
    __syncthreads();
    in = out;
  }
  return df::make(in[0].x, in[0].y);
}

// W warps per utterance, one position a lane: position a = w*32 + lane;
// named barrier 1 + u for utterance u of the block (at most 4 with W > 1)
template <int W>
__global__ void __launch_bounds__(MAX_WARPS / W * W * 32)
align_fwd_df_warp_kernel(
    const float* __restrict__ prev_hi, const float* __restrict__ prev_lo,
    const float* __restrict__ ams_hi, const float* __restrict__ ams_lo,
    const float* __restrict__ tdp_hi, const float* __restrict__ tdp_lo,
    const unsigned char* __restrict__ pos_valid, const int* __restrict__ feat_len,
    float* __restrict__ out_hi, float* __restrict__ out_lo, signed char* __restrict__ jumps,
    int B, int C, int A, int t0, float thr_hi, float thr_lo, int tie_pruned,
    int use_pruning) {
  constexpr int U = MAX_WARPS / W;  // utterances a block
  // per utterance and frame parity, per warp: its minimum (NaN if its costs
  // hold a NaN) and the costs of its second-last and last positions
  __shared__ float2 s_pub[U][2][W][3];
  // a NaN row's costs and each warp's fold buffers
  __shared__ float2 s_row[U][W * 32];
  __shared__ float2 s_fold[U * W][2][FOLD_HALF];
  const int warp = threadIdx.x >> 5;
  const int u = warp / W;
  const int w = warp - u * W;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * U + u;
  if (b >= B) return;  // the utterance's W warps together
  const df::DF thr = df::make(thr_hi, thr_lo);
  const int a = w * 32 + lane;
  const size_t urow = (size_t)b * A;
  const size_t row = urow + min(a, A - 1);  // the last position stands in past A
  const bool pos = a < A;
  const bool valid = pos && pos_valid[row] != 0;
  const df::DF tw0 = df::make(tdp_hi[row * 3 + 0], tdp_lo[row * 3 + 0]);
  const df::DF tw1 = df::make(tdp_hi[row * 3 + 1], tdp_lo[row * 3 + 1]);
  const df::DF tw2 = df::make(tdp_hi[row * 3 + 2], tdp_lo[row * 3 + 2]);
  df::DF h = pos ? df::make(prev_hi[row], prev_lo[row]) : big();
  // the shadow: lane 0 follows position w*32-1 and lane 1 position w*32-2,
  // the previous warp's last two, from the costs that warp publishes
  const int sa = w * 32 - 1 - lane;
  df::DF sh = df::make(0.f, 0.f);
  if (W > 1 && w > 0) sh = df::make(prev_hi[urow + max(sa, 0)], prev_lo[urow + max(sa, 0)]);
  const int len = feat_len[b];
  // this lane's column of the utterance's emissions
  const float* am_hi = ams_hi + (size_t)b * C * A + min(a, A - 1);
  const float* am_lo = ams_lo + (size_t)b * C * A + min(a, A - 1);

  // the emissions of frames i .. i+PREFETCH-1, slot i % PREFETCH
  float ring_hi[PREFETCH], ring_lo[PREFETCH];
#pragma unroll
  for (int p = 0; p < PREFETCH; ++p) {
    ring_hi[p] = p < C ? am_hi[(size_t)p * A] : 0.f;
    ring_lo[p] = p < C ? am_lo[(size_t)p * A] : 0.f;
  }

  // frame i from the carry h (and the shadow sh): the costs and jumps, the
  // row minimum, the carry. Returns whether the utterance's row held a NaN;
  // with fold (std::true_type) such a row takes the plain version's fold,
  // without it the keyed minimum stands and the caller does the frame again.
  auto frame = [&](int i, df::DF am, auto fold) -> bool {
    // positions a-1 and a-2: the lanes below, or the shadow
    df::DF n1 = df::make(__shfl_up_sync(FULL, h.hi, 1), __shfl_up_sync(FULL, h.lo, 1));
    df::DF n2 = df::make(__shfl_up_sync(FULL, h.hi, 2), __shfl_up_sync(FULL, h.lo, 2));
    if (W > 1) {
      const df::DF sh_up = df::make(__shfl_up_sync(FULL, sh.hi, 1),
                                    __shfl_up_sync(FULL, sh.lo, 1));
      const df::DF sh_down = df::make(__shfl_down_sync(FULL, sh.hi, 1),
                                      __shfl_down_sync(FULL, sh.lo, 1));
      if (lane == 0) { n1 = sh; n2 = sh_down; }
      if (lane == 1) n2 = sh_up;
    }
    const int t = t0 + i;
    signed char jump;
    df::DF cost = step_cost(h, n1, n2, tw0, tw1, tw2, am, a, valid, tie_pruned, jump);
    cost = pos ? cost : big();
    store_if(jumps + ((size_t)i * B + b) * A + a, jump, pos);

    // the exact row minimum: the warp's, then the utterance's
    df::DF row_best = warp_minimum(cost);
    bool nan_row = __any_sync(FULL, pos && is_nan(cost));
    if (W > 1) {
      float2* pub = s_pub[u][i & 1][w];
      if (lane == 0) pub[0] = nan_row ? nan_pair() : make_float2(row_best.hi, row_best.lo);
      if (lane >= 30) pub[lane - 29] = make_float2(cost.hi, cost.lo);
      asm volatile("bar.sync %0, %1;" :: "r"(1 + u), "r"(W * 32) : "memory");
      const float2 m0 = s_pub[u][i & 1][0][0];
      row_best = df::make(m0.x, m0.y);
      nan_row = m0.x != m0.x;
#pragma unroll
      for (int v = 1; v < W; ++v) {
        const float2 mv = s_pub[u][i & 1][v][0];
        row_best = df::minimum(row_best, df::make(mv.x, mv.y));
        nan_row = nan_row || mv.x != mv.x;
      }
    }
    if constexpr (decltype(fold)::value) {
      if (nan_row) {  // the same for the utterance's warps: the plain fold
        if (pos) s_row[u][a] = make_float2(cost.hi, cost.lo);
        if (W > 1)
          asm volatile("bar.sync %0, %1;" :: "r"(1 + u), "r"(W * 32) : "memory");
        else
          __syncwarp();
        row_best = fold_minimum_warp(s_row[u], A, s_fold[warp], lane);
      }
    }
    if (row_best.hi >= HALF_BIG) row_best = df::make(0.f, 0.f);
    if (W > 1) {
      const float2 sc = s_pub[u][i & 1][max(w - 1, 0)][lane == 0 ? 2 : 1];
      sh = step_carry(df::make(sc.x, sc.y), row_best, df::make(0.f, 0.f), sh, thr, sa,
                      false, t, len, use_pruning);
    }
    h = step_carry(cost, row_best, am, h, thr, a, valid, t, len, use_pruning);
    return nan_row;
  };

  for (int i0 = 0; i0 < C; i0 += PREFETCH) {
    const df::DF h_group = h, sh_group = sh;
    bool nan_group = false;
#pragma unroll
    for (int p = 0; p < PREFETCH; ++p) {
      const int i = i0 + p;
      if (i < C) {  // the same for the whole utterance
        const df::DF am = df::make(ring_hi[p], ring_lo[p]);
        ring_hi[p] = am_hi[(size_t)min(i + PREFETCH, C - 1) * A];
        ring_lo[p] = am_lo[(size_t)min(i + PREFETCH, C - 1) * A];
        nan_group |= frame(i, am, std::false_type{});
      }
    }
    if (nan_group) {  // the same for the utterance's warps: the group again, folded
      h = h_group;
      sh = sh_group;
#pragma unroll 1
      for (int i = i0; i < min(i0 + PREFETCH, C); ++i)
        frame(i, df::make(am_hi[(size_t)i * A], am_lo[(size_t)i * A]), std::true_type{});
    }
  }
  if (pos) {
    out_hi[row] = h.hi;
    out_lo[row] = h.lo;
  }
}

// ---- the wide instance (128 < A <= 1024): W warps an utterance, K positions a lane ----

constexpr int WIDE_WARPS = 8;  // warps an utterance, at most

// positions a lane (2-4) and warps an utterance (3-8) of the wide instance:
// at most 256 positions take 2 a lane, longer rows 3 or 4, so that an
// utterance's warps stay at most 8. On an H100 a trainer chunk (B 130, C
// 320, A 303) took 0.39 ms at 2 positions a lane on 5 warps, 0.41 ms at 1 on
// 10 and 0.51 ms at 3 on 4
__host__ __device__ __forceinline__ int wide_k(int A) {
  const int k = (A + 8 * 32 - 1) / (8 * 32);
  return k < 2 ? 2 : k;
}

__host__ __device__ __forceinline__ int wide_warps(int A) {
  const int k = wide_k(A);
  return (A + 32 * k - 1) / (32 * k);
}

// One utterance a block of W = blockDim.x / 32 warps, K consecutive
// positions a lane: position a = (w*32 + lane)*K + k. The warp instance's
// design with K positions a lane: TDPs, validity and the carry in registers,
// the emissions PREFETCH frames ahead in a register ring, neighbours a-1 and
// a-2 of a lane's first position from the lane below (shuffles) or, in
// lane 0, from the shadow of the previous warp's last two positions; the
// row minimum a keyed redux.sync a warp, the W warps' minima folded by every
// thread after the one barrier a frame. A NaN row: each warp publishes a
// NaN minimum, and the group of PREFETCH frames that held one is done again
// frame by frame, its NaN rows folded by the block as the plain version
// folds them (fold_minimum_block, through shared memory); the groups after
// it are folded from the start, until a group holds no NaN row.
template <int K>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
align_fwd_df_wide_kernel(
    const float* __restrict__ prev_hi, const float* __restrict__ prev_lo,
    const float* __restrict__ ams_hi, const float* __restrict__ ams_lo,
    const float* __restrict__ tdp_hi, const float* __restrict__ tdp_lo,
    const unsigned char* __restrict__ pos_valid, const int* __restrict__ feat_len,
    float* __restrict__ out_hi, float* __restrict__ out_lo, signed char* __restrict__ jumps,
    int B, int C, int A, int t0, float thr_hi, float thr_lo, int tie_pruned,
    int use_pruning) {
  // per frame parity and warp: its minimum (NaN if its costs hold a NaN) and
  // the costs of its second-last and last positions
  __shared__ float2 s_pub[2][WIDE_WARPS][3];
  // a NaN row's costs and the fold's two buffers
  __shared__ float2 s_row[SHARED_POSITIONS];
  __shared__ float2 s_fold[2][SHARED_POSITIONS / 2];
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const df::DF thr = df::make(thr_hi, thr_lo);
  const int a0 = (warp * 32 + lane) * K;  // this lane's first position
  const size_t urow = (size_t)b * A;
  df::DF tw0[K], tw1[K], tw2[K], h[K];
  bool valid[K], pos[K];
  int col[K];  // the position's column, the last one standing in past A
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = a0 + k;
    pos[k] = a < A;
    col[k] = min(a, A - 1);
    const size_t r = urow + col[k];
    valid[k] = pos[k] && pos_valid[r] != 0;
    tw0[k] = df::make(tdp_hi[r * 3 + 0], tdp_lo[r * 3 + 0]);
    tw1[k] = df::make(tdp_hi[r * 3 + 1], tdp_lo[r * 3 + 1]);
    tw2[k] = df::make(tdp_hi[r * 3 + 2], tdp_lo[r * 3 + 2]);
    h[k] = pos[k] ? df::make(prev_hi[r], prev_lo[r]) : big();
  }
  // the shadow: positions w*32*K - 1 and w*32*K - 2, the previous warp's
  // last two, followed by every lane from the costs that warp publishes
  const int s1 = warp * 32 * K - 1, s2 = s1 - 1;
  df::DF sh1 = big(), sh2 = big();
  if (warp > 0) {
    sh1 = df::make(prev_hi[urow + s1], prev_lo[urow + s1]);
    sh2 = df::make(prev_hi[urow + s2], prev_lo[urow + s2]);
  }
  const int len = feat_len[b];
  const float* am_hi = ams_hi + (size_t)b * C * A;
  const float* am_lo = ams_lo + (size_t)b * C * A;

  // the emissions of frames i .. i+PREFETCH-1, slot i % PREFETCH
  float ring_hi[PREFETCH][K], ring_lo[PREFETCH][K];
#pragma unroll
  for (int p = 0; p < PREFETCH; ++p)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ring_hi[p][k] = p < C ? am_hi[(size_t)p * A + col[k]] : 0.f;
      ring_lo[p][k] = p < C ? am_lo[(size_t)p * A + col[k]] : 0.f;
    }

  // frame i from the carry h and the shadow: the costs and jumps, the row
  // minimum, the carry. Returns whether the row held a NaN; with fold
  // (std::true_type) such a row takes the plain version's fold, without it
  // the keyed minimum stands and the caller does the frame again.
  auto frame = [&](int i, const df::DF(&am)[K], auto fold) -> bool {
    const df::DF below1 = df::make(__shfl_up_sync(FULL, h[K - 1].hi, 1),
                                   __shfl_up_sync(FULL, h[K - 1].lo, 1));
    const df::DF below2 = df::make(__shfl_up_sync(FULL, h[K - 2].hi, 1),
                                   __shfl_up_sync(FULL, h[K - 2].lo, 1));
    const df::DF up1 = lane == 0 ? sh1 : below1;
    const df::DF up2 = lane == 0 ? sh2 : below2;
    const int t = t0 + i;
    df::DF cost[K];
    df::DF m = big();
    bool nan_cell = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const df::DF n1 = k >= 1 ? h[k >= 1 ? k - 1 : 0] : up1;
      const df::DF n2 = k >= 2 ? h[k >= 2 ? k - 2 : 0] : (k == 1 ? up1 : up2);
      signed char jump;
      cost[k] = step_cost(h[k], n1, n2, tw0[k], tw1[k], tw2[k], am[k], a0 + k, valid[k],
                          tie_pruned, jump);
      cost[k] = pos[k] ? cost[k] : big();
      store_if(jumps + ((size_t)i * B + b) * A + a0 + k, jump, pos[k]);
      m = df::minimum(m, cost[k]);
      nan_cell |= pos[k] && is_nan(cost[k]);
    }
    // the exact row minimum: the warp's, then the utterance's
    df::DF row_best = warp_minimum(m);
    const bool nan_warp = __any_sync(FULL, nan_cell);
    float2* pub = s_pub[i & 1][warp];
    if (lane == 0) pub[0] = nan_warp ? nan_pair() : make_float2(row_best.hi, row_best.lo);
    if (lane == 31) {
      pub[1] = make_float2(cost[K - 2].hi, cost[K - 2].lo);
      pub[2] = make_float2(cost[K - 1].hi, cost[K - 1].lo);
    }
    __syncthreads();  // the minima and the edge costs are visible
    const float2 m0 = s_pub[i & 1][0][0];
    row_best = df::make(m0.x, m0.y);
    bool nan_row = m0.x != m0.x;
    for (int v = 1; v < W; ++v) {
      const float2 mv = s_pub[i & 1][v][0];
      row_best = df::minimum(row_best, df::make(mv.x, mv.y));
      nan_row = nan_row || mv.x != mv.x;
    }
    if constexpr (decltype(fold)::value) {
      if (nan_row) {  // the same for the whole block: the plain fold
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (pos[k]) s_row[a0 + k] = make_float2(cost[k].hi, cost[k].lo);
        __syncthreads();  // the row is visible
        row_best = fold_minimum_block(s_row, A, s_fold[0], s_fold[1]);
      }
    }
    if (row_best.hi >= HALF_BIG) row_best = df::make(0.f, 0.f);
    if (warp > 0) {
      const float2 c1 = s_pub[i & 1][warp - 1][2], c2 = s_pub[i & 1][warp - 1][1];
      sh1 = step_carry(df::make(c1.x, c1.y), row_best, df::make(0.f, 0.f), sh1, thr, s1, false,
                       t, len, use_pruning);
      sh2 = step_carry(df::make(c2.x, c2.y), row_best, df::make(0.f, 0.f), sh2, thr, s2, false,
                       t, len, use_pruning);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      h[k] = step_carry(cost[k], row_best, am[k], h[k], thr, a0 + k, valid[k], t, len,
                        use_pruning);
    return nan_row;
  };

  // after a group that held a NaN row the next group is folded frame by
  // frame from the start (such rows usually recur: the AN4 TDPs' infinite
  // silence skip gives one every frame), until a group holds none
  bool folding = false;
  for (int i0 = 0; i0 < C; i0 += PREFETCH) {
    bool nan_group = false;
    if (!folding) {  // the same for the whole block
      df::DF h_group[K];
#pragma unroll
      for (int k = 0; k < K; ++k) h_group[k] = h[k];
      const df::DF sh1_group = sh1, sh2_group = sh2;
#pragma unroll
      for (int p = 0; p < PREFETCH; ++p) {
        const int i = i0 + p;
        if (i < C) {  // the same for the whole block
          df::DF am[K];
          const size_t nx = (size_t)min(i + PREFETCH, C - 1) * A;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            am[k] = df::make(ring_hi[p][k], ring_lo[p][k]);
            ring_hi[p][k] = am_hi[nx + col[k]];
            ring_lo[p][k] = am_lo[nx + col[k]];
          }
          nan_group |= frame(i, am, std::false_type{});
        }
      }
      if (nan_group) {  // the group again from its carry
#pragma unroll
        for (int k = 0; k < K; ++k) h[k] = h_group[k];
        sh1 = sh1_group;
        sh2 = sh2_group;
      }
    }
    if (folding || nan_group) {  // the same for the whole block: the group, folded
      bool nan_again = false;
#pragma unroll 1
      for (int i = i0; i < min(i0 + PREFETCH, C); ++i) {
        df::DF am[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
          am[k] = df::make(am_hi[(size_t)i * A + col[k]], am_lo[(size_t)i * A + col[k]]);
        nan_again |= frame(i, am, std::true_type{});
      }
      if (folding) {  // the ring was not read: the next group's emissions
#pragma unroll
        for (int p = 0; p < PREFETCH; ++p) {
          const size_t nx = (size_t)min(i0 + PREFETCH + p, C - 1) * A;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            ring_hi[p][k] = am_hi[nx + col[k]];
            ring_lo[p][k] = am_lo[nx + col[k]];
          }
        }
      }
      folding = nan_again;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (pos[k]) {
      out_hi[urow + a0 + k] = h[k].hi;
      out_lo[urow + a0 + k] = h[k].lo;
    }
}

// the (hi, lo) pairs the block instance keeps per utterance: the row
// double-buffered by frame parity, and the NaN fold's two buffers
__host__ __device__ __forceinline__ size_t block_pairs(int A) {
  return 2 * (size_t)A + 2 * (size_t)((A + 1) / 2);
}

// one block of min(ceil(A/32)*32, 1024) threads per utterance, each thread
// looping over the positions a = threadIdx.x + k*blockDim.x; the row's
// (hi, lo) pairs double-buffered by frame parity in lat [2][A], then the
// NaN fold's buffers: shared memory where scratch is null, else the
// utterance's block_pairs(A) of the wrapper's device scratch (not restrict:
// the threads read one another's writes after each __syncthreads)
__global__ void __launch_bounds__(BLOCK_THREADS) align_fwd_df_block_kernel(
    const float* __restrict__ prev_hi, const float* __restrict__ prev_lo,
    const float* __restrict__ ams_hi, const float* __restrict__ ams_lo,
    const float* __restrict__ tdp_hi, const float* __restrict__ tdp_lo,
    const unsigned char* __restrict__ pos_valid, const int* __restrict__ feat_len,
    float* __restrict__ out_hi, float* __restrict__ out_lo, signed char* __restrict__ jumps,
    float2* scratch, int B, int C, int A, int t0, float thr_hi, float thr_lo, int tie_pruned,
    int use_pruning) {
  extern __shared__ float2 smem[];
  __shared__ float2 s_wmin[BLOCK_THREADS / 32];
  const int b = blockIdx.x;
  const int nwarps = blockDim.x / 32;
  const size_t urow = (size_t)b * A;
  float2* lat = scratch != nullptr ? scratch + (size_t)b * block_pairs(A) : smem;
  float2* fold0 = lat + 2 * (size_t)A;
  float2* fold1 = fold0 + (A + 1) / 2;
  const df::DF thr = df::make(thr_hi, thr_lo);
  const int len = feat_len[b];
  for (int a = threadIdx.x; a < A; a += blockDim.x)
    lat[a] = make_float2(prev_hi[urow + a], prev_lo[urow + a]);
  __syncthreads();

  int buf = 0;
  for (int i = 0; i < C; ++i) {
    const int t = t0 + i;
    const float2* cur = lat + (size_t)buf * A;
    float2* nxt = lat + (size_t)(buf ^ 1) * A;
    const size_t am_t = ((size_t)b * C + i) * A;
    // (a) every position's cost before the renormalisation, into nxt
    df::DF m = big();
    int nan_seen = 0;
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
      const size_t r = urow + a;
      const df::DF h1 = a >= 1 ? df::make(cur[a - 1].x, cur[a - 1].y) : big();
      const df::DF h2 = a >= 2 ? df::make(cur[a - 2].x, cur[a - 2].y) : big();
      signed char jump;
      const df::DF cost = step_cost(
          df::make(cur[a].x, cur[a].y), h1, h2, df::make(tdp_hi[r * 3 + 0], tdp_lo[r * 3 + 0]),
          df::make(tdp_hi[r * 3 + 1], tdp_lo[r * 3 + 1]),
          df::make(tdp_hi[r * 3 + 2], tdp_lo[r * 3 + 2]),
          df::make(ams_hi[am_t + a], ams_lo[am_t + a]), a, pos_valid[r] != 0, tie_pruned, jump);
      jumps[((size_t)i * B + b) * A + a] = jump;
      nxt[a] = make_float2(cost.hi, cost.lo);
      m = df::minimum(m, cost);
      nan_seen |= is_nan(cost);
    }
    // the lexicographic row minimum (exact in any order); a thread without
    // a position holds (BIG, 0), which every real row minimum already is or
    // undercuts
    m = warp_minimum(m);
    if ((threadIdx.x & 31) == 0) s_wmin[threadIdx.x >> 5] = make_float2(m.hi, m.lo);
    // the per-warp minima and the row are visible; a NaN row folds as the
    // plain version does
    df::DF row_best;
    if (__syncthreads_or(nan_seen)) {
      row_best = fold_minimum_block(nxt, A, fold0, fold1);
    } else {
      row_best = df::make(s_wmin[0].x, s_wmin[0].y);
      for (int k = 1; k < nwarps; ++k)
        row_best = df::minimum(row_best, df::make(s_wmin[k].x, s_wmin[k].y));
    }
    if (row_best.hi >= HALF_BIG) row_best = df::make(0.f, 0.f);
    // (b) each thread's own positions: the carry
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
      const df::DF c = step_carry(df::make(nxt[a].x, nxt[a].y), row_best,
                                  df::make(ams_hi[am_t + a], ams_lo[am_t + a]),
                                  df::make(cur[a].x, cur[a].y), thr, a,
                                  pos_valid[urow + a] != 0, t, len, use_pruning);
      nxt[a] = make_float2(c.hi, c.lo);
    }
    __syncthreads();  // the new row is visible; the minima may be rewritten
    buf ^= 1;
  }
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const float2 v = lat[(size_t)buf * A + a];
    out_hi[urow + a] = v.x;
    out_lo[urow + a] = v.y;
  }
}

}  // namespace

// the instance sr_align_fwd_df launches for A positions: warps per
// utterance of the warp instance (1-4, one position a lane) or of the wide
// instance (3-8, sr_align_fwd_df_positions(A) positions a lane); the block
// instance with its row in device scratch of B * sr_align_fwd_df_scratch(A)
// (hi, lo) pairs (-1). The block instance with its row in shared memory (0)
// runs only as the first design, forced for 128 < A <= 1024.
extern "C" int sr_align_fwd_df_warps(int A) {
  if (A <= WARP_POSITIONS) return (A + 31) / 32;
  return A <= SHARED_POSITIONS ? wide_warps(A) : -1;
}

// positions a lane of that instance: 1 (the warp instance), 2-4 (the wide
// instance), 0 (the block instance, whose threads loop over the positions)
extern "C" int sr_align_fwd_df_positions(int A) {
  if (A <= WARP_POSITIONS) return 1;
  return A <= SHARED_POSITIONS ? wide_k(A) : 0;
}

// the block instance's (hi, lo) pairs an utterance, in device scratch past A = 1024
extern "C" int sr_align_fwd_df_scratch(int A) { return (int)block_pairs(A); }

extern "C" int sr_align_fwd_df(const float* prev_hi, const float* prev_lo,
                               const float* ams_hi, const float* ams_lo, const float* tdp_hi,
                               const float* tdp_lo, const unsigned char* pos_valid,
                               const int* feat_len, float* out_hi, float* out_lo,
                               signed char* jumps, float* scratch, int B, int C, int A, int t0,
                               float thr_hi, float thr_lo, int tie_pruned, int use_pruning,
                               int first_design, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || A == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
#define SR_WARPS(W)                                                                           \
  align_fwd_df_warp_kernel<W><<<(B + MAX_WARPS / W - 1) / (MAX_WARPS / W),                    \
                                MAX_WARPS / W * W * 32, 0, st>>>(                             \
      prev_hi, prev_lo, ams_hi, ams_lo, tdp_hi, tdp_lo, pos_valid, feat_len, out_hi, out_lo,  \
      jumps, B, C, A, t0, thr_hi, thr_lo, tie_pruned, use_pruning)
#define SR_WIDE(K)                                                                            \
  align_fwd_df_wide_kernel<K><<<B, wide_warps(A) * 32, 0, st>>>(                              \
      prev_hi, prev_lo, ams_hi, ams_lo, tdp_hi, tdp_lo, pos_valid, feat_len, out_hi, out_lo,  \
      jumps, B, C, A, t0, thr_hi, thr_lo, tie_pruned, use_pruning)
  const bool wide = A > WARP_POSITIONS && A <= SHARED_POSITIONS;
  const int inst = wide && first_design ? 0 : sr_align_fwd_df_warps(A);
  if (wide && !first_design) {
    switch (wide_k(A)) {
      case 2: SR_WIDE(2); break;
      case 3: SR_WIDE(3); break;
      default: SR_WIDE(4);
    }
    return (int)cudaGetLastError();
  }
  switch (inst) {
    case 1: SR_WARPS(1); break;
    case 2: SR_WARPS(2); break;
    case 3: SR_WARPS(3); break;
    case 4: SR_WARPS(4); break;
    default: {
      // the row in shared memory (0: the first design, forced) or in the
      // scratch (-1)
      if (inst < 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
      const int threads = A < BLOCK_THREADS ? (A + 31) / 32 * 32 : BLOCK_THREADS;
      const size_t smem = inst < 0 ? 0 : block_pairs(A) * sizeof(float2);
      align_fwd_df_block_kernel<<<B, threads, smem, st>>>(
          prev_hi, prev_lo, ams_hi, ams_lo, tdp_hi, tdp_lo, pos_valid, feat_len, out_hi, out_lo,
          jumps, inst < 0 ? reinterpret_cast<float2*>(scratch) : nullptr, B, C, A, t0, thr_hi,
          thr_lo, tie_pruned, use_pruning);
    }
  }
#undef SR_WARPS
#undef SR_WIDE
  return (int)cudaGetLastError();
}
