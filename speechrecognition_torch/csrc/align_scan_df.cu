// Kernel F: one time chunk of the forced-alignment Viterbi DP in double-float.
//
// Replaces speechrecognition_tpu/align/viterbi.py::_align_fwd_chunk_df, the
// (hi, lo) float32-pair twin of _align_fwd_chunk that the df32 trainer
// realigns with (XLA fuses it into one lax.scan). Kernel E's layout and step
// (csrc/align_scan.cu), with every score a pair and df.cuh's exact add, sub
// and comparisons:
//   * candidates c_j = add(prev[a-j], tdp[a,j]), (BIG, 0) where a-j < 0;
//     selection with strict less() in the reference's tie order;
//   * cost = valid ? add(best, am) : (BIG, 0); (BIG, 0) where cost.hi >= BIG/2;
//   * the lexicographic (hi, lo) row minimum, exact in any order; a dead row
//     (minimum hi >= BIG/2) renormalises by (0, 0); shifted = sub(cost, min),
//     kept only where cost.hi < BIG/2;
//   * pruning where !less_equal(cost, thr);
//   * t == 0 initialises position 0 only; rows with t >= feat_len keep
//     their carry.
// Inputs and outputs as kernel E's, each score array as separate hi and lo
// float32 arrays; thr is a (hi, lo) pair. The DP only adds, subtracts,
// compares and selects, and df.cuh's round-to-nearest intrinsics keep nvcc
// from contracting anything, so the kernel matches its plain PyTorch version
// bit for bit in both words.
//
// What bounds it: latency, as kernel E; a double-float add is ~20 FP32
// instructions, so a frame costs about 100 instructions a thread between its
// two __syncthreads.

#include <cuda_runtime.h>

#include "df.cuh"

namespace {

constexpr float BIG = 1e30f;
constexpr float HALF_BIG = BIG * 0.5f;  // exact in float32

__device__ __forceinline__ df::DF big() { return df::make(BIG, 0.f); }

__global__ void align_fwd_df_kernel(
    const float* __restrict__ prev_hi, const float* __restrict__ prev_lo,
    const float* __restrict__ ams_hi, const float* __restrict__ ams_lo,
    const float* __restrict__ tdp_hi, const float* __restrict__ tdp_lo,
    const unsigned char* __restrict__ pos_valid, const int* __restrict__ feat_len,
    float* __restrict__ out_hi, float* __restrict__ out_lo, signed char* __restrict__ jumps,
    int B, int C, int A, int t0, float thr_hi, float thr_lo, int tie_pruned,
    int use_pruning) {
  extern __shared__ float smem[];
  float* sh_hi = smem;           // [2][A]
  float* sh_lo = sh_hi + 2 * A;  // [2][A]
  float* s_whi = sh_lo + 2 * A;  // [32]
  float* s_wlo = s_whi + 32;     // [32]

  const int b = blockIdx.x;
  const int a = threadIdx.x;
  const int nwarps = blockDim.x / 32;
  const bool pos = a < A;
  const size_t row = (size_t)b * A + a;
  const df::DF thr = df::make(thr_hi, thr_lo);

  bool valid = false;
  df::DF tw0 = df::make(0.f, 0.f), tw1 = tw0, tw2 = tw0;
  df::DF h = big();
  if (pos) {
    valid = pos_valid[row] != 0;
    tw0 = df::make(tdp_hi[row * 3 + 0], tdp_lo[row * 3 + 0]);
    tw1 = df::make(tdp_hi[row * 3 + 1], tdp_lo[row * 3 + 1]);
    tw2 = df::make(tdp_hi[row * 3 + 2], tdp_lo[row * 3 + 2]);
    h = df::make(prev_hi[row], prev_lo[row]);
  }
  const int len = feat_len[b];
  const size_t am_b = (size_t)b * C * A;

  int buf = 0;
  for (int i = 0; i < C; ++i) {
    const int t = t0 + i;
    if (pos) {
      sh_hi[buf * A + a] = h.hi;
      sh_lo[buf * A + a] = h.lo;
    }
    __syncthreads();  // (1) the previous frame's row is visible

    df::DF cost = big();
    df::DF am = df::make(0.f, 0.f);
    if (pos) {
      am = df::make(ams_hi[am_b + (size_t)i * A + a], ams_lo[am_b + (size_t)i * A + a]);
      const df::DF c0 = df::add(h, tw0);
      const df::DF c1 = a >= 1 ? df::add(df::make(sh_hi[buf * A + a - 1],
                                                   sh_lo[buf * A + a - 1]), tw1)
                               : big();
      const df::DF c2 = a >= 2 ? df::add(df::make(sh_hi[buf * A + a - 2],
                                                   sh_lo[buf * A + a - 2]), tw2)
                               : big();
      df::DF best;
      signed char jump;
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
      cost = valid ? df::add(best, am) : big();
      if (cost.hi >= HALF_BIG) cost = big();
      jumps[((size_t)i * B + b) * A + a] = jump;
    }

    // lexicographic row minimum (exact in any order); idle threads hold
    // (BIG, 0), which every real row minimum already is or undercuts
    df::DF m = cost;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const df::DF o = df::make(__shfl_xor_sync(0xffffffffu, m.hi, off),
                                __shfl_xor_sync(0xffffffffu, m.lo, off));
      m = df::minimum(m, o);
    }
    if ((a & 31) == 0) {
      s_whi[a >> 5] = m.hi;
      s_wlo[a >> 5] = m.lo;
    }
    __syncthreads();  // (2) per-warp minima are visible
    df::DF row_best = df::make(s_whi[0], s_wlo[0]);
    for (int k = 1; k < nwarps; ++k)
      row_best = df::minimum(row_best, df::make(s_whi[k], s_wlo[k]));
    if (row_best.hi >= HALF_BIG) row_best = df::make(0.f, 0.f);
    const df::DF shifted = df::sub(cost, row_best);
    cost = cost.hi >= HALF_BIG ? big() : shifted;
    if (use_pruning && !df::less_equal(cost, thr)) cost = big();
    if (t == 0) cost = (a == 0 && valid) ? am : big();
    if (t < len) h = cost;
    buf ^= 1;
  }
  if (pos) {
    out_hi[row] = h.hi;
    out_lo[row] = h.lo;
  }
}

}  // namespace

extern "C" int sr_align_fwd_df(const float* prev_hi, const float* prev_lo,
                               const float* ams_hi, const float* ams_lo, const float* tdp_hi,
                               const float* tdp_lo, const unsigned char* pos_valid,
                               const int* feat_len, float* out_hi, float* out_lo,
                               signed char* jumps, int B, int C, int A, int t0, float thr_hi,
                               float thr_lo, int tie_pruned, int use_pruning, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || A == 0) return (int)cudaSuccess;
  const int threads = (A + 31) / 32 * 32;
  const size_t smem = (4 * (size_t)A + 64) * sizeof(float);
  align_fwd_df_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      prev_hi, prev_lo, ams_hi, ams_lo, tdp_hi, tdp_lo, pos_valid, feat_len, out_hi, out_lo,
      jumps, B, C, A, t0, thr_hi, thr_lo, tie_pruned, use_pruning);
  return (int)cudaGetLastError();
}
