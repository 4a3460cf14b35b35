// Kernel L: the Baum-Welch forward-backward scan over the banded 0-1-2
// position lattice.
//
// Replaces speechrecognition_tpu/align/baumwelch.py::_forward_backward (:44),
// two lax.scans over T with a three-way logsumexp (_lse3, :34) that XLA
// fuses; written op by op in PyTorch it takes about 20 small launches a
// frame in each of the two passes. Same inputs and outputs: the emissions
// lams [B, T, A] (-score), the transitions ltdp [B, A, 3] (into position a
// by jump j, -penalty), pos_valid [B, A] (uint8), feat_len [B] and aut_len
// [B]; it writes the posteriors gamma [B, T, A] and log_z [B]. A template
// on the score type: float or double. NEG_BIG = -1e30 and its half are in
// the score type, as the plain version (align/baumwelch.py) keeps them.
//
// Per utterance, the reference's recursions (len = min(feat_len, T)):
//   * forward: alpha_0 = lams[0, 0] at position 0 (if valid), NEG_BIG
//     elsewhere; each frame t < len: lse3(alpha[a] + ltdp[a,0],
//     alpha[a-1] + ltdp[a,1], alpha[a-2] + ltdp[a,2]) + lams[t, a], invalid
//     positions NEG_BIG, then the row shifted by its maximum (0 for a dead
//     row) with cells <= NEG_BIG/2 set to NEG_BIG; frames past len keep
//     the row, so only frames < len are computed;
//   * log_z = alpha[len-1][aut_len-1] (a negative index wraps once, as the
//     reference's take_along_axis does) + the shifts of frames 1..len-1,
//     summed in frame order;
//   * backward: beta at frame len-1 is 0 at aut_len-1 and NEG_BIG elsewhere;
//     frame t < len-1: lse3(term[a] + ltdp[a,0], term[a+1] + ltdp[a+1,1],
//     term[a+2] + ltdp[a+2,2]) with term = beta[t+1] + lams[t+1], masked and
//     shifted as the forward row;
//   * posteriors: post = alpha + beta, p = exp(post - max(rowmax,
//     NEG_BIG/2)), 0 where post <= NEG_BIG/2, divided by max(sum p, 1e-30);
//     rows t >= len are 0. The row sum is taken in one fixed order, which
//     the plain version spells out: the row is cut into 32 chunks of
//     K = ceil(A/32) positions, each chunk summed in position order, then
//     the 32 chunk sums by the butterfly of offsets 16, 8, 4, 2, 1.
// lse3 sums its three exponentials in order and every other step is an
// add, compare, select, max or division in the score type, so on the card
// the kernel repeats its plain version's operations; exp and log are the
// CUDA math library's (built without --use_fast_math), not the
// intrinsics.
//
// What bounds it: the chain of dependent work a frame, not bytes or
// operations. Each frame needs the whole previous row through its maximum.
// At the full-width shape (B 256, T 960, A 70) the function's bytes (lams
// read, gamma written) take 0.04 ms in float32 at 3.35 TB/s, and a frame's
// chain (the neighbours' shuffles, three exponentials and a logarithm, the
// row maximum, the renorm) sets the time. Instances, chosen in the C entry
// from A alone (sr_forward_backward_instance):
//   * A <= 96 (every SieTill automaton): two concurrent chains, then the
//     posterior rows off the chains; two launches on the caller's stream.
//     - fb_chain_kernel: a block of two warps an utterance, K = ceil(A/32)
//       consecutive positions a lane. Warp 0 runs the forward recursion,
//       writes the alpha rows into gamma and writes log_z; warp 1 runs the
//       backward recursion and writes the beta rows into beta [B, T, A], a
//       buffer the wrapper allocates. Beta never reads alpha, so the serial
//       chain is the longer of the two recursions, not their sum, and
//       neither carries a posterior. Positions a-1, a-2 (forward) and a+1,
//       a+2 (backward) of a lane's edge positions come from the
//       neighbouring lanes by shuffles; a row's maximum is one redux.sync on
//       order-preserving keys (two in double; keys.cuh), exact; each chain
//       keeps the emissions of its next 4 frames (2 in double) in flight in
//       registers.
//     - fb_posterior_kernel: the posterior rows from alpha (in gamma) and
//       beta, gamma overwritten in place, rows past the utterance written 0.
//       A block takes POST_TILE consecutive rows of one utterance (its
//       feat_len read once), a warp POST_ROWS of them, all loaded before
//       any is reduced. The loads are independent of one another, so it is
//       bound by its bytes (alpha and beta read, gamma written). A launch
//       of its own rather than a phase after a barrier of the first: the
//       chains hold two warps an utterance, 512 at B 256, and only a launch
//       of its own spreads the rows over the whole card.
//   * the first design for A <= 96 (fb_warp_kernel, launched only when the
//     caller asks for it, so that the two can be timed in turns): one warp
//     an utterance, the forward pass and then the backward pass, each
//     backward frame forming its posterior row on the chain from beta in
//     registers and alpha read back from gamma; maxima by butterfly
//     shuffles.
//   * 96 < A <= 1024 (the Sprint path's automata: A 303 at AN4's shape):
//     the same two chains and posterior pass, each chain on a block of its
//     own (grid [B, 2]) of W warps, K consecutive positions a lane (K =
//     max(2, ceil(A/256)), W = ceil(A/(32K)): A 303 takes 5 warps of 2),
//     tables and validity in registers, the emissions in flight ahead
//     (fb_wide_chain_kernel). A warp's neighbours across its edge come from
//     a shadow: each warp publishes its row maximum and the raw cells of
//     its two edge positions, and after the one barrier a frame every
//     thread folds the W maxima (keys' exact order) and renormalises the
//     neighbouring warp's two cells as their owner does. The posterior
//     pass takes ceil(A/32) positions a lane, the row sum's order.
//   * A > 1024: one block of 1024 threads an utterance, each looping over
//     the positions a = threadIdx.x + k*blockDim.x; the alpha / beta row
//     double-buffered and a row of the posterior's exponentials in device
//     scratch [B, 3, A] that the wrapper allocates (-1); warp 0 forms the
//     row sum in the order above, each backward frame's posterior row on
//     the chain. Simple, not tuned. For 96 < A <= 1024 it was the first
//     design, its rows in shared memory; the C entry's first_design
//     launches it there, for timing in turns, and nothing else does.

#include <cuda_runtime.h>
#include <math.h>

#include "keys.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_POSITIONS = 96;      // the warp instance's longest automaton (3 a lane)
constexpr int SHARED_POSITIONS = 1024;  // the longest row the block instance keeps in shared memory
constexpr int BLOCK_THREADS = 1024;     // threads an utterance of the block instance, at most
constexpr int POST_ROWS = 2;    // rows a warp of the posterior pass has in flight
constexpr int POST_THREADS = 256;
constexpr int POST_TILE = POST_ROWS * (POST_THREADS / 32);  // rows of one utterance a block

// frames of emissions a chain has in flight: 4, and 2 in double, whose chain
// kernel spills at 4 (128 registers)
template <typename T>
__host__ __device__ constexpr int prefetch() { return sizeof(T) == 4 ? 4 : 2; }

template <typename T>
__device__ __forceinline__ T neg_big() { return T(-1e30); }
template <typename T>
__device__ __forceinline__ T half_neg_big() { return T(-1e30) * T(0.5); }
template <typename T>
__device__ __forceinline__ T minus_inf() { return -T(INFINITY); }

__device__ __forceinline__ float t_exp(float x) { return expf(x); }
__device__ __forceinline__ double t_exp(double x) { return exp(x); }
__device__ __forceinline__ float t_log(float x) { return logf(x); }
__device__ __forceinline__ double t_log(double x) { return log(x); }
__device__ __forceinline__ float t_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double t_max(double a, double b) { return fmax(a, b); }

// the reference's _lse3: NaN-free at NEG_BIG, NEG_BIG for an all-dead triple
template <typename T>
__device__ __forceinline__ T lse3(T a, T b, T c) {
  const T m = t_max(t_max(a, b), c);
  const T safe = t_max(m, half_neg_big<T>());
  const T out = safe + t_log(t_exp(a - safe) + t_exp(b - safe) + t_exp(c - safe));
  return m <= half_neg_big<T>() ? neg_big<T>() : out;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = t_max(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// the butterfly of the fixed row-sum order; every lane ends with the sum
template <typename T>
__device__ __forceinline__ T warp_tree_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(FULL, v, off);
  return v;
}

// the row's shift: its maximum, or 0 for a dead row
template <typename T>
__device__ __forceinline__ T row_shift(T m) {
  return m <= half_neg_big<T>() ? T(0) : m;
}

template <typename T>
__device__ __forceinline__ T renorm(T v, T shift) {
  return v <= half_neg_big<T>() ? neg_big<T>() : v - shift;
}

// the posterior row of the warp instance from alpha and beta in registers,
// written to g (the row of gamma)
template <typename T, int K>
__device__ __forceinline__ void warp_posterior(const T (&alpha)[K], const T (&beta)[K], T* g,
                                               int lane, int A) {
  const T HALF = half_neg_big<T>();
  T post[K];
  T m = minus_inf<T>();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    post[k] = alpha[k] + beta[k];
    if (lane * K + k < A) m = t_max(m, post[k]);
  }
  const T safe = t_max(warp_max(m), HALF);
  T p[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    p[k] = (lane * K + k < A && post[k] > HALF) ? t_exp(post[k] - safe) : T(0);
  T s = p[0];
#pragma unroll
  for (int k = 1; k < K; ++k) s = s + p[k];
  const T den = t_max(warp_tree_sum(s), T(1e-30));
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = lane * K + k;
    if (a < A) g[a] = p[k] / den;
  }
}

// one warp an utterance, K consecutive positions a lane
template <typename T, int K>
__global__ void __launch_bounds__(32)
fb_warp_kernel(const T* __restrict__ lams, const T* __restrict__ ltdp,
               const unsigned char* __restrict__ pos_valid, const int* __restrict__ feat_len,
               const int* __restrict__ aut_len, T* __restrict__ gamma, T* __restrict__ log_z,
               int Tn, int A) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const T NB = neg_big<T>();
  const int len = min(max(feat_len[b], 0), Tn);
  const int al = aut_len[b];
  const size_t urow = (size_t)b * A;
  const T* lam_b = lams + (size_t)b * Tn * A;
  T* g_b = gamma + (size_t)b * Tn * A;

  T tw0[K], tw1[K], tw2[K];
  bool valid[K];
  int col[K];  // the position's column, the last one standing in past A
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = lane * K + k;
    col[k] = min(a, A - 1);
    const size_t r = urow + col[k];
    valid[k] = a < A && pos_valid[r] != 0;
    tw0[k] = ltdp[r * 3 + 0];
    tw1[k] = ltdp[r * 3 + 1];
    tw2[k] = ltdp[r * 3 + 2];
  }

  // -- forward ----------------------------------------------------------------
  T alpha[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    alpha[k] = (lane * K + k == 0 && valid[k]) ? lam_b[0] : NB;
    if (len > 0 && lane * K + k < A) g_b[lane * K + k] = alpha[k];
  }
  T shift_sum = T(0);
  T lam_nx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) lam_nx[k] = len > 1 ? lam_b[(size_t)A + col[k]] : T(0);
  for (int t = 1; t < len; ++t) {
    T lam_t[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lam_t[k] = lam_nx[k];
      lam_nx[k] = lam_b[(size_t)min(t + 1, len - 1) * A + col[k]];
    }
    // positions a-1 and a-2 of the lane's first positions: the lanes below
    const T up1 = __shfl_up_sync(FULL, alpha[K - 1], 1);
    const T up2 = K >= 2 ? __shfl_up_sync(FULL, alpha[K >= 2 ? K - 2 : 0], 1)
                         : __shfl_up_sync(FULL, alpha[0], 2);
    T nw[K];
    T m = minus_inf<T>();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int a = lane * K + k;
      const T p1 = k >= 1 ? alpha[k >= 1 ? k - 1 : 0] : up1;
      const T p2 = k >= 2 ? alpha[k >= 2 ? k - 2 : 0] : (k == 1 ? up1 : up2);
      const T c0 = alpha[k] + tw0[k];
      const T c1 = a >= 1 ? p1 + tw1[k] : NB;
      const T c2 = a >= 2 ? p2 + tw2[k] : NB;
      const T v = lse3(c0, c1, c2) + lam_t[k];
      nw[k] = valid[k] ? v : NB;
      if (a < A) m = t_max(m, nw[k]);
    }
    const T shift = row_shift(warp_max(m));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      alpha[k] = renorm(nw[k], shift);
      if (lane * K + k < A) g_b[(size_t)t * A + lane * K + k] = alpha[k];
    }
    shift_sum = shift_sum + shift;
  }

  // log_z: alpha at (len-1, aut_len-1) plus the shifts
  const int fz = min(max(al - 1 < 0 ? al - 1 + A : al - 1, 0), A - 1);
  T az = NB;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane * K + k == fz) az = alpha[k];
  az = __shfl_sync(FULL, az, fz / K);
  if (lane == 0) log_z[b] = az + shift_sum;

  // -- backward and posteriors -------------------------------------------------
  if (len > 0) {
    T beta[K];
#pragma unroll
    for (int k = 0; k < K; ++k) beta[k] = (lane * K + k == al - 1 && lane * K + k < A) ? T(0) : NB;
    warp_posterior<T, K>(alpha, beta, g_b + (size_t)(len - 1) * A, lane, A);
    T lam1[K];  // the emissions of frame t+1
#pragma unroll
    for (int k = 0; k < K; ++k) lam1[k] = len > 1 ? lam_b[(size_t)(len - 1) * A + col[k]] : T(0);
    for (int t = len - 2; t >= 0; --t) {
      T term[K], v1[K], v2[K], arow[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        term[k] = beta[k] + lam1[k];
        v1[k] = term[k] + tw1[k];
        v2[k] = term[k] + tw2[k];
        lam1[k] = lam_b[(size_t)t * A + col[k]];  // frame t's, for the next step
        // alpha of frame t, which this lane wrote in the forward pass
        arow[k] = lane * K + k < A ? g_b[(size_t)t * A + lane * K + k] : NB;
      }
      // positions a+1 and a+2 of the lane's last positions: the lanes above
      const T dn1 = __shfl_down_sync(FULL, v1[0], 1);
      const T dn2_first = __shfl_down_sync(FULL, v2[0], 1);
      const T dn2 = K >= 2 ? __shfl_down_sync(FULL, v2[K >= 2 ? 1 : 0], 1)
                           : __shfl_down_sync(FULL, v2[0], 2);
      T nb[K];
      T m = minus_inf<T>();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int a = lane * K + k;
        const T n1 = k + 1 < K ? v1[k + 1 < K ? k + 1 : 0] : dn1;
        const T n2 = k + 2 < K ? v2[k + 2 < K ? k + 2 : 0] : (k + 2 == K ? dn2_first : dn2);
        const T b0 = term[k] + tw0[k];
        const T b1 = a + 1 < A ? n1 : NB;
        const T b2 = a + 2 < A ? n2 : NB;
        nb[k] = valid[k] ? lse3(b0, b1, b2) : NB;
        if (a < A) m = t_max(m, nb[k]);
      }
      const T shift = row_shift(warp_max(m));
#pragma unroll
      for (int k = 0; k < K; ++k) beta[k] = renorm(nb[k], shift);
      warp_posterior<T, K>(arow, beta, g_b + (size_t)t * A, lane, A);
    }
  }
  // frames past the utterance
  for (int t = len; t < Tn; ++t)
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (lane * K + k < A) g_b[(size_t)t * A + lane * K + k] = T(0);
}

// -- the two chains and the posterior pass (A <= 96) ---------------------------

// a lane's K positions: their transitions into them, validity and emission
// columns (the last column standing in past A)
template <typename T, int K>
__device__ __forceinline__ void lane_tables(const T* ltdp, const unsigned char* pos_valid,
                                            size_t urow, int lane, int A, T (&tw0)[K],
                                            T (&tw1)[K], T (&tw2)[K], bool (&valid)[K],
                                            int (&col)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int a = lane * K + k;
    col[k] = min(a, A - 1);
    const size_t r = urow + col[k];
    valid[k] = a < A && pos_valid[r] != 0;
    tw0[k] = ltdp[r * 3 + 0];
    tw1[k] = ltdp[r * 3 + 1];
    tw2[k] = ltdp[r * 3 + 2];
  }
}

// the forward recursion of one utterance on one warp: alpha rows 0..len-1
// into g_b, log_z into *z; frame t's emissions are loaded PREFETCH frames
// ahead into a ring of registers (the frame loop is unrolled by PREFETCH so
// that every ring index is static)
template <typename T, int K>
__device__ __forceinline__ void forward_chain(const T* __restrict__ lam_b, const T (&tw0)[K],
                                              const T (&tw1)[K], const T (&tw2)[K],
                                              const bool (&valid)[K], const int (&col)[K],
                                              int lane, int len, int al, int A, T* g_b, T* z) {
  const T NB = neg_big<T>();
  T alpha[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    alpha[k] = (lane * K + k == 0 && valid[k]) ? lam_b[0] : NB;
    if (len > 0 && lane * K + k < A) g_b[lane * K + k] = alpha[k];
  }
  T shift_sum = T(0);
  constexpr int PREFETCH = prefetch<T>();
  T ring[PREFETCH][K];  // ring[d]: the emissions of frame t0 + d
#pragma unroll
  for (int d = 0; d < PREFETCH; ++d)
#pragma unroll
    for (int k = 0; k < K; ++k)
      ring[d][k] = len > 1 ? lam_b[(size_t)min(1 + d, len - 1) * A + col[k]] : T(0);
  for (int t0 = 1; t0 < len; t0 += PREFETCH) {
#pragma unroll
    for (int d = 0; d < PREFETCH; ++d) {
      const int t = t0 + d;
      if (t >= len) break;
      T lam_t[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        lam_t[k] = ring[d][k];
        ring[d][k] = lam_b[(size_t)min(t + PREFETCH, len - 1) * A + col[k]];
      }
      // positions a-1 and a-2 of the lane's first positions: the lanes below
      const T up1 = __shfl_up_sync(FULL, alpha[K - 1], 1);
      const T up2 = K >= 2 ? __shfl_up_sync(FULL, alpha[K >= 2 ? K - 2 : 0], 1)
                           : __shfl_up_sync(FULL, alpha[0], 2);
      T nw[K];
      T m = minus_inf<T>();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int a = lane * K + k;
        const T p1 = k >= 1 ? alpha[k >= 1 ? k - 1 : 0] : up1;
        const T p2 = k >= 2 ? alpha[k >= 2 ? k - 2 : 0] : (k == 1 ? up1 : up2);
        const T c0 = alpha[k] + tw0[k];
        const T c1 = a >= 1 ? p1 + tw1[k] : NB;
        const T c2 = a >= 2 ? p2 + tw2[k] : NB;
        const T v = lse3(c0, c1, c2) + lam_t[k];
        nw[k] = valid[k] ? v : NB;
        if (a < A) m = t_max(m, nw[k]);
      }
      const T shift = row_shift(keys::warp_maximum(m));
#pragma unroll
      for (int k = 0; k < K; ++k) {
        alpha[k] = renorm(nw[k], shift);
        if (lane * K + k < A) g_b[(size_t)t * A + lane * K + k] = alpha[k];
      }
      shift_sum = shift_sum + shift;
    }
  }
  // log_z: alpha at (len-1, aut_len-1) plus the shifts
  const int fz = min(max(al - 1 < 0 ? al - 1 + A : al - 1, 0), A - 1);
  T az = NB;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane * K + k == fz) az = alpha[k];
  az = __shfl_sync(FULL, az, fz / K);
  if (lane == 0) *z = az + shift_sum;
}

// the backward recursion of one utterance on one warp: beta rows len-1..0
// into be_b; step t takes the emissions of frame t+1, loaded PREFETCH steps
// ahead as in forward_chain
template <typename T, int K>
__device__ __forceinline__ void backward_chain(const T* __restrict__ lam_b, const T (&tw0)[K],
                                               const T (&tw1)[K], const T (&tw2)[K],
                                               const bool (&valid)[K], const int (&col)[K],
                                               int lane, int len, int al, int A, T* be_b) {
  if (len <= 0) return;
  const T NB = neg_big<T>();
  T beta[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    beta[k] = (lane * K + k == al - 1 && lane * K + k < A) ? T(0) : NB;
    if (lane * K + k < A) be_b[(size_t)(len - 1) * A + lane * K + k] = beta[k];
  }
  constexpr int PREFETCH = prefetch<T>();
  T ring[PREFETCH][K];  // ring[d]: the emissions of step s0 + d, frame len-1 - (s0 + d)
#pragma unroll
  for (int d = 0; d < PREFETCH; ++d)
#pragma unroll
    for (int k = 0; k < K; ++k)
      ring[d][k] = len > 1 ? lam_b[(size_t)max(len - 1 - d, 0) * A + col[k]] : T(0);
  for (int s0 = 0; s0 < len - 1; s0 += PREFETCH) {
#pragma unroll
    for (int d = 0; d < PREFETCH; ++d) {
      const int t = len - 2 - (s0 + d);
      if (t < 0) break;
      T term[K], v1[K], v2[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        term[k] = beta[k] + ring[d][k];
        v1[k] = term[k] + tw1[k];
        v2[k] = term[k] + tw2[k];
        ring[d][k] = lam_b[(size_t)max(t + 1 - PREFETCH, 0) * A + col[k]];
      }
      // positions a+1 and a+2 of the lane's last positions: the lanes above
      const T dn1 = __shfl_down_sync(FULL, v1[0], 1);
      const T dn2_first = __shfl_down_sync(FULL, v2[0], 1);
      const T dn2 = K >= 2 ? __shfl_down_sync(FULL, v2[K >= 2 ? 1 : 0], 1)
                           : __shfl_down_sync(FULL, v2[0], 2);
      T nb[K];
      T m = minus_inf<T>();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int a = lane * K + k;
        const T n1 = k + 1 < K ? v1[k + 1 < K ? k + 1 : 0] : dn1;
        const T n2 = k + 2 < K ? v2[k + 2 < K ? k + 2 : 0] : (k + 2 == K ? dn2_first : dn2);
        const T b0 = term[k] + tw0[k];
        const T b1 = a + 1 < A ? n1 : NB;
        const T b2 = a + 2 < A ? n2 : NB;
        // formed for every position and then selected, as in forward_chain:
        // `valid ? lse3(...) : NB` compiles to a branch a position, which
        // runs a lane's K positions one after another
        const T v = lse3(b0, b1, b2);
        nb[k] = valid[k] ? v : NB;
        if (a < A) m = t_max(m, nb[k]);
      }
      const T shift = row_shift(keys::warp_maximum(m));
#pragma unroll
      for (int k = 0; k < K; ++k) {
        beta[k] = renorm(nb[k], shift);
        if (lane * K + k < A) be_b[(size_t)t * A + lane * K + k] = beta[k];
      }
    }
  }
}

// two warps an utterance: chain0 + warp index selects the recursion (0
// forward, 1 backward); the production launch has both warps and chain0 0,
// sr_forward_backward_chain one warp and the chain it times. A minimum of
// one block an SM lets ptxas pass 128 registers (it holds the double
// instance there otherwise); B 256 needs two an SM
template <typename T, int K>
__global__ void __launch_bounds__(64, 1)
fb_chain_kernel(const T* __restrict__ lams, const T* __restrict__ ltdp,
                const unsigned char* __restrict__ pos_valid, const int* __restrict__ feat_len,
                const int* __restrict__ aut_len, T* __restrict__ gamma, T* __restrict__ log_z,
                T* __restrict__ beta, int Tn, int A, int chain0) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int len = min(max(feat_len[b], 0), Tn);
  const int al = aut_len[b];
  const size_t urow = (size_t)b * A;
  T tw0[K], tw1[K], tw2[K];
  bool valid[K];
  int col[K];
  lane_tables<T, K>(ltdp, pos_valid, urow, lane, A, tw0, tw1, tw2, valid, col);
  const T* lam_b = lams + (size_t)b * Tn * A;
  if (chain0 + (int)(threadIdx.x >> 5) == 0)
    forward_chain<T, K>(lam_b, tw0, tw1, tw2, valid, col, lane, len, al, A,
                        gamma + (size_t)b * Tn * A, log_z + b);
  else
    backward_chain<T, K>(lam_b, tw0, tw1, tw2, valid, col, lane, len, al, A,
                         beta + (size_t)b * Tn * A);
}

// -- the two chains of W warps (96 < A <= 1024) --------------------------------------

constexpr int WIDE_WARPS = 8;  // warps a chain, at most

// positions a lane (2-4) and warps a chain (2-8) of the wide chains: at most
// 256 positions take 2 a lane, longer rows 3 or 4, so that a chain's warps
// stay at most 8. Fewer a lane is not faster: on an H100 (B 130, T 1,105, A
// 303) one position a lane on 10 warps took 1.71 / 2.95 ms (f32 / f64), two
// on 5 1.42 / 2.78 ms
__host__ __device__ __forceinline__ int wide_k(int A) {
  const int k = (A + 8 * 32 - 1) / (8 * 32);
  return k < 2 ? 2 : k;
}

__host__ __device__ __forceinline__ int wide_warps(int A) {
  const int k = wide_k(A);
  return (A + 32 * k - 1) / (32 * k);
}

// the larger of two row maxima as keys::warp_maximum orders them (exact)
template <typename T>
__device__ __forceinline__ T key_max(T a, T b) {
  return keys::order_key(b) > keys::order_key(a) ? b : a;
}

// what a warp of a wide chain publishes a frame: its row maximum and the raw
// cells of its two positions at the edge that the neighbouring warp reads
// (the forward chain's last two, the backward chain's first two)
template <typename T>
struct EdgePub {
  T max, c0, c1;
};

// the row's shift from the W warps' published maxima, folded in warp order
template <typename T>
__device__ __forceinline__ T wide_shift(const EdgePub<T>* pub, int W) {
  T m = pub[0].max;
  for (int v = 1; v < W; ++v) m = key_max(m, pub[v].max);
  return row_shift(m);
}

// the forward recursion of one utterance on the block's W warps, K
// consecutive positions a lane (position a = (w*32 + lane)*K + k): the
// lanes below give a-1 and a-2 by shuffles, lane 0 reads them from the
// shadow of the previous warp's last two positions, which every lane
// renormalises from the raw cells that warp publishes (bit for bit the
// owner's); one barrier a frame. Alpha rows 0..len-1 into g_b, log_z into *z
template <typename T, int K>
__device__ __forceinline__ void forward_chain_wide(const T* __restrict__ lam_b, const T (&tw0)[K],
                                                   const T (&tw1)[K], const T (&tw2)[K],
                                                   const bool (&valid)[K], const int (&col)[K],
                                                   int warp, int lane, int W, int len, int al,
                                                   int A, T* g_b, T* z,
                                                   EdgePub<T> (*pub)[WIDE_WARPS]) {
  const T NB = neg_big<T>();
  const int a0 = (warp * 32 + lane) * K;
  T alpha[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    alpha[k] = (a0 + k == 0 && valid[k]) ? lam_b[0] : NB;
    if (len > 0 && a0 + k < A) g_b[a0 + k] = alpha[k];
  }
  T sh1 = NB, sh2 = NB;  // alpha of positions warp*32*K - 1 and - 2
  T shift_sum = T(0);
  constexpr int PREFETCH = prefetch<T>();
  T ring[PREFETCH][K];  // ring[d]: the emissions of frame t0 + d
#pragma unroll
  for (int d = 0; d < PREFETCH; ++d)
#pragma unroll
    for (int k = 0; k < K; ++k)
      ring[d][k] = len > 1 ? lam_b[(size_t)min(1 + d, len - 1) * A + col[k]] : T(0);
  for (int t0 = 1; t0 < len; t0 += PREFETCH) {
#pragma unroll
    for (int d = 0; d < PREFETCH; ++d) {
      const int t = t0 + d;
      if (t >= len) break;
      T lam_t[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        lam_t[k] = ring[d][k];
        ring[d][k] = lam_b[(size_t)min(t + PREFETCH, len - 1) * A + col[k]];
      }
      const T below1 = __shfl_up_sync(FULL, alpha[K - 1], 1);
      const T below2 = __shfl_up_sync(FULL, alpha[K - 2], 1);
      const T up1 = lane == 0 ? sh1 : below1;
      const T up2 = lane == 0 ? sh2 : below2;
      T nw[K];
      T m = minus_inf<T>();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int a = a0 + k;
        const T p1 = k >= 1 ? alpha[k >= 1 ? k - 1 : 0] : up1;
        const T p2 = k >= 2 ? alpha[k >= 2 ? k - 2 : 0] : (k == 1 ? up1 : up2);
        const T c0 = alpha[k] + tw0[k];
        const T c1 = a >= 1 ? p1 + tw1[k] : NB;
        const T c2 = a >= 2 ? p2 + tw2[k] : NB;
        const T v = lse3(c0, c1, c2) + lam_t[k];
        nw[k] = valid[k] ? v : NB;
        if (a < A) m = t_max(m, nw[k]);
      }
      m = keys::warp_maximum(m);
      EdgePub<T>* p = pub[t & 1];
      if (lane == 0) p[warp].max = m;
      if (lane == 31) {
        p[warp].c0 = nw[K - 2];
        p[warp].c1 = nw[K - 1];
      }
      __syncthreads();  // the maxima and the edge cells are visible
      const T shift = wide_shift(p, W);
      if (warp > 0) {
        sh2 = renorm(p[warp - 1].c0, shift);
        sh1 = renorm(p[warp - 1].c1, shift);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        alpha[k] = renorm(nw[k], shift);
        if (a0 + k < A) g_b[(size_t)t * A + a0 + k] = alpha[k];
      }
      shift_sum = shift_sum + shift;
    }
  }
  // log_z: alpha at (len-1, aut_len-1) plus the shifts, by its owner
  const int fz = min(max(al - 1 < 0 ? al - 1 + A : al - 1, 0), A - 1);
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (a0 + k == fz) *z = alpha[k] + shift_sum;
}

// the backward recursion of one utterance on the block's W warps, K
// positions a lane: the lanes above give a+1 and a+2 by shuffles, lane 31
// forms them from the shadow of the next warp's first two positions (their
// beta renormalised from the raw cells that warp publishes, their emissions
// and transitions its own); one barrier a frame. Beta rows len-1..0 into
// be_b
template <typename T, int K>
__device__ __forceinline__ void backward_chain_wide(const T* __restrict__ lam_b,
                                                    const T* __restrict__ ltdp_b,
                                                    const T (&tw0)[K], const T (&tw1)[K],
                                                    const T (&tw2)[K], const bool (&valid)[K],
                                                    const int (&col)[K], int warp, int lane, int W,
                                                    int len, int al, int A, T* be_b,
                                                    EdgePub<T> (*pub)[WIDE_WARPS]) {
  if (len <= 0) return;
  const T NB = neg_big<T>();
  const int a0 = (warp * 32 + lane) * K;
  T beta[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    beta[k] = (a0 + k == al - 1 && a0 + k < A) ? T(0) : NB;
    if (a0 + k < A) be_b[(size_t)(len - 1) * A + a0 + k] = beta[k];
  }
  // the shadow: positions (warp+1)*32*K and + 1, the next warp's first two
  const int n0 = (warp + 1) * 32 * K, n1 = n0 + 1;
  const int sc0 = min(n0, A - 1), sc1 = min(n1, A - 1);
  T shb0 = (n0 == al - 1 && n0 < A) ? T(0) : NB;
  T shb1 = (n1 == al - 1 && n1 < A) ? T(0) : NB;
  const T stw1_0 = ltdp_b[(size_t)sc0 * 3 + 1], stw2_0 = ltdp_b[(size_t)sc0 * 3 + 2];
  const T stw2_1 = ltdp_b[(size_t)sc1 * 3 + 2];
  constexpr int PREFETCH = prefetch<T>();
  // ring[d]: the emissions of step s0 + d (frame len-1 - (s0 + d)), the
  // lane's K columns and the shadow's two
  T ring[PREFETCH][K + 2];
#pragma unroll
  for (int d = 0; d < PREFETCH; ++d) {
    const size_t row = (size_t)max(len - 1 - d, 0) * A;
#pragma unroll
    for (int k = 0; k < K; ++k) ring[d][k] = len > 1 ? lam_b[row + col[k]] : T(0);
    ring[d][K] = len > 1 ? lam_b[row + sc0] : T(0);
    ring[d][K + 1] = len > 1 ? lam_b[row + sc1] : T(0);
  }
  for (int s0 = 0; s0 < len - 1; s0 += PREFETCH) {
#pragma unroll
    for (int d = 0; d < PREFETCH; ++d) {
      const int t = len - 2 - (s0 + d);
      if (t < 0) break;
      const size_t nx = (size_t)max(t + 1 - PREFETCH, 0) * A;
      T term[K], v1[K], v2[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        term[k] = beta[k] + ring[d][k];
        v1[k] = term[k] + tw1[k];
        v2[k] = term[k] + tw2[k];
        ring[d][k] = lam_b[nx + col[k]];
      }
      const T sterm0 = shb0 + ring[d][K];
      const T sterm1 = shb1 + ring[d][K + 1];
      ring[d][K] = lam_b[nx + sc0];
      ring[d][K + 1] = lam_b[nx + sc1];
      // positions a+1 and a+2 of the lane's last positions: the lanes above,
      // or the shadow
      const T above1 = __shfl_down_sync(FULL, v1[0], 1);
      const T above2_first = __shfl_down_sync(FULL, v2[0], 1);
      const T above2 = __shfl_down_sync(FULL, v2[1], 1);
      const T dn1 = lane == 31 ? sterm0 + stw1_0 : above1;
      const T dn2_first = lane == 31 ? sterm0 + stw2_0 : above2_first;
      const T dn2 = lane == 31 ? sterm1 + stw2_1 : above2;
      T nb[K];
      T m = minus_inf<T>();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int a = a0 + k;
        const T n1v = k + 1 < K ? v1[k + 1 < K ? k + 1 : 0] : dn1;
        const T n2v = k + 2 < K ? v2[k + 2 < K ? k + 2 : 0] : (k + 2 == K ? dn2_first : dn2);
        const T b0 = term[k] + tw0[k];
        const T b1 = a + 1 < A ? n1v : NB;
        const T b2 = a + 2 < A ? n2v : NB;
        const T v = lse3(b0, b1, b2);
        nb[k] = valid[k] ? v : NB;
        if (a < A) m = t_max(m, nb[k]);
      }
      m = keys::warp_maximum(m);
      EdgePub<T>* p = pub[t & 1];
      if (lane == 0) {
        p[warp].max = m;
        p[warp].c0 = nb[0];
        p[warp].c1 = nb[1];
      }
      __syncthreads();  // the maxima and the edge cells are visible
      const T shift = wide_shift(p, W);
      if (warp + 1 < W) {
        shb0 = renorm(p[warp + 1].c0, shift);
        shb1 = renorm(p[warp + 1].c1, shift);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        beta[k] = renorm(nb[k], shift);
        if (a0 + k < A) be_b[(size_t)t * A + a0 + k] = beta[k];
      }
    }
  }
}

// a block of W warps a chain and utterance: blockIdx.y + chain0 selects the
// recursion (0 forward, 1 backward); the production launch has both chains
// (grid [B, 2], chain0 0), sr_forward_backward_chain one and the chain it
// times
template <typename T, int K>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
fb_wide_chain_kernel(const T* __restrict__ lams, const T* __restrict__ ltdp,
                     const unsigned char* __restrict__ pos_valid,
                     const int* __restrict__ feat_len, const int* __restrict__ aut_len,
                     T* __restrict__ gamma, T* __restrict__ log_z, T* __restrict__ beta, int Tn,
                     int A, int chain0) {
  __shared__ EdgePub<T> s_pub[2][WIDE_WARPS];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int W = blockDim.x >> 5;
  const int len = min(max(feat_len[b], 0), Tn);
  const int al = aut_len[b];
  const size_t urow = (size_t)b * A;
  T tw0[K], tw1[K], tw2[K];
  bool valid[K];
  int col[K];
  lane_tables<T, K>(ltdp, pos_valid, urow, warp * 32 + lane, A, tw0, tw1, tw2, valid, col);
  const T* lam_b = lams + (size_t)b * Tn * A;
  if (chain0 + (int)blockIdx.y == 0)
    forward_chain_wide<T, K>(lam_b, tw0, tw1, tw2, valid, col, warp, lane, W, len, al, A,
                             gamma + (size_t)b * Tn * A, log_z + b, s_pub);
  else
    backward_chain_wide<T, K>(lam_b, ltdp + urow * 3, tw0, tw1, tw2, valid, col, warp, lane, W,
                              len, al, A, beta + (size_t)b * Tn * A, s_pub);
}

// the posterior rows: block (x, y) takes POST_TILE consecutive rows of
// utterance y (and of y + gridDim.y, ...), a warp POST_ROWS of them, all
// loaded before any is reduced; feat_len is read once a block and
// utterance, and rows at or past it load nothing. Row t of utterance b
// holds alpha in gamma, which it overwrites, and beta in beta. Per row the
// operations and order of the plain version (and of warp_posterior): post
// = alpha + beta, its maximum floored at NEG_BIG/2, the exponentials, the
// fixed-order sum, the division; 0 for rows at or past feat_len
template <typename T, int K>
__global__ void __launch_bounds__(POST_THREADS)
fb_posterior_kernel(T* __restrict__ gamma, const T* __restrict__ beta,
                    const int* __restrict__ feat_len, int B, int Tn, int A) {
  const T HALF = half_neg_big<T>();
  const int lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * POST_TILE + (int)(threadIdx.x >> 5) * POST_ROWS;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const int len = min(max(feat_len[b], 0), Tn);
    T* g_b = gamma + (size_t)b * Tn * A;
    const T* be_b = beta + (size_t)b * Tn * A;
    T post[POST_ROWS][K];
#pragma unroll
    for (int i = 0; i < POST_ROWS; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int a = lane * K + k;
        const size_t x = (size_t)(t0 + i) * A + a;
        post[i][k] = (t0 + i < len && a < A) ? g_b[x] + be_b[x] : minus_inf<T>();
      }
#pragma unroll
    for (int i = 0; i < POST_ROWS; ++i) {
      const int t = t0 + i;
      if (t >= Tn) break;
      T* g = g_b + (size_t)t * A;
      if (t >= len) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (lane * K + k < A) g[lane * K + k] = T(0);
        continue;
      }
      T m = minus_inf<T>();
#pragma unroll
      for (int k = 0; k < K; ++k) m = t_max(m, post[i][k]);
      const T safe = t_max(keys::warp_maximum(m), HALF);
      T p[K];
#pragma unroll
      for (int k = 0; k < K; ++k) p[k] = post[i][k] > HALF ? t_exp(post[i][k] - safe) : T(0);
      T s = p[0];
#pragma unroll
      for (int k = 1; k < K; ++k) s = s + p[k];
      const T den = t_max(warp_tree_sum(s), T(1e-30));
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane * K + k < A) g[lane * K + k] = p[k] / den;
    }
  }
}

// the block's maximum of v; red holds a value a warp (at least 32)
template <typename T>
__device__ __forceinline__ T block_max(T v, T* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = t_max(r, red[w]);
  return r;
}

// the posterior row of the block instance: beta in row, alpha in g (the row
// of gamma, each thread's own positions), the exponentials staged in prow
template <typename T>
__device__ void block_posterior(const T* row, T* prow, T* g, int A, T* red, T* sum) {
  const T HALF = half_neg_big<T>();
  T m = minus_inf<T>();
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const T post = g[a] + row[a];
    prow[a] = post;
    m = t_max(m, post);
  }
  const T safe = t_max(block_max(m, red), HALF);
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const T post = prow[a];
    prow[a] = post > HALF ? t_exp(post - safe) : T(0);
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // the fixed order: 32 chunks of K positions, then the butterfly
    const int K = (A + 31) / 32;
    const int a0 = threadIdx.x * K;
    T s = a0 < A ? prow[a0] : T(0);
    for (int k = 1; k < K; ++k) s = s + (a0 + k < A ? prow[a0 + k] : T(0));
    s = warp_tree_sum(s);
    if (threadIdx.x == 0) *sum = s;
  }
  __syncthreads();
  const T den = t_max(*sum, T(1e-30));
  for (int a = threadIdx.x; a < A; a += blockDim.x) g[a] = prow[a] / den;
}

// one block an utterance; lat [3][A]: the alpha / beta row double-buffered
// by frame parity and the posterior's row, in shared memory where scratch
// is null, else the utterance's part of the device scratch [B][3][A] (not
// restrict: the threads read one another's writes after __syncthreads)
template <typename T>
__global__ void __launch_bounds__(BLOCK_THREADS)
fb_block_kernel(const T* __restrict__ lams, const T* __restrict__ ltdp,
                const unsigned char* __restrict__ pos_valid, const int* __restrict__ feat_len,
                const int* __restrict__ aut_len, T* gamma, T* __restrict__ log_z, T* scratch,
                int Tn, int A) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  __shared__ T s_red[2][BLOCK_THREADS / 32];
  __shared__ T s_sum;
  const int b = blockIdx.x;
  const T NB = neg_big<T>();
  const int len = min(max(feat_len[b], 0), Tn);
  const int al = aut_len[b];
  const size_t urow = (size_t)b * A;
  const T* lam_b = lams + (size_t)b * Tn * A;
  T* g_b = gamma + (size_t)b * Tn * A;
  T* lat = scratch != nullptr ? scratch + 3 * urow : reinterpret_cast<T*>(smem_raw);
  T* prow = lat + 2 * (size_t)A;
  auto valid = [&](int a) { return pos_valid[urow + a] != 0; };
  auto tw = [&](int a, int j) { return ltdp[(urow + a) * 3 + j]; };

  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const T v = (a == 0 && valid(a)) ? lam_b[0] : NB;
    lat[a] = v;
    if (len > 0) g_b[a] = v;
  }
  __syncthreads();
  T shift_sum = T(0);  // the same in every thread
  int buf = 0;
  for (int t = 1; t < len; ++t) {
    const T* cur = lat + (size_t)buf * A;
    T* nxt = lat + (size_t)(buf ^ 1) * A;
    T m = minus_inf<T>();
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
      const T c0 = cur[a] + tw(a, 0);
      const T c1 = a >= 1 ? cur[a - 1] + tw(a, 1) : NB;
      const T c2 = a >= 2 ? cur[a - 2] + tw(a, 2) : NB;
      const T v = lse3(c0, c1, c2) + lam_b[(size_t)t * A + a];
      nxt[a] = valid(a) ? v : NB;
      m = t_max(m, nxt[a]);
    }
    const T shift = row_shift(block_max(m, s_red[0]));
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
      const T v = renorm(nxt[a], shift);
      nxt[a] = v;
      g_b[(size_t)t * A + a] = v;
    }
    shift_sum = shift_sum + shift;
    __syncthreads();  // the new row is visible; the maxima may be rewritten
    buf ^= 1;
  }
  if (threadIdx.x == 0) {
    const int fz = min(max(al - 1 < 0 ? al - 1 + A : al - 1, 0), A - 1);
    log_z[b] = lat[(size_t)buf * A + fz] + shift_sum;
  }
  __syncthreads();  // the last alpha row is read before beta overwrites it

  if (len > 0) {
    T* last = lat + (size_t)buf * A;
    for (int a = threadIdx.x; a < A; a += blockDim.x) last[a] = a == al - 1 ? T(0) : NB;
    block_posterior(last, prow, g_b + (size_t)(len - 1) * A, A, s_red[1], &s_sum);
    for (int t = len - 2; t >= 0; --t) {
      const T* cur = lat + (size_t)buf * A;
      T* nxt = lat + (size_t)(buf ^ 1) * A;
      const T* lam1 = lam_b + (size_t)(t + 1) * A;
      T m = minus_inf<T>();
      for (int a = threadIdx.x; a < A; a += blockDim.x) {
        const T b0 = (cur[a] + lam1[a]) + tw(a, 0);
        const T b1 = a + 1 < A ? (cur[a + 1] + lam1[a + 1]) + tw(a + 1, 1) : NB;
        const T b2 = a + 2 < A ? (cur[a + 2] + lam1[a + 2]) + tw(a + 2, 2) : NB;
        nxt[a] = valid(a) ? lse3(b0, b1, b2) : NB;
        m = t_max(m, nxt[a]);
      }
      const T shift = row_shift(block_max(m, s_red[0]));
      for (int a = threadIdx.x; a < A; a += blockDim.x) nxt[a] = renorm(nxt[a], shift);
      // its barriers also make the new row visible to the next frame
      block_posterior(nxt, prow, g_b + (size_t)t * A, A, s_red[1], &s_sum);
      buf ^= 1;
    }
  }
  for (int t = len; t < Tn; ++t)
    for (int a = threadIdx.x; a < A; a += blockDim.x) g_b[(size_t)t * A + a] = T(0);
}

// K positions a lane of the two chains for A positions: 1-3 on one warp a
// chain (A <= 96), 2-4 on wide_warps(A) warps a chain (A <= 1024); past
// them -1, the block instance with its rows in device scratch
int instance_for(int A) {
  if (A <= WARP_POSITIONS) return (A + 31) / 32;
  return A <= SHARED_POSITIONS ? wide_k(A) : -1;
}

// warps a chain of that instance (0 past A = 1024: the block instance)
int warps_for(int A) {
  if (A <= WARP_POSITIONS) return 1;
  return A <= SHARED_POSITIONS ? wide_warps(A) : 0;
}

// the chains of A positions, both (chains 2, chain0 0) or one (chains 1,
// chain0 the chain): for A <= 96 a block of one warp a chain, two chains a
// block; past it a block of W warps a chain, the chain by blockIdx.y
template <typename T>
cudaError_t launch_chain_kernels(const T* lams, const T* ltdp, const unsigned char* pos_valid,
                                 const int* feat_len, const int* aut_len, T* gamma, T* log_z,
                                 T* beta, int B, int Tn, int A, int chains, int chain0,
                                 cudaStream_t st) {
#define SR_CHAIN(K)                                                                         \
  fb_chain_kernel<T, K><<<B, 32 * chains, 0, st>>>(lams, ltdp, pos_valid, feat_len, aut_len, \
                                                   gamma, log_z, beta, Tn, A, chain0)
#define SR_WIDE(K)                                                                          \
  fb_wide_chain_kernel<T, K><<<dim3(B, chains), 32 * wide_warps(A), 0, st>>>(              \
      lams, ltdp, pos_valid, feat_len, aut_len, gamma, log_z, beta, Tn, A, chain0)
  switch (A <= WARP_POSITIONS ? instance_for(A) : 4 + instance_for(A)) {
    case 1: SR_CHAIN(1); break;
    case 2: SR_CHAIN(2); break;
    case 3: SR_CHAIN(3); break;
    case 6: SR_WIDE(2); break;
    case 7: SR_WIDE(3); break;
    default: SR_WIDE(4);
  }
#undef SR_CHAIN
#undef SR_WIDE
  return cudaGetLastError();
}

// the posterior pass over every row: ceil(A/32) positions a lane, the
// row sum's order for any A up to 1024
template <typename T>
cudaError_t launch_posterior(T* gamma, const T* beta, const int* feat_len, int B, int Tn, int A,
                             cudaStream_t st) {
  const dim3 grid((Tn + POST_TILE - 1) / POST_TILE, B < 65535 ? B : 65535);
#define SR_POST(K)                                                                           \
  case K:                                                                                    \
    fb_posterior_kernel<T, K><<<grid, POST_THREADS, 0, st>>>(gamma, beta, feat_len, B, Tn, A); \
    break
  switch ((A + 31) / 32) {
    SR_POST(1); SR_POST(2); SR_POST(3); SR_POST(4); SR_POST(5); SR_POST(6); SR_POST(7);
    SR_POST(8); SR_POST(9); SR_POST(10); SR_POST(11); SR_POST(12); SR_POST(13); SR_POST(14);
    SR_POST(15); SR_POST(16); SR_POST(17); SR_POST(18); SR_POST(19); SR_POST(20);
    SR_POST(21); SR_POST(22); SR_POST(23); SR_POST(24); SR_POST(25); SR_POST(26);
    SR_POST(27); SR_POST(28); SR_POST(29); SR_POST(30); SR_POST(31); SR_POST(32);
    default: return cudaErrorInvalidValue;
  }
#undef SR_POST
  return cudaGetLastError();
}

template <typename T>
int launch(const T* lams, const T* ltdp, const unsigned char* pos_valid, const int* feat_len,
           const int* aut_len, T* gamma, T* log_z, T* scratch, T* beta, int B, int Tn, int A,
           int first_design, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Tn == 0 || A == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int inst = instance_for(A);
  if (inst > 0 && !first_design) {  // the two chains, then the posterior pass
    if (beta == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t e = launch_chain_kernels<T>(lams, ltdp, pos_valid, feat_len, aut_len, gamma,
                                            log_z, beta, B, Tn, A, 2, 0, st);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_posterior<T>(gamma, beta, feat_len, B, Tn, A, st);
  }
  // the first designs: a warp an utterance up to A = 96, past it the block
  // instance (its rows in shared memory up to A = 1024)
  switch (A <= WARP_POSITIONS ? inst : A <= SHARED_POSITIONS ? 0 : -1) {
    case 1:
      fb_warp_kernel<T, 1><<<B, 32, 0, st>>>(lams, ltdp, pos_valid, feat_len, aut_len, gamma,
                                             log_z, Tn, A);
      break;
    case 2:
      fb_warp_kernel<T, 2><<<B, 32, 0, st>>>(lams, ltdp, pos_valid, feat_len, aut_len, gamma,
                                             log_z, Tn, A);
      break;
    case 3:
      fb_warp_kernel<T, 3><<<B, 32, 0, st>>>(lams, ltdp, pos_valid, feat_len, aut_len, gamma,
                                             log_z, Tn, A);
      break;
    default: {
      if (inst < 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
      const int threads = A < BLOCK_THREADS ? (A + 31) / 32 * 32 : BLOCK_THREADS;
      const size_t smem = inst < 0 ? 0 : 3 * (size_t)A * sizeof(T);
      fb_block_kernel<T><<<B, threads, smem, st>>>(lams, ltdp, pos_valid, feat_len, aut_len,
                                                   gamma, log_z, inst < 0 ? scratch : nullptr,
                                                   Tn, A);
    }
  }
  return (int)cudaGetLastError();
}

// one chain (0 forward, 1 backward) of the two chains' instance alone (A <=
// 1024), for timing the chains apart
template <typename T>
int launch_chain(int chain, const T* lams, const T* ltdp, const unsigned char* pos_valid,
                 const int* feat_len, const int* aut_len, T* gamma, T* log_z, T* beta, int B,
                 int Tn, int A, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int inst = instance_for(A);
  if (inst <= 0 || (chain != 0 && chain != 1)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Tn == 0) return (int)cudaSuccess;
  return (int)launch_chain_kernels<T>(lams, ltdp, pos_valid, feat_len, aut_len, gamma, log_z,
                                      beta, B, Tn, A, 1, chain, (cudaStream_t)stream);
}

// blocks per SM of the launch for A positions (-1: error): for A <= 1024
// the chains' launch, or with first_design the first design's
template <typename T>
int residency(int A, int first_design) {
  int n = 0;
  cudaError_t err;
  const int inst = instance_for(A);
  if (inst > 0 && !first_design) {
    const int wt = 32 * warps_for(A);
    switch (A <= WARP_POSITIONS ? inst : 4 + inst) {
      case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_chain_kernel<T, 1>, 64, 0); break;
      case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_chain_kernel<T, 2>, 64, 0); break;
      case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_chain_kernel<T, 3>, 64, 0); break;
      case 6: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_wide_chain_kernel<T, 2>, wt, 0); break;
      case 7: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_wide_chain_kernel<T, 3>, wt, 0); break;
      default: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_wide_chain_kernel<T, 4>, wt, 0);
    }
    return err == cudaSuccess ? n : -1;
  }
  switch (A <= WARP_POSITIONS ? inst : A <= SHARED_POSITIONS ? 0 : -1) {
    case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_warp_kernel<T, 1>, 32, 0); break;
    case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_warp_kernel<T, 2>, 32, 0); break;
    case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_warp_kernel<T, 3>, 32, 0); break;
    default: {
      const int threads = A < BLOCK_THREADS ? (A + 31) / 32 * 32 : BLOCK_THREADS;
      const size_t smem = inst < 0 ? 0 : 3 * (size_t)A * sizeof(T);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fb_block_kernel<T>, threads, smem);
    }
  }
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// blocks per SM of kernel L's launch for A positions in float (f64 = 0) or
// double (-1: error); for A <= 1024 the two chains' launch (two warps a
// block up to A = 96, past it a chain a block), or the first design's with
// first_design != 0
extern "C" int sr_forward_backward_residency(int A, int f64, int first_design) {
  return f64 ? residency<double>(A, first_design) : residency<float>(A, first_design);
}

// the instance sr_forward_backward launches for A positions: positions a
// lane of the two chains (1-3 up to A = 96, 2-4 up to 1024, on
// sr_forward_backward_warps(A) warps a chain); the block instance with its
// rows in device scratch of 3*B*A scores (-1). The block instance with its
// rows in shared memory runs only as the first design, forced for 96 < A
// <= 1024.
extern "C" int sr_forward_backward_instance(int A) { return instance_for(A); }

// warps a chain of that instance: 1 up to A = 96, 2-8 up to 1024, 0 past it
extern "C" int sr_forward_backward_warps(int A) { return warps_for(A); }

// f64 selects double (else float) for lams, ltdp, gamma, log_z, scratch and
// beta. beta [B, T, A] holds the backward chain's rows for A <= 1024 (NULL
// otherwise, or with first_design != 0, which launches the first design
// for A <= 1024: a warp an utterance up to A = 96, past it the block
// instance with its rows in shared memory; it changes nothing past 1024);
// scratch as sr_forward_backward_instance says.
extern "C" int sr_forward_backward(int f64, const void* lams, const void* ltdp,
                                   const unsigned char* pos_valid, const int* feat_len,
                                   const int* aut_len, void* gamma, void* log_z, void* scratch,
                                   void* beta, int B, int T, int A, int first_design, int device,
                                   void* stream) {
  if (f64)
    return launch<double>((const double*)lams, (const double*)ltdp, pos_valid, feat_len, aut_len,
                          (double*)gamma, (double*)log_z, (double*)scratch, (double*)beta, B, T,
                          A, first_design, device, stream);
  return launch<float>((const float*)lams, (const float*)ltdp, pos_valid, feat_len, aut_len,
                       (float*)gamma, (float*)log_z, (float*)scratch, (float*)beta, B, T, A,
                       first_design, device, stream);
}

// chain 0 (the forward recursion: alpha rows into gamma, log_z) or 1 (the
// backward: beta rows into beta) of the two chains' instance (A <= 1024)
// alone, without the posterior pass: for timing the two chains apart
extern "C" int sr_forward_backward_chain(int f64, int chain, const void* lams, const void* ltdp,
                                         const unsigned char* pos_valid, const int* feat_len,
                                         const int* aut_len, void* gamma, void* log_z,
                                         void* beta, int B, int T, int A, int device,
                                         void* stream) {
  if (f64)
    return launch_chain<double>(chain, (const double*)lams, (const double*)ltdp, pos_valid,
                                feat_len, aut_len, (double*)gamma, (double*)log_z,
                                (double*)beta, B, T, A, device, stream);
  return launch_chain<float>(chain, (const float*)lams, (const float*)ltdp, pos_valid, feat_len,
                             aut_len, (float*)gamma, (float*)log_z, (float*)beta, B, T, A,
                             device, stream);
}
