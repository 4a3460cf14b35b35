// Kernel D: the double-float word-loop Viterbi over one time chunk.
//
// Replaces speechrecognition_tpu/search/decoder.py::_decode_scan_df, the
// production (df32) decode scan that XLA fuses into one lax.scan. It is
// kernel B (decode_scan.cu) with every score a (hi, lo) float32 pair
// (df.cuh), so that path-score decisions follow the reference's float64
// (Recognizer.cpp:103-232) with float32 arithmetic only. Inputs: am_hi,
// am_lo [B, T, S]; feat_len [B]; the lexicon tables state_table [W, P],
// last_pos, word_len, first_state [W]; the TDP tables tdp [W, P, 3] and
// entry [W, 2] as hi and lo arrays split from float64 on the host (their
// BIG = 1e30 entries carry a non-zero lo, so they are not rebuilt here); the
// carried lattice (hyp hi/lo [B, W, P], bkp [B, W, P], book hi/lo [B]) and
// t0. It writes the carry after the chunk and, per frame, the best word end
// (score hi, word, backpointer), each [T, B].
//
// Per frame it follows _decode_scan_df step for step:
//   * within-word candidates c0 = hyp[s] + tdp[s,0], c1 = hyp[s-1] + tdp[s,1],
//     c2 = hyp[s-2] + tdp[s,2] (missing ones are (BIG, 0)); start at c2, take
//     c1 then c0 if strictly less (larger jumps win ties); add am[state];
//   * entries into positions 0 and 1: (book_prev + entry[w,p]) + am of the
//     word's FIRST state (the df32 reference's emission rule, decoder.py:290;
//     kernel B charges the entered position's state instead; the two agree
//     wherever positions 0 and 1 share a state, as in SieTill); entries win
//     ties (less_equal);
//   * invalid slots and hi >= BIG become (BIG, 0); the block-wide lexicographic
//     minimum; renormalise with the hi >= BIG/2 guards; prune where the score
//     is not <= (threshold, 0);
//   * word ends at last_pos, the first word index attaining the minimum;
//   * the utterance freezes once t > feat_len (outputs are still written).
// Every step is an error-free transform, a lexicographic compare or a select
// written with round-to-nearest intrinsics, so the kernel matches its plain
// PyTorch version bit for bit. The minimum is exact in any order, so the
// warp-shuffle reduction of both words keeps that property; the word choice
// is a serial first-index scan.
//
// What bounds it: latency, as for kernel B. A frame is three __syncthreads,
// two scattered reads of am and about a hundred FP32 instructions per thread
// (four DF adds and the compares); one block per utterance, one thread per
// (word, position) slot, the pairs double-buffered in shared memory.

#include <cuda_runtime.h>

#include "df.cuh"

namespace {

using df::DF;

__global__ void decode_scan_df_kernel(
    const float* __restrict__ am_hi, const float* __restrict__ am_lo,
    const int* __restrict__ feat_len, const int* __restrict__ state_table,
    const int* __restrict__ last_pos, const int* __restrict__ word_len,
    const int* __restrict__ first_state, const float* __restrict__ tdp_hi,
    const float* __restrict__ tdp_lo, const float* __restrict__ ent_hi,
    const float* __restrict__ ent_lo, const float* __restrict__ hyp_hi_in,
    const float* __restrict__ hyp_lo_in, const int* __restrict__ bkp_in,
    const float* __restrict__ book_hi_in, const float* __restrict__ book_lo_in,
    float* __restrict__ hyp_hi_out, float* __restrict__ hyp_lo_out,
    int* __restrict__ bkp_out, float* __restrict__ book_hi_out,
    float* __restrict__ book_lo_out, float* __restrict__ score,
    int* __restrict__ word, int* __restrict__ bkp, int B, int T, int S, int W,
    int P, int t0, float am_threshold, int prune) {
  const float BIG = 1e30f;
  const DF big = df::make(BIG, 0.f);
  const DF thr = df::make(am_threshold, 0.f);
  const int WP = W * P;
  const int nwarps = blockDim.x / 32;
  extern __shared__ float smem[];
  float* sh_hi = smem;                                   // [2][WP]
  float* sh_lo = sh_hi + 2 * WP;                         // [2][WP]
  int* sh_b = reinterpret_cast<int*>(sh_lo + 2 * WP);    // [2][WP]
  float* s_end_hi = reinterpret_cast<float*>(sh_b + 2 * WP);  // [W]
  float* s_end_lo = s_end_hi + W;                        // [W]
  int* s_endb = reinterpret_cast<int*>(s_end_lo + W);    // [W]
  float* s_wmin_hi = reinterpret_cast<float*>(s_endb + W);    // [32]
  float* s_wmin_lo = s_wmin_hi + 32;                     // [32]
  float* s_book = s_wmin_lo + 32;                        // [2]: hi, lo

  const int b = blockIdx.x;
  const int idx = threadIdx.x;
  const bool slot = idx < WP;
  const int w = slot ? idx / P : 0;
  const int p = slot ? idx - w * P : 0;

  // per-slot constants
  int st = 0, first = 0;
  DF tw0 = big, tw1 = big, tw2 = big, ep = big;
  bool valid = false, is_end = false;
  if (slot) {
    st = state_table[idx];
    first = first_state[w];
    tw0 = df::make(tdp_hi[idx * 3 + 0], tdp_lo[idx * 3 + 0]);
    tw1 = df::make(tdp_hi[idx * 3 + 1], tdp_lo[idx * 3 + 1]);
    tw2 = df::make(tdp_hi[idx * 3 + 2], tdp_lo[idx * 3 + 2]);
    valid = p < word_len[w];
    is_end = p == last_pos[w];
    if (p < 2) ep = df::make(ent_hi[w * 2 + p], ent_lo[w * 2 + p]);
  }

  const size_t off = (size_t)b * WP + idx;
  DF h = slot ? df::make(hyp_hi_in[off], hyp_lo_in[off]) : big;
  int bk = slot ? bkp_in[off] : 0;
  if (idx == 0) {
    s_book[0] = book_hi_in[b];
    s_book[1] = book_lo_in[b];
  }
  const int len = feat_len[b];
  const float half_big = BIG * 0.5f;
  const size_t am_off = (size_t)b * T * S;

  int buf = 0;
  for (int i = 0; i < T; ++i) {
    const int t = t0 + i + 1;  // 1-based frame index
    if (slot) {
      sh_hi[buf * WP + idx] = h.hi;
      sh_lo[buf * WP + idx] = h.lo;
      sh_b[buf * WP + idx] = bk;
    }
    __syncthreads();  // (1) hyp of frame t-1 and book_prev are visible
    const DF book_prev = df::make(s_book[0], s_book[1]);

    DF nv = big;
    int nb = 0;
    if (slot) {
      const size_t row = am_off + (size_t)i * S;
      const DF am_v = df::make(am_hi[row + st], am_lo[row + st]);
      const int q1 = buf * WP + idx - 1, q2 = q1 - 1;
      const DF c0 = df::add(h, tw0);
      const DF c1 = p >= 1 ? df::add(df::make(sh_hi[q1], sh_lo[q1]), tw1) : big;
      const DF c2 = p >= 2 ? df::add(df::make(sh_hi[q2], sh_lo[q2]), tw2) : big;
      const int b0 = p >= 1 ? sh_b[q1] : 0;
      const int b00 = p >= 2 ? sh_b[q2] : 0;
      DF within = c2;
      int wb = b00;
      if (df::less(c1, within)) { within = c1; wb = b0; }
      if (df::less(c0, within)) { within = c0; wb = bk; }
      within = df::add(within, am_v);
      DF entry = big;
      if (p < 2) {
        const DF am_first = df::make(am_hi[row + first], am_lo[row + first]);
        entry = df::add(df::add(book_prev, ep), am_first);
      }
      if (df::less_equal(entry, within)) {
        nv = entry;
        nb = t - 1;
      } else {
        nv = within;
        nb = wb;
      }
      if (!valid) nv = big;
      if (nv.hi >= BIG) nv = big;
    }

    // block-wide lexicographic minimum (exact in any order)
    DF m = nv;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const DF other = df::make(__shfl_xor_sync(0xffffffffu, m.hi, o),
                                __shfl_xor_sync(0xffffffffu, m.lo, o));
      m = df::minimum(m, other);
    }
    if ((idx & 31) == 0) {
      s_wmin_hi[idx >> 5] = m.hi;
      s_wmin_lo[idx >> 5] = m.lo;
    }
    __syncthreads();  // (2) per-warp minima are visible
    DF best = df::make(s_wmin_hi[0], s_wmin_lo[0]);
    for (int k = 1; k < nwarps; ++k)
      best = df::minimum(best, df::make(s_wmin_hi[k], s_wmin_lo[k]));
    if (best.hi >= half_big) best = df::make(0.f, 0.f);
    nv = nv.hi >= half_big ? big : df::sub(nv, best);
    if (prune && !df::less_equal(nv, thr)) nv = big;

    if (slot && is_end) {
      s_end_hi[w] = nv.hi;
      s_end_lo[w] = nv.lo;
      s_endb[w] = nb;
    }
    __syncthreads();  // (3) word-end scores are visible

    const bool alive = t <= len;
    if (idx == 0) {
      DF bs = df::make(s_end_hi[0], s_end_lo[0]);
      int bw = 0;
      for (int k = 1; k < W; ++k) {
        const DF e = df::make(s_end_hi[k], s_end_lo[k]);
        if (df::less(e, bs)) { bs = e; bw = k; }
      }
      const int bb = s_endb[bw];
      if (bs.hi >= half_big) bs = big;
      score[(size_t)i * B + b] = bs.hi;
      word[(size_t)i * B + b] = bw;
      bkp[(size_t)i * B + b] = bb;
      if (alive) {
        s_book[0] = bs.hi;
        s_book[1] = bs.lo;
      }
    }
    if (alive) {
      h = nv;
      bk = nb;
    }
    buf ^= 1;
  }

  if (slot) {
    hyp_hi_out[off] = h.hi;
    hyp_lo_out[off] = h.lo;
    bkp_out[off] = bk;
  }
  __syncthreads();
  if (idx == 0) {
    book_hi_out[b] = s_book[0];
    book_lo_out[b] = s_book[1];
  }
}

}  // namespace

extern "C" int sr_decode_scan_df(
    const float* am_hi, const float* am_lo, const int* feat_len,
    const int* state_table, const int* last_pos, const int* word_len,
    const int* first_state, const float* tdp_hi, const float* tdp_lo,
    const float* ent_hi, const float* ent_lo, const float* hyp_hi_in,
    const float* hyp_lo_in, const int* bkp_in, const float* book_hi_in,
    const float* book_lo_in, float* hyp_hi_out, float* hyp_lo_out,
    int* bkp_out, float* book_hi_out, float* book_lo_out, float* score,
    int* word, int* bkp, int B, int T, int S, int W, int P, int t0,
    float am_threshold, int prune, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaSuccess;
  const int WP = W * P;
  const int threads = (WP + 31) / 32 * 32;
  const size_t smem = (6 * (size_t)WP + 3 * (size_t)W + 66) * sizeof(float);
  decode_scan_df_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      am_hi, am_lo, feat_len, state_table, last_pos, word_len, first_state,
      tdp_hi, tdp_lo, ent_hi, ent_lo, hyp_hi_in, hyp_lo_in, bkp_in,
      book_hi_in, book_lo_in, hyp_hi_out, hyp_lo_out, bkp_out, book_hi_out,
      book_lo_out, score, word, bkp, B, T, S, W, P, t0, am_threshold, prune);
  return (int)cudaGetLastError();
}
