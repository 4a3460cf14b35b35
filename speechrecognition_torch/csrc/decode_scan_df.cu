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
//   * invalid slots and hi >= BIG become (BIG, 0) (the kernel leaves the
//     second out: see slot_step); the utterance's
//     lexicographic minimum; renormalise with the hi >= BIG/2 guards; prune
//     where the score is not <= (threshold, 0);
//   * word ends at last_pos, on the renormalised and pruned scores: the
//     first word index attaining the minimum;
//   * the utterance freezes once t > feat_len (outputs are still written).
// Every step is an error-free transform, a lexicographic compare or a select
// written with round-to-nearest intrinsics, so the kernel matches its plain
// PyTorch version bit for bit. The minima are exact in any order.
//
// What bounds it: instruction issue. A frame of 1,024 utterances x 288
// slots needs 5 double-float adds a slot (about 117 FP32 instructions with
// the compares); the kernel issues about 1,000 instructions a lane and frame
// for its 3 slots (cuobjdump; about 420 of them float adds), and each frame
// also waits on its chain (the row minimum, the renormalisation, the word
// end that the next frame's entries read). Two instances, chosen in the C
// entry from the lattice's shape alone (sr_decode_scan_df_instance):
//   * P <= 32 and W <= 32 (SieTill: 12 x 24, the production path): one
//     block per utterance of ceil(W/4) warps; 8 lanes a word and K =
//     ceil(P/8) consecutive positions a lane, so a word's neighbours are
//     shuffles within its 8-lane group and the per-lane overhead is shared
//     by K slots. Every add is formed and missing candidates are replaced
//     after it, and the three candidate compares are independent, so the
//     selection has no branch. One __syncthreads a frame: before it each
//     warp publishes its exact minimum (a butterfly of shuffles) and the
//     owner of each word end its raw score and backpointer
//     (double-buffered by frame parity); after it every warp folds the
//     minima in the same order, renormalises its own slots, and chooses the
//     word end itself from the published raw scores (renormalised and
//     pruned by the same operations, then the first index at the minimum
//     by redux.sync on order-preserving keys), so the next frame's entries
//     need no second barrier. Each lane forms the entry of its group's
//     position min(l, 1) (the same warp instruction serves every lane);
//     each lane keeps the next PREFETCH frames' emissions in registers. At
//     80 registers a thread (launch bounds; a few values spill), 8
//     utterances of 96 threads fit an SM, so 1,024 utterances take one wave
//     on 132 SMs where the first design (one thread a slot, three
//     __syncthreads a frame, a serial word-end scan by thread 0) fit 4 of
//     its 288-thread blocks and took two.
//   * any other W x P: the block instance, one block of min(ceil(W*P/32)*32,
//     1024) threads per utterance, each looping over ceil(W*P/1024) slots,
//     two __syncthreads a frame, the word end by a block reduction of
//     (score, word) pairs; the lattice double-buffered by frame parity in
//     shared memory up to 1,024 slots (the query gives 0), beyond in device
//     scratch that the wrapper allocates (-1; 24,000 slots of df32 carry do
//     not fit a block's shared memory). Simple, not tuned.
// sr_decode_scan_df_residency gives the blocks an SM holds of the chosen
// instance's launch.
//
// A NaN score: the plain version's minima are doublefloat.min_axis,
// pairwise halving (positions first, then words; the first half against
// the second by df::minimum, an odd last element carried), and
// df::minimum keeps the second of a pair unless the first is strictly
// less. So a NaN survives only as the second of a pair, and a finite first
// of a pair whose second is NaN is lost: the result depends on where the
// NaNs lie, and is NaN exactly where the last element is. A row that holds
// a NaN (a cell whose hi is NaN; a NaN emission gives (NaN, NaN)) is
// therefore folded as the plain version folds it, by one thread through
// the halving in shared memory (or the scratch), after a second barrier;
// the word ends, when one is NaN, likewise (by shuffles in the warp
// instance), and the word is the first index whose end equals that
// minimum in both words, or 0 where none does (NaN equals nothing), as the
// plain version's argmax over its equality mask gives. Finite rows take
// the exact minimum in any order, as before.

#include <climits>
#include <cuda_runtime.h>

#include "df.cuh"
#include "keys.cuh"

namespace {

using df::DF;
using keys::order_key;

constexpr float BIG = 1e30f;
constexpr float HALF_BIG = BIG * 0.5f;  // exact in float32
constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 8;            // lanes a word in the warp instance
constexpr int WORDS_PER_WARP = 32 / GROUP;
constexpr int MAX_K = 4;            // positions a lane: P <= 32
constexpr int MAX_WARP_WORDS = 32;  // words of the warp instance: 8 warps
constexpr int PREFETCH = 2;         // frames of emissions in flight
constexpr int SHARED_SLOTS = 1024;   // the largest lattice the block instance keeps in shared memory
constexpr int BLOCK_THREADS = 1024;  // threads per utterance of the block instance, at most

__device__ __forceinline__ DF big() { return df::make(BIG, 0.f); }

__device__ __forceinline__ DF pair_df(float2 v) { return df::make(v.x, v.y); }

__device__ __forceinline__ bool nan_hi(DF v) { return v.hi != v.hi; }

// The plain version's pairwise halving (doublefloat.min_axis) of the n
// pairs in[0], in[stride], ..., by one thread, through buf (n/2 + n%2
// pairs; buf may be in when stride is 1): each stage takes df::minimum of
// the first half against the second and carries an odd last element.
// Within a stage, element i < n/2 is written after it and in[i + n/2] are
// read, and the carried one last, so the stages run in place in buf.
__device__ __noinline__ DF halving_min(const float2* in, int stride, int n, float2* buf) {
  if (n == 1) return pair_df(in[0]);
  int half = n >> 1;
  for (int i = 0; i < half; ++i) {
    const DF v = df::minimum(pair_df(in[(size_t)i * stride]),
                             pair_df(in[(size_t)(i + half) * stride]));
    buf[i] = make_float2(v.hi, v.lo);
  }
  if (n & 1) buf[half] = in[(size_t)(n - 1) * stride];
  for (n -= half; n > 1; n -= half) {
    half = n >> 1;
    for (int i = 0; i < half; ++i) {
      const DF v = df::minimum(pair_df(buf[i]), pair_df(buf[i + half]));
      buf[i] = make_float2(v.hi, v.lo);
    }
    if (n & 1) buf[half] = buf[n - 1];
  }
  return pair_df(buf[0]);
}

// the row minimum of the lattice row[W][P] as the plain version folds it:
// each word's positions (through fold, (P+1)/2 pairs) into wres[W], then
// the words (by one thread)
__device__ __noinline__ DF lattice_min(const float2* row, int W, int P, float2* fold,
                                       float2* wres) {
  for (int w = 0; w < W; ++w) {
    const DF v = halving_min(row + (size_t)w * P, 1, P, fold);
    wres[w] = make_float2(v.hi, v.lo);
  }
  return halving_min(wres, 1, W, wres);
}

// pairs of the NaN fold's buffers: a word's halving, then one pair a word
__host__ __device__ __forceinline__ size_t fold_pairs(int W, int P) {
  return (size_t)(P + 1) / 2 + W;
}

// the exact lexicographic (hi, lo) minimum over the warp (a butterfly of
// shuffles: on the card it was a little faster here than two redux.sync on
// order-preserving keys)
__device__ __forceinline__ DF warp_minimum(DF m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = df::minimum(m, df::make(__shfl_xor_sync(FULL, m.hi, o), __shfl_xor_sync(FULL, m.lo, o)));
  return m;
}

// within-word candidates, the selection, the emission and the entry of one
// slot, then the validity and BIG guards: the new score and backpointer
__device__ __forceinline__ DF slot_step(DF h, int bk, DF h1, int b1, DF h2, int b2, DF tw0,
                                        DF tw1, DF tw2, DF am, DF entry, int p, bool valid,
                                        int t, int& nb) {
  // every add is formed and the missing candidates replaced after it, and
  // the three compares are independent (c1 against c2, c0 against both),
  // so the selection is short and free of branches; it is the reference's
  // sequential one (start at c2, take c1, then c0, if strictly less)
  const DF c0 = df::add(h, tw0);
  DF c1 = df::add(h1, tw1);
  DF c2 = df::add(h2, tw2);
  if (p < 1) c1 = big();
  if (p < 2) c2 = big();
  const bool t1 = df::less(c1, c2);
  const bool t0 = t1 ? df::less(c0, c1) : df::less(c0, c2);
  DF within = t0 ? c0 : t1 ? c1 : c2;
  const int wb = t0 ? bk : t1 ? (p >= 1 ? b1 : 0) : (p >= 2 ? b2 : 0);
  within = df::add(within, am);
  DF nv;
  if (df::less_equal(entry, within)) {
    nv = entry;
    nb = t - 1;
  } else {
    nv = within;
    nb = wb;
  }
  // the reference also caps every score with hi >= BIG at (BIG, 0); the cap
  // is left out, because it changes no output: such a score is never a live
  // row's minimum (a dead row renormalises by 0 either way), renorm turns it
  // into (BIG, 0), and its backpointer is kept as the reference keeps it
  return valid ? nv : big();
}

// renormalisation by the row minimum (already 0 for a dead row) and pruning
__device__ __forceinline__ DF renorm(DF nv, DF best, DF thr, int prune) {
  nv = nv.hi >= HALF_BIG ? big() : df::sub(nv, best);
  if (prune && !df::less_equal(nv, thr)) nv = big();
  return nv;
}

// ---- the warp instance: 8 lanes a word, K positions a lane -------------------------

// per frame parity: each warp's minimum; each word end's raw score and
// backpointer
struct WarpShared {
  float2 wmin[2][MAX_WARP_WORDS / WORDS_PER_WARP];
  float2 end[2][MAX_WARP_WORDS];
  int endb[2][MAX_WARP_WORDS];
};

// dynamic shared memory: a NaN row [W][P], then the fold's buffers
template <int K>
__global__ void __launch_bounds__(256, 3) decode_scan_df_warp_kernel(
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
  __shared__ WarpShared s;
  __shared__ float2 s_best;
  extern __shared__ float2 s_row[];  // [W][P], then fold_pairs(W, P)
  const DF thr = df::make(am_threshold, 0.f);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = lane & (GROUP - 1);        // lane within the word's group
  const int w = warp * WORDS_PER_WARP + (lane >> 3);
  const bool wv = w < W;
  const int wc = wv ? w : 0;               // a word that exists, for loads
  const int WP = W * P;
  const size_t off = (size_t)b * WP;

  // per-slot constants; slot k of this lane is position p = l*K + k
  int st[K];
  DF tw0[K], tw1[K], tw2[K], h[K];
  int bk[K];
  unsigned valid = 0;                      // bit k: the slot is a valid position
  const int wlen = word_len[wc];
  const int end_k = wv ? last_pos[wc] - l * K : -1;  // the slot holding the word end
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = l * K + k;
    const bool real = wv && p < P;
    const int idx = wc * P + (real ? p : 0);
    st[k] = state_table[idx];
    tw0[k] = real ? df::make(tdp_hi[idx * 3 + 0], tdp_lo[idx * 3 + 0]) : big();
    tw1[k] = real ? df::make(tdp_hi[idx * 3 + 1], tdp_lo[idx * 3 + 1]) : big();
    tw2[k] = real ? df::make(tdp_hi[idx * 3 + 2], tdp_lo[idx * 3 + 2]) : big();
    h[k] = real ? df::make(hyp_hi_in[off + idx], hyp_lo_in[off + idx]) : big();
    bk[k] = real ? bkp_in[off + idx] : 0;
    if (real && p < wlen) valid |= 1u << k;
  }
  // lanes 0 and 1 of a group form the entries into positions 0 and 1
  const DF ep = df::make(ent_hi[wc * 2 + min(l, 1)], ent_lo[wc * 2 + min(l, 1)]);
  const int first = first_state[wc];
  DF book = df::make(book_hi_in[b], book_lo_in[b]);
  const int len = feat_len[b];

  // the emissions of frames i .. i+PREFETCH-1 (slot i % PREFETCH): the K
  // slots' states, then the word's first state
  const float* amh = am_hi + (size_t)b * T * S;
  const float* aml = am_lo + (size_t)b * T * S;
  float ring_hi[PREFETCH][K + 1], ring_lo[PREFETCH][K + 1];
#pragma unroll
  for (int q = 0; q < PREFETCH; ++q) {
    const size_t row = (size_t)q * S;
#pragma unroll
    for (int k = 0; k <= K; ++k) {
      const int sk = k < K ? st[k] : first;
      ring_hi[q][k] = q < T ? amh[row + sk] : 0.f;
      ring_lo[q][k] = q < T ? aml[row + sk] : 0.f;
    }
  }

  for (int i0 = 0; i0 < T; i0 += PREFETCH) {
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q) {
      const int i = i0 + q;
      if (i < T) {  // the same for the whole block
        const int t = t0 + i + 1;  // 1-based frame index
        const int par = i & 1;
        DF am[K + 1];
        const int row = min(i + PREFETCH, T - 1) * S;
        const float* rh = amh + row;
        const float* rl = aml + row;
#pragma unroll
        for (int k = 0; k <= K; ++k) {
          am[k] = df::make(ring_hi[q][k], ring_lo[q][k]);
          const int sk = k < K ? st[k] : first;
          ring_hi[q][k] = rh[sk];
          ring_lo[q][k] = rl[sk];
        }
        // the entry this lane forms (positions 0 and 1 are lanes 0 and 1's
        // own when K == 1; lane 0's slots 0 and 1 otherwise)
        const DF ent_own = df::add(df::add(book, ep), am[K]);
        const DF ent_next = df::make(__shfl_down_sync(FULL, ent_own.hi, 1, GROUP),
                                     __shfl_down_sync(FULL, ent_own.lo, 1, GROUP));
        // the two positions left of this lane's first slot: the lane below
        const DF left1 = df::make(__shfl_up_sync(FULL, h[K - 1].hi, 1, GROUP),
                                  __shfl_up_sync(FULL, h[K - 1].lo, 1, GROUP));
        const int left1b = __shfl_up_sync(FULL, bk[K - 1], 1, GROUP);
        const int d2 = K >= 2 ? 1 : 2;
        const DF src2 = K >= 2 ? h[K >= 2 ? K - 2 : 0] : h[0];
        const int src2b = K >= 2 ? bk[K >= 2 ? K - 2 : 0] : bk[0];
        const DF left2 = df::make(__shfl_up_sync(FULL, src2.hi, d2, GROUP),
                                  __shfl_up_sync(FULL, src2.lo, d2, GROUP));
        const int left2b = __shfl_up_sync(FULL, src2b, d2, GROUP);

        DF nv[K];
        int nb[K];
        DF m = big();
        bool nan_cell = false;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int p = l * K + k;
          const DF h1 = k >= 1 ? h[k - 1] : left1;
          const int b1 = k >= 1 ? bk[k - 1] : left1b;
          const DF h2 = k >= 2 ? h[k - 2] : (k == 1 ? left1 : left2);
          const int b2 = k >= 2 ? bk[k - 2] : (k == 1 ? left1b : left2b);
          const DF entry = p == 0 ? ent_own : p == 1 ? (K == 1 ? ent_own : ent_next) : big();
          nv[k] = slot_step(h[k], bk[k], h1, b1, h2, b2, tw0[k], tw1[k], tw2[k], am[k], entry, p,
                            (valid >> k) & 1u, t, nb[k]);
          m = df::minimum(m, nv[k]);
          nan_cell |= nan_hi(nv[k]);
          if (k == end_k) {
            s.end[par][w] = make_float2(nv[k].hi, nv[k].lo);
            s.endb[par][w] = nb[k];
          }
        }
        m = warp_minimum(m);
        // a warp whose cells hold a NaN publishes a NaN minimum
        if (__any_sync(FULL, nan_cell)) m = df::make(__int_as_float(0x7fffffff), 0.f);
        if (lane == 0) s.wmin[par][warp] = make_float2(m.hi, m.lo);
        __syncthreads();  // the minima and the raw word ends are visible

        DF best = df::make(s.wmin[par][0].x, s.wmin[par][0].y);
        bool nan_row = nan_hi(best);
#pragma unroll
        for (int v = 1; v < MAX_WARP_WORDS / WORDS_PER_WARP; ++v)
          if (v < nwarps) {
            const DF mv = df::make(s.wmin[par][v].x, s.wmin[par][v].y);
            best = df::minimum(best, mv);
            nan_row |= nan_hi(mv);
          }
        if (nan_row) {  // the same for the whole block: the plain version's fold
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (wv && l * K + k < P) s_row[w * P + l * K + k] = make_float2(nv[k].hi, nv[k].lo);
          __syncthreads();  // the row is visible
          if (threadIdx.x == 0) {
            const DF v = lattice_min(s_row, W, P, s_row + WP, s_row + WP + (P + 1) / 2);
            s_best = make_float2(v.hi, v.lo);
          }
          __syncthreads();  // its minimum is visible
          best = pair_df(s_best);
        }
        if (best.hi >= HALF_BIG) best = df::make(0.f, 0.f);

        // the word end, in every warp: lane j takes word j's published score
        // through the same renormalisation and pruning as its owner, then
        // the first index at the exact minimum
        const int j = min(lane, W - 1);
        const DF e = renorm(df::make(s.end[par][j].x, s.end[par][j].y), best, thr, prune);
        const int eb = s.endb[par][j];
        int bw;
        if (__any_sync(FULL, lane < W && nan_hi(e))) {
          // the plain version's halving over the words' ends, lane i
          // holding element i; then the first end equal to it, else 0
          DF f = e;
          for (int n = W; n > 1;) {
            const int half = n >> 1;
            const DF o = df::make(__shfl_down_sync(FULL, f.hi, half),
                                  __shfl_down_sync(FULL, f.lo, half));
            if (lane < half)
              f = df::minimum(f, o);
            else if (lane == half && (n & 1))
              f = o;
            n -= half;
          }
          const DF root = df::make(__shfl_sync(FULL, f.hi, 0), __shfl_sync(FULL, f.lo, 0));
          const unsigned eq = __ballot_sync(FULL, lane < W && e.hi == root.hi && e.lo == root.lo);
          bw = eq ? __ffs(eq) - 1 : 0;
        } else {
          const unsigned kh = lane < W ? order_key(e.hi) : FULL;
          const unsigned mh = __reduce_min_sync(FULL, kh);
          const unsigned kl = kh == mh ? order_key(e.lo) : FULL;
          const unsigned ml = __reduce_min_sync(FULL, kl);
          bw = (int)__reduce_min_sync(FULL, kh == mh && kl == ml ? (unsigned)lane : FULL);
        }
        DF bs = df::make(__shfl_sync(FULL, e.hi, bw), __shfl_sync(FULL, e.lo, bw));
        const int bb = __shfl_sync(FULL, eb, bw);
        if (bs.hi >= HALF_BIG) bs = big();
        if (threadIdx.x == 0) {
          score[(size_t)i * B + b] = bs.hi;
          word[(size_t)i * B + b] = bw;
          bkp[(size_t)i * B + b] = bb;
        }
        if (t <= len) {
          book = bs;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            h[k] = renorm(nv[k], best, thr, prune);
            bk[k] = nb[k];
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = l * K + k;
    if (wv && p < P) {
      const size_t o = off + (size_t)w * P + p;
      hyp_hi_out[o] = h[k].hi;
      hyp_lo_out[o] = h[k].lo;
      bkp_out[o] = bk[k];
    }
  }
  if (threadIdx.x == 0) {
    book_hi_out[b] = book.hi;
    book_lo_out[b] = book.lo;
  }
}

// ---- the block instance: any W*P, threads looping over the slots ------------------

// a word-end candidate: the renormalised score, its word and backpointer
struct End {
  DF v;
  int w, bk;
};

// (score, word) lexicographic: the smaller score, the smaller word on ties
__device__ __forceinline__ bool end_less(const End& a, const End& b) {
  return df::less(a.v, b.v) || (a.v.hi == b.v.hi && a.v.lo == b.v.lo && a.w < b.w);
}

__device__ __forceinline__ End shfl_end(const End& e, int o) {
  return End{df::make(__shfl_xor_sync(FULL, e.v.hi, o), __shfl_xor_sync(FULL, e.v.lo, o)),
             __shfl_xor_sync(FULL, e.w, o), __shfl_xor_sync(FULL, e.bk, o)};
}

// one block of min(ceil(W*P/32)*32, 1024) threads per utterance, thread x
// owning the slots x + k*blockDim.x; the lattice double-buffered by frame
// parity in lat_h / lat_b [2][W*P], and the NaN fold's buffers (fold_pairs
// pairs, then the word ends' pairs and backpointers, W each): shared memory
// where lat_h is null, else the utterance's part of the wrapper's device
// scratch (lat_h [B][2][W*P], lat_b [B][2][W*P], fold [B][fold_pairs + W],
// fold_b [B][W]; not restrict: the threads read one another's writes after
// __syncthreads)
__global__ void __launch_bounds__(BLOCK_THREADS) decode_scan_df_block_kernel(
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
    int* __restrict__ word, int* __restrict__ bkp, float2* lat_h, int* lat_b, float2* fold,
    int* fold_b, int B, int T, int S, int W, int P, int t0, float am_threshold, int prune) {
  extern __shared__ float2 smem[];
  __shared__ float2 s_wmin[BLOCK_THREADS / 32];
  __shared__ End s_wend[BLOCK_THREADS / 32];
  __shared__ float2 s_best;
  __shared__ End s_end;
  const DF thr = df::make(am_threshold, 0.f);
  const int b = blockIdx.x;
  const int nwarps = blockDim.x / 32;
  const int WP = W * P;
  const size_t off = (size_t)b * WP;
  const size_t fp = fold_pairs(W, P) + W;
  if (lat_h != nullptr) {
    lat_h += 2 * off;
    lat_b += 2 * off;
    fold += (size_t)b * fp;
    fold_b += (size_t)b * W;
  } else {
    lat_h = smem;
    fold = smem + 2 * WP;
    lat_b = reinterpret_cast<int*>(fold + fp);
    fold_b = lat_b + 2 * WP;
  }
  float2* const wres = fold + (P + 1) / 2;  // a pair a word
  float2* const ends = wres + W;           // the word ends' scores

  for (int s = threadIdx.x; s < WP; s += blockDim.x) {
    lat_h[s] = make_float2(hyp_hi_in[off + s], hyp_lo_in[off + s]);
    lat_b[s] = bkp_in[off + s];
  }
  DF book = df::make(book_hi_in[b], book_lo_in[b]);
  const int len = feat_len[b];
  __syncthreads();

  int buf = 0;
  for (int i = 0; i < T; ++i) {
    const int t = t0 + i + 1;  // 1-based frame index
    const float2* ch = lat_h + (size_t)buf * WP;
    const int* cb = lat_b + (size_t)buf * WP;
    float2* nh = lat_h + (size_t)(buf ^ 1) * WP;
    int* nbk = lat_b + (size_t)(buf ^ 1) * WP;
    const size_t row = ((size_t)b * T + i) * S;
    // (a) every slot's new score and backpointer, before the renormalisation
    DF m = big();
    int nan_seen = 0;
    for (int s = threadIdx.x; s < WP; s += blockDim.x) {
      const int w = s / P, p = s - w * P;
      const DF h1 = p >= 1 ? df::make(ch[s - 1].x, ch[s - 1].y) : big();
      const DF h2 = p >= 2 ? df::make(ch[s - 2].x, ch[s - 2].y) : big();
      const int b1 = p >= 1 ? cb[s - 1] : 0;
      const int b2 = p >= 2 ? cb[s - 2] : 0;
      const int fs = first_state[w];
      const DF entry = p < 2 ? df::add(df::add(book, df::make(ent_hi[w * 2 + p],
                                                              ent_lo[w * 2 + p])),
                                       df::make(am_hi[row + fs], am_lo[row + fs]))
                             : big();
      const int st = state_table[s];
      int nb;
      const DF nv = slot_step(df::make(ch[s].x, ch[s].y), cb[s], h1, b1, h2, b2,
                              df::make(tdp_hi[s * 3 + 0], tdp_lo[s * 3 + 0]),
                              df::make(tdp_hi[s * 3 + 1], tdp_lo[s * 3 + 1]),
                              df::make(tdp_hi[s * 3 + 2], tdp_lo[s * 3 + 2]),
                              df::make(am_hi[row + st], am_lo[row + st]), entry, p,
                              p < word_len[w], t, nb);
      nh[s] = make_float2(nv.hi, nv.lo);
      nbk[s] = nb;
      m = df::minimum(m, nv);
      nan_seen |= nan_hi(nv);
    }
    // a thread without a slot holds (BIG, 0), which every real row minimum
    // already is or undercuts
    m = warp_minimum(m);
    if ((threadIdx.x & 31) == 0) s_wmin[threadIdx.x >> 5] = make_float2(m.hi, m.lo);
    // the per-warp minima and the row are visible; a NaN row folds as the
    // plain version does
    DF best;
    if (__syncthreads_or(nan_seen)) {
      if (threadIdx.x == 0) {
        const DF v = lattice_min(nh, W, P, fold, wres);
        s_best = make_float2(v.hi, v.lo);
      }
      __syncthreads();  // its minimum is visible
      best = pair_df(s_best);
    } else {
      best = df::make(s_wmin[0].x, s_wmin[0].y);
      for (int k = 1; k < nwarps; ++k)
        best = df::minimum(best, df::make(s_wmin[k].x, s_wmin[k].y));
    }
    if (best.hi >= HALF_BIG) best = df::make(0.f, 0.f);

    // (b) each thread's own slots: renormalise, prune, offer the word ends
    const bool alive = t <= len;
    End e{df::make(__int_as_float(0x7f800000), 0.f), 0x7fffffff, 0};  // loses to every end
    int nan_end = 0;
    for (int s = threadIdx.x; s < WP; s += blockDim.x) {
      const int w = s / P;
      const DF nv = renorm(df::make(nh[s].x, nh[s].y), best, thr, prune);
      const End c{nv, w, nbk[s]};
      if (s - w * P == last_pos[w]) {
        if (end_less(c, e)) e = c;
        ends[w] = make_float2(nv.hi, nv.lo);
        fold_b[w] = c.bk;
        nan_end |= nan_hi(nv);
      }
      if (alive) {
        nh[s] = make_float2(nv.hi, nv.lo);
      } else {
        nh[s] = ch[s];
        nbk[s] = cb[s];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const End other = shfl_end(e, o);
      if (end_less(other, e)) e = other;
    }
    if ((threadIdx.x & 31) == 0) s_wend[threadIdx.x >> 5] = e;
    // the word ends and the new lattice are visible; where an end is NaN,
    // the plain version's halving over the ends, then the first end equal
    // to it, else word 0
    End be;
    if (__syncthreads_or(nan_end)) {
      if (threadIdx.x == 0) {
        const DF root = halving_min(ends, 1, W, wres);
        int bw = 0;
        for (int w = 0; w < W; ++w)
          if (ends[w].x == root.hi && ends[w].y == root.lo) {
            bw = w;
            break;
          }
        s_end = End{pair_df(ends[bw]), bw, fold_b[bw]};
      }
      __syncthreads();  // the chosen end is visible
      be = s_end;
    } else {
      be = s_wend[0];
      for (int k = 1; k < nwarps; ++k)
        if (end_less(s_wend[k], be)) be = s_wend[k];
    }
    DF bs = be.v.hi >= HALF_BIG ? big() : be.v;
    if (threadIdx.x == 0) {
      score[(size_t)i * B + b] = bs.hi;
      word[(size_t)i * B + b] = be.w;
      bkp[(size_t)i * B + b] = be.bk;
    }
    if (alive) book = bs;
    buf ^= 1;
  }

  for (int s = threadIdx.x; s < WP; s += blockDim.x) {
    const float2 v = lat_h[(size_t)buf * WP + s];
    hyp_hi_out[off + s] = v.x;
    hyp_lo_out[off + s] = v.y;
    bkp_out[off + s] = lat_b[(size_t)buf * WP + s];
  }
  if (threadIdx.x == 0) {
    book_hi_out[b] = book.hi;
    book_lo_out[b] = book.lo;
  }
}

// positions a lane of the warp instance (1-4); for the block instance 0
// (its lattice in shared memory) or -1 (in device scratch)
int instance_for(int W, int P) {
  if (P <= GROUP * MAX_K && W <= MAX_WARP_WORDS) return (P + GROUP - 1) / GROUP;
  return W * P <= SHARED_SLOTS ? 0 : -1;
}

// the warp instance's threads a block (4 words a warp), and the block
// instance's
int threads_for(int W, int P) {
  if (instance_for(W, P) > 0) return (W + WORDS_PER_WARP - 1) / WORDS_PER_WARP * 32;
  return W * P < BLOCK_THREADS ? (W * P + 31) / 32 * 32 : BLOCK_THREADS;
}

// the block instance's shared lattice: two buffers of (hi, lo) pairs, the
// NaN fold's pairs and the word ends' pairs, then two buffers of
// backpointers and the word ends' backpointers
size_t block_smem(int W, int P) {
  if (instance_for(W, P) != 0) return 0;
  return (2 * (size_t)W * P + fold_pairs(W, P) + W) * sizeof(float2)
         + (2 * (size_t)W * P + W) * sizeof(int);
}

// the warp instance's dynamic shared memory: a NaN row and the fold's pairs
size_t warp_smem(int W, int P) {
  return ((size_t)W * P + fold_pairs(W, P)) * sizeof(float2);
}

// floats of the block instance's device scratch an utterance (A > 1,024
// slots): the lattice's two buffers of pairs and two of backpointers, the
// fold's pairs and the word ends' pairs and backpointers
size_t scratch_floats(int W, int P) {
  return 6 * (size_t)W * P + 2 * (fold_pairs(W, P) + W) + W;
}

}  // namespace

extern "C" int sr_decode_scan_df_instance(int W, int P) { return instance_for(W, P); }

// floats of device scratch the block instance needs an utterance where the
// instance is -1 (-1: more than an int holds)
extern "C" int sr_decode_scan_df_scratch(int W, int P) {
  const size_t n = scratch_floats(W, P);
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

// threads a block of the chosen instance's launch for a W x P lattice
extern "C" int sr_decode_scan_df_threads(int W, int P) { return threads_for(W, P); }

extern "C" int sr_decode_scan_df(
    const float* am_hi, const float* am_lo, const int* feat_len,
    const int* state_table, const int* last_pos, const int* word_len,
    const int* first_state, const float* tdp_hi, const float* tdp_lo,
    const float* ent_hi, const float* ent_lo, const float* hyp_hi_in,
    const float* hyp_lo_in, const int* bkp_in, const float* book_hi_in,
    const float* book_lo_in, float* hyp_hi_out, float* hyp_lo_out,
    int* bkp_out, float* book_hi_out, float* book_lo_out, float* score,
    int* word, int* bkp, float* scratch, int B, int T, int S, int W, int P, int t0,
    float am_threshold, int prune, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || W == 0 || P == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int WP = W * P;
  const int inst = instance_for(W, P);
  const int threads = threads_for(W, P);
#define SR_ARGS                                                                     \
  am_hi, am_lo, feat_len, state_table, last_pos, word_len, first_state, tdp_hi,     \
      tdp_lo, ent_hi, ent_lo, hyp_hi_in, hyp_lo_in, bkp_in, book_hi_in, book_lo_in, \
      hyp_hi_out, hyp_lo_out, bkp_out, book_hi_out, book_lo_out, score, word, bkp
  switch (inst) {
    case 1: decode_scan_df_warp_kernel<1><<<B, threads, warp_smem(W, P), st>>>(SR_ARGS, B, T, S, W, P, t0, am_threshold, prune); break;
    case 2: decode_scan_df_warp_kernel<2><<<B, threads, warp_smem(W, P), st>>>(SR_ARGS, B, T, S, W, P, t0, am_threshold, prune); break;
    case 3: decode_scan_df_warp_kernel<3><<<B, threads, warp_smem(W, P), st>>>(SR_ARGS, B, T, S, W, P, t0, am_threshold, prune); break;
    case 4: decode_scan_df_warp_kernel<4><<<B, threads, warp_smem(W, P), st>>>(SR_ARGS, B, T, S, W, P, t0, am_threshold, prune); break;
    default: {
      // the lattice in shared memory (0) or in the scratch (-1): lat_h
      // [B][2][WP] pairs, lat_b [B][2][WP] ints, the fold's pairs, its ints
      if (inst < 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
      float2* lat = inst < 0 ? reinterpret_cast<float2*>(scratch) : nullptr;
      int* lat_b = inst < 0 ? reinterpret_cast<int*>(scratch) + 4 * (size_t)B * WP : nullptr;
      float2* fold = inst < 0 ? reinterpret_cast<float2*>(lat_b + 2 * (size_t)B * WP) : nullptr;
      int* fold_b = inst < 0 ? reinterpret_cast<int*>(fold + (size_t)B * (fold_pairs(W, P) + W))
                             : nullptr;
      decode_scan_df_block_kernel<<<B, threads, block_smem(W, P), st>>>(
          SR_ARGS, lat, lat_b, fold, fold_b, B, T, S, W, P, t0, am_threshold, prune);
    }
  }
#undef SR_ARGS
  return (int)cudaGetLastError();
}

// blocks of the chosen instance that one SM holds at once for a W x P
// lattice (the occupancy calculator's answer for the launch above), or -1
extern "C" int sr_decode_scan_df_residency(int W, int P) {
  int n = 0;
  const int threads = threads_for(W, P);
  cudaError_t err;
  switch (instance_for(W, P)) {
    case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_df_warp_kernel<1>, threads, warp_smem(W, P)); break;
    case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_df_warp_kernel<2>, threads, warp_smem(W, P)); break;
    case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_df_warp_kernel<3>, threads, warp_smem(W, P)); break;
    case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_df_warp_kernel<4>, threads, warp_smem(W, P)); break;
    default:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_df_block_kernel, threads,
                                                          block_smem(W, P));
  }
  return err == cudaSuccess ? n : -1;
}
