// Kernel J: the word-loop Viterbi with bigram LM recombination over a whole
// batch.
//
// Replaces speechrecognition_tpu/search/ngram_decoder.py::_decode_scan_bigram
// (one lax.scan that XLA fuses; op by op in PyTorch about 50 launches a
// frame). Same inputs and outputs: am [B, T, S], feat_len [B], the linear
// lexicon's tables (state_table [W, P], last_pos, word_len [W], tdp_within
// [W, P, 3], entry_tdp [W, 2]), the bigram lm [W, W] = -log p(w|v) and the
// start row lm_start [W]; it writes per frame and word the word-end book,
// its backpointer and its predecessor (-1: the sentence start), each
// [T, B, W], and the renormalisation offset [T, B] (0 once the utterance
// ended). A template on the score type (float, double).
//
// Per frame it follows the reference step exactly:
//   * every word's entry: the min-plus product min_v book_prev[v] + lm[v, w]
//     (the first v at the minimum), replaced by the start row at frame 1
//     only where that is strictly less;
//   * within-word candidates from s, s-1, s-2 (start at the jump-2 one, take
//     jump 1 if strictly less, then jump 0 if strictly less), carrying the
//     backpointer and the predecessor (0 and -1 left of position 0), plus the
//     emission; entries into positions 0 and 1 cost (entry + entry_tdp) plus
//     the ENTERED position's emission and win ties (<=); invalid positions
//     BIG; min(new, BIG);
//   * the frame's minimum; renormalise; prune new > am_threshold;
//   * every word's end at last_pos, capped at BIG from BIG/2;
//   * the utterance freezes once t > feat_len (outputs are still written).
// Rounded adds, compares and selects only: bit-equal to the plain version.
//
// What bounds it: the per-frame chain, not bytes (the bytes bound of a
// 1,024-utterance, 960-frame float32 batch is 0.17 ms). Two instances,
// chosen in the C entry from the shape alone (sr_decode_scan_bigram_instance):
//   * the warp instance (W <= 32 and P <= 32, SieTill's 12 x 24 in
//     both types), kernel B's layout: ceil(W/4) warps an utterance, 8 lanes
//     a word and ceil(P/8) consecutive positions a lane, a word's
//     neighbours by shuffles within its group; scores, backpointers and
//     predecessors in registers; each lane prefetches the next frames'
//     emissions into registers. One __syncthreads a frame: before it each
//     warp publishes its exact minimum and the owner of each word end its
//     raw score, backpointer and predecessor (double-buffered by frame
//     parity); after it every warp folds the minima in the same order,
//     renormalises and prunes its slots, rebuilds the books of its lanes'
//     predecessors by the owners' operations, and forms its words' entries
//     by the min-plus product in the 8-lane group (lane l takes the
//     predecessors l, l + 8, ..., the group's keyed argmin keeps the first
//     predecessor at the minimum; the LM in shared memory). Launch bounds
//     let 8 utterances of 96 threads share an SM: 1,024 in one wave. On an
//     NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 24, B 1,024,
//     T 960): 1.87 ms float32 (1.95 us a frame), 2.50 ms float64.
//   * the block instance (the first design; any other shape): one
//     block per utterance, threads looping over the W*P slots; the lattice
//     double-buffered in shared memory, or past search::SHARED_LIMIT in
//     device scratch (sr_decode_scan_bigram_scratch gives the bytes an
//     utterance); per frame the entries (W threads, each a serial min over
//     the W predecessors), the slots, the block minimum and the word ends:
//     3 barriers. On SieTill, forced, in the same run: 4.94 ms float32, 6.02
//     ms float64 (7 and 5 blocks an SM, 2 waves).

#include <cuda_runtime.h>

#include "search.cuh"

namespace {

using search::add;
using search::big;
using search::tmin;

// per utterance: hyp [2][WP] T, bkp [2][WP], pred [2][WP] int, book [W] T,
// entry [W] T, entry_pred [W] int
struct Layout {
  size_t hyp, bkp, pred, book, ent, entp, total;
  template <typename T>
  static Layout of(int W, int P) {
    const size_t WP = (size_t)W * P;
    Layout L;
    size_t o = 0;
    L.hyp = o; o += search::align16(2 * WP * sizeof(T));
    L.bkp = o; o += search::align16(2 * WP * sizeof(int));
    L.pred = o; o += search::align16(2 * WP * sizeof(int));
    L.book = o; o += search::align16(W * sizeof(T));
    L.ent = o; o += search::align16(W * sizeof(T));
    L.entp = o; o += search::align16(W * sizeof(int));
    L.total = o;
    return L;
  }
};

template <typename T>
__global__ void __launch_bounds__(search::MAX_THREADS) bigram_scan_kernel(
    const T* __restrict__ am, const int* __restrict__ feat_len,
    const int* __restrict__ state_table, const int* __restrict__ last_pos,
    const int* __restrict__ word_len, const T* __restrict__ tdpw, const T* __restrict__ entp,
    const T* __restrict__ lm, const T* __restrict__ lm_start, T* __restrict__ book_out,
    int* __restrict__ bkp_out, int* __restrict__ pred_out, T* __restrict__ offset,
    unsigned char* scratch, Layout L, int B, int Tn, int S, int W, int P, T thr, int prune) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_red[32];
  const T BIG = big<T>();
  const T HALF = BIG * T(0.5);
  const int b = blockIdx.x;
  const int WP = W * P;
  unsigned char* base = scratch != nullptr ? scratch + (size_t)b * L.total : smem;
  T* lat_h = reinterpret_cast<T*>(base + L.hyp);
  int* lat_b = reinterpret_cast<int*>(base + L.bkp);
  int* lat_p = reinterpret_cast<int*>(base + L.pred);
  T* s_book = reinterpret_cast<T*>(base + L.book);
  T* s_ent = reinterpret_cast<T*>(base + L.ent);
  int* s_entp = reinterpret_cast<int*>(base + L.entp);
  for (int s = threadIdx.x; s < WP; s += blockDim.x) {
    lat_h[s] = BIG;
    lat_b[s] = 0;
    lat_p[s] = -1;
  }
  for (int w = threadIdx.x; w < W; w += blockDim.x) s_book[w] = BIG;
  const int len = feat_len[b];
  __syncthreads();

  int buf = 0;
  for (int i = 0; i < Tn; ++i) {
    const int t = i + 1;  // 1-based frame index
    const bool alive = t <= len;
    const T* ch = lat_h + (size_t)buf * WP;
    const int* cb = lat_b + (size_t)buf * WP;
    const int* cp = lat_p + (size_t)buf * WP;
    T* nh = lat_h + (size_t)(buf ^ 1) * WP;
    int* nb = lat_b + (size_t)(buf ^ 1) * WP;
    int* np = lat_p + (size_t)(buf ^ 1) * WP;
    const T* am_t = am + ((size_t)b * Tn + i) * S;
    // (a) bigram recombination: each word's entry and predecessor
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      T rec = add(s_book[0], lm[w]);
      int rp = 0;
      for (int v = 1; v < W; ++v) {
        const T c = add(s_book[v], lm[(size_t)v * W + w]);
        if (search::takes(c, rec)) {
          rec = c;
          rp = v;
        }
      }
      const T start = t == 1 ? lm_start[w] : BIG;
      const bool take = start < rec;
      s_ent[w] = take ? start : rec;
      s_entp[w] = take ? -1 : rp;
    }
    __syncthreads();  // the entries are visible
    // (b) every slot's new score, backpointer and predecessor
    T m = BIG;
    for (int s = threadIdx.x; s < WP; s += blockDim.x) {
      const int w = s / P, p = s - w * P;
      const T c0 = add(ch[s], tdpw[3 * s]);
      const T c1 = p >= 1 ? add(ch[s - 1], tdpw[3 * s + 1]) : BIG;
      const T c2 = p >= 2 ? add(ch[s - 2], tdpw[3 * s + 2]) : BIG;
      T wv = c2;
      int wb = p >= 2 ? cb[s - 2] : 0;
      int wp = p >= 2 ? cp[s - 2] : -1;
      if (c1 < wv) {
        wv = c1;
        wb = p >= 1 ? cb[s - 1] : 0;
        wp = p >= 1 ? cp[s - 1] : -1;
      }
      if (c0 < wv) {
        wv = c0;
        wb = cb[s];
        wp = cp[s];
      }
      const T a = am_t[state_table[s]];
      wv = add(wv, a);
      const T entry = p < 2 ? add(add(s_ent[w], entp[2 * w + p]), a) : BIG;
      T nv;
      int nbv, npv;
      if (entry <= wv) {
        nv = entry;
        nbv = t - 1;
        npv = p < 2 ? s_entp[w] : -1;
      } else {
        nv = wv;
        nbv = wb;
        npv = wp;
      }
      if (p >= word_len[w]) nv = BIG;
      nv = tmin(nv, BIG);
      nh[s] = nv;
      nb[s] = nbv;
      np[s] = npv;
      m = tmin(m, nv);
    }
    T best = search::block_min(m, s_red);
    if (best >= HALF) best = T(0);
    // (c) renormalise, prune, and write the word ends
    for (int s = threadIdx.x; s < WP; s += blockDim.x) {
      const int w = s / P, p = s - w * P;
      T nv = search::renorm(nh[s], best);
      if (prune && nv > thr) nv = BIG;
      nh[s] = nv;
      if (p == last_pos[w]) {
        const T es = nv >= HALF ? BIG : nv;
        const size_t o = ((size_t)i * B + b) * W + w;
        book_out[o] = es;
        bkp_out[o] = nb[s];
        pred_out[o] = np[s];
        if (alive) s_book[w] = es;
      }
    }
    if (threadIdx.x == 0) offset[(size_t)i * B + b] = alive ? best : T(0);
    __syncthreads();  // the book and the new lattice are visible
    if (alive) buf ^= 1;  // a finished utterance keeps its lattice
  }
}

// ---- the warp instance: 8 lanes a word, K positions a lane -------------------------

constexpr int GROUP = 8;                    // lanes a word
constexpr int WORDS_PER_WARP = 32 / GROUP;  // 4
constexpr int MAX_K = 4;                    // positions a lane: P <= 32
constexpr int MAX_WARP_WORDS = 32;          // words of the warp instance: 8 warps
constexpr int MAX_PRED = MAX_WARP_WORDS / GROUP;  // predecessors a lane: W <= 32
constexpr int PREFETCH = 2;                 // frames of emissions in flight

// per frame parity: each warp's minimum; each word end's raw score,
// backpointer and predecessor
template <typename T>
struct WarpShared {
  T lm[MAX_WARP_WORDS * MAX_WARP_WORDS];  // lm [W, W], loaded once
  T wmin[2][MAX_WARP_WORDS / WORDS_PER_WARP];
  T end[2][MAX_WARP_WORDS];
  int endb[2][MAX_WARP_WORDS];
  int endp[2][MAX_WARP_WORDS];
};

// renormalisation by the frame's minimum (0 for a dead frame) and pruning
template <typename T>
__device__ __forceinline__ T renorm_prune(T v, T best, T thr, int prune) {
  v = search::renorm(v, best);
  if (prune && v > thr) v = big<T>();
  return v;
}

template <typename T, int K>
__global__ void __launch_bounds__(MAX_WARP_WORDS / WORDS_PER_WARP * 32, 3)
    bigram_scan_warp_kernel(const T* __restrict__ am, const int* __restrict__ feat_len,
                            const int* __restrict__ state_table,
                            const int* __restrict__ last_pos, const int* __restrict__ word_len,
                            const T* __restrict__ tdpw, const T* __restrict__ entp,
                            const T* __restrict__ lm, const T* __restrict__ lm_start,
                            T* __restrict__ book_out, int* __restrict__ bkp_out,
                            int* __restrict__ pred_out, T* __restrict__ offset, int B, int Tn,
                            int S, int W, int P, T thr, int prune) {
  __shared__ WarpShared<T> s;
  const T BIG = big<T>();
  const T HALF = BIG * T(0.5);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = lane & (GROUP - 1);  // lane within the word's group
  const int w = warp * WORDS_PER_WARP + (lane >> 3);
  const bool wv = w < W;
  const int wc = wv ? w : 0;  // a word that exists, for loads

  // per-slot constants; slot k of this lane is position p = l*K + k
  int st[K];
  T tw0[K], tw1[K], tw2[K], h[K];
  int bk[K], pd[K];
  unsigned valid = 0;  // bit k: the slot is a valid position of the word
  const int wlen = word_len[wc];
  const int end_k = wv ? last_pos[wc] - l * K : -1;  // the slot holding the word end
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = l * K + k;
    const bool real = wv && p < P;
    const int idx = wc * P + (real ? p : 0);
    st[k] = state_table[idx];
    tw0[k] = real ? tdpw[idx * 3 + 0] : BIG;
    tw1[k] = real ? tdpw[idx * 3 + 1] : BIG;
    tw2[k] = real ? tdpw[idx * 3 + 2] : BIG;
    h[k] = BIG;
    bk[k] = 0;
    pd[k] = -1;
    if (real && p < wlen) valid |= 1u << k;
  }
  // the entry penalties of this lane's slots at positions 0 and 1 (lane 0's
  // first two slots, or lanes 0 and 1's first when K == 1)
  constexpr int KE = K < 2 ? K : 2;
  T ep[KE];
#pragma unroll
  for (int k = 0; k < KE; ++k) {
    const int p = l * K + k;
    ep[k] = wv && p < 2 ? entp[wc * 2 + p] : BIG;
  }
  // the books of this lane's predecessors v = l + GROUP*j in the min-plus
  // product (none has ended yet); the LM in shared memory
  T book[MAX_PRED];
#pragma unroll
  for (int j = 0; j < MAX_PRED; ++j) book[j] = BIG;
  for (int k = threadIdx.x; k < W * W; k += blockDim.x) s.lm[k] = lm[k];
  const T start_row = lm_start[wc];
  const int len = feat_len[b];
  __syncthreads();  // the LM is visible

  // the emissions of frames i .. i+PREFETCH-1 (slot i % PREFETCH)
  const T* amb = am + (size_t)b * Tn * S;
  T ring[PREFETCH][K];
#pragma unroll
  for (int q = 0; q < PREFETCH; ++q)
#pragma unroll
    for (int k = 0; k < K; ++k) ring[q][k] = q < Tn ? amb[(size_t)q * S + st[k]] : T(0);

  for (int i0 = 0; i0 < Tn; i0 += PREFETCH) {
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q) {
      const int i = i0 + q;
      if (i < Tn) {  // the same for the whole block
        const int t = i + 1;  // 1-based frame index
        const bool alive = t <= len;
        const int par = i & 1;
        T a[K];
        const T* row = amb + (size_t)min(i + PREFETCH, Tn - 1) * S;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          a[k] = ring[q][k];
          ring[q][k] = row[st[k]];
        }
        // (a) this word's entry: the min-plus product over the predecessors,
        // split across the group's lanes, then the group's keyed argmin
        // (the smallest value, the first predecessor on ties)
        T rec = search::infinity<T>();
        int rp = INT_MAX;
#pragma unroll
        for (int j = 0; j < MAX_PRED; ++j) {
          const int v = l + GROUP * j;
          if (v < W) {
            const T c = add(book[j], s.lm[v * W + wc]);
            if (search::takes(c, rec)) {  // v grows with j: the first v at the minimum
              rec = c;
              rp = v;
            }
          }
        }
#pragma unroll
        for (int o = GROUP / 2; o > 0; o >>= 1) {
          const T orec = __shfl_xor_sync(search::FULL, rec, o);
          const int orp = __shfl_xor_sync(search::FULL, rp, o);
          if (search::pair_less(orec, orp, rec, rp)) {
            rec = orec;
            rp = orp;
          }
        }
        const T start = t == 1 ? start_row : BIG;
        const bool take_start = start < rec;
        const T ent = take_start ? start : rec;
        const int entp_v = take_start ? -1 : rp;

        // (b) the slots: the two positions left of this lane's first slot
        // come from the lanes below
        const T left1 = __shfl_up_sync(search::FULL, h[K - 1], 1, GROUP);
        const int left1b = __shfl_up_sync(search::FULL, bk[K - 1], 1, GROUP);
        const int left1p = __shfl_up_sync(search::FULL, pd[K - 1], 1, GROUP);
        constexpr int d2 = K >= 2 ? 1 : 2;
        constexpr int k2 = K >= 2 ? K - 2 : 0;
        const T left2 = __shfl_up_sync(search::FULL, h[k2], d2, GROUP);
        const int left2b = __shfl_up_sync(search::FULL, bk[k2], d2, GROUP);
        const int left2p = __shfl_up_sync(search::FULL, pd[k2], d2, GROUP);

        T nv[K];
        int nb[K], np[K];
        T m = BIG;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int p = l * K + k;
          const T h1 = k >= 1 ? h[k - 1] : left1;
          const int b1 = k >= 1 ? bk[k - 1] : left1b;
          const int p1 = k >= 1 ? pd[k - 1] : left1p;
          const T h2 = k >= 2 ? h[k - 2] : (k == 1 ? left1 : left2);
          const int b2 = k >= 2 ? bk[k - 2] : (k == 1 ? left1b : left2b);
          const int p2 = k >= 2 ? pd[k - 2] : (k == 1 ? left1p : left2p);
          const T c0 = add(h[k], tw0[k]);
          const T c1 = p >= 1 ? add(h1, tw1[k]) : BIG;
          const T c2 = p >= 2 ? add(h2, tw2[k]) : BIG;
          // the sequential selection (start at c2, take c1, then c0, if
          // strictly less) with its compares made independent
          const bool take1 = c1 < c2;
          const bool take0 = take1 ? c0 < c1 : c0 < c2;
          T wvs = take0 ? c0 : take1 ? c1 : c2;
          const int wb = take0 ? bk[k] : take1 ? (p >= 1 ? b1 : 0) : (p >= 2 ? b2 : 0);
          const int wp = take0 ? pd[k] : take1 ? (p >= 1 ? p1 : -1) : (p >= 2 ? p2 : -1);
          wvs = add(wvs, a[k]);
          const T entry = k < KE && p < 2 ? add(add(ent, ep[k < KE ? k : 0]), a[k]) : BIG;
          T v;
          if (entry <= wvs) {
            v = entry;
            nb[k] = t - 1;
            np[k] = p < 2 ? entp_v : -1;
          } else {
            v = wvs;
            nb[k] = wb;
            np[k] = wp;
          }
          if (!((valid >> k) & 1u)) v = BIG;
          nv[k] = tmin(v, BIG);
          m = tmin(m, nv[k]);
          if (k == end_k) {
            s.end[par][w] = nv[k];
            s.endb[par][w] = nb[k];
            s.endp[par][w] = np[k];
          }
        }
        m = keys::warp_minimum_nan(m);
        if (lane == 0) s.wmin[par][warp] = m;
        __syncthreads();  // the minima and the raw word ends are visible

        // (c) every warp folds the minima in the same order
        T best = s.wmin[par][0];
#pragma unroll
        for (int u = 1; u < MAX_WARP_WORDS / WORDS_PER_WARP; ++u)
          if (u < nwarps) best = tmin(best, s.wmin[par][u]);
        if (best >= HALF) best = T(0);
        // renormalise and prune this lane's slots; the owner of the word end
        // writes the book
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const T v = renorm_prune(nv[k], best, thr, prune);
          if (k == end_k) {
            const size_t o = ((size_t)i * B + b) * W + w;
            book_out[o] = v >= HALF ? BIG : v;
            bkp_out[o] = nb[k];
            pred_out[o] = np[k];
          }
          if (alive) {
            h[k] = v;
            bk[k] = nb[k];
            pd[k] = np[k];
          }
        }
        // the books of this lane's predecessors, by the owners' operations
        if (alive) {
#pragma unroll
          for (int j = 0; j < MAX_PRED; ++j) {
            const int v = l + GROUP * j;
            if (v < W) {
              const T e = renorm_prune(s.end[par][v], best, thr, prune);
              book[j] = e >= HALF ? BIG : e;
            }
          }
        }
        if (threadIdx.x == 0) offset[(size_t)i * B + b] = alive ? best : T(0);
      }
    }
  }
}

// positions a lane of the warp instance (1-4); for the block instance 0
// (its lattice in shared memory) or -1 (in device scratch)
int instance_for(int W, int P, int f64) {
  if (W <= MAX_WARP_WORDS && P >= 2 && P <= GROUP * MAX_K) return (P + GROUP - 1) / GROUP;
  const size_t n = f64 ? Layout::of<double>(W, P).total : Layout::of<float>(W, P).total;
  return n <= search::SHARED_LIMIT ? 0 : -1;
}

// the warp instance's threads a block (4 words a warp), and the block
// instance's
int threads_for(int W, int P, int f64) {
  if (instance_for(W, P, f64) > 0) return (W + WORDS_PER_WARP - 1) / WORDS_PER_WARP * 32;
  return search::threads_for((long long)W * P);
}

template <typename T, int K>
cudaError_t launch_warp(const T* am, const int* feat_len, const int* state_table,
                        const int* last_pos, const int* word_len, const T* tdpw, const T* entp,
                        const T* lm, const T* lm_start, T* book, int* bkp, int* pred,
                        T* offset, int B, int Tn, int S, int W, int P, T thr, int prune,
                        int threads, cudaStream_t stream) {
  bigram_scan_warp_kernel<T, K><<<B, threads, 0, stream>>>(
      am, feat_len, state_table, last_pos, word_len, tdpw, entp, lm, lm_start, book, bkp, pred,
      offset, B, Tn, S, W, P, thr, prune);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* am, const int* feat_len, const int* state_table, const int* last_pos,
           const int* word_len, const void* tdpw, const void* entp, const void* lm,
           const void* lm_start, void* book, int* bkp, int* pred, void* offset, void* scratch,
           int B, int Tn, int S, int W, int P, double thr, int prune, int first_design,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Tn == 0) return (int)cudaSuccess;
  if (W == 0 || P < 2) return (int)cudaErrorInvalidValue;
  const int f64 = sizeof(T) == 8;
  const int inst = first_design ? 0 : instance_for(W, P, f64);
  const cudaStream_t st = (cudaStream_t)stream;
  if (inst > 0) {
    const int threads = threads_for(W, P, f64);
#define SR_J_ARGS                                                                         \
  static_cast<const T*>(am), feat_len, state_table, last_pos, word_len,                 \
      static_cast<const T*>(tdpw), static_cast<const T*>(entp), static_cast<const T*>(lm), \
      static_cast<const T*>(lm_start), static_cast<T*>(book), bkp, pred,                  \
      static_cast<T*>(offset), B, Tn, S, W, P, T(thr), prune, threads, st
    switch (inst) {
      case 1: err = launch_warp<T, 1>(SR_J_ARGS); break;
      case 2: err = launch_warp<T, 2>(SR_J_ARGS); break;
      case 3: err = launch_warp<T, 3>(SR_J_ARGS); break;
      default: err = launch_warp<T, 4>(SR_J_ARGS); break;
    }
#undef SR_J_ARGS
    return (int)err;
  }
  const Layout L = Layout::of<T>(W, P);
  const bool in_scratch = L.total > search::SHARED_LIMIT;
  if (in_scratch && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_scratch ? 0 : L.total;
  err = search::allow_smem(bigram_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  bigram_scan_kernel<T><<<B, search::threads_for((long long)W * P), smem, st>>>(
      static_cast<const T*>(am), feat_len, state_table, last_pos, word_len,
      static_cast<const T*>(tdpw), static_cast<const T*>(entp), static_cast<const T*>(lm),
      static_cast<const T*>(lm_start), static_cast<T*>(book), bkp, pred,
      static_cast<T*>(offset), in_scratch ? static_cast<unsigned char*>(scratch) : nullptr, L,
      B, Tn, S, W, P, T(thr), prune);
  return (int)cudaGetLastError();
}

template <typename T>
int residency(int W, int P, int first_design) {
  const int f64 = sizeof(T) == 8;
  const int inst = first_design ? 0 : instance_for(W, P, f64);
  int n = 0;
  cudaError_t err;
  if (inst > 0) {
    const int threads = threads_for(W, P, f64);
    switch (inst) {
      case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bigram_scan_warp_kernel<T, 1>, threads, 0); break;
      case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bigram_scan_warp_kernel<T, 2>, threads, 0); break;
      case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bigram_scan_warp_kernel<T, 3>, threads, 0); break;
      default: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bigram_scan_warp_kernel<T, 4>, threads, 0); break;
    }
  } else {
    const Layout L = Layout::of<T>(W, P);
    const size_t smem = L.total > search::SHARED_LIMIT ? 0 : L.total;
    err = search::allow_smem(bigram_scan_kernel<T>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, bigram_scan_kernel<T>, search::threads_for((long long)W * P), smem);
  }
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// bytes of device scratch an utterance needs for a W x P lattice (0: it
// stays in shared memory; -1: too large); f64 != 0 for the float64 scan
extern "C" int sr_decode_scan_bigram_scratch(int W, int P, int f64) {
  const size_t n = f64 ? Layout::of<double>(W, P).total : Layout::of<float>(W, P).total;
  if (n <= search::SHARED_LIMIT) return 0;
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

// am [B, T, S], tdp_within, entry_tdp, lm, lm_start, book [T, B, W] and
// offset [T, B] in float (f64 == 0) or double; bkp and pred [T, B, W] int.
// The instance follows from the shape (sr_decode_scan_bigram_instance);
// first_design != 0 launches the block instance whatever the shape, so that
// the first design can be timed beside the warp instance (the wrapper
// passes 0).
extern "C" int sr_decode_scan_bigram(int f64, const void* am, const int* feat_len,
                                     const int* state_table, const int* last_pos,
                                     const int* word_len, const void* tdp_within,
                                     const void* entry_tdp, const void* lm,
                                     const void* lm_start, void* book, int* bkp, int* pred,
                                     void* offset, void* scratch, int B, int T, int S, int W,
                                     int P, double am_threshold, int prune, int first_design,
                                     int device, void* stream) {
  return f64 ? launch<double>(am, feat_len, state_table, last_pos, word_len, tdp_within,
                              entry_tdp, lm, lm_start, book, bkp, pred, offset, scratch, B, T,
                              S, W, P, am_threshold, prune, first_design, device, stream)
             : launch<float>(am, feat_len, state_table, last_pos, word_len, tdp_within,
                             entry_tdp, lm, lm_start, book, bkp, pred, offset, scratch, B, T,
                             S, W, P, am_threshold, prune, first_design, device, stream);
}

// the instance the entry launches for a W x P lattice: positions a lane of
// the warp instance (1-4: W <= 32 and 2 <= P <= 32); the block instance with
// its lattice in shared memory (0) or in device scratch (-1)
extern "C" int sr_decode_scan_bigram_instance(int W, int P, int f64) {
  return instance_for(W, P, f64);
}

// blocks one SM holds of that instance's launch (with first_design != 0:
// of the block instance's), by the occupancy calculator, or -1
extern "C" int sr_decode_scan_bigram_residency(int W, int P, int f64, int first_design) {
  return f64 ? residency<double>(W, P, first_design) : residency<float>(W, P, first_design);
}
