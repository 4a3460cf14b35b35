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
// Design (a first, simple one): one block per utterance, threads looping
// over the W*P slots; the lattice (scores, backpointers, predecessors)
// double-buffered in shared memory (SieTill: 12 x 24, 9 KB in float64), or
// past search::SHARED_LIMIT in device scratch (sr_decode_scan_bigram_scratch
// gives the bytes an utterance); the book and each word's entry in the same
// place. Per frame: the entries (W threads, each a serial min over the W
// predecessors), a barrier, the slots, the block minimum, the renormalised
// slots and the word ends, a barrier. Bound by that per-frame chain, not by
// bytes: a 1,024-utterance, 960-frame float32 batch takes 4.9 ms (its bytes
// bound 0.17 ms) on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase
// 24).

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
        if (c < rec) {
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

template <typename T>
int launch(const void* am, const int* feat_len, const int* state_table, const int* last_pos,
           const int* word_len, const void* tdpw, const void* entp, const void* lm,
           const void* lm_start, void* book, int* bkp, int* pred, void* offset, void* scratch,
           int B, int Tn, int S, int W, int P, double thr, int prune, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Tn == 0) return (int)cudaSuccess;
  if (W == 0 || P < 2) return (int)cudaErrorInvalidValue;
  const Layout L = Layout::of<T>(W, P);
  const bool in_scratch = L.total > search::SHARED_LIMIT;
  if (in_scratch && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_scratch ? 0 : L.total;
  err = search::allow_smem(bigram_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  bigram_scan_kernel<T><<<B, search::threads_for((long long)W * P), smem,
                          (cudaStream_t)stream>>>(
      static_cast<const T*>(am), feat_len, state_table, last_pos, word_len,
      static_cast<const T*>(tdpw), static_cast<const T*>(entp), static_cast<const T*>(lm),
      static_cast<const T*>(lm_start), static_cast<T*>(book), bkp, pred,
      static_cast<T*>(offset), in_scratch ? static_cast<unsigned char*>(scratch) : nullptr, L,
      B, Tn, S, W, P, T(thr), prune);
  return (int)cudaGetLastError();
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
// offset [T, B] in float (f64 == 0) or double; bkp and pred [T, B, W] int
extern "C" int sr_decode_scan_bigram(int f64, const void* am, const int* feat_len,
                                     const int* state_table, const int* last_pos,
                                     const int* word_len, const void* tdp_within,
                                     const void* entry_tdp, const void* lm,
                                     const void* lm_start, void* book, int* bkp, int* pred,
                                     void* offset, void* scratch, int B, int T, int S, int W,
                                     int P, double am_threshold, int prune, int device,
                                     void* stream) {
  return f64 ? launch<double>(am, feat_len, state_table, last_pos, word_len, tdp_within,
                              entry_tdp, lm, lm_start, book, bkp, pred, offset, scratch, B, T,
                              S, W, P, am_threshold, prune, device, stream)
             : launch<float>(am, feat_len, state_table, last_pos, word_len, tdp_within,
                             entry_tdp, lm, lm_start, book, bkp, pred, offset, scratch, B, T,
                             S, W, P, am_threshold, prune, device, stream);
}
