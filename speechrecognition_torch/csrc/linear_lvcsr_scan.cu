// Kernel M: the linear-lexicon LVCSR Viterbi with bigram recombination and
// per-predecessor silence copies, over a whole batch.
//
// Replaces speechrecognition_tpu/search/linear_lvcsr.py::_decode_scan_linear_ts
// (one lax.scan that XLA fuses; op by op in PyTorch about 90 launches a
// frame). Same inputs and outputs: am [B, T, S], feat_len [B], the real
// words' tables (state_table [W, P], last_pos, word_len [W], tdp_within
// [W, P, 3], entry_pen [W, 2]), the silence's (sil_states [Ps], sil_tdp
// [Ps, 3], sil_entry_pen [2], sil_exit) and the boundary matrix lm_ext
// [V, W] (V = W + 1, the last row the sentence start); it writes per frame
// book, bkp, pred, via [T, B, W], origin, silend, silorg [T, B, V] and
// offset [T, B]. A template on the score type (float, double).
//
// Per frame it follows the reference step exactly:
//   * the effective predecessor books: word v's end or, where strictly
//     smaller, its silence copy's end (via); the start context (v = W) is 0
//     at frame 1 only; origin is t - 1 when the book wins and the silence
//     copy's carried origin when it wins;
//   * every word's entry: the min-plus product min_v ebook[v] + lm[v, w],
//     the first v at the minimum (a thread a word loops over v in order and
//     takes a candidate only when strictly smaller);
//   * within-word candidates from s, s-1, s-2 (start at the jump-2 one, take
//     jump 1 if strictly less, then jump 0 if strictly less), carrying the
//     backpointer and the predecessor (0 and W left of position 0), plus the
//     emission; entries into positions 0 and 1 cost (entry + entry_pen) plus
//     the entered position's emission and win ties (<=); invalid positions
//     BIG; min(new, BIG);
//   * the silence copies the same way, one per predecessor v, entered from
//     ebook[v] and carrying origins;
//   * the joint minimum over words and silence copies; renormalise (BIG/2
//     and above stays BIG); prune new > am_threshold;
//   * word ends at last_pos, capped at BIG from BIG/2; silence ends plus
//     sil_exit; via gathered at each word end's predecessor;
//   * the utterance freezes once t > feat_len (outputs are still written).
// Rounded adds, compares and selects only: bit-equal to the plain version.
//
// Design: one block an utterance (B 130 on AN4 fills one wave of the 132
// SMs), a thread a word and a silence copy. The lattice is updated in place:
// a thread walks its word's positions from the last to the first, so each
// position reads its own and its two left neighbours' scores before they
// are overwritten; the raw scores are stored in the first pass and
// renormalised in the second, once the block's minimum is known. The
// lattice, the silence copies, the frame's emissions and the books live in
// shared memory (AN4's 130 x 30 lattice: about 57 KB in float32, 73 KB in
// float64), past search::SHARED_LIMIT in device scratch
// (sr_linear_scan_scratch gives the bytes an utterance). lm_ext is read
// through the read-only cache, coalesced over the words; at 68 KB (136 KB
// in double) it stays in L1 and L2 for every block.
//
// What bounds it: the per-frame chain of each utterance, not bytes or
// operations. A frame is a V-step min-plus loop, a P-step walk and three
// barriers; the longest utterance sets the time.

#include <climits>
#include <cuda_runtime.h>

#include "search.cuh"

namespace {

using search::add;
using search::big;
using search::tmin;

// per utterance, in shared memory or device scratch: the lattice hyp, bkp,
// pred [W * P]; the silence copies shyp, sorg [V * Ps]; the books book [W],
// silend, silorg [V]; this frame's ebook, via, origin [V], the raw word ends
// endv, endb, endp [W] and silence ends silv, silo [V]; the frame's
// emissions am [S]
struct Layout {
  size_t hyp, bkp, pred, shyp, sorg, book, silend, silorg, ebook, via, origin, endv, endb, endp,
      silv, silo, am, total;
  template <typename T>
  static Layout of(int W, int P, int Ps, int S) {
    const size_t WP = (size_t)W * P, V = (size_t)W + 1, VP = V * Ps;
    Layout L;
    size_t o = 0;
    auto put = [&o](size_t& field, size_t bytes) {
      field = o;
      o += search::align16(bytes);
    };
    put(L.hyp, WP * sizeof(T));
    put(L.bkp, WP * sizeof(int));
    put(L.pred, WP * sizeof(int));
    put(L.shyp, VP * sizeof(T));
    put(L.sorg, VP * sizeof(int));
    put(L.book, W * sizeof(T));
    put(L.silend, V * sizeof(T));
    put(L.silorg, V * sizeof(int));
    put(L.ebook, V * sizeof(T));
    put(L.via, V * sizeof(int));
    put(L.origin, V * sizeof(int));
    put(L.endv, W * sizeof(T));
    put(L.endb, W * sizeof(int));
    put(L.endp, W * sizeof(int));
    put(L.silv, V * sizeof(T));
    put(L.silo, V * sizeof(int));
    put(L.am, (size_t)S * sizeof(T));
    L.total = o;
    return L;
  }
};

template <typename T>
__global__ void __launch_bounds__(search::MAX_THREADS) linear_scan_kernel(
    const T* __restrict__ am, const int* __restrict__ feat_len,
    const int* __restrict__ state_table, const int* __restrict__ last_pos,
    const int* __restrict__ word_len, const T* __restrict__ tdpw, const T* __restrict__ entp,
    const int* __restrict__ sil_states, const T* __restrict__ stdp,
    const T* __restrict__ sentp, const T* __restrict__ lm, T* __restrict__ book_out,
    int* __restrict__ bkp_out, int* __restrict__ pred_out, bool* __restrict__ via_out,
    int* __restrict__ origin_out, T* __restrict__ silend_out, int* __restrict__ silorg_out,
    T* __restrict__ offset_out, unsigned char* scratch, Layout L, int B, int Tn, int S, int W,
    int P, int Ps, T sexit, T thr, int prune) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_red[32];
  const T BIG = big<T>();
  const T HALF = BIG * T(0.5);
  const int b = blockIdx.x;
  const int V = W + 1;
  const int nt = blockDim.x;
  unsigned char* base = scratch != nullptr ? scratch + (size_t)b * L.total : smem;
  T* hyp = reinterpret_cast<T*>(base + L.hyp);
  int* bkp = reinterpret_cast<int*>(base + L.bkp);
  int* pred = reinterpret_cast<int*>(base + L.pred);
  T* shyp = reinterpret_cast<T*>(base + L.shyp);
  int* sorg = reinterpret_cast<int*>(base + L.sorg);
  T* book = reinterpret_cast<T*>(base + L.book);
  T* silend = reinterpret_cast<T*>(base + L.silend);
  int* silorg = reinterpret_cast<int*>(base + L.silorg);
  T* ebook = reinterpret_cast<T*>(base + L.ebook);
  int* via = reinterpret_cast<int*>(base + L.via);
  int* origin = reinterpret_cast<int*>(base + L.origin);
  T* endv = reinterpret_cast<T*>(base + L.endv);
  int* endb = reinterpret_cast<int*>(base + L.endb);
  int* endp = reinterpret_cast<int*>(base + L.endp);
  T* silv = reinterpret_cast<T*>(base + L.silv);
  int* silo = reinterpret_cast<int*>(base + L.silo);
  T* s_am = reinterpret_cast<T*>(base + L.am);

  for (int s = threadIdx.x; s < W * P; s += nt) {
    hyp[s] = BIG;
    bkp[s] = 0;
    pred[s] = W;
  }
  for (int s = threadIdx.x; s < V * Ps; s += nt) {
    shyp[s] = BIG;
    sorg[s] = 0;
  }
  for (int v = threadIdx.x; v < V; v += nt) {
    if (v < W) book[v] = BIG;
    silend[v] = BIG;
    silorg[v] = 0;
  }
  const int len = feat_len[b];
  __syncthreads();

  for (int i = 0; i < Tn; ++i) {
    const int t = i + 1;  // 1-based frame index
    const bool alive = t <= len;
    const T* am_t = am + ((size_t)b * Tn + i) * S;
    const size_t ow = ((size_t)i * B + b) * W;
    const size_t ov = ((size_t)i * B + b) * V;
    // (a) the frame's emissions; the effective predecessor books
    for (int s = threadIdx.x; s < S; s += nt) s_am[s] = am_t[s];
    for (int v = threadIdx.x; v < V; v += nt) {
      T eb = v < W ? book[v] : (t == 1 ? T(0) : BIG);
      const T se = silend[v];
      const bool vp = se < eb;
      eb = tmin(eb, se);
      const int org = vp ? silorg[v] : t - 1;
      ebook[v] = eb;
      via[v] = vp;
      origin[v] = org;
      origin_out[ov + v] = org;
    }
    __syncthreads();  // emissions and books are visible

    // (b) words: entry by the min-plus product, then the positions from the
    // last to the first, raw scores stored in place
    T m = BIG;
    for (int w = threadIdx.x; w < W; w += nt) {
      T rec = add(ebook[0], __ldg(lm + w));
      int rp = 0;
      for (int v = 1; v < V; ++v) {
        const T c = add(ebook[v], __ldg(lm + (size_t)v * W + w));
        if (c < rec) {
          rec = c;
          rp = v;
        }
      }
      const int wl = word_len[w];
      const int lp = last_pos[w];
      for (int p = P - 1; p >= 0; --p) {
        const int s = w * P + p;
        const T c0 = add(hyp[s], tdpw[3 * s]);
        const T c1 = p >= 1 ? add(hyp[s - 1], tdpw[3 * s + 1]) : BIG;
        const T c2 = p >= 2 ? add(hyp[s - 2], tdpw[3 * s + 2]) : BIG;
        T wv = c2;
        int wb = p >= 2 ? bkp[s - 2] : 0;
        int wp = p >= 2 ? pred[s - 2] : W;
        if (c1 < wv) {
          wv = c1;
          wb = p >= 1 ? bkp[s - 1] : 0;
          wp = p >= 1 ? pred[s - 1] : W;
        }
        if (c0 < wv) {
          wv = c0;
          wb = bkp[s];
          wp = pred[s];
        }
        const T a = s_am[state_table[s]];
        wv = add(wv, a);
        const T entry = p < 2 ? add(add(rec, entp[2 * w + p]), a) : BIG;
        T nv;
        int nb, np;
        if (entry <= wv) {
          nv = entry;
          nb = t - 1;
          np = p < 2 ? rp : W;
        } else {
          nv = wv;
          nb = wb;
          np = wp;
        }
        if (p >= wl) nv = BIG;
        nv = tmin(nv, BIG);
        m = tmin(m, nv);
        if (p == lp) {
          endv[w] = nv;
          endb[w] = nb;
          endp[w] = np;
        }
        if (alive) {
          hyp[s] = nv;
          bkp[s] = nb;
          pred[s] = np;
        }
      }
    }
    // silence copies, one per predecessor
    for (int v = threadIdx.x; v < V; v += nt) {
      const T eb = ebook[v];
      const int org = origin[v];
      for (int p = Ps - 1; p >= 0; --p) {
        const int s = v * Ps + p;
        const T c0 = add(shyp[s], stdp[3 * p]);
        const T c1 = p >= 1 ? add(shyp[s - 1], stdp[3 * p + 1]) : BIG;
        const T c2 = p >= 2 ? add(shyp[s - 2], stdp[3 * p + 2]) : BIG;
        T wv = c2;
        int wo = p >= 2 ? sorg[s - 2] : 0;
        if (c1 < wv) {
          wv = c1;
          wo = p >= 1 ? sorg[s - 1] : 0;
        }
        if (c0 < wv) {
          wv = c0;
          wo = sorg[s];
        }
        const T a = s_am[sil_states[p]];
        wv = add(wv, a);
        const T entry = p < 2 ? add(add(eb, sentp[p]), a) : BIG;
        T nv;
        int no;
        if (entry <= wv) {
          nv = entry;
          no = org;
        } else {
          nv = wv;
          no = wo;
        }
        nv = tmin(nv, BIG);
        m = tmin(m, nv);
        if (p == Ps - 1) {
          silv[v] = nv;
          silo[v] = no;
        }
        if (alive) {
          shyp[s] = nv;
          sorg[s] = no;
        }
      }
    }
    T best = search::block_min(m, s_red);  // its barriers publish the raw ends
    if (best >= HALF) best = T(0);

    // (c) renormalise and prune; the books and the frame's outputs
    for (int w = threadIdx.x; w < W; w += nt) {
      T e = search::renorm(endv[w], best);
      if (prune && e > thr) e = BIG;
      e = e >= HALF ? BIG : e;
      const int np = endp[w];
      book_out[ow + w] = e;
      bkp_out[ow + w] = endb[w];
      pred_out[ow + w] = np;
      via_out[ow + w] = via[np] != 0;
      if (alive) {
        book[w] = e;
        for (int p = 0; p < P; ++p) {
          T h = search::renorm(hyp[w * P + p], best);
          if (prune && h > thr) h = BIG;
          hyp[w * P + p] = h;
        }
      }
    }
    for (int v = threadIdx.x; v < V; v += nt) {
      T e = search::renorm(silv[v], best);
      if (prune && e > thr) e = BIG;
      e = e >= HALF ? BIG : add(e, sexit);
      silend_out[ov + v] = e;
      silorg_out[ov + v] = silo[v];
      if (alive) {
        silend[v] = e;
        silorg[v] = silo[v];
        for (int p = 0; p < Ps; ++p) {
          T h = search::renorm(shyp[v * Ps + p], best);
          if (prune && h > thr) h = BIG;
          shyp[v * Ps + p] = h;
        }
      }
    }
    if (threadIdx.x == 0) offset_out[(size_t)i * B + b] = alive ? best : T(0);
    __syncthreads();  // the next frame rewrites the emissions, ebook and via
  }
}

template <typename T>
int launch(const void* am, const int* feat_len, const int* state_table, const int* last_pos,
           const int* word_len, const void* tdpw, const void* entp, const int* sil_states,
           const void* stdp, const void* sentp, const void* lm, void* book, int* bkp,
           int* pred, bool* via, int* origin, void* silend, int* silorg, void* offset,
           void* scratch, int B, int Tn, int S, int W, int P, int Ps, double sexit, double thr,
           int prune, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Tn == 0) return (int)cudaSuccess;
  if (W == 0 || P < 2 || Ps < 1) return (int)cudaErrorInvalidValue;
  const Layout L = Layout::of<T>(W, P, Ps, S);
  const bool in_scratch = L.total > search::SHARED_LIMIT;
  if (in_scratch && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_scratch ? 0 : L.total;
  err = search::allow_smem(linear_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  linear_scan_kernel<T><<<B, search::threads_for(W + 1), smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(am), feat_len, state_table, last_pos, word_len,
      static_cast<const T*>(tdpw), static_cast<const T*>(entp), sil_states,
      static_cast<const T*>(stdp), static_cast<const T*>(sentp), static_cast<const T*>(lm),
      static_cast<T*>(book), bkp, pred, via, origin, static_cast<T*>(silend), silorg,
      static_cast<T*>(offset), in_scratch ? static_cast<unsigned char*>(scratch) : nullptr, L,
      B, Tn, S, W, P, Ps, T(sexit), T(thr), prune);
  return (int)cudaGetLastError();
}

template <typename T>
int residency(int W, int P, int Ps, int S) {
  const Layout L = Layout::of<T>(W, P, Ps, S);
  const size_t smem = L.total > search::SHARED_LIMIT ? 0 : L.total;
  int n = 0;
  cudaError_t err = search::allow_smem(linear_scan_kernel<T>, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, linear_scan_kernel<T>,
                                                        search::threads_for(W + 1), smem);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// bytes of device scratch an utterance needs (0: its state stays in shared
// memory; -1: too large); f64 != 0 for the float64 scan
extern "C" int sr_linear_scan_scratch(int W, int P, int Ps, int S, int f64) {
  const size_t n =
      f64 ? Layout::of<double>(W, P, Ps, S).total : Layout::of<float>(W, P, Ps, S).total;
  if (n <= search::SHARED_LIMIT) return 0;
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

// am [B, T, S], tdp_within, entry_pen, sil_tdp, sil_entry_pen, lm_ext, book,
// silend [T, B, ...] and offset in float (f64 == 0) or double; the rest int
// (via bool). sexit and thr are already in the score type.
extern "C" int sr_linear_scan(int f64, const void* am, const int* feat_len,
                              const int* state_table, const int* last_pos, const int* word_len,
                              const void* tdp_within, const void* entry_pen,
                              const int* sil_states, const void* sil_tdp,
                              const void* sil_entry_pen, const void* lm_ext, void* book,
                              int* bkp, int* pred, bool* via, int* origin, void* silend,
                              int* silorg, void* offset, void* scratch, int B, int T, int S,
                              int W, int P, int Ps, double sil_exit, double am_threshold,
                              int prune, int device, void* stream) {
  return f64 ? launch<double>(am, feat_len, state_table, last_pos, word_len, tdp_within,
                              entry_pen, sil_states, sil_tdp, sil_entry_pen, lm_ext, book, bkp,
                              pred, via, origin, silend, silorg, offset, scratch, B, T, S, W, P,
                              Ps, sil_exit, am_threshold, prune, device, stream)
             : launch<float>(am, feat_len, state_table, last_pos, word_len, tdp_within,
                             entry_pen, sil_states, sil_tdp, sil_entry_pen, lm_ext, book, bkp,
                             pred, via, origin, silend, silorg, offset, scratch, B, T, S, W, P,
                             Ps, sil_exit, am_threshold, prune, device, stream);
}

// blocks one SM holds of kernel M's launch for that shape, by the occupancy
// calculator, or -1
extern "C" int sr_linear_scan_residency(int W, int P, int Ps, int S, int f64) {
  return f64 ? residency<double>(W, P, Ps, S) : residency<float>(W, P, Ps, S);
}
