// Kernel K: one time chunk of the word-conditioned tree search (WCTS).
//
// Replaces speechrecognition_tpu/search/wcts.py::_wcts_scan with the
// histogram pruning of speechrecognition_tpu/search/histogram.py::
// histogram_prune folded in (one lax.scan that XLA fuses; op by op in
// PyTorch about 60 launches a frame). Same inputs and outputs: am [B, T, S],
// feat_len [B]; the tree (state, parent, grand [N], tdp [N, 3],
// loop_allowed [N]), the entry tables (entry_state, entry_pen [N]),
// end_node [W], lm_ext [C, W] (last row: the sentence start), la [C, N]
// lookahead scores; the carry (hyp, bkp [B, C, N], book [B, W], silp, silb
// [B, C]) in and out; per frame the book, its backpointer and predecessor
// context [T, B, W] and the renormalisation offset [T, B]; optionally the
// pre-recombination word ends and their entry frames [T, B, C, W], the
// statistics (active states, active trees, word ends [T, B]) and, for
// transparent silence, via_sil, the carried silence entry frames, this
// frame's silence ends and their entry frames [T, B, C]. A template on the
// score type (float, double) with the lookahead and the histogram as
// compile-time flags (the per-slot passes they add); the other outputs are
// written where their pointers are given.
//
// Per frame it follows the reference step exactly, for every (context,
// node) slot, the roots included:
//   * each context's entry score: the book of its word (the sentence start:
//     0 at the global frame 1, else BIG); with transparent silence the
//     smaller of that and the silence that ended in the context (via_sil
//     where the silence is strictly smaller);
//   * within a tree copy: skip from the grandparent, then forward from the
//     parent if strictly less, then loop (where allowed) if strictly less,
//     plus the node's emission; the entry (context + entry_pen) + the
//     emission of the ENTERED node's state wins ties (<=); the root BIG;
//     min(new, BIG);
//   * the frame's minimum over all copies; renormalise; beam pruning on the
//     score or, with the lookahead, on the prospect relative to its own
//     minimum; then, with a state limit, histogram pruning of the valid
//     slots' pruning scores (histogram.cuh) with lower 0 and upper the
//     threshold;
//   * word ends: cand[c, w] = new[c, end_node[w]] + lm_ext[c, w] (BIG from
//     BIG/2), the silence column kept per context and set to BIG with
//     transparent silence, and the book the first context at the minimum;
//   * the utterance freezes once t > feat_len (outputs are still written).
// Rounded adds, subtracts, compares and selects, and the histogram's one
// multiply and two divides, each rounded once: bit-equal to the plain
// version in both types; the counts are integers.
//
// Design (a first, simple one): one block of up to 512 threads per
// utterance, threads looping over the C*N slots; every tree copy's scores
// and backpointers double-buffered in shared memory with the per-context and
// per-word vectors and the histogram (SieTill: C 13, N 212, 2,756 slots, 66
// KB in float64), or past search::SHARED_LIMIT in device scratch
// (sr_wcts_scan_scratch gives the bytes an utterance). Per frame 5 to 8
// barriers: the contexts, the minimum, with the lookahead the prospect's
// minimum, with the histogram its counts and threshold, the final lattice,
// and the word ends (W threads, each a serial first-argmin over the C
// contexts). Bound by that chain, not by bytes or operations: a
// 1,024-utterance, 960-frame float32 batch takes 28.7 ms pruned and 32.6 ms
// with the lookahead (30 us a frame; operations bound 0.57 ms) on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py phase 25).

#include <cuda_runtime.h>

#include "histogram.cuh"
#include "search.cuh"

namespace {

using search::add;
using search::big;
using search::sub;
using search::tmin;

// per utterance: hyp [2][CN] T, bkp [2][CN] int, ext [C] T, book [W] T,
// silp [C] T, silb [C] int, counts [bins] int, any [C] int
struct Layout {
  size_t hyp, bkp, ext, book, silp, silb, counts, any, total;
  template <typename T>
  static Layout of(int C, int N, int W, int bins) {
    const size_t CN = (size_t)C * N;
    Layout L;
    size_t o = 0;
    L.hyp = o; o += search::align16(2 * CN * sizeof(T));
    L.bkp = o; o += search::align16(2 * CN * sizeof(int));
    L.ext = o; o += search::align16(C * sizeof(T));
    L.book = o; o += search::align16(W * sizeof(T));
    L.silp = o; o += search::align16(C * sizeof(T));
    L.silb = o; o += search::align16(C * sizeof(int));
    L.counts = o; o += search::align16(bins * sizeof(int));
    L.any = o; o += search::align16(C * sizeof(int));
    L.total = o;
    return L;
  }
};

template <typename T>
struct Args {
  const T* am;
  const int* feat_len;
  const int *state, *parent, *grand;
  const T* tdp;
  const int *loop_allowed, *entry_state;
  const T* entry_pen;
  const int* end_node;
  const T *lm_ext, *la;
  // the carry in and out
  const T* hyp_in;
  const int* bkp_in;
  const T *book_in, *silp_in;
  const int* silb_in;
  T* hyp_out;
  int* bkp_out;
  T *book_c, *silp_c;
  int* silb_c;
  // per frame
  T* book;
  int *bkp, *pred;
  T* offset;
  T* cand;          // or null
  int* ebkp;        // or null
  int *st_states, *st_trees, *st_ends;  // or null
  unsigned char* via;                   // or null (transparent silence)
  int* silb_prev;
  T* silp_t;
  int* silb_t;
  unsigned char* scratch;  // or null: the state in shared memory
  Layout L;
  int B, Tn, S, C, N, W, t0;
  T thr;
  int prune, state_limit, bins, sil;
};

// the slot's pruning score from its score after the beam (the prospect
// relative to its minimum with the lookahead)
template <typename T, bool LA>
__device__ __forceinline__ T prune_score(T nv, T la, T ant_best) {
  const T BIG = big<T>(), HALF = BIG * T(0.5);
  if (!LA) return nv;
  if (nv >= HALF) return BIG;
  const T ant = add(nv, la);
  return ant >= HALF ? BIG : sub(ant, ant_best);
}

template <typename T, bool LA, bool HIST>
__global__ void __launch_bounds__(search::MAX_THREADS) wcts_scan_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_red[32];
  __shared__ int s_cnt[3];  // valid slots (histogram), live slots, word ends
  __shared__ T s_hthr;
  const T BIG = big<T>();
  const T HALF = BIG * T(0.5);
  const int b = blockIdx.x;
  const int C = a.C, N = a.N, W = a.W, B = a.B;
  const int CN = C * N;
  const Layout& L = a.L;
  unsigned char* base = a.scratch != nullptr ? a.scratch + (size_t)b * L.total : smem;
  T* lat_h = reinterpret_cast<T*>(base + L.hyp);
  int* lat_b = reinterpret_cast<int*>(base + L.bkp);
  T* s_ext = reinterpret_cast<T*>(base + L.ext);
  T* s_book = reinterpret_cast<T*>(base + L.book);
  T* s_silp = reinterpret_cast<T*>(base + L.silp);
  int* s_silb = reinterpret_cast<int*>(base + L.silb);
  int* s_counts = reinterpret_cast<int*>(base + L.counts);
  int* s_any = reinterpret_cast<int*>(base + L.any);
  const bool sil = a.sil >= 0;
  const bool stats = a.st_states != nullptr;
  const bool do_la = LA && a.prune;
  const bool do_hist = HIST && a.prune;

  for (int s = threadIdx.x; s < CN; s += blockDim.x) {
    lat_h[s] = a.hyp_in[(size_t)b * CN + s];
    lat_b[s] = a.bkp_in[(size_t)b * CN + s];
  }
  for (int w = threadIdx.x; w < W; w += blockDim.x) s_book[w] = a.book_in[(size_t)b * W + w];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s_silp[c] = a.silp_in[(size_t)b * C + c];
    s_silb[c] = a.silb_in[(size_t)b * C + c];
  }
  const int len = a.feat_len[b];
  const T lower = T(0), upper = a.thr;
  const T hscale = do_hist ? hist::scale(lower, upper, a.bins) : T(0);
  __syncthreads();

  int buf = 0;
  for (int i = 0; i < a.Tn; ++i) {
    const int t = a.t0 + i + 1;  // the global 1-based frame index
    const bool alive = t <= len;
    const size_t fb = (size_t)i * B + b;  // this frame and utterance
    const T* ch = lat_h + (size_t)buf * CN;
    const int* cb = lat_b + (size_t)buf * CN;
    T* nh = lat_h + (size_t)(buf ^ 1) * CN;
    int* nb = lat_b + (size_t)(buf ^ 1) * CN;
    const T* am_t = a.am + ((size_t)b * a.Tn + i) * a.S;

    // (1) each context's entry score; the per-frame counters cleared
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      T e = c < W ? s_book[c] : (t == 1 ? T(0) : BIG);
      if (sil) {
        const T sp = s_silp[c];
        a.via[fb * C + c] = sp < e;
        a.silb_prev[fb * C + c] = s_silb[c];
        e = tmin(e, sp);
      }
      s_ext[c] = e;
      if (stats) s_any[c] = 0;
    }
    if (do_hist)
      for (int k = threadIdx.x; k < a.bins; k += blockDim.x) s_counts[k] = 0;
    if (threadIdx.x == 0) s_cnt[0] = s_cnt[1] = s_cnt[2] = 0;
    __syncthreads();  // the entry scores are visible

    // (2) every slot's new score and backpointer
    T m = BIG;
    for (int s = threadIdx.x; s < CN; s += blockDim.x) {
      const int c = s / N, n = s - c * N;
      const int row = c * N;
      const int pa = row + a.parent[n], gr = row + a.grand[n];
      const T loop = a.loop_allowed[n] ? add(ch[s], a.tdp[3 * n]) : BIG;
      const T fwd = add(ch[pa], a.tdp[3 * n + 1]);
      T wv = add(ch[gr], a.tdp[3 * n + 2]);
      int wb = cb[gr];
      if (fwd < wv) {
        wv = fwd;
        wb = cb[pa];
      }
      if (loop < wv) {
        wv = loop;
        wb = cb[s];
      }
      wv = add(wv, am_t[a.state[n]]);
      const T entry = add(add(s_ext[c], a.entry_pen[n]), am_t[a.entry_state[n]]);
      T nv;
      int nbv;
      if (entry <= wv) {
        nv = entry;
        nbv = t - 1;
      } else {
        nv = wv;
        nbv = wb;
      }
      if (n == 0) nv = BIG;
      nv = tmin(nv, BIG);
      nh[s] = nv;
      nb[s] = nbv;
      m = tmin(m, nv);
    }
    T best = search::block_min(m, s_red);
    if (best >= HALF) best = T(0);

    // (3) renormalise and beam-prune (on the prospect with the lookahead)
    T ant_best = T(0);
    if (do_la) {
      T ma = BIG;
      for (int s = threadIdx.x; s < CN; s += blockDim.x) {
        const T nv = search::renorm(nh[s], best);
        nh[s] = nv;
        ma = tmin(ma, nv >= HALF ? BIG : add(nv, a.la[s]));
      }
      ant_best = search::block_min(ma, s_red);
      if (ant_best >= HALF) ant_best = T(0);
    }
    int valid = 0;
    for (int s = threadIdx.x; s < CN; s += blockDim.x) {
      T nv = nh[s];
      if (do_la) {
        const T ant = nv >= HALF ? BIG : add(nv, a.la[s]);
        const T rel = ant >= HALF ? BIG : sub(ant, ant_best);
        if (rel > a.thr) nv = BIG;
      } else {
        nv = search::renorm(nv, best);
        if (a.prune && nv > a.thr) nv = BIG;
      }
      nh[s] = nv;
      if (do_hist) {
        const T ps = prune_score<T, LA>(nv, LA ? a.la[s] : T(0), ant_best);
        if (ps < HALF) {
          ++valid;
          atomicAdd(&s_counts[hist::bin(ps, lower, hscale, a.bins)], 1);
        }
      }
    }
    // (4) histogram pruning: keep the valid slots at or under the quantile
    if (do_hist) {
      search::block_add(valid, &s_cnt[0]);
      __syncthreads();  // the counts are complete
      if (threadIdx.x < 32) {
        const T q = hist::quantile(s_counts, a.bins, a.state_limit, lower, hscale);
        if (threadIdx.x == 0) s_hthr = s_cnt[0] > a.state_limit && lower < upper ? q : upper;
      }
      __syncthreads();  // the threshold is visible
      const T hthr = s_hthr;
      for (int s = threadIdx.x; s < CN; s += blockDim.x) {
        const T ps = prune_score<T, LA>(nh[s], LA ? a.la[s] : T(0), ant_best);
        if (!(ps < HALF && ps <= hthr)) nh[s] = BIG;
      }
    }
    if (stats && alive) {
      int live = 0;
      for (int s = threadIdx.x; s < CN; s += blockDim.x)
        if (nh[s] < HALF) {
          ++live;
          s_any[s / N] = 1;
        }
      search::block_add(live, &s_cnt[1]);
    }
    __syncthreads();  // the frame's lattice is final

    // (5) word ends, recombined over the contexts
    int trees = 0;
    if (stats && threadIdx.x < 32) {
      for (int c = threadIdx.x; c < C; c += 32) trees += s_any[c];
      trees = __reduce_add_sync(search::FULL, trees);
    }
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const int en = a.end_node[w];
      const bool is_sil = sil && w == a.sil;
      T bv = BIG;
      int bc = 0, bb = 0;
      for (int c = 0; c < C; ++c) {
        const T e = nh[c * N + en];
        T cd = e >= HALF ? BIG : add(e, a.lm_ext[(size_t)c * W + w]);
        const int eb = nb[c * N + en];
        if (is_sil) {
          // silence ends stay per context and never recombine
          if (alive) {
            s_silp[c] = cd;
            s_silb[c] = eb;
          }
          a.silp_t[fb * C + c] = s_silp[c];
          a.silb_t[fb * C + c] = s_silb[c];
          cd = BIG;
        }
        if (a.cand != nullptr) {
          a.cand[(fb * C + c) * W + w] = cd;
          a.ebkp[(fb * C + c) * W + w] = eb;
        }
        if (c == 0 || cd < bv) {  // the first context at the minimum
          bv = cd;
          bc = c;
          bb = eb;
        }
      }
      if (bv >= HALF) bv = BIG;
      a.book[fb * W + w] = bv;
      a.bkp[fb * W + w] = bb;
      a.pred[fb * W + w] = bc;
      if (alive) s_book[w] = bv;
      if (stats && bv < HALF) atomicAdd(&s_cnt[2], 1);
    }
    __syncthreads();  // the book, the silence ends and the counts are visible
    if (threadIdx.x == 0) {
      a.offset[fb] = best;
      if (stats) {
        a.st_states[fb] = s_cnt[1];
        a.st_trees[fb] = alive ? trees : 0;
        a.st_ends[fb] = alive ? s_cnt[2] : 0;
      }
    }
    if (alive) buf ^= 1;  // a finished utterance keeps its lattice
  }

  for (int s = threadIdx.x; s < CN; s += blockDim.x) {
    a.hyp_out[(size_t)b * CN + s] = lat_h[(size_t)buf * CN + s];
    a.bkp_out[(size_t)b * CN + s] = lat_b[(size_t)buf * CN + s];
  }
  for (int w = threadIdx.x; w < W; w += blockDim.x) a.book_c[(size_t)b * W + w] = s_book[w];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    a.silp_c[(size_t)b * C + c] = s_silp[c];
    a.silb_c[(size_t)b * C + c] = s_silb[c];
  }
}

template <typename T, bool LA, bool HIST>
cudaError_t launch_one(const Args<T>& a, int threads, size_t smem, cudaStream_t stream) {
  const cudaError_t err = search::allow_smem(wcts_scan_kernel<T, LA, HIST>, smem);
  if (err != cudaSuccess) return err;
  wcts_scan_kernel<T, LA, HIST><<<a.B, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
size_t utterance_bytes(int C, int N, int W, int bins) {
  return Layout::of<T>(C, N, W, bins).total;
}

template <typename T>
int launch(void* const* p, int B, int Tn, int S, int C, int N, int W, int t0, double thr,
           int prune, int use_la, int state_limit, int bins, int sil, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Tn == 0) return (int)cudaSuccess;
  if (C == 0 || N == 0 || W == 0) return (int)cudaErrorInvalidValue;
  const bool hist = prune && state_limit != 0;
  if (hist && bins < 1) return (int)cudaErrorInvalidValue;
  Args<T> a;
  int k = 0;
  a.am = static_cast<const T*>(p[k++]);
  a.feat_len = static_cast<const int*>(p[k++]);
  a.state = static_cast<const int*>(p[k++]);
  a.parent = static_cast<const int*>(p[k++]);
  a.grand = static_cast<const int*>(p[k++]);
  a.tdp = static_cast<const T*>(p[k++]);
  a.loop_allowed = static_cast<const int*>(p[k++]);
  a.entry_state = static_cast<const int*>(p[k++]);
  a.entry_pen = static_cast<const T*>(p[k++]);
  a.end_node = static_cast<const int*>(p[k++]);
  a.lm_ext = static_cast<const T*>(p[k++]);
  a.la = static_cast<const T*>(p[k++]);
  a.hyp_in = static_cast<const T*>(p[k++]);
  a.bkp_in = static_cast<const int*>(p[k++]);
  a.book_in = static_cast<const T*>(p[k++]);
  a.silp_in = static_cast<const T*>(p[k++]);
  a.silb_in = static_cast<const int*>(p[k++]);
  a.hyp_out = static_cast<T*>(p[k++]);
  a.bkp_out = static_cast<int*>(p[k++]);
  a.book_c = static_cast<T*>(p[k++]);
  a.silp_c = static_cast<T*>(p[k++]);
  a.silb_c = static_cast<int*>(p[k++]);
  a.book = static_cast<T*>(p[k++]);
  a.bkp = static_cast<int*>(p[k++]);
  a.pred = static_cast<int*>(p[k++]);
  a.offset = static_cast<T*>(p[k++]);
  a.cand = static_cast<T*>(p[k++]);
  a.ebkp = static_cast<int*>(p[k++]);
  a.st_states = static_cast<int*>(p[k++]);
  a.st_trees = static_cast<int*>(p[k++]);
  a.st_ends = static_cast<int*>(p[k++]);
  a.via = static_cast<unsigned char*>(p[k++]);
  a.silb_prev = static_cast<int*>(p[k++]);
  a.silp_t = static_cast<T*>(p[k++]);
  a.silb_t = static_cast<int*>(p[k++]);
  a.scratch = static_cast<unsigned char*>(p[k++]);
  if ((a.cand == nullptr) != (a.ebkp == nullptr)) return (int)cudaErrorInvalidValue;
  if (sil >= 0 && (a.via == nullptr || a.silb_prev == nullptr || a.silp_t == nullptr ||
                   a.silb_t == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.st_states != nullptr && (a.st_trees == nullptr || a.st_ends == nullptr))
    return (int)cudaErrorInvalidValue;
  a.L = Layout::of<T>(C, N, W, hist ? bins : 0);
  const bool in_scratch = a.L.total > search::SHARED_LIMIT;
  if (in_scratch && a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (!in_scratch) a.scratch = nullptr;
  a.B = B;
  a.Tn = Tn;
  a.S = S;
  a.C = C;
  a.N = N;
  a.W = W;
  a.t0 = t0;
  a.thr = T(thr);
  a.prune = prune;
  a.state_limit = state_limit;
  a.bins = hist ? bins : 0;
  a.sil = sil;
  const int threads = search::threads_for((long long)C * N);
  const size_t smem = in_scratch ? 0 : a.L.total;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool la = prune && use_la;
  if (la && hist) err = launch_one<T, true, true>(a, threads, smem, st);
  else if (la) err = launch_one<T, true, false>(a, threads, smem, st);
  else if (hist) err = launch_one<T, false, true>(a, threads, smem, st);
  else err = launch_one<T, false, false>(a, threads, smem, st);
  return (int)err;
}

}  // namespace

// bytes of device scratch an utterance needs (0: its state stays in shared
// memory; -1: too large) for C contexts, N nodes, W words and `bins`
// histogram bins (0 without histogram pruning); f64 != 0 for float64
extern "C" int sr_wcts_scan_scratch(int C, int N, int W, int bins, int f64) {
  const size_t n = f64 ? utterance_bytes<double>(C, N, W, bins)
                       : utterance_bytes<float>(C, N, W, bins);
  if (n <= search::SHARED_LIMIT) return 0;
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

// The float arrays (am, tdp, entry_pen, lm_ext, la, the carried scores and
// the per-frame scores) in float (f64 == 0) or double; the optional outputs
// null where not asked for; via is one byte a flag.
extern "C" int sr_wcts_scan(
    int f64, const void* am, const int* feat_len, const int* state, const int* parent,
    const int* grand, const void* tdp, const int* loop_allowed, const int* entry_state,
    const void* entry_pen, const int* end_node, const void* lm_ext, const void* la,
    const void* hyp_in, const int* bkp_in, const void* book_in, const void* silp_in,
    const int* silb_in, void* hyp_out, int* bkp_out, void* book_c, void* silp_c, int* silb_c,
    void* book, int* bkp, int* pred, void* offset, void* cand, int* ebkp, int* st_states,
    int* st_trees, int* st_ends, void* via, int* silb_prev, void* silp_t, int* silb_t,
    void* scratch, int B, int T, int S, int C, int N, int W, int t0, double am_threshold,
    int prune, int use_lookahead, int state_limit, int bins, int sil, int device,
    void* stream) {
  void* const p[] = {const_cast<void*>(am), const_cast<int*>(feat_len),
                     const_cast<int*>(state), const_cast<int*>(parent), const_cast<int*>(grand),
                     const_cast<void*>(tdp), const_cast<int*>(loop_allowed),
                     const_cast<int*>(entry_state), const_cast<void*>(entry_pen),
                     const_cast<int*>(end_node), const_cast<void*>(lm_ext), const_cast<void*>(la),
                     const_cast<void*>(hyp_in), const_cast<int*>(bkp_in),
                     const_cast<void*>(book_in), const_cast<void*>(silp_in),
                     const_cast<int*>(silb_in), hyp_out, bkp_out, book_c, silp_c, silb_c, book,
                     bkp, pred, offset, cand, ebkp, st_states, st_trees, st_ends, via, silb_prev,
                     silp_t, silb_t, scratch};
  return f64 ? launch<double>(p, B, T, S, C, N, W, t0, am_threshold, prune, use_lookahead,
                              state_limit, bins, sil, device, stream)
             : launch<float>(p, B, T, S, C, N, W, t0, am_threshold, prune, use_lookahead,
                             state_limit, bins, sil, device, stream);
}
