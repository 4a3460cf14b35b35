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
// What bounds it: a latency and issue chain, not bytes or operations (the
// operations bound of a 1,024-utterance, 960-frame float32 chunk is 0.57
// ms): every frame depends on the last through the lattice, its minimum and
// the books that the next entries read. Two instances, chosen in the C
// entry from the shape alone (sr_wcts_scan_instance):
//   * the owner instance (SieTill's C 13 x N 212 in both types): a
//     thread owns one node in every context of its group (SPT = 16 contexts,
//     or 8 where 16 would take too many threads), so its node's tables
//     (parent, grand, TDPs, entry penalty, states) and its two emissions are
//     read once a frame for all its slots, and lanes sit on consecutive
//     nodes (shared-memory accesses free of bank conflicts). Its scores and
//     backpointers stay in registers through the frame; the lattice is one
//     buffer of (score, backpointer) cells in shared memory, read for the
//     parents before the frame's first barrier and written after it. Frame
//     t+1's emission row is staged by cp.async while frame t runs. Each warp
//     publishes its exact minimum (keys.cuh) and every warp folds them in
//     the same order; the lookahead's prospect minimum and the histogram's
//     valid count take the same scheme, the histogram's counts by shared
//     atomics and its quantile in every warp. The owners of the word-end
//     slots publish their cells; after the frame's last barrier every warp
//     forms every word's book, two lanes a word on SieTill, each taking the
//     first context at its minimum and the pair folding by (value, context),
//     so the next frame's entries need no barrier of their own; warp 0
//     writes the outputs. Barriers a frame: 2 pruned, 3 with the lookahead
//     or the histogram, 4 with both (the first design: 5, 7 and 9).
//     Launch bounds 256 threads and 4 blocks an SM in float32 (224 threads
//     on SieTill, 4 utterances an SM, 2 waves of 1,024), 2 in float64 (4
//     waves); a sweep of 8 contexts a thread (448 threads, 2 an SM) took
//     14.80 ms against 11.95. On an NVIDIA H100 80GB HBM3 at 700.00 W
//     (chip_smoke.py phase 25, B 1,024, T 960): pruned float32 11.67 ms
//     (12.2 us a frame), with the lookahead 17.49, state limit 48 15.78,
//     float64 pruned 18.99 ms.
//   * the block instance (the first design; any other shape, and
//     state past search::SHARED_LIMIT in device scratch, whose bytes
//     sr_wcts_scan_scratch gives): one block of up to 512 threads an
//     utterance, threads looping over the C*N slots, every tree copy
//     double-buffered in shared memory with the per-context and per-word
//     vectors and the histogram; per frame 5 to 9 barriers and a serial
//     word-end phase (W threads, each a first-argmin over the C contexts).
//     On SieTill, forced, in the same run: 28.73 ms pruned, 32.77 with the
//     lookahead, 33.67 with state limit 48, 30.24 in float64 (2 an SM, 4
//     waves).

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
        if (c == 0 || search::takes(cd, bv)) {  // the first context at the minimum
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

// ---- the owner instance: a thread owns one node in every context ------------------

constexpr int OWNER_MAX_C = 32;      // contexts: one a lane in the recombination
constexpr int OWNER_MAX_WARPS = 32;  // warps a block, at most

// contexts a thread (SPT) and the launch bounds of each configuration: the
// threads a block at most and the blocks an SM the registers must allow
template <int SPT>
struct OwnerCfg;
template <>
struct OwnerCfg<8> {
  static constexpr int MAXT = 512;
  static constexpr int minb(size_t) { return 2; }
};
template <>
struct OwnerCfg<16> {
  static constexpr int MAXT = 256;
  // 4 blocks an SM in float32 (64 registers), 2 in float64 (128: the
  // scores take twice the registers)
  static constexpr int minb(size_t word) { return word == 8 ? 2 : 4; }
};

// a slot's score and backpointer side by side, so that one shared-memory
// access moves both
template <typename T>
struct alignas(2 * sizeof(T)) Cell {
  T h;
  int b;
};

// per utterance in shared memory: the lattice [C][N] cells (one buffer:
// every read of the previous frame precedes the frame's first barrier,
// every write follows it); the word ends of the frame [C][W] cells, at the
// first word ending at each end node; two emission rows [2][S] T; lm_ext
// [C][W] T; the histogram [bins] int; each node's first word ending there
// [N] int (set-up only); with the lookahead la [C][N] T
struct OwnerLayout {
  size_t lat, end, am, lm, counts, eidx, la, total;
  template <typename T>
  static OwnerLayout of(int C, int N, int W, int S, int bins, bool la) {
    const size_t CN = (size_t)C * N;
    OwnerLayout L;
    size_t o = 0;
    L.lat = o; o += search::align16(CN * sizeof(Cell<T>));
    L.end = o; o += search::align16((size_t)C * W * sizeof(Cell<T>));
    L.am = o; o += search::align16(2 * (size_t)S * sizeof(T));
    L.lm = o; o += search::align16((size_t)C * W * sizeof(T));
    L.counts = o; o += search::align16((size_t)bins * sizeof(int));
    L.eidx = o; o += search::align16((size_t)N * sizeof(int));
    L.la = o; o += la ? search::align16(CN * sizeof(T)) : 0;
    L.total = o;
    return L;
  }
};

// one score of device memory into shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem),
               "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a context group's threads in the owner instance: one a node, whole warps
__host__ __device__ __forceinline__ int owner_nodes_padded(int N) { return (N + 31) / 32 * 32; }

template <typename T, int SPT, bool LA, bool HIST>
__global__ void __launch_bounds__(OwnerCfg<SPT>::MAXT, OwnerCfg<SPT>::minb(sizeof(T)))
    wcts_owner_kernel(const Args<T> a, const OwnerLayout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_wmin[OWNER_MAX_WARPS], s_wla[OWNER_MAX_WARPS];
  __shared__ int s_valid[OWNER_MAX_WARPS], s_live[OWNER_MAX_WARPS], s_ends[OWNER_MAX_WARPS];
  __shared__ unsigned s_mask[OWNER_MAX_WARPS];
  __shared__ T s_ext[OWNER_MAX_WARPS][OWNER_MAX_C];  // each warp's entry scores
  const T BIG = big<T>();
  const T HALF = BIG * T(0.5);
  const int b = blockIdx.x;
  const int C = a.C, N = a.N, W = a.W, B = a.B, S = a.S;
  const int CN = C * N;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = nthreads >> 5;
  Cell<T>* lat = reinterpret_cast<Cell<T>*>(smem + L.lat);
  Cell<T>* s_end = reinterpret_cast<Cell<T>*>(smem + L.end);
  T* s_am = reinterpret_cast<T*>(smem + L.am);
  T* s_lm = reinterpret_cast<T*>(smem + L.lm);
  int* s_counts = reinterpret_cast<int*>(smem + L.counts);
  int* s_eidx = reinterpret_cast<int*>(smem + L.eidx);
  T* s_la = reinterpret_cast<T*>(smem + L.la);
  const bool sil = a.sil >= 0;
  const bool stats = a.st_states != nullptr;
  const T* amb = a.am + (size_t)b * a.Tn * S;

  // the lattice carried in, the LM, the lookahead and frame 0's emissions
  for (int s = tid; s < CN; s += nthreads) {
    lat[s] = {a.hyp_in[(size_t)b * CN + s], a.bkp_in[(size_t)b * CN + s]};
    if (LA) s_la[s] = a.la[s];
  }
  for (int k = tid; k < C * W; k += nthreads) s_lm[k] = a.lm_ext[k];
  for (int n = tid; n < N; n += nthreads) s_eidx[n] = INT_MAX;
  if (HIST)
    for (int k = tid; k < a.bins; k += nthreads) s_counts[k] = 0;
  for (int k = tid; k < S; k += nthreads) cp_async(s_am + k, amb + k);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int w = tid; w < W; w += nthreads) atomicMin(&s_eidx[a.end_node[w]], w);
  __syncthreads();  // each node's first word is known

  // this thread's node n (lanes on consecutive nodes, so that the warp's
  // shared-memory accesses are free of bank conflicts) in the contexts
  // c0 + k, k < SPT, of its group
  const int np = owner_nodes_padded(N);
  const int n = tid % np;
  const int c0 = tid / np * SPT;    // the same for the whole warp
  const int nk = min(SPT, C - c0);  // the group's contexts (the same too)
  const bool node = n < N;
  const bool dead = !node || n == 0;  // the root (BIG) or a padding lane
  const int nc = node ? n : 0;  // a node that exists, for loads
  const int pa = a.parent[nc], gr = a.grand[nc];
  const T tdp0 = a.tdp[3 * nc], tdp1 = a.tdp[3 * nc + 1], tdp2 = a.tdp[3 * nc + 2];
  const T epen = a.entry_pen[nc];
  const int st = a.state[nc], est = a.entry_state[nc];
  const bool loop_ok = a.loop_allowed[nc] != 0;
  const int w0 = node && s_eidx[nc] < W ? s_eidx[nc] : -1;  // the first word ending here
  T h[SPT];
  int bk[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int c = c0 + k;
    const bool real = node && c < C;
    h[k] = real ? lat[c * N + n].h : BIG;
    bk[k] = real ? lat[c * N + n].b : 0;
  }
  // lane c's context c (every warp keeps them all): its book (a word's
  // context), its silence end and that end's entry frame
  const bool has_ctx = lane < C;
  T bookc = BIG, silpc = BIG;
  int silbc = 0;
  if (has_ctx) {
    if (lane < W) bookc = a.book_in[(size_t)b * W + lane];
    silpc = a.silp_in[(size_t)b * C + lane];
    silbc = a.silb_in[(size_t)b * C + lane];
  }
  const int sil_end = sil ? s_eidx[a.end_node[a.sil]] : 0;
  // the recombination's lanes: q a word (a power of two, q*W <= 32), lane
  // wl*q + wr taking the contexts wr, wr + q, ... of word wl, whose end
  // cells sit at wend (the first word ending at its end node)
  int q = 32;
  while (q * W > 32) q >>= 1;
  const int wl = lane / q, wr = lane % q;
  const int wend = wl < W ? s_eidx[a.end_node[wl]] : 0;
  const int len = a.feat_len[b];
  const T lower = T(0), upper = a.thr;
  const T hscale = HIST ? hist::scale(lower, upper, a.bins) : T(0);

  for (int i = 0; i < a.Tn; ++i) {
    const int t = a.t0 + i + 1;  // the global 1-based frame index
    const bool alive = t <= len;
    const size_t fb = (size_t)i * B + b;  // this frame and utterance
    const T* am_t = s_am + (size_t)(i & 1) * S;
    // N and W, opaque to the compiler inside the frame loop: the slots'
    // offsets are recomputed a frame (an IMAD each) instead of hoisted out
    // of the loop and held in registers, which would spill
    int nv = N, wn = W;
    asm volatile("" : "+r"(nv), "+r"(wn));
    // frame i+1's emissions, in flight while this frame runs
    if (i + 1 < a.Tn)
      for (int k = tid; k < S; k += nthreads)
        cp_async(s_am + (size_t)((i + 1) & 1) * S + k, amb + (size_t)(i + 1) * S + k);
    cp_async_commit();

    // (1) each context's entry score, in its lane, to the warp's row of
    // s_ext (read back as a broadcast by every slot of the context)
    if (has_ctx) {
      T ext = lane < W ? bookc : (t == 1 ? T(0) : BIG);
      if (sil) {
        if (warp == 0) {
          a.via[fb * C + lane] = silpc < ext;
          a.silb_prev[fb * C + lane] = silbc;
        }
        ext = tmin(ext, silpc);
      }
      s_ext[warp][lane] = ext;
    }
    __syncwarp();

    // (2) the node's new score and backpointer in each context, in place of
    // the old ones in the registers (a frozen utterance takes the old ones
    // back from the lattice in (5)); the node's emissions once for all
    const T es = am_t[st];
    const T ee = am_t[est];
    T m = BIG;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      if (k >= nk) break;  // the same for the whole warp
      const T e = s_ext[warp][c0 + k];
      const int row = (c0 + k) * nv;
      const Cell<T> cp = lat[row + pa], cg = lat[row + gr];
      const T loop = loop_ok ? add(h[k], tdp0) : BIG;
      const T fwd = add(cp.h, tdp1);
      T wv = add(cg.h, tdp2);
      int wb = cg.b;
      if (fwd < wv) {
        wv = fwd;
        wb = cp.b;
      }
      if (loop < wv) {
        wv = loop;
        wb = bk[k];
      }
      wv = add(wv, es);
      const T entry = add(add(e, epen), ee);
      const bool take = entry <= wv;
      const T v = take ? entry : wv;
      bk[k] = take ? t - 1 : wb;
      h[k] = dead ? BIG : tmin(v, BIG);
      m = tmin(m, h[k]);
    }
    m = keys::warp_minimum_nan(m);
    if (lane == 0) s_wmin[warp] = m;
    __syncthreads();  // barrier 1: the warps' minima are visible

    // the previous frame's statistics, from the warps' published counts
    if (stats && tid == 0 && i > 0) {
      const size_t fp = (size_t)(i - 1) * B + b;
      int live = 0, ends = 0;
      unsigned mask = 0;
      for (int u = 0; u < nwarps; ++u) {
        live += s_live[u];
        ends += s_ends[u];
        mask |= s_mask[u];
      }
      a.st_states[fp] = live;
      a.st_trees[fp] = __popc(mask);
      a.st_ends[fp] = ends;
    }
    T best = s_wmin[0];
    for (int u = 1; u < nwarps; ++u) best = tmin(best, s_wmin[u]);
    if (best >= HALF) best = T(0);
    if (tid == 0) a.offset[fb] = best;

    // (3) renormalise and beam-prune (on the prospect with the lookahead)
#pragma unroll
    for (int k = 0; k < SPT; ++k) h[k] = search::renorm(h[k], best);
    T ant_best = T(0);
    if (LA) {
      T ma = BIG;
#pragma unroll
      for (int k = 0; k < SPT; ++k)
        if (node && c0 + k < C && !(h[k] >= HALF))  // a NaN takes part
          ma = tmin(ma, add(h[k], s_la[(c0 + k) * nv + n]));
      ma = keys::warp_minimum_nan(ma);
      if (lane == 0) s_wla[warp] = ma;
      __syncthreads();  // barrier 2 (lookahead): the prospects' minima are visible
      ant_best = s_wla[0];
      for (int u = 1; u < nwarps; ++u) ant_best = tmin(ant_best, s_wla[u]);
      if (ant_best >= HALF) ant_best = T(0);
    }
    // the lookahead score of slot k (0 where it is not read)
    auto la_of = [&](int k) {
      return LA && node && c0 + k < C ? s_la[(c0 + k) * nv + n] : T(0);
    };
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      if (LA) {
        const T ant = h[k] >= HALF ? BIG : add(h[k], la_of(k));
        const T rel = ant >= HALF ? BIG : sub(ant, ant_best);
        if (rel > a.thr) h[k] = BIG;
      } else if (a.prune && h[k] > a.thr) {
        h[k] = BIG;
      }
    }
    // (4) histogram pruning: keep the valid slots at or under the quantile
    if (HIST) {
      int valid = 0;
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const T ps = prune_score<T, LA>(h[k], la_of(k), ant_best);
        if (ps < HALF) {
          ++valid;
          atomicAdd(&s_counts[hist::bin(ps, lower, hscale, a.bins)], 1);
        }
      }
      valid = __reduce_add_sync(search::FULL, valid);
      if (lane == 0) s_valid[warp] = valid;
      __syncthreads();  // barrier 3 (histogram): the counts are complete
      int total = 0;
      for (int u = 0; u < nwarps; ++u) total += s_valid[u];
      const T q = hist::quantile(s_counts, a.bins, a.state_limit, lower, hscale);
      const T hthr = total > a.state_limit && lower < upper ? q : upper;
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const T ps = prune_score<T, LA>(h[k], la_of(k), ant_best);
        if (!(ps < HALF && ps <= hthr)) h[k] = BIG;
      }
    }

    // (5) the frame's lattice: the word-end slots published, the lattice
    // kept where the utterance is alive
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      if (k >= nk) break;  // the same for the whole warp
      if (node && w0 >= 0) s_end[(c0 + k) * wn + w0] = {h[k], bk[k]};
    }
    if (alive) {
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        if (k >= nk) break;
        if (node) lat[(c0 + k) * nv + n] = {h[k], bk[k]};
      }
    } else {  // a finished utterance keeps its lattice
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        if (k >= nk) break;
        if (node) {
          const Cell<T> old = lat[(c0 + k) * nv + n];
          h[k] = old.h;
          bk[k] = old.b;
        }
      }
    }
    int live = 0;
    unsigned mask = 0;
    if (stats && alive) {
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        if (k >= nk) break;
        if (node && h[k] < HALF) {
          ++live;
          mask |= 1u << (c0 + k);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // barrier E: the lattice, the word ends and the next emissions are visible

    if (HIST)  // every read of this frame's histogram is done
      for (int k = tid; k < a.bins; k += nthreads) s_counts[k] = 0;

    // (6) each word's book, in lane w of every warp: the first context at
    // the smallest word end (each warp needs every context's entry)
    int ends = 0;
    {
      T bv = BIG;
      int bc = INT_MAX, bb = 0;
      if (wl < W) {
        const bool is_sil = sil && wl == a.sil;
        const bool out = warp == 0 && a.cand != nullptr;
#pragma unroll 4
        for (int c = wr; c < C; c += q) {
          const Cell<T> ce = s_end[c * W + wend];
          T cd = ce.h >= HALF ? BIG : add(ce.h, s_lm[c * W + wl]);
          if (is_sil) cd = BIG;  // silence ends never recombine
          if (out) {
            a.cand[(fb * C + c) * W + wl] = cd;
            a.ebkp[(fb * C + c) * W + wl] = ce.b;
          }
          if (bc == INT_MAX || search::takes(cd, bv)) {  // this lane's first context at its minimum
            bv = cd;
            bc = c;
            bb = ce.b;
          }
        }
      }
      // the word's q lanes: the smaller end, the first context on ties
      for (int o = 1; o < q; o <<= 1) {
        const T ov = __shfl_xor_sync(search::FULL, bv, o);
        const int oc = __shfl_xor_sync(search::FULL, bc, o);
        const int ob = __shfl_xor_sync(search::FULL, bb, o);
        if (search::pair_less(ov, oc, bv, bc)) {
          bv = ov;
          bc = oc;
          bb = ob;
        }
      }
      if (bv >= HALF) bv = BIG;
      if (warp == 0 && wl < W && wr == 0) {
        a.book[fb * W + wl] = bv;
        a.bkp[fb * W + wl] = bb;
        a.pred[fb * W + wl] = bc;
        ends = alive && bv < HALF;
      }
      // lane c takes its context's book from its word's first lane
      bv = __shfl_sync(search::FULL, bv, min(lane, W - 1) * q);
      if (alive && lane < W) bookc = bv;
    }
    // each context's silence end stays its own
    if (sil && has_ctx) {
      if (alive) {
        const Cell<T> ce = s_end[lane * W + sil_end];
        silpc = ce.h >= HALF ? BIG : add(ce.h, s_lm[lane * W + a.sil]);
        silbc = ce.b;
      }
      if (warp == 0) {
        a.silp_t[fb * C + lane] = silpc;
        a.silb_t[fb * C + lane] = silbc;
      }
    }
    if (stats) {
      live = __reduce_add_sync(search::FULL, live);
      mask = __reduce_or_sync(search::FULL, mask);
      ends = __reduce_add_sync(search::FULL, ends);
      if (lane == 0) {
        s_live[warp] = live;
        s_mask[warp] = mask;
        s_ends[warp] = ends;
      }
    }
  }

  cp_async_wait_all();
  __syncthreads();  // the last frame's counts are visible
  if (stats && tid == 0 && a.Tn > 0) {
    const size_t fp = (size_t)(a.Tn - 1) * B + b;
    int live = 0, ends = 0;
    unsigned mask = 0;
    for (int u = 0; u < nwarps; ++u) {
      live += s_live[u];
      ends += s_ends[u];
      mask |= s_mask[u];
    }
    a.st_states[fp] = live;
    a.st_trees[fp] = __popc(mask);
    a.st_ends[fp] = ends;
  }
#pragma unroll
  for (int k = 0; k < SPT; ++k)
    if (node && c0 + k < C) {
      a.hyp_out[(size_t)b * CN + (c0 + k) * N + n] = h[k];
      a.bkp_out[(size_t)b * CN + (c0 + k) * N + n] = bk[k];
    }
  if (warp == 0 && has_ctx) {
    if (lane < W) a.book_c[(size_t)b * W + lane] = bookc;
    a.silp_c[(size_t)b * C + lane] = silpc;
    a.silb_c[(size_t)b * C + lane] = silbc;
  }
}

template <typename T, bool LA, bool HIST>
cudaError_t launch_block(const Args<T>& a, int threads, size_t smem, cudaStream_t stream) {
  const cudaError_t err = search::allow_smem(wcts_scan_kernel<T, LA, HIST>, smem);
  if (err != cudaSuccess) return err;
  wcts_scan_kernel<T, LA, HIST><<<a.B, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int SPT, bool LA, bool HIST>
cudaError_t launch_owner(const Args<T>& a, const OwnerLayout& L, int threads,
                         cudaStream_t stream) {
  const cudaError_t err = search::allow_smem(wcts_owner_kernel<T, SPT, LA, HIST>, L.total);
  if (err != cudaSuccess) return err;
  wcts_owner_kernel<T, SPT, LA, HIST><<<a.B, threads, L.total, stream>>>(a, L);
  return cudaGetLastError();
}

// threads of the owner instance's block at SPT contexts a thread:
// ceil(C / SPT) context groups of one thread a node
template <int SPT>
int owner_threads(int C, int N) {
  return (C + SPT - 1) / SPT * owner_nodes_padded(N);
}

// whether the owner instance with SPT contexts a thread takes the shape: at
// most 32 contexts (one a lane), fewer words than contexts, its threads
// within the configuration's bound and its state (with the lookahead's
// table, so that the choice does not depend on it) within SHARED_LIMIT
template <typename T>
bool owner_takes(int spt, int C, int N, int W, int S, int bins) {
  if (C > OWNER_MAX_C || W >= C) return false;
  bool fits;
  switch (spt) {
    case 8: fits = owner_threads<8>(C, N) <= OwnerCfg<8>::MAXT; break;
    case 16: fits = owner_threads<16>(C, N) <= OwnerCfg<16>::MAXT; break;
    default: return false;
  }
  return fits && OwnerLayout::of<T>(C, N, W, S, bins, true).total <= search::SHARED_LIMIT;
}

// the instance the C entry launches for a shape: the owner instance's
// contexts a thread (8 for up to 8 contexts, else 16, or 8 where 16 would
// take too many threads), or the block instance with its state in shared
// memory (0) or in device scratch (-1)
template <typename T>
int instance_for(int C, int N, int W, int S, int bins) {
  if (C <= 8 && owner_takes<T>(8, C, N, W, S, bins)) return 8;
  if (owner_takes<T>(16, C, N, W, S, bins)) return 16;
  if (owner_takes<T>(8, C, N, W, S, bins)) return 8;
  return Layout::of<T>(C, N, W, bins).total <= search::SHARED_LIMIT ? 0 : -1;
}

template <typename T, int SPT>
cudaError_t launch_owner_flags(const Args<T>& a, const OwnerLayout& L, bool la, bool hist,
                               cudaStream_t st) {
  const int threads = owner_threads<SPT>(a.C, a.N);
  if (la && hist) return launch_owner<T, SPT, true, true>(a, L, threads, st);
  if (la) return launch_owner<T, SPT, true, false>(a, L, threads, st);
  if (hist) return launch_owner<T, SPT, false, true>(a, L, threads, st);
  return launch_owner<T, SPT, false, false>(a, L, threads, st);
}

template <typename T>
size_t utterance_bytes(int C, int N, int W, int bins) {
  return Layout::of<T>(C, N, W, bins).total;
}

template <typename T>
int launch(void* const* p, int B, int Tn, int S, int C, int N, int W, int t0, double thr,
           int prune, int use_la, int state_limit, int bins, int sil, int force, int device,
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
  const cudaStream_t st = (cudaStream_t)stream;
  const bool la = prune && use_la;
  // force: 0 the instance the shape chooses; 1 the block instance; 8 or 16
  // the owner instance with that many contexts a thread
  int inst = force == 0 ? instance_for<T>(C, N, W, S, a.bins) : force;
  if (force > 1 && !owner_takes<T>(force, C, N, W, S, a.bins)) return (int)cudaErrorInvalidValue;
  if (inst > 1) {
    const OwnerLayout L = OwnerLayout::of<T>(C, N, W, S, a.bins, la);
    a.scratch = nullptr;
    switch (inst) {
      case 8: err = launch_owner_flags<T, 8>(a, L, la, hist, st); break;
      case 16: err = launch_owner_flags<T, 16>(a, L, la, hist, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)err;
  }
  a.L = Layout::of<T>(C, N, W, a.bins);
  const bool in_scratch = a.L.total > search::SHARED_LIMIT;
  if (in_scratch && a.scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (!in_scratch) a.scratch = nullptr;
  const int threads = search::threads_for((long long)C * N);
  const size_t smem = in_scratch ? 0 : a.L.total;
  if (la && hist) err = launch_block<T, true, true>(a, threads, smem, st);
  else if (la) err = launch_block<T, true, false>(a, threads, smem, st);
  else if (hist) err = launch_block<T, false, true>(a, threads, smem, st);
  else err = launch_block<T, false, false>(a, threads, smem, st);
  return (int)err;
}

template <typename T, typename K>
int occupancy(K kernel, int threads, size_t smem) {
  int n = 0;
  cudaError_t err = search::allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return err == cudaSuccess ? n : -1;
}

template <typename T, int SPT>
int owner_residency(int C, int N, int W, int S, int bins, bool la, bool hist) {
  const int threads = owner_threads<SPT>(C, N);
  const size_t smem = OwnerLayout::of<T>(C, N, W, S, bins, la).total;
  if (la && hist) return occupancy<T>(wcts_owner_kernel<T, SPT, true, true>, threads, smem);
  if (la) return occupancy<T>(wcts_owner_kernel<T, SPT, true, false>, threads, smem);
  if (hist) return occupancy<T>(wcts_owner_kernel<T, SPT, false, true>, threads, smem);
  return occupancy<T>(wcts_owner_kernel<T, SPT, false, false>, threads, smem);
}

template <typename T>
int residency(int C, int N, int W, int S, int bins, int use_la, int force) {
  const bool hist = bins > 0, la = use_la != 0;
  const int inst = force == 0 ? instance_for<T>(C, N, W, S, bins) : force;
  if (inst > 1 && !owner_takes<T>(inst, C, N, W, S, bins)) return -1;
  switch (inst) {
    case 8: return owner_residency<T, 8>(C, N, W, S, bins, la, hist);
    case 16: return owner_residency<T, 16>(C, N, W, S, bins, la, hist);
    default: break;
  }
  const Layout L = Layout::of<T>(C, N, W, bins);
  const size_t smem = L.total > search::SHARED_LIMIT ? 0 : L.total;
  const int threads = search::threads_for((long long)C * N);
  if (la && hist) return occupancy<T>(wcts_scan_kernel<T, true, true>, threads, smem);
  if (la) return occupancy<T>(wcts_scan_kernel<T, true, false>, threads, smem);
  if (hist) return occupancy<T>(wcts_scan_kernel<T, false, true>, threads, smem);
  return occupancy<T>(wcts_scan_kernel<T, false, false>, threads, smem);
}

}  // namespace

// bytes of device scratch an utterance needs (0: its state stays in shared
// memory; -1: too large) for C contexts, N nodes, W words, S states and
// `bins` histogram bins (0 without histogram pruning); f64 != 0 for float64.
// Only the block instance past SHARED_LIMIT needs it.
extern "C" int sr_wcts_scan_scratch(int C, int N, int W, int S, int bins, int f64) {
  const int inst = f64 ? instance_for<double>(C, N, W, S, bins)
                       : instance_for<float>(C, N, W, S, bins);
  if (inst >= 0) return 0;
  const size_t n = f64 ? utterance_bytes<double>(C, N, W, bins)
                       : utterance_bytes<float>(C, N, W, bins);
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

// the instance sr_wcts_scan launches for a shape: the owner instance's
// contexts a thread (8 or 16); the block instance with its state in shared
// memory (0) or in device scratch (-1)
extern "C" int sr_wcts_scan_instance(int C, int N, int W, int S, int bins, int f64) {
  return f64 ? instance_for<double>(C, N, W, S, bins) : instance_for<float>(C, N, W, S, bins);
}

// blocks one SM holds of the launch sr_wcts_scan makes for a shape (bins 0:
// no histogram; use_lookahead != 0: the lookahead's kernel), with force as
// there (0: the instance the shape chooses), by the occupancy calculator;
// -1 on an error or a forced instance that does not take the shape
extern "C" int sr_wcts_scan_residency(int C, int N, int W, int S, int bins, int f64,
                                      int use_lookahead, int force) {
  return f64 ? residency<double>(C, N, W, S, bins, use_lookahead, force)
             : residency<float>(C, N, W, S, bins, use_lookahead, force);
}

// The float arrays (am, tdp, entry_pen, lm_ext, la, the carried scores and
// the per-frame scores) in float (f64 == 0) or double; the optional outputs
// null where not asked for; via is one byte a flag. force 0 launches the
// instance the shape chooses (sr_wcts_scan_instance; the wrapper passes 0),
// 1 the block instance, 8 or 16 the owner instance with that many contexts
// a thread (timing the first design and the owner's configurations beside
// one another).
extern "C" int sr_wcts_scan(
    int f64, const void* am, const int* feat_len, const int* state, const int* parent,
    const int* grand, const void* tdp, const int* loop_allowed, const int* entry_state,
    const void* entry_pen, const int* end_node, const void* lm_ext, const void* la,
    const void* hyp_in, const int* bkp_in, const void* book_in, const void* silp_in,
    const int* silb_in, void* hyp_out, int* bkp_out, void* book_c, void* silp_c, int* silb_c,
    void* book, int* bkp, int* pred, void* offset, void* cand, int* ebkp, int* st_states,
    int* st_trees, int* st_ends, void* via, int* silb_prev, void* silp_t, int* silb_t,
    void* scratch, int B, int T, int S, int C, int N, int W, int t0, double am_threshold,
    int prune, int use_lookahead, int state_limit, int bins, int sil, int force, int device,
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
                              state_limit, bins, sil, force, device, stream)
             : launch<float>(p, B, T, S, C, N, W, t0, am_threshold, prune, use_lookahead,
                             state_limit, bins, sil, force, device, stream);
}
