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
//     the first v at the minimum;
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
// Two designs, both one block an utterance (B 130 on AN4 fills one wave of
// the 132 SMs); the C entry chooses from the shape (sr_linear_scan_instance)
// unless asked for the first design (first_design), which stays for timing
// in turns and for every lexicon past the warp instance's limits.
//
// The warp instance: 16 warps. Warp k owns a contiguous range of the words
// (8 or 9 of AN4's 130) and the silence copies of the same predecessors
// (the last warp also the start context's), its entities, and every
// lattice slot of them: a word's max(word_len, last_pos + 1) positions (the
// last is its end), a copy's Ps; a lane takes every 32nd of the warp's
// slots. Per frame:
//   (a) the min-plus product: G = 32 / (words a warp) lanes a word (3 at
//       AN4), lane k of a group folds the predecessors v = k (mod G) in
//       order by a strict < (lm_ext transposed into shared memory once,
//       conflict-free rows; the effective books ebk from shared memory),
//       then the group's first lane takes the least (value, v) of its lanes
//       by shuffles (search::pair_less): the reference's first argmin, and
//       its value (a warp-wide fold by redux.sync on order keys, a word at a
//       time, was slower: its reductions, not its adds, set the pace);
//   (b) the slots in rounds of 32 from the warp's last slot to its first: a
//       round reads its cells and their two left neighbours, then (after a
//       __syncwarp) writes its new raw scores and packed backpointers in
//       place. No later round reads a cell that a round writes, so the next
//       round's reads are issued before this round's writes, and neither a
//       30-step walk nor a second buffer is needed. Cells hold raw scores; a
//       reader renormalises and prunes by the last live frame's minimum, so
//       there is no renormalisation pass either;
//   (c) the warp's minimum; a barrier; the joint minimum from the 16
//       warps' by one redux; a lane an entity renormalises its end into the
//       frame's book and outputs; a lane a silence copy forms the next
//       frame's effective book, via and origin of its predecessor (word v's
//       book and copy v's end are the same warp's; by frame parity); a
//       barrier publishes them and the next frame's emissions (cp.async, in
//       flight during the frame).
// Two barriers a frame. lm_ext (68 KB in float32, 136 KB in float64), the
// cells (raw score and packed backpointers, 8 or 12 bytes a slot over
// W x P + V x Ps) and the descriptors stay in shared memory: 129 / 220 KB
// of the 227 KB a block may hold at AN4's 130 x 30 (float32 / float64);
// the TDPs come through L1 (float32) or L2 (float64). Limits: at most 64
// entities a warp, P and Ps <= 256, S <= 65,536, T < 2^22, V < 1,024 and
// the state in shared memory (W up to 189 / 135 at P 30).
//
// What bounds it: the frame chain, two barriers and the dependent work
// between them ((a) a 44-step fold a lane at AN4, (b) four or five rounds
// of a slot's loads and compare-selects, (c) the ends); the bytes' bound
// (am read, the outputs written) is the floor. The first design's 131-step
// loop of dependent loads a frame is gone.
//
// The first design: a thread a word and a silence copy; a thread loops over
// the predecessors in order and takes a candidate only when strictly
// smaller. The lattice
// is updated in place: a thread walks its word's positions from the last to
// the first, so each position reads its own and its two left neighbours'
// scores before they are overwritten; the raw scores are stored in the first
// pass and renormalised in the second, once the block's minimum is known.
// The lattice, the silence copies, the frame's emissions and the books live
// in shared memory (AN4's 130 x 30 lattice: about 57 KB in float32, 73 KB in
// float64), past search::SHARED_LIMIT in device scratch
// (sr_linear_scan_scratch gives the bytes an utterance). lm_ext is read
// through the read-only cache, coalesced over the words. A frame is a
// V-step min-plus loop, a P-step walk and three barriers.

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
        if (search::takes(c, rec)) {
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


// -- the warp instance ----------------------------------------------------------------

constexpr int NW = 16;                  // warps a block
constexpr int WARP_THREADS = NW * 32;
constexpr int MAX_ENT = 64;             // entities (words, silence copies) a warp
constexpr int BKP_BITS = 22;            // a cell's entry frame; its predecessor above
constexpr unsigned BKP_MASK = (1u << BKP_BITS) - 1u;
constexpr size_t MAX_SMEM = 227 * 1024;

// per utterance, in shared memory: lm_ext transposed [W][V]; the cells of
// every slot (the live positions of the words, max(word_len, last_pos + 1)
// each, and the V silence copies' Ps), their raw scores h and packed
// backpointers bp (entry frame | predecessor << 22; a silence cell's
// origin), and their descriptors desc; the emissions of two frames; the
// books book [W], silend, silorg [V]; the effective books ebk, via and
// origin [V] of two frames (by parity); the words' entries recv, recp [W];
// the raw word ends endv, endb, endp [W] and silence ends silv, silo [V];
// the warps' minima part and slot counts base
struct WarpLayout {
  size_t lm, h, bp, desc, em, book, silend, silorg, ebk, via, origin, recv, recp, endv, endb,
      endp, silv, silo, part, base, total;
  template <typename T>
  static WarpLayout of(int W, int P, int Ps, int S) {
    const size_t V = (size_t)W + 1, slots = (size_t)W * P + V * Ps;
    WarpLayout L;
    size_t o = 0;
    auto put = [&o](size_t& field, size_t bytes) {
      field = o;
      o += search::align16(bytes);
    };
    put(L.lm, (size_t)W * V * sizeof(T));
    put(L.h, slots * sizeof(T));
    put(L.bp, slots * sizeof(int));
    put(L.desc, slots * sizeof(unsigned));
    put(L.em, 2 * (size_t)S * sizeof(T));
    put(L.book, W * sizeof(T));
    put(L.silend, V * sizeof(T));
    put(L.silorg, V * sizeof(int));
    put(L.ebk, 2 * V * sizeof(T));
    put(L.via, 2 * V * sizeof(int));
    put(L.origin, 2 * V * sizeof(int));
    put(L.recv, W * sizeof(T));
    put(L.recp, W * sizeof(int));
    put(L.endv, W * sizeof(T));
    put(L.endb, W * sizeof(int));
    put(L.endp, W * sizeof(int));
    put(L.silv, V * sizeof(T));
    put(L.silo, V * sizeof(int));
    put(L.part, NW * sizeof(T));
    put(L.base, NW * sizeof(int));
    L.total = o;
    return L;
  }
};

// the warp instance takes the shape: the state in shared memory, at most 64
// entities a warp, descriptors of 16 state bits and 8 position bits, entry
// frames in 22 bits and predecessors in 10
template <typename T>
bool warp_instance_fits(int W, int P, int Ps, int S, int Tn) {
  const int ent = 2 * ((W + NW - 1) / NW) + 1;
  return W >= 1 && W + 1 < (1 << (32 - BKP_BITS)) && ent <= MAX_ENT && P >= 2 && P <= 256 &&
         Ps >= 1 && Ps <= 256 && S >= 1 && S <= 65536 && Tn < (1 << BKP_BITS) &&
         WarpLayout::of<T>(W, P, Ps, S).total <= MAX_SMEM;
}

__device__ __forceinline__ unsigned pack_bp(int bkp, int pred) {
  return (unsigned)bkp | ((unsigned)pred << BKP_BITS);
}

// copies of 4 or 8 bytes from device to shared memory, in flight until
// cp_async_wait
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// the exclusive prefix of x over the warp's lanes, and the total
__device__ __forceinline__ int warp_scan(int x, int lane, int& total) {
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(search::FULL, incl, o);
    if (lane >= o) incl += y;
  }
  total = __shfl_sync(search::FULL, incl, 31);
  return incl - x;
}

// a lane's reads for one slot of a round: descriptor, its cell and its two
// left neighbours (raw), emission, transitions, the entry's score before the
// emission (BIG past position 1) and what an entry carries (predecessor or
// origin)
template <typename T>
struct SlotIn {
  bool act;
  unsigned d, b0, b1, b2;
  int o;
  T h0, h1, h2, a, t0, t1, t2, e;
};

template <typename T>
__global__ void __launch_bounds__(WARP_THREADS, 1) linear_scan_warp_kernel(
    const T* __restrict__ am, const int* __restrict__ feat_len,
    const int* __restrict__ state_table, const int* __restrict__ last_pos,
    const int* __restrict__ word_len, const T* __restrict__ tdpw, const T* __restrict__ entp,
    const int* __restrict__ sil_states, const T* __restrict__ stdp,
    const T* __restrict__ sentp, const T* __restrict__ lm, T* __restrict__ book_out,
    int* __restrict__ bkp_out, int* __restrict__ pred_out, bool* __restrict__ via_out,
    int* __restrict__ origin_out, T* __restrict__ silend_out, int* __restrict__ silorg_out,
    T* __restrict__ offset_out, WarpLayout L, int B, int Tn, int S, int W, int P, int Ps,
    T sexit, T thr, int prune) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T BIG = big<T>();
  const T HALF = BIG * T(0.5);
  const int b = blockIdx.x;
  const int V = W + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* lmT = reinterpret_cast<T*>(smem + L.lm);
  T* h = reinterpret_cast<T*>(smem + L.h);
  unsigned* bp = reinterpret_cast<unsigned*>(smem + L.bp);
  unsigned* desc = reinterpret_cast<unsigned*>(smem + L.desc);
  T* em = reinterpret_cast<T*>(smem + L.em);
  T* book = reinterpret_cast<T*>(smem + L.book);
  T* silend = reinterpret_cast<T*>(smem + L.silend);
  int* silorg = reinterpret_cast<int*>(smem + L.silorg);
  T* ebk = reinterpret_cast<T*>(smem + L.ebk);
  int* via = reinterpret_cast<int*>(smem + L.via);
  int* origin = reinterpret_cast<int*>(smem + L.origin);
  T* recv = reinterpret_cast<T*>(smem + L.recv);
  int* recp = reinterpret_cast<int*>(smem + L.recp);
  T* endv = reinterpret_cast<T*>(smem + L.endv);
  int* endb = reinterpret_cast<int*>(smem + L.endb);
  int* endp = reinterpret_cast<int*>(smem + L.endp);
  T* silv = reinterpret_cast<T*>(smem + L.silv);
  int* silo = reinterpret_cast<int*>(smem + L.silo);
  T* part = reinterpret_cast<T*>(smem + L.part);
  int* base = reinterpret_cast<int*>(smem + L.base);

  // this warp's entities: words [w0, w1) (8 or 9 of AN4's 130), then the
  // silence copies of the same predecessors (the last warp also the start
  // context's, v = W); entity j is word w0 + j or copy w0 + j - nw
  const int w0 = warp * W / NW, w1 = (warp + 1) * W / NW;
  const int nw = w1 - w0, nv = nw + (warp == NW - 1);
  const int ne = nw + nv;
  auto slots_of = [&](int j) {
    if (j >= ne) return 0;
    if (j >= nw) return Ps;
    const int w = w0 + j;
    return min(P, max(word_len[w], last_pos[w] + 1));
  };

  // set-up: lm_ext transposed, the books and the first frame's effective
  // books (the start context 0), its emissions in flight, the slot counts
  for (int e = threadIdx.x; e < V * W; e += WARP_THREADS) {
    const int v = e / W, w = e - v * W;
    lmT[w * V + v] = lm[e];
  }
  for (int v = threadIdx.x; v < V; v += WARP_THREADS) {
    if (v < W) book[v] = BIG;
    silend[v] = BIG;
    silorg[v] = 0;
    ebk[v] = v < W ? BIG : T(0);
    via[v] = 0;
    origin[v] = 0;
  }
  if (Tn > 0) {
    for (int s = threadIdx.x; s < S; s += WARP_THREADS) cp_async(em + s, am + (size_t)b * Tn * S + s);
    cp_async_commit();
  }
  int n0 = slots_of(lane), n1 = slots_of(lane + 32), tot0, tot1;
  const int off0 = warp_scan(n0, lane, tot0);
  const int off1 = tot0 + warp_scan(n1, lane, tot1);
  if (lane == 0) base[warp] = tot0 + tot1;
  cp_async_wait();
  __syncthreads();
  int start = 0;
  for (int k = 0; k < warp; ++k) start += base[k];
  const int nslots = base[warp];
  // the descriptors (state 16 bits | position 8 | entity 6 | end | invalid)
  // and the first cells: BIG, entered at 0 from the sentence start
  for (int q = 0; q < 2; ++q) {
    const int j = lane + 32 * q, n = q ? n1 : n0, off = start + (q ? off1 : off0);
    for (int p = 0; p < n; ++p) {
      unsigned st, flags;
      if (j < nw) {
        const int w = w0 + j;
        st = (unsigned)state_table[w * P + p];
        flags = (p == last_pos[w] ? 1u << 30 : 0u) | (p >= word_len[w] ? 1u << 31 : 0u);
      } else {
        st = (unsigned)sil_states[p];
        flags = p == Ps - 1 ? 1u << 30 : 0u;
      }
      desc[off + p] = st | ((unsigned)p << 16) | ((unsigned)j << 24) | flags;
      h[off + p] = BIG;
      bp[off + p] = j < nw ? pack_bp(0, W) : 0u;
    }
  }
  // the min-plus product's lanes: G lanes a word, lane k of a group the
  // predecessors v = k (mod G)
  const int G = max(1, 32 / ((W + NW - 1) / NW));
  const int gj = lane / G, gk = lane - gj * G;
  const int len = feat_len[b];
  T best_state = T(0);  // the last live frame's minimum: the cells hold raw scores
  __syncwarp();

  for (int i = 0; i < Tn; ++i) {
    const int t = i + 1;  // 1-based frame index
    const bool alive = t <= len;
    const T* em_t = em + (size_t)(i & 1) * S;
    const T* ebk_t = ebk + (i & 1) * V;
    const int* via_t = via + (i & 1) * V;
    const int* org_t = origin + (i & 1) * V;
    const size_t ow = ((size_t)i * B + b) * W;
    const size_t ov = ((size_t)i * B + b) * V;
    if (i + 1 < Tn) {
      T* next = em + (size_t)((i + 1) & 1) * S;
      const T* src = am + ((size_t)b * Tn + i + 1) * S;
      for (int s = threadIdx.x; s < S; s += WARP_THREADS) cp_async(next + s, src + s);
      cp_async_commit();
    }
    for (int j = lane; j < nv; j += 32) origin_out[ov + w0 + j] = org_t[w0 + j];

    // (a) the warp's words' entries, min_v ebook[v] + lm[v, w] and the first
    // v at the minimum: a lane folds its predecessors in order by a strict <,
    // then the group's first lane takes the least (value, v) of its lanes
    {
      T pv = search::infinity<T>();
      int pi = INT_MAX;
      if (gj < nw && gk < V) {
        const T* row = lmT + (size_t)(w0 + gj) * V;
        pv = add(ebk_t[gk], row[gk]);
        pi = gk;
#pragma unroll 4
        for (int v = gk + G; v < V; v += G) {
          const T c = add(ebk_t[v], row[v]);
          if (search::takes(c, pv)) {
            pv = c;
            pi = v;
          }
        }
      }
      T bv = pv;
      int bi = pi;
      for (int s = 1; s < G; ++s) {
        const T sv = __shfl_down_sync(search::FULL, pv, s);
        const int oi = __shfl_down_sync(search::FULL, pi, s);
        if (search::pair_less(sv, oi, bv, bi)) {
          bv = sv;
          bi = oi;
        }
      }
      if (gj < nw && gk == 0) {
        recv[w0 + gj] = bv;
        recp[w0 + gj] = bi;
      }
    }
    __syncwarp();

    // (b) the warp's slots, a lane every 32nd, rounds from the last to the
    // first: a round reads its cells and their two left neighbours (raw,
    // renormalised and pruned by the last live frame's minimum as they are
    // read), then writes its new raw cells. A round writes no cell that a
    // later round reads, nor one that the round after it reads, so the next
    // round's reads are issued before this round's writes.
    auto ren = [&](T v) {
      v = search::renorm(v, best_state);
      return prune && v > thr ? BIG : v;
    };
    auto load = [&](int r, SlotIn<T>& x) {
      x.act = r >= 0 && 32 * r + lane < nslots;
      if (!x.act) return;
      const int gi = start + 32 * r + lane;
      x.d = desc[gi];
      const int p = (int)((x.d >> 16) & 0xffu), j = (int)((x.d >> 24) & 63u);
      x.h0 = h[gi];
      x.b0 = bp[gi];
      x.h1 = p >= 1 ? h[gi - 1] : BIG;
      x.b1 = p >= 1 ? bp[gi - 1] : 0u;
      x.h2 = p >= 2 ? h[gi - 2] : BIG;
      x.b2 = p >= 2 ? bp[gi - 2] : 0u;
      x.a = em_t[x.d & 0xffffu];
      if (j < nw) {
        const int w = w0 + j, sl = w * P + p;
        x.t0 = tdpw[3 * sl];
        x.t1 = tdpw[3 * sl + 1];
        x.t2 = tdpw[3 * sl + 2];
        x.e = p < 2 ? add(recv[w], entp[2 * w + p]) : BIG;
        x.o = p < 2 ? recp[w] : W;
      } else {
        const int v = w0 + j - nw;
        x.t0 = stdp[3 * p];
        x.t1 = stdp[3 * p + 1];
        x.t2 = stdp[3 * p + 2];
        x.e = p < 2 ? add(ebk_t[v], sentp[p]) : BIG;
        x.o = org_t[v];
      }
    };
    T m = BIG;
    SlotIn<T> cur;
    load((nslots + 31) / 32 - 1, cur);
    for (int r = (nslots + 31) / 32 - 1; r >= 0; --r) {
      SlotIn<T> nxt;
      load(r - 1, nxt);
      T nh = BIG;
      unsigned nbp = 0;
      if (cur.act) {
        const unsigned d = cur.d;
        const int p = (int)((d >> 16) & 0xffu), j = (int)((d >> 24) & 63u);
        const bool word = j < nw;
        const unsigned none = word ? pack_bp(0, W) : 0u;
        const T c0 = add(ren(cur.h0), cur.t0);
        const T c1 = p >= 1 ? add(ren(cur.h1), cur.t1) : BIG;
        const T c2 = p >= 2 ? add(ren(cur.h2), cur.t2) : BIG;
        T wv = c2;
        unsigned wbp = p >= 2 ? cur.b2 : none;
        if (c1 < wv) {
          wv = c1;
          wbp = p >= 1 ? cur.b1 : none;
        }
        if (c0 < wv) {
          wv = c0;
          wbp = cur.b0;
        }
        wv = add(wv, cur.a);
        const T entry = p < 2 ? add(cur.e, cur.a) : BIG;
        if (entry <= wv) {
          nh = entry;
          nbp = word ? pack_bp(t - 1, cur.o) : (unsigned)cur.o;
        } else {
          nh = wv;
          nbp = wbp;
        }
        if ((d >> 31) & 1u) nh = BIG;
        nh = tmin(nh, BIG);
        if ((d >> 30) & 1u) {
          if (word) {
            const int w = w0 + j;
            endv[w] = nh;
            endb[w] = (int)(nbp & BKP_MASK);
            endp[w] = (int)(nbp >> BKP_BITS);
          } else {
            const int v = w0 + j - nw;
            silv[v] = nh;
            silo[v] = (int)nbp;
          }
        }
        m = tmin(m, nh);
      }
      __syncwarp();
      if (cur.act && alive) {
        const int gi = start + 32 * r + lane;
        h[gi] = nh;
        bp[gi] = nbp;
      }
      cur = nxt;
    }
    m = keys::warp_minimum_nan(m);
    if (lane == 0) part[warp] = m;
    __syncthreads();  // the warps' minima and the raw ends are visible

    // (c) the joint minimum; a lane an entity: the frame's books and outputs;
    // then a lane a silence copy the next frame's effective book, via and
    // origin of its predecessor (word w's book and copy w's end are this
    // warp's)
    T best = keys::warp_minimum_nan(lane < NW ? part[lane] : BIG);
    if (best >= HALF) best = T(0);
    for (int j = lane; j < ne; j += 32) {
      if (j < nw) {
        const int w = w0 + j;
        T e = search::renorm(endv[w], best);
        if (prune && e > thr) e = BIG;
        e = e >= HALF ? BIG : e;
        const int np = endp[w];
        book_out[ow + w] = e;
        bkp_out[ow + w] = endb[w];
        pred_out[ow + w] = np;
        via_out[ow + w] = via_t[np] != 0;
        if (alive) book[w] = e;
      } else {
        const int v = w0 + j - nw;
        T e = search::renorm(silv[v], best);
        if (prune && e > thr) e = BIG;
        e = e >= HALF ? BIG : add(e, sexit);
        silend_out[ov + v] = e;
        silorg_out[ov + v] = silo[v];
        if (alive) {
          silend[v] = e;
          silorg[v] = silo[v];
        }
      }
    }
    __syncwarp();
    for (int j = lane; j < nv; j += 32) {
      const int v = w0 + j, nx = ((i + 1) & 1) * V + v;
      const T bk = v < W ? book[v] : BIG;  // the start context from frame 2 on
      const T se = silend[v];
      const bool vp = se < bk;
      ebk[nx] = tmin(bk, se);
      via[nx] = vp;
      origin[nx] = vp ? silorg[v] : t;
    }
    if (threadIdx.x == 0) offset_out[(size_t)i * B + b] = alive ? best : T(0);
    if (alive) best_state = best;
    cp_async_wait();
    __syncthreads();  // the books and the next frame's emissions are visible
  }
}

template <typename T>
int launch(const void* am, const int* feat_len, const int* state_table, const int* last_pos,
           const int* word_len, const void* tdpw, const void* entp, const int* sil_states,
           const void* stdp, const void* sentp, const void* lm, void* book, int* bkp,
           int* pred, bool* via, int* origin, void* silend, int* silorg, void* offset,
           void* scratch, int B, int Tn, int S, int W, int P, int Ps, double sexit, double thr,
           int prune, int first_design, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Tn == 0) return (int)cudaSuccess;
  if (W == 0 || P < 2 || Ps < 1) return (int)cudaErrorInvalidValue;
  if (!first_design && warp_instance_fits<T>(W, P, Ps, S, Tn)) {
    const WarpLayout L = WarpLayout::of<T>(W, P, Ps, S);
    err = search::allow_smem(linear_scan_warp_kernel<T>, L.total);
    if (err != cudaSuccess) return (int)err;
    linear_scan_warp_kernel<T><<<B, WARP_THREADS, L.total, (cudaStream_t)stream>>>(
        static_cast<const T*>(am), feat_len, state_table, last_pos, word_len,
        static_cast<const T*>(tdpw), static_cast<const T*>(entp), sil_states,
        static_cast<const T*>(stdp), static_cast<const T*>(sentp), static_cast<const T*>(lm),
        static_cast<T*>(book), bkp, pred, via, origin, static_cast<T*>(silend), silorg,
        static_cast<T*>(offset), L, B, Tn, S, W, P, Ps, T(sexit), T(thr), prune);
    return (int)cudaGetLastError();
  }
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
int instance(int W, int P, int Ps, int S, int Tn) {
  if (warp_instance_fits<T>(W, P, Ps, S, Tn)) return 1;
  return Layout::of<T>(W, P, Ps, S).total > search::SHARED_LIMIT ? -1 : 0;
}

template <typename T>
int residency(int W, int P, int Ps, int S, int first_design) {
  int n = 0;
  cudaError_t err;
  if (!first_design && warp_instance_fits<T>(W, P, Ps, S, 1)) {
    const size_t smem = WarpLayout::of<T>(W, P, Ps, S).total;
    err = search::allow_smem(linear_scan_warp_kernel<T>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, linear_scan_warp_kernel<T>,
                                                          WARP_THREADS, smem);
    return err == cudaSuccess ? n : -1;
  }
  const Layout L = Layout::of<T>(W, P, Ps, S);
  const size_t smem = L.total > search::SHARED_LIMIT ? 0 : L.total;
  err = search::allow_smem(linear_scan_kernel<T>, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, linear_scan_kernel<T>,
                                                        search::threads_for(W + 1), smem);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// bytes of device scratch an utterance of the first design needs (0: its
// state stays in shared memory; -1: too large); f64 != 0 for the float64 scan
extern "C" int sr_linear_scan_scratch(int W, int P, int Ps, int S, int f64) {
  const size_t n =
      f64 ? Layout::of<double>(W, P, Ps, S).total : Layout::of<float>(W, P, Ps, S).total;
  if (n <= search::SHARED_LIMIT) return 0;
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

// kernel M's instance for that shape: 1 the warp instance; the first design
// with its state in shared memory (0) or in device scratch (-1)
extern "C" int sr_linear_scan_instance(int W, int P, int Ps, int S, int T, int f64) {
  return f64 ? instance<double>(W, P, Ps, S, T) : instance<float>(W, P, Ps, S, T);
}

// am [B, T, S], tdp_within, entry_pen, sil_tdp, sil_entry_pen, lm_ext, book,
// silend [T, B, ...] and offset in float (f64 == 0) or double; the rest int
// (via bool). sexit and thr are already in the score type. first_design 0:
// the instance sr_linear_scan_instance names (scratch, of
// sr_linear_scan_scratch bytes an utterance, only for -1); 1: the first
// design (in scratch where that query says so).
extern "C" int sr_linear_scan(int f64, const void* am, const int* feat_len,
                              const int* state_table, const int* last_pos, const int* word_len,
                              const void* tdp_within, const void* entry_pen,
                              const int* sil_states, const void* sil_tdp,
                              const void* sil_entry_pen, const void* lm_ext, void* book,
                              int* bkp, int* pred, bool* via, int* origin, void* silend,
                              int* silorg, void* offset, void* scratch, int B, int T, int S,
                              int W, int P, int Ps, double sil_exit, double am_threshold,
                              int prune, int first_design, int device, void* stream) {
  return f64 ? launch<double>(am, feat_len, state_table, last_pos, word_len, tdp_within,
                              entry_pen, sil_states, sil_tdp, sil_entry_pen, lm_ext, book, bkp,
                              pred, via, origin, silend, silorg, offset, scratch, B, T, S, W, P,
                              Ps, sil_exit, am_threshold, prune, first_design, device, stream)
             : launch<float>(am, feat_len, state_table, last_pos, word_len, tdp_within,
                             entry_pen, sil_states, sil_tdp, sil_entry_pen, lm_ext, book, bkp,
                             pred, via, origin, silend, silorg, offset, scratch, B, T, S, W, P,
                             Ps, sil_exit, am_threshold, prune, first_design, device, stream);
}

// blocks one SM holds of kernel M's launch for that shape (first_design 0:
// the instance the shape chooses), by the occupancy calculator, or -1
extern "C" int sr_linear_scan_residency(int W, int P, int Ps, int S, int f64, int first_design) {
  return f64 ? residency<double>(W, P, Ps, S, first_design)
             : residency<float>(W, P, Ps, S, first_design);
}
