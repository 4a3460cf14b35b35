// Kernel B: time-synchronous word-loop Viterbi over one time chunk.
//
// Replaces speechrecognition_tpu/search/decoder.py::_decode_scan, the
// word-loop recursion that XLA fuses into one lax.scan (written op by op in
// PyTorch it costs about 30 launches per frame). Same inputs and outputs:
// am [B, T, S], feat_len [B], the lexicon / TDP tables, the carried lattice
// (hyp [B, W, P], bkp [B, W, P] i32, book [B]) and t0; it writes the carry
// after the chunk and, per frame, the best word end (score, word,
// backpointer), each [T, B]. The kernel is a template on the score type:
// float for the f32 path, double for the f64 parity path (Hopper has native
// float64; the reference runs the same _decode_scan in either dtype). BIG,
// its >= BIG/2 guards and the threshold are in the score type, as
// _decode_scan casts them.
//
// Per frame it follows the reference step exactly:
//   * within-word candidates from s, s-1 and s-2 with tdp_within; start at
//     the jump-2 candidate, take jump 1 if strictly less, then jump 0 if
//     strictly less (larger jumps win ties);
//   * entries into positions 0 and 1 cost (book_prev + entry_pen) plus the
//     acoustic score of the ENTERED position's state (kernel D charges the
//     word's first state, as its reference does); entries win ties (<=);
//   * invalid slots and min(new, BIG); the utterance's minimum; renormalize
//     with the >= BIG/2 guards; prune new > am_threshold;
//   * word ends at last_pos (+ exit_pen when given), argmin over words with
//     the first index winning ties; the end score capped at BIG from BIG/2;
//   * the utterance freezes once t > feat_len (outputs are still written).
// Every operation is an add, compare or select in the score type and
// BIG = 1e30 is a finite sentinel, so the kernel matches its plain PyTorch
// version bit for bit in both types. The minimum is exact in any order; the
// word end is the first index at the minimum. A NaN score is kept as the
// reference keeps it: the cap at BIG and the minimum give NaN where an
// operand is NaN (jnp.minimum, .min), and the word end is the first NaN
// (jnp.argmin).
//
// What bounds it: one frame's chain, and at the full batch instruction
// issue, not bytes (a chunk of 1,024 utterances x 320 frames reads 44 MB of
// float32 scores, 0.013 ms at 3.35 TB/s). Each frame depends on the
// previous one through the lattice, its minimum and the word end that the
// next entries read; on an H100 a float32 chunk takes 0.17 ms with one
// utterance an SM and 0.38 ms with eight, about 235 instructions a warp and
// frame. Two instances,
// chosen in the C entry from the lattice's shape alone
// (sr_decode_scan_instance), as kernel D's:
//   * P <= 32 and W <= 32 (SieTill: 12 x 24, the f32 and f64 decodes' main
//     path): one block per utterance of ceil(W/4) warps; 8 lanes a word and
//     K = ceil(P/8) consecutive positions a lane, so a word's neighbours are
//     shuffles within its 8-lane group. One __syncthreads a frame: before
//     it each warp publishes its exact minimum (redux.sync on an
//     order-preserving key: one for float, two for double) and the owner of
//     each word end its raw score and backpointer (double-buffered by frame
//     parity); after it every warp folds the minima in the same order,
//     renormalises its own slots, and chooses the word end itself from the
//     published raw scores (renormalised, pruned and given the exit penalty
//     by the owner's operations, then the first index at the minimum by
//     redux.sync on the keys and on the lane index), so the next frame's
//     entries need no second barrier. The lane that owns position 0 or 1
//     forms its entry from its own slot's emission. Each lane keeps the next
//     PREFETCH frames' emissions in registers, so device-memory latency
//     leaves the chain. Launch bounds cap the registers so that 8
//     utterances of 96 threads fit an SM: 1,024 utterances in one wave on
//     132 SMs. The first design gave each slot a thread, three
//     __syncthreads a frame and thread 0 a serial word-end scan; at 7
//     float32 and 5 float64 blocks an SM it took two waves.
//   * any other W x P: the block instance, one block of min(ceil(W*P/32)*32,
//     1024) threads per utterance, each looping over ceil(W*P/1024) slots,
//     two __syncthreads a frame, the word end by a block reduction of
//     (score, word) pairs; the lattice double-buffered by frame parity in
//     shared memory up to 1,024 slots (the query gives 0), beyond in device
//     scratch that the wrapper allocates (-1). Simple, not tuned.
// sr_decode_scan_residency gives the blocks an SM holds of the chosen
// instance's launch.

#include <cuda_runtime.h>

#include "keys.cuh"

namespace {

using keys::nan_first_key;
using keys::warp_minimum_nan;

constexpr unsigned FULL = 0xffffffffu;
constexpr int GROUP = 8;             // lanes a word in the warp instance
constexpr int WORDS_PER_WARP = 32 / GROUP;
constexpr int MAX_K = 4;             // positions a lane: P <= 32
constexpr int MAX_WARP_WORDS = 32;   // words of the warp instance: 8 warps
constexpr int PREFETCH = 2;          // frames of emissions in flight
constexpr int SHARED_SLOTS = 1024;   // the largest lattice the block instance keeps in shared memory
constexpr int BLOCK_THREADS = 1024;  // threads per utterance of the block instance, at most

template <typename T>
__device__ __forceinline__ T big() { return T(1e30); }

// the minimum of two scores, NaN where either is
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return keys::nan_min(a, b); }

// the first lane whose live value is the warp's minimum, a NaN first (lanes
// that are not live lose to every live one)
__device__ __forceinline__ int first_min_lane(float v, bool live) {
  const unsigned k = live ? nan_first_key(v) : FULL;
  const unsigned m = __reduce_min_sync(FULL, k);
  return (int)__reduce_min_sync(FULL, k == m ? (unsigned)(threadIdx.x & 31) : FULL);
}

__device__ __forceinline__ int first_min_lane(double v, bool live) {
  const unsigned long long k = nan_first_key(v);
  const unsigned hi = live ? (unsigned)(k >> 32) : FULL;
  const unsigned lo = live ? (unsigned)k : FULL;
  const unsigned mh = __reduce_min_sync(FULL, hi);
  const unsigned ml = __reduce_min_sync(FULL, hi == mh ? lo : FULL);
  return (int)__reduce_min_sync(FULL, hi == mh && lo == ml ? (unsigned)(threadIdx.x & 31) : FULL);
}

// within-word candidates from s, s-1 and s-2, the selection, the emission
// and the entry of one slot, then the validity guard and the cap at BIG:
// the new score, and its backpointer in nb (h1, b1 count only where p >= 1,
// h2, b2 only where p >= 2)
template <typename T>
__device__ __forceinline__ T slot_step(T h, int bk, T h1, int b1, T h2, int b2, T tw0, T tw1,
                                       T tw2, T am_v, T entry, int p, bool valid, int t,
                                       int& nb) {
  const T c0 = h + tw0;
  const T c1 = p >= 1 ? h1 + tw1 : big<T>();
  const T c2 = p >= 2 ? h2 + tw2 : big<T>();
  // the sequential selection (start at c2, take c1, then c0, if strictly
  // less) with its compares made independent
  const bool take1 = c1 < c2;
  const bool take0 = take1 ? c0 < c1 : c0 < c2;
  T within = take0 ? c0 : take1 ? c1 : c2;
  const int wb = take0 ? bk : take1 ? (p >= 1 ? b1 : 0) : (p >= 2 ? b2 : 0);
  within = within + am_v;
  T nv;
  if (entry <= within) {
    nv = entry;
    nb = t - 1;
  } else {
    nv = within;
    nb = wb;
  }
  if (!valid) nv = big<T>();
  return tmin(nv, big<T>());
}

// renormalisation by the row minimum (already 0 for a dead row) and pruning
template <typename T>
__device__ __forceinline__ T renorm(T nv, T best, T thr, int prune) {
  nv = nv >= big<T>() * T(0.5) ? big<T>() : nv - best;
  if (prune && nv > thr) nv = big<T>();
  return nv;
}

// ---- the warp instance: 8 lanes a word, K positions a lane -------------------------

// per frame parity: each warp's minimum; each word end's raw score and
// backpointer
template <typename T>
struct WarpShared {
  T wmin[2][MAX_WARP_WORDS / WORDS_PER_WARP];
  T end[2][MAX_WARP_WORDS];
  int endb[2][MAX_WARP_WORDS];
};

template <typename T, int K>
__global__ void __launch_bounds__(256, 3) decode_scan_warp_kernel(
    const T* __restrict__ am, const int* __restrict__ feat_len,
    const int* __restrict__ state_table, const int* __restrict__ last_pos,
    const int* __restrict__ word_len, const T* __restrict__ tdp_within,
    const T* __restrict__ entry_pen, const T* __restrict__ exit_pen,
    const T* __restrict__ hyp_in, const int* __restrict__ bkp_in,
    const T* __restrict__ book_in, T* __restrict__ hyp_out, int* __restrict__ bkp_out,
    T* __restrict__ book_out, T* __restrict__ score, int* __restrict__ word,
    int* __restrict__ bkp, int B, int Tn, int S, int W, int P, int t0, T am_threshold,
    int prune) {
  __shared__ WarpShared<T> s;
  const T BIG = big<T>();
  const T HALF = BIG * T(0.5);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = lane & (GROUP - 1);        // lane within the word's group
  const int w = warp * WORDS_PER_WARP + (lane >> 3);
  const bool wv = w < W;
  const int wc = wv ? w : 0;               // a word that exists, for loads
  const size_t off = (size_t)b * W * P;

  // per-slot constants; slot k of this lane is position p = l*K + k
  int st[K];
  T tw0[K], tw1[K], tw2[K], h[K];
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
    tw0[k] = real ? tdp_within[idx * 3 + 0] : BIG;
    tw1[k] = real ? tdp_within[idx * 3 + 1] : BIG;
    tw2[k] = real ? tdp_within[idx * 3 + 2] : BIG;
    h[k] = real ? hyp_in[off + idx] : BIG;
    bk[k] = real ? bkp_in[off + idx] : 0;
    if (real && p < wlen) valid |= 1u << k;
  }
  // the entry penalties of this lane's slots at positions 0 and 1 (lane 0's
  // first two slots, or lanes 0 and 1's first when K == 1)
  T ep[K < 2 ? K : 2];
#pragma unroll
  for (int k = 0; k < (K < 2 ? K : 2); ++k) {
    const int p = l * K + k;
    ep[k] = wv && p < 2 && p < P ? entry_pen[wc * 2 + p] : BIG;
  }
  // the word end this lane chooses among: word min(lane, W - 1)
  const int j = min(lane, W - 1);
  const T xp = exit_pen != nullptr ? exit_pen[j] : T(0);
  const T thr = am_threshold;
  T book = book_in[b];
  const int len = feat_len[b];

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
        const int t = t0 + i + 1;  // 1-based frame index
        const int par = i & 1;
        T a[K];
        const T* row = amb + (size_t)min(i + PREFETCH, Tn - 1) * S;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          a[k] = ring[q][k];
          ring[q][k] = row[st[k]];
        }
        // the two positions left of this lane's first slot: the lanes below
        const T left1 = __shfl_up_sync(FULL, h[K - 1], 1, GROUP);
        const int left1b = __shfl_up_sync(FULL, bk[K - 1], 1, GROUP);
        const int d2 = K >= 2 ? 1 : 2;
        const T left2 = __shfl_up_sync(FULL, h[K >= 2 ? K - 2 : 0], d2, GROUP);
        const int left2b = __shfl_up_sync(FULL, bk[K >= 2 ? K - 2 : 0], d2, GROUP);

        T nv[K];
        int nb[K];
        T m = BIG;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int p = l * K + k;
          const T h1 = k >= 1 ? h[k - 1] : left1;
          const int b1 = k >= 1 ? bk[k - 1] : left1b;
          const T h2 = k >= 2 ? h[k - 2] : (k == 1 ? left1 : left2);
          const int b2 = k >= 2 ? bk[k - 2] : (k == 1 ? left1b : left2b);
          const T entry = k < 2 && p < 2 ? (book + ep[k < 2 ? k : 0]) + a[k] : BIG;
          nv[k] = slot_step(h[k], bk[k], h1, b1, h2, b2, tw0[k], tw1[k], tw2[k], a[k], entry, p,
                            (valid >> k) & 1u, t, nb[k]);
          m = tmin(m, nv[k]);
          if (k == end_k) {
            s.end[par][w] = nv[k];
            s.endb[par][w] = nb[k];
          }
        }
        m = warp_minimum_nan(m);
        if (lane == 0) s.wmin[par][warp] = m;
        __syncthreads();  // the minima and the raw word ends are visible

        T best = s.wmin[par][0];
#pragma unroll
        for (int v = 1; v < MAX_WARP_WORDS / WORDS_PER_WARP; ++v)
          if (v < nwarps) best = tmin(best, s.wmin[par][v]);
        if (best >= HALF) best = T(0);

        // the word end, in every warp: lane j takes word j's published score
        // through the owner's renormalisation and pruning and the exit
        // penalty, then the first index at the minimum
        T e = renorm(s.end[par][j], best, thr, prune);
        if (exit_pen != nullptr) e = e + xp;
        const int eb = s.endb[par][j];
        const int bw = first_min_lane(e, lane < W);
        T bs = __shfl_sync(FULL, e, bw);
        const int bb = __shfl_sync(FULL, eb, bw);
        if (bs >= HALF) bs = BIG;
        if (threadIdx.x == 0) {
          score[(size_t)i * B + b] = bs;
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
      hyp_out[o] = h[k];
      bkp_out[o] = bk[k];
    }
  }
  if (threadIdx.x == 0) book_out[b] = book;
}

// ---- the block instance: any W*P, threads looping over the slots ------------------

// a word-end candidate: its score (exit penalty added), word and backpointer
template <typename T>
struct End {
  T v;
  int w, bk;
};

// (score, word) lexicographic: the smaller score, the smaller word on
// ties; a NaN before every other score
template <typename T>
__device__ __forceinline__ bool end_less(const End<T>& a, const End<T>& b) {
  if (a.v != a.v) return b.v == b.v || a.w < b.w;
  return a.v < b.v || (a.v == b.v && a.w < b.w);
}

// one block of min(ceil(W*P/32)*32, 1024) threads per utterance, thread x
// owning the slots x + k*blockDim.x; the lattice double-buffered by frame
// parity in lat_h / lat_b [2][W*P]: shared memory where lat_h is null, else
// the utterance's part of the wrapper's device scratch [B][2][W*P] (not
// restrict: the threads read one another's writes after __syncthreads)
template <typename T>
__global__ void __launch_bounds__(BLOCK_THREADS) decode_scan_block_kernel(
    const T* __restrict__ am, const int* __restrict__ feat_len,
    const int* __restrict__ state_table, const int* __restrict__ last_pos,
    const int* __restrict__ word_len, const T* __restrict__ tdp_within,
    const T* __restrict__ entry_pen, const T* __restrict__ exit_pen,
    const T* __restrict__ hyp_in, const int* __restrict__ bkp_in,
    const T* __restrict__ book_in, T* __restrict__ hyp_out, int* __restrict__ bkp_out,
    T* __restrict__ book_out, T* __restrict__ score, int* __restrict__ word,
    int* __restrict__ bkp, T* lat_h, int* lat_b, int B, int Tn, int S, int W, int P, int t0,
    T am_threshold, int prune) {
  extern __shared__ __align__(8) unsigned char smem[];
  __shared__ T s_wmin[BLOCK_THREADS / 32];
  __shared__ End<T> s_wend[BLOCK_THREADS / 32];
  const T BIG = big<T>();
  const T HALF = BIG * T(0.5);
  const int b = blockIdx.x;
  const int nwarps = blockDim.x / 32;
  const int WP = W * P;
  const size_t off = (size_t)b * WP;
  if (lat_h != nullptr) {
    lat_h += 2 * off;
    lat_b += 2 * off;
  } else {
    lat_h = reinterpret_cast<T*>(smem);
    lat_b = reinterpret_cast<int*>(lat_h + 2 * WP);
  }
  for (int s = threadIdx.x; s < WP; s += blockDim.x) {
    lat_h[s] = hyp_in[off + s];
    lat_b[s] = bkp_in[off + s];
  }
  T book = book_in[b];
  const int len = feat_len[b];
  __syncthreads();

  int buf = 0;
  for (int i = 0; i < Tn; ++i) {
    const int t = t0 + i + 1;  // 1-based frame index
    const T* ch = lat_h + (size_t)buf * WP;
    const int* cb = lat_b + (size_t)buf * WP;
    T* nh = lat_h + (size_t)(buf ^ 1) * WP;
    int* nbk = lat_b + (size_t)(buf ^ 1) * WP;
    const T* am_t = am + ((size_t)b * Tn + i) * S;
    // (a) every slot's new score and backpointer, before the renormalisation
    T m = BIG;
    for (int s = threadIdx.x; s < WP; s += blockDim.x) {
      const int w = s / P, p = s - w * P;
      const T am_v = am_t[state_table[s]];
      const T h1 = p >= 1 ? ch[s - 1] : BIG;
      const T h2 = p >= 2 ? ch[s - 2] : BIG;
      const int b1 = p >= 1 ? cb[s - 1] : 0;
      const int b2 = p >= 2 ? cb[s - 2] : 0;
      const T entry = p < 2 ? (book + entry_pen[w * 2 + p]) + am_v : BIG;
      int nb;
      const T nv = slot_step(ch[s], cb[s], h1, b1, h2, b2, tdp_within[s * 3 + 0],
                             tdp_within[s * 3 + 1], tdp_within[s * 3 + 2], am_v, entry, p,
                             p < word_len[w], t, nb);
      nh[s] = nv;
      nbk[s] = nb;
      m = tmin(m, nv);
    }
    // a thread without a slot holds BIG, which every row minimum already is
    // or undercuts
    m = warp_minimum_nan(m);
    if ((threadIdx.x & 31) == 0) s_wmin[threadIdx.x >> 5] = m;
    __syncthreads();  // the per-warp minima are visible
    T best = s_wmin[0];
    for (int k = 1; k < nwarps; ++k) best = tmin(best, s_wmin[k]);
    if (best >= HALF) best = T(0);

    // (b) each thread's own slots: renormalise, prune, offer the word ends
    const bool alive = t <= len;
    End<T> e{T(__int_as_float(0x7f800000)), 0x7fffffff, 0};  // loses to every end
    for (int s = threadIdx.x; s < WP; s += blockDim.x) {
      const int w = s / P;
      const T nv = renorm(nh[s], best, am_threshold, prune);
      const End<T> c{exit_pen != nullptr ? nv + exit_pen[w] : nv, w, nbk[s]};
      if (s - w * P == last_pos[w] && end_less(c, e)) e = c;
      if (alive) {
        nh[s] = nv;
      } else {
        nh[s] = ch[s];
        nbk[s] = cb[s];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const End<T> other{__shfl_xor_sync(FULL, e.v, o), __shfl_xor_sync(FULL, e.w, o),
                         __shfl_xor_sync(FULL, e.bk, o)};
      if (end_less(other, e)) e = other;
    }
    if ((threadIdx.x & 31) == 0) s_wend[threadIdx.x >> 5] = e;
    __syncthreads();  // the word ends and the new lattice are visible
    End<T> be = s_wend[0];
    for (int k = 1; k < nwarps; ++k)
      if (end_less(s_wend[k], be)) be = s_wend[k];
    const T bs = be.v >= HALF ? BIG : be.v;
    if (threadIdx.x == 0) {
      score[(size_t)i * B + b] = bs;
      word[(size_t)i * B + b] = be.w;
      bkp[(size_t)i * B + b] = be.bk;
    }
    if (alive) book = bs;
    buf ^= 1;
  }

  for (int s = threadIdx.x; s < WP; s += blockDim.x) {
    hyp_out[off + s] = lat_h[(size_t)buf * WP + s];
    bkp_out[off + s] = lat_b[(size_t)buf * WP + s];
  }
  if (threadIdx.x == 0) book_out[b] = book;
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

// the block instance's shared lattice: two buffers of scores, then two of
// backpointers
template <typename T>
size_t block_smem(int W, int P) {
  return instance_for(W, P) == 0 ? 2 * (size_t)W * P * (sizeof(T) + sizeof(int)) : 0;
}

// scratch: lat_h [B][2][W*P] scores, then lat_b [B][2][W*P] ints
template <typename T>
int launch(const T* am, const int* feat_len, const int* state_table,
           const int* last_pos, const int* word_len, const T* tdp_within,
           const T* entry_pen, const T* exit_pen, const T* hyp_in,
           const int* bkp_in, const T* book_in, T* hyp_out, int* bkp_out,
           T* book_out, T* score, int* word, int* bkp, void* scratch, int B, int Tn,
           int S, int W, int P, int t0, T am_threshold, int prune, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || W == 0 || P == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int inst = instance_for(W, P);
  const int threads = threads_for(W, P);
#define SR_ARGS                                                                         \
  am, feat_len, state_table, last_pos, word_len, tdp_within, entry_pen, exit_pen, hyp_in, \
      bkp_in, book_in, hyp_out, bkp_out, book_out, score, word, bkp
  switch (inst) {
    case 1: decode_scan_warp_kernel<T, 1><<<B, threads, 0, st>>>(SR_ARGS, B, Tn, S, W, P, t0, am_threshold, prune); break;
    case 2: decode_scan_warp_kernel<T, 2><<<B, threads, 0, st>>>(SR_ARGS, B, Tn, S, W, P, t0, am_threshold, prune); break;
    case 3: decode_scan_warp_kernel<T, 3><<<B, threads, 0, st>>>(SR_ARGS, B, Tn, S, W, P, t0, am_threshold, prune); break;
    case 4: decode_scan_warp_kernel<T, 4><<<B, threads, 0, st>>>(SR_ARGS, B, Tn, S, W, P, t0, am_threshold, prune); break;
    default: {
      // the lattice in shared memory (0) or in the scratch (-1)
      if (inst < 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
      T* lat_h = inst < 0 ? static_cast<T*>(scratch) : nullptr;
      int* lat_b = inst < 0 ? reinterpret_cast<int*>(lat_h + 2 * (size_t)B * W * P) : nullptr;
      decode_scan_block_kernel<T><<<B, threads, block_smem<T>(W, P), st>>>(
          SR_ARGS, lat_h, lat_b, B, Tn, S, W, P, t0, am_threshold, prune);
    }
  }
#undef SR_ARGS
  return (int)cudaGetLastError();
}

template <typename T>
int residency(int W, int P) {
  int n = 0;
  const int threads = threads_for(W, P);
  cudaError_t err;
  switch (instance_for(W, P)) {
    case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_warp_kernel<T, 1>, threads, 0); break;
    case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_warp_kernel<T, 2>, threads, 0); break;
    case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_warp_kernel<T, 3>, threads, 0); break;
    case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_warp_kernel<T, 4>, threads, 0); break;
    default:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_block_kernel<T>, threads,
                                                          block_smem<T>(W, P));
  }
  return err == cudaSuccess ? n : -1;
}

}  // namespace

extern "C" int sr_decode_scan(
    const float* am, const int* feat_len, const int* state_table,
    const int* last_pos, const int* word_len, const float* tdp_within,
    const float* entry_pen, const float* exit_pen, const float* hyp_in,
    const int* bkp_in, const float* book_in, float* hyp_out, int* bkp_out,
    float* book_out, float* score, int* word, int* bkp, float* scratch, int B, int T,
    int S, int W, int P, int t0, float am_threshold, int prune, int device,
    void* stream) {
  return launch<float>(am, feat_len, state_table, last_pos, word_len,
                       tdp_within, entry_pen, exit_pen, hyp_in, bkp_in,
                       book_in, hyp_out, bkp_out, book_out, score, word, bkp,
                       scratch, B, T, S, W, P, t0, am_threshold, prune, device, stream);
}

extern "C" int sr_decode_scan_f64(
    const double* am, const int* feat_len, const int* state_table,
    const int* last_pos, const int* word_len, const double* tdp_within,
    const double* entry_pen, const double* exit_pen, const double* hyp_in,
    const int* bkp_in, const double* book_in, double* hyp_out, int* bkp_out,
    double* book_out, double* score, int* word, int* bkp, double* scratch, int B,
    int T, int S, int W, int P, int t0, double am_threshold, int prune, int device,
    void* stream) {
  return launch<double>(am, feat_len, state_table, last_pos, word_len,
                        tdp_within, entry_pen, exit_pen, hyp_in, bkp_in,
                        book_in, hyp_out, bkp_out, book_out, score, word, bkp,
                        scratch, B, T, S, W, P, t0, am_threshold, prune, device, stream);
}

// the instance both entries launch for a W x P lattice: positions a lane of
// the warp instance (1-4); the block instance with its lattice in shared
// memory (0) or in device scratch (-1, which needs scratch of 2*B*W*P scores
// and 2*B*W*P ints)
extern "C" int sr_decode_scan_instance(int W, int P) { return instance_for(W, P); }

// blocks of that instance one SM holds at once (the occupancy calculator's
// answer for the launch the float32 entry, or with f64 != 0 the float64
// entry, makes), or -1
extern "C" int sr_decode_scan_residency(int W, int P, int f64) {
  return f64 ? residency<double>(W, P) : residency<float>(W, P);
}
