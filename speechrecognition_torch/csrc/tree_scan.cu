// Kernel I: the prefix-tree time-synchronous Viterbi over a whole batch.
//
// Replaces speechrecognition_tpu/search/tree_decoder.py::_tree_scan, the
// tree recursion XLA fuses into one lax.scan (written op by op in PyTorch
// it costs about 40 launches a frame). Same inputs and outputs: am [B, T, S],
// feat_len [B], the flattened tree (state, parent, grand, depth [N], tdp
// [N, 3], loop_allowed, end_word [N], exit_penalty [N]); it writes, per
// frame, the best word end (score, word, backpointer), each [T, B]. The scan
// starts from an empty tree with book 0 at frame 1, as the reference's does.
// A template on the score type: float for the f32 path, double for f64.
//
// Per frame it follows the reference step exactly, for every node, the root
// included (no node is skipped, so every backpointer the traceback may read
// is the reference's):
//   * predecessors through the tree, the root carrying the book: loop (where
//     allowed), forward from the parent, skip from the grandparent; depth-1
//     nodes are entered forward from the book and never by a skip, depth-2
//     nodes by a skip from the book; start at the skip, take forward if
//     strictly less, then loop if strictly less (larger jumps win ties);
//     plus the node's emission; the root BIG; min(new, BIG);
//   * the frame's minimum; renormalise with the >= BIG/2 guards; prune
//     new > am_threshold;
//   * the word end: the first node at the minimum of new + exit_penalty over
//     end nodes (BIG elsewhere), its word and backpointer, the score capped
//     at BIG from BIG/2;
//   * the utterance freezes once t > feat_len (outputs are still written).
// Every operation is a rounded add, compare or select in the score type, so
// the kernel matches its plain PyTorch version bit for bit in both types.
//
// What bounds it: one frame's chain of dependent steps, not bytes (a
// 1,024-utterance, 960-frame float32 batch reads 417 MB of scores, 0.12 ms
// at an H100's 3.35 TB/s). Two instances, chosen in the C entry from the
// shape alone (sr_tree_scan_instance):
//   * the owner instance (N <= 1,024 nodes; SieTill's 212): a thread owns K
//     nodes (K = ceil(N / 128), at most 4: SieTill 2, 4 warps), node
//     k * blockDim + thread, so lanes sit on consecutive nodes. Each node's
//     tables (state, parent, grandparent, depth flags, its three TDPs,
//     loop_allowed, its place in the word-end list) and its score and
//     backpointer stay in registers for the whole scan; each lane loads
//     frame t+2's emissions while frame t runs. Each live frame publishes
//     one row of raw new scores and backpointers to shared memory,
//     double-buffered by frame parity; a node reads its parent's and
//     grandparent's raw cells from the row of the last live frame and
//     renormalises and prunes them with that frame's minimum, which gives
//     the value the reference's renormalised lattice holds. The word-end
//     candidates (the end nodes and the first other node, in node order: the
//     reference's argmin runs over every node, the others at BIG) form a
//     compact list built once; their owners publish their raw cells beside
//     the row. One __syncthreads a frame: before it each warp publishes its
//     exact minimum (keys.cuh); after it every warp folds the minima in the
//     same order, forms the word end from the list (renormalise, prune, add
//     the exit penalty, the keyed argmin that takes the first candidate) and
//     so the next frame's book; warp 0 writes the outputs. A frozen
//     utterance (t > feat_len) neither publishes a row nor moves its book.
//   * the block instance (the first design; N > 1,024, and every tree
//     whose lattice lives in device scratch): one block per utterance,
//     threads looping over the nodes; the tree's scores and backpointers
//     double-buffered by frame parity in shared memory, or past
//     search::SHARED_LIMIT bytes in device scratch that the wrapper
//     allocates (sr_tree_scan_scratch gives the bytes an utterance); per
//     frame two block reductions (the minimum, the word end's argmin) and
//     one barrier for the book: 5 barriers. It takes 4.6 ms (4.8 us a frame)
//     on SieTill at B 1,024, T 960 in float32 on an NVIDIA H100 80GB HBM3 at
//     700 W (chip_smoke.py phase 23).

#include <cuda_runtime.h>

#include <limits>

#include "search.cuh"

namespace {

using search::add;
using search::big;
using search::tmin;

template <typename T>
size_t utterance_bytes(int N) {
  return search::align16(2 * (size_t)N * sizeof(T)) + search::align16(2 * (size_t)N * sizeof(int));
}

template <typename T>
__global__ void __launch_bounds__(search::MAX_THREADS) tree_scan_kernel(
    const T* __restrict__ am, const int* __restrict__ feat_len, const int* __restrict__ state,
    const int* __restrict__ parent, const int* __restrict__ grand,
    const int* __restrict__ depth, const T* __restrict__ tdp,
    const int* __restrict__ loop_allowed, const int* __restrict__ end_word,
    const T* __restrict__ exit_penalty, T* __restrict__ score, int* __restrict__ word,
    int* __restrict__ bkp, unsigned char* scratch, size_t per_utt, int B, int Tn, int S,
    int N, T thr, int prune) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_v[32];
  __shared__ int s_i[32];
  __shared__ T s_book;
  const T BIG = big<T>();
  const T HALF = BIG * T(0.5);
  const int b = blockIdx.x;
  unsigned char* base = scratch != nullptr ? scratch + (size_t)b * per_utt : smem;
  // lat_h [2][N] scores, lat_b [2][N] backpointers (not restrict: threads
  // read one another's writes after a barrier)
  T* lat_h = reinterpret_cast<T*>(base);
  int* lat_b = reinterpret_cast<int*>(base + search::align16(2 * (size_t)N * sizeof(T)));
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    lat_h[n] = BIG;
    lat_b[n] = 0;
  }
  if (threadIdx.x == 0) s_book = T(0);
  const int len = feat_len[b];
  __syncthreads();

  int buf = 0;
  for (int i = 0; i < Tn; ++i) {
    const int t = i + 1;  // 1-based frame index
    const T* ch = lat_h + (size_t)buf * N;
    const int* cb = lat_b + (size_t)buf * N;
    T* nh = lat_h + (size_t)(buf ^ 1) * N;
    int* nb = lat_b + (size_t)(buf ^ 1) * N;
    const T* am_t = am + ((size_t)b * Tn + i) * S;
    const T book = s_book;
    // (a) every node's new score and backpointer
    T m = BIG;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const int d = depth[n], pa = parent[n], gr = grand[n];
      const T tw0 = tdp[3 * n], tw1 = tdp[3 * n + 1], tw2 = tdp[3 * n + 2];
      const T loop = loop_allowed[n] ? add(ch[n], tw0) : BIG;
      const T fwd = add(d == 1 || pa == 0 ? book : ch[pa], tw1);
      T skip = add(d == 2 || gr == 0 ? book : ch[gr], tw2);
      if (d == 1) skip = BIG;
      T nv = skip;
      int nbv = d == 2 ? t - 1 : cb[gr];
      if (fwd < nv) {
        nv = fwd;
        nbv = d == 1 ? t - 1 : cb[pa];
      }
      if (loop < nv) {
        nv = loop;
        nbv = cb[n];
      }
      nv = add(nv, am_t[state[n]]);
      if (n == 0) nv = BIG;
      nv = tmin(nv, BIG);
      nh[n] = nv;
      nb[n] = nbv;
      m = tmin(m, nv);
    }
    T best = search::block_min(m, s_v);
    if (best >= HALF) best = T(0);
    // (b) renormalise, prune, and offer the word ends (first node wins)
    T ev = search::infinity<T>();
    int en = INT_MAX;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      T nv = search::renorm(nh[n], best);
      if (prune && nv > thr) nv = BIG;
      nh[n] = nv;
      const T e = end_word[n] >= 0 ? add(nv, exit_penalty[n]) : BIG;
      if (search::takes(e, ev)) {  // a thread's nodes ascend: the first at the minimum
        ev = e;
        en = n;
      }
    }
    search::block_argmin(ev, en, s_v, s_i);
    if (threadIdx.x == 0) {
      const T bs = ev >= HALF ? BIG : ev;
      const size_t o = (size_t)i * B + b;
      score[o] = bs;
      word[o] = end_word[en];
      bkp[o] = nb[en];
      if (t <= len) s_book = bs;
    }
    __syncthreads();  // the book is visible
    if (t <= len) buf ^= 1;  // a finished utterance keeps its lattice
  }
}

// ---- the owner instance: a thread owns K nodes -----------------------------------

constexpr int OWNER_MAX_NODES = 1024;    // nodes of the owner instance, at most
constexpr int OWNER_MAX_K = 4;           // nodes a lane, at most
constexpr int OWNER_NODES_PER_K = 64;    // K = min(ceil(N / 64), 4)
constexpr int OWNER_MAX_THREADS = 256;   // 1,024 nodes at 4 a lane
constexpr int OWNER_MIN_BLOCKS = 2;      // blocks an SM the registers must allow
constexpr int OWNER_MAX_WARPS = OWNER_MAX_THREADS / 32;
constexpr int PREFETCH = 2;              // frames of emissions in flight

// a node's flags (registers): where its predecessors come from
enum : unsigned {
  FWD_BOOK = 1u,    // forward from the book (depth 1, or the parent is the root)
  SKIP_BOOK = 2u,   // skip from the book (depth 2, or the grandparent is the root)
  NO_SKIP = 4u,     // depth 1: never entered by a skip; forward backpointer t - 1
  SKIP_NOW = 8u,    // depth 2: skip backpointer t - 1
  LOOP = 16u,       // loop_allowed
  DEAD = 32u,       // the root (BIG) or a padding lane
  REAL = 64u,       // a node of the tree (not a padding lane)
};

// a node's score and backpointer side by side, so that one shared-memory
// access moves both
template <typename T>
struct alignas(2 * sizeof(T)) Cell {
  T h;
  int b;
};

// per utterance in shared memory: the row [2][N] cells (raw new scores and
// backpointers of the live frames, by frame parity), the word-end
// candidates' cells [2][N] (by frame parity), their words [N] int and exit
// penalties [N] T (at most N candidates)
struct OwnerLayout {
  size_t row, ends, word, xpen, total;
  template <typename T>
  static OwnerLayout of(int N) {
    OwnerLayout L;
    size_t o = 0;
    L.row = o; o += search::align16(2 * (size_t)N * sizeof(Cell<T>));
    L.ends = o; o += search::align16(2 * (size_t)N * sizeof(Cell<T>));
    L.word = o; o += search::align16((size_t)N * sizeof(int));
    L.xpen = o; o += search::align16((size_t)N * sizeof(T));
    L.total = o;
    return L;
  }
};

// the lattice's value of a raw score: renormalised by its frame's minimum
// (0 for a dead frame) and pruned (thr is +inf without pruning)
template <typename T>
__device__ __forceinline__ T renorm_prune(T v, T best, T thr) {
  v = search::renorm(v, best);
  return v > thr ? big<T>() : v;
}

// nodes a lane for an N-node tree (0: past the owner instance)
__host__ __device__ __forceinline__ int owner_k(int N) {
  if (N < 1 || N > OWNER_MAX_NODES) return 0;
  const int k = (N + OWNER_NODES_PER_K - 1) / OWNER_NODES_PER_K;
  return k < OWNER_MAX_K ? k : OWNER_MAX_K;
}

// threads a block of the owner instance: whole warps, ceil(N / K) lanes
__host__ __device__ __forceinline__ int owner_threads(int N) {
  const int k = owner_k(N);
  return k == 0 ? 0 : ((N + k - 1) / k + 31) / 32 * 32;
}

template <typename T, int K>
__global__ void __launch_bounds__(OWNER_MAX_THREADS, OWNER_MIN_BLOCKS) tree_scan_owner_kernel(
    const T* __restrict__ am, const int* __restrict__ feat_len, const int* __restrict__ state,
    const int* __restrict__ parent, const int* __restrict__ grand,
    const int* __restrict__ depth, const T* __restrict__ tdp,
    const int* __restrict__ loop_allowed, const int* __restrict__ end_word,
    const T* __restrict__ exit_penalty, T* __restrict__ score, int* __restrict__ word,
    int* __restrict__ bkp, OwnerLayout L, int B, int Tn, int S, int N, T thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_wmin[2][OWNER_MAX_WARPS];
  __shared__ int s_count[OWNER_MAX_K * OWNER_MAX_WARPS];
  __shared__ int s_first;
  const T BIG = big<T>();
  const T HALF = BIG * T(0.5);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = nt >> 5;
  Cell<T>* row = reinterpret_cast<Cell<T>*>(smem + L.row);
  Cell<T>* ends = reinterpret_cast<Cell<T>*>(smem + L.ends);
  int* s_word = reinterpret_cast<int*>(smem + L.word);
  T* s_xpen = reinterpret_cast<T*>(smem + L.xpen);

  // the nodes' tables, once; the row of "frame 0" (parity 1): BIG, 0
  if (tid == 0) s_first = INT_MAX;
  int st[K], pa[K], gr[K], ew[K];
  unsigned fl[K];
  T tw0[K], tw1[K], tw2[K], h[K];
  int bk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = k * nt + tid;
    const bool real = n < N;
    const int nc = real ? n : 0;  // a node that exists, for loads
    st[k] = state[nc];
    pa[k] = parent[nc];
    gr[k] = grand[nc];
    const int d = depth[nc];
    ew[k] = end_word[nc];
    tw0[k] = tdp[3 * nc];
    tw1[k] = tdp[3 * nc + 1];
    tw2[k] = tdp[3 * nc + 2];
    fl[k] = (d == 1 || pa[k] == 0 ? FWD_BOOK : 0u) | (d == 2 || gr[k] == 0 ? SKIP_BOOK : 0u) |
            (d == 1 ? NO_SKIP : 0u) | (d == 2 ? SKIP_NOW : 0u) |
            (loop_allowed[nc] ? LOOP : 0u) | (!real || n == 0 ? DEAD : 0u) |
            (real ? REAL : 0u);
    h[k] = BIG;
    bk[k] = 0;
    if (real) row[N + n] = {BIG, 0};
  }
  __syncthreads();  // s_first is set
  // the word-end candidates: every end node, and the first other node (the
  // reference's argmin runs over all nodes, the others at BIG)
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((fl[k] & REAL) && ew[k] < 0) atomicMin(&s_first, k * nt + tid);
  __syncthreads();  // the first other node is known
  const int first = s_first;
  unsigned below[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = k * nt + tid;
    const bool cand = (fl[k] & REAL) && (ew[k] >= 0 || n == first);
    const unsigned mask = __ballot_sync(search::FULL, cand);
    if (lane == 0) s_count[k * nwarps + warp] = __popc(mask);
    below[k] = cand ? __popc(mask & ((1u << lane) - 1u)) : ~0u;
  }
  __syncthreads();  // the candidates' counts are visible
  // each candidate's place in the list (node order: k, then warp, then lane)
  int pos[K];
#pragma unroll
  for (int k = 0; k < K; ++k) pos[k] = -1;
  int E = 0;  // the candidates
  for (int c = 0; c < K * nwarps; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (c == k * nwarps + warp && below[k] != ~0u) pos[k] = E + (int)below[k];
    E += s_count[c];
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (pos[k] >= 0) {
      const int n = k * nt + tid;
      s_word[pos[k]] = ew[k];
      s_xpen[pos[k]] = ew[k] >= 0 ? exit_penalty[n] : T(0);
    }
  const int len = feat_len[b];
  __syncthreads();  // the list and the first row are visible

  // the emissions of frames i .. i+PREFETCH-1 (slot i % PREFETCH)
  const T* amb = am + (size_t)b * Tn * S;
  T ring[PREFETCH][K];
#pragma unroll
  for (int q = 0; q < PREFETCH; ++q)
#pragma unroll
    for (int k = 0; k < K; ++k) ring[q][k] = q < Tn ? amb[(size_t)q * S + st[k]] : T(0);

  T book = T(0), best_prev = T(0);
  int rd = 1;  // the row of the last live frame
  for (int i0 = 0; i0 < Tn; i0 += PREFETCH) {
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q) {
      const int i = i0 + q;
      if (i < Tn) {  // the same for the whole block
        const int t = i + 1;  // 1-based frame index
        const bool alive = t <= len;
        const int par = i & 1;
        const Cell<T>* prev = row + (size_t)rd * N;
        Cell<T>* next = row + (size_t)par * N;
        Cell<T>* ends_t = ends + (size_t)par * N;
        const T* nxt = amb + (size_t)min(i + PREFETCH, Tn - 1) * S;
        T nv[K];
        int nb[K];
        T m = BIG;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const T a = ring[q][k];
          ring[q][k] = nxt[st[k]];
          const unsigned f = fl[k];
          const Cell<T> cp = prev[pa[k]], cg = prev[gr[k]];
          const T hp = (f & FWD_BOOK) ? book : renorm_prune(cp.h, best_prev, thr);
          const T hg = (f & SKIP_BOOK) ? book : renorm_prune(cg.h, best_prev, thr);
          const T loop = (f & LOOP) ? add(h[k], tw0[k]) : BIG;
          const T fwd = add(hp, tw1[k]);
          const T skip = (f & NO_SKIP) ? BIG : add(hg, tw2[k]);
          const int bp = (f & NO_SKIP) ? t - 1 : cp.b;
          const int bg = (f & SKIP_NOW) ? t - 1 : cg.b;
          // the sequential selection (start at the skip, take the forward,
          // then the loop, if strictly less) with its compares made
          // independent
          const bool take1 = fwd < skip;
          const bool take0 = take1 ? loop < fwd : loop < skip;
          const T v = add(take0 ? loop : take1 ? fwd : skip, a);
          nb[k] = take0 ? bk[k] : take1 ? bp : bg;
          nv[k] = (f & DEAD) ? BIG : tmin(v, BIG);
          m = tmin(m, nv[k]);
          if ((f & REAL) && alive) next[k * nt + tid] = {nv[k], nb[k]};
          if (pos[k] >= 0) ends_t[pos[k]] = {nv[k], nb[k]};
        }
        m = keys::warp_minimum_nan(m);
        if (lane == 0) s_wmin[par][warp] = m;
        __syncthreads();  // the row, the candidates and the minima are visible

        // every warp: the frame's minimum, folded in the same order
        T best = s_wmin[par][0];
        for (int u = 1; u < nwarps; ++u) best = tmin(best, s_wmin[par][u]);
        if (best >= HALF) best = T(0);
        // the word end: the first candidate at the minimum of the pruned,
        // renormalised score plus the exit penalty (BIG for the non-end one)
        T ev = search::infinity<T>();
        int ej = INT_MAX;
        for (int j = lane; j < E; j += 32) {
          const T e = s_word[j] >= 0
                          ? add(renorm_prune(ends_t[j].h, best, thr), s_xpen[j])
                          : BIG;
          if (ej == INT_MAX || search::takes(e, ev)) {  // a lane's candidates ascend
            ev = e;
            ej = j;
          }
        }
        const T mv = keys::warp_minimum_nan(ev);
        const int jmin = __reduce_min_sync(search::FULL, search::same_value(ev, mv) ? ej : INT_MAX);
        const T ws = __shfl_sync(search::FULL, ev, jmin & 31);  // its bits
        const T bs = ws >= HALF ? BIG : ws;
        if (tid == 0) {
          const size_t o = (size_t)i * B + b;
          score[o] = bs;
          word[o] = s_word[jmin];
          bkp[o] = ends_t[jmin].b;
        }
        if (alive) {  // a finished utterance keeps its lattice and book
          book = bs;
          best_prev = best;
          rd = par;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            h[k] = renorm_prune(nv[k], best, thr);
            bk[k] = nb[k];
          }
        }
      }
    }
  }
}

}  // namespace

// bytes of device scratch an utterance needs for an N-node tree (0: the
// tree stays in shared memory; -1: too large); f64 != 0 for the float64 scan
extern "C" int sr_tree_scan_scratch(int N, int f64) {
  const size_t n = f64 ? utterance_bytes<double>(N) : utterance_bytes<float>(N);
  if (n <= search::SHARED_LIMIT) return 0;
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

namespace {

// nodes a lane of the owner instance (1-4); for the block instance 0 (its
// lattice in shared memory) or -1 (in device scratch)
int instance_for(int N, int f64) {
  const int k = owner_k(N);
  if (k > 0) return k;
  return sr_tree_scan_scratch(N, f64) == 0 ? 0 : -1;
}

template <typename T, int K>
cudaError_t launch_owner(const T* am, const int* feat_len, const int* state, const int* parent,
                         const int* grand, const int* depth, const T* tdp,
                         const int* loop_allowed, const int* end_word, const T* exit_penalty,
                         T* score, int* word, int* bkp, int B, int Tn, int S, int N, T thr,
                         cudaStream_t stream) {
  const OwnerLayout L = OwnerLayout::of<T>(N);
  const cudaError_t err = search::allow_smem(tree_scan_owner_kernel<T, K>, L.total);
  if (err != cudaSuccess) return err;
  tree_scan_owner_kernel<T, K><<<B, owner_threads(N), L.total, stream>>>(
      am, feat_len, state, parent, grand, depth, tdp, loop_allowed, end_word, exit_penalty,
      score, word, bkp, L, B, Tn, S, N, thr);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* am, const int* feat_len, const int* state, const int* parent,
           const int* grand, const int* depth, const void* tdp, const int* loop_allowed,
           const int* end_word, const void* exit_penalty, void* score, int* word, int* bkp,
           void* scratch, int B, int Tn, int S, int N, double thr, int prune, int first_design,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Tn == 0) return (int)cudaSuccess;
  if (N == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int inst = first_design ? 0 : instance_for(N, sizeof(T) == 8);
  if (inst > 0) {
    const T thr_eff = prune ? T(thr) : std::numeric_limits<T>::infinity();
#define SR_I_ARGS                                                                          \
  static_cast<const T*>(am), feat_len, state, parent, grand, depth,                       \
      static_cast<const T*>(tdp), loop_allowed, end_word,                                  \
      static_cast<const T*>(exit_penalty), static_cast<T*>(score), word, bkp, B, Tn, S, N, \
      thr_eff, st
    switch (inst) {
      case 1: err = launch_owner<T, 1>(SR_I_ARGS); break;
      case 2: err = launch_owner<T, 2>(SR_I_ARGS); break;
      case 3: err = launch_owner<T, 3>(SR_I_ARGS); break;
      default: err = launch_owner<T, 4>(SR_I_ARGS); break;
    }
#undef SR_I_ARGS
    return (int)err;
  }
  const size_t bytes = utterance_bytes<T>(N);
  const bool in_scratch = bytes > search::SHARED_LIMIT;
  if (in_scratch && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_scratch ? 0 : bytes;
  err = search::allow_smem(tree_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  tree_scan_kernel<T><<<B, search::threads_for(N), smem, st>>>(
      static_cast<const T*>(am), feat_len, state, parent, grand, depth,
      static_cast<const T*>(tdp), loop_allowed, end_word, static_cast<const T*>(exit_penalty),
      static_cast<T*>(score), word, bkp,
      in_scratch ? static_cast<unsigned char*>(scratch) : nullptr, bytes, B, Tn, S, N, T(thr),
      prune);
  return (int)cudaGetLastError();
}

template <typename T, int K>
cudaError_t owner_occupancy(int* n, int N) {
  const OwnerLayout L = OwnerLayout::of<T>(N);
  const cudaError_t err = search::allow_smem(tree_scan_owner_kernel<T, K>, L.total);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, tree_scan_owner_kernel<T, K>,
                                                       owner_threads(N), L.total);
}

template <typename T>
int residency(int N, int first_design) {
  const int inst = first_design ? 0 : instance_for(N, sizeof(T) == 8);
  int n = 0;
  cudaError_t err;
  switch (inst) {
    case 1: err = owner_occupancy<T, 1>(&n, N); break;
    case 2: err = owner_occupancy<T, 2>(&n, N); break;
    case 3: err = owner_occupancy<T, 3>(&n, N); break;
    case 4: err = owner_occupancy<T, 4>(&n, N); break;
    default: {
      const size_t bytes = utterance_bytes<T>(N);
      const size_t smem = bytes > search::SHARED_LIMIT ? 0 : bytes;
      err = search::allow_smem(tree_scan_kernel<T>, smem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, tree_scan_kernel<T>,
                                                            search::threads_for(N), smem);
    }
  }
  return err == cudaSuccess ? n : -1;
}

}  // namespace

// am [B, T, S], tdp [N, 3] and exit_penalty [N] in float (f64 == 0) or
// double; score [T, B] in the same type, word and bkp [T, B] int. The
// instance follows from the shape (sr_tree_scan_instance); first_design != 0
// launches the block instance whatever the shape, so that the first design
// can be timed beside the owner instance (the wrapper passes 0).
extern "C" int sr_tree_scan(int f64, const void* am, const int* feat_len, const int* state,
                            const int* parent, const int* grand, const int* depth,
                            const void* tdp, const int* loop_allowed, const int* end_word,
                            const void* exit_penalty, void* score, int* word, int* bkp,
                            void* scratch, int B, int T, int S, int N, double am_threshold,
                            int prune, int first_design, int device, void* stream) {
  return f64 ? launch<double>(am, feat_len, state, parent, grand, depth, tdp, loop_allowed,
                              end_word, exit_penalty, score, word, bkp, scratch, B, T, S, N,
                              am_threshold, prune, first_design, device, stream)
             : launch<float>(am, feat_len, state, parent, grand, depth, tdp, loop_allowed,
                             end_word, exit_penalty, score, word, bkp, scratch, B, T, S, N,
                             am_threshold, prune, first_design, device, stream);
}

// the instance the entry launches for an N-node tree: nodes a lane of the
// owner instance (1-4: 1 <= N <= 1,024); the block instance with its
// lattice in shared memory (0) or in device scratch (-1)
extern "C" int sr_tree_scan_instance(int N, int f64) { return instance_for(N, f64); }

// blocks one SM holds of that instance's launch (with first_design != 0: of
// the block instance's), by the occupancy calculator, or -1
extern "C" int sr_tree_scan_residency(int N, int f64, int first_design) {
  return f64 ? residency<double>(N, first_design) : residency<float>(N, first_design);
}
