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
// Design (a first, simple one): one block per utterance, threads looping
// over the nodes; the tree's scores and backpointers double-buffered by
// frame parity in shared memory (SieTill: 212 nodes, 5 KB in float64), or
// past search::SHARED_LIMIT bytes in device scratch that the wrapper
// allocates (sr_tree_scan_scratch gives the bytes an utterance). Per frame
// two block reductions (the minimum, the word end's argmin) and one barrier
// for the book. What bounds it: one frame's chain of dependent barriers and
// reductions, not bytes: a 1,024-utterance, 960-frame float32 batch reads
// 417 MB of scores, 0.12 ms at an H100's 3.35 TB/s, and takes 4.6 ms (4.8 us
// a frame) on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 23).

#include <cuda_runtime.h>

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
      if (e < ev) {  // a thread's nodes ascend: strict < keeps the first
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

}  // namespace

// bytes of device scratch an utterance needs for an N-node tree (0: the
// tree stays in shared memory; -1: too large); f64 != 0 for the float64 scan
extern "C" int sr_tree_scan_scratch(int N, int f64) {
  const size_t n = f64 ? utterance_bytes<double>(N) : utterance_bytes<float>(N);
  if (n <= search::SHARED_LIMIT) return 0;
  return n > (size_t)INT_MAX ? -1 : (int)n;
}

namespace {

template <typename T>
int launch(const void* am, const int* feat_len, const int* state, const int* parent,
           const int* grand, const int* depth, const void* tdp, const int* loop_allowed,
           const int* end_word, const void* exit_penalty, void* score, int* word, int* bkp,
           void* scratch, int B, int Tn, int S, int N, double thr, int prune, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Tn == 0) return (int)cudaSuccess;
  if (N == 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = utterance_bytes<T>(N);
  const bool in_scratch = bytes > search::SHARED_LIMIT;
  if (in_scratch && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_scratch ? 0 : bytes;
  err = search::allow_smem(tree_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  tree_scan_kernel<T><<<B, search::threads_for(N), smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(am), feat_len, state, parent, grand, depth,
      static_cast<const T*>(tdp), loop_allowed, end_word, static_cast<const T*>(exit_penalty),
      static_cast<T*>(score), word, bkp,
      in_scratch ? static_cast<unsigned char*>(scratch) : nullptr, bytes, B, Tn, S, N, T(thr),
      prune);
  return (int)cudaGetLastError();
}

}  // namespace

// am [B, T, S], tdp [N, 3] and exit_penalty [N] in float (f64 == 0) or
// double; score [T, B] in the same type, word and bkp [T, B] int
extern "C" int sr_tree_scan(int f64, const void* am, const int* feat_len, const int* state,
                            const int* parent, const int* grand, const int* depth,
                            const void* tdp, const int* loop_allowed, const int* end_word,
                            const void* exit_penalty, void* score, int* word, int* bkp,
                            void* scratch, int B, int T, int S, int N, double am_threshold,
                            int prune, int device, void* stream) {
  return f64 ? launch<double>(am, feat_len, state, parent, grand, depth, tdp, loop_allowed,
                              end_word, exit_penalty, score, word, bkp, scratch, B, T, S, N,
                              am_threshold, prune, device, stream)
             : launch<float>(am, feat_len, state, parent, grand, depth, tdp, loop_allowed,
                             end_word, exit_penalty, score, word, bkp, scratch, B, T, S, N,
                             am_threshold, prune, device, stream);
}
