// Kernel P: one rank's frame step of the context-sharded word-conditioned
// tree search. Replaces the per-device `kernel` of
// speechrecognition_tpu/parallel/mesh.py::wcts_sharded (its `step` under
// lax.scan and shard_map). A rank owns n_local consecutive predecessor
// contexts [ctx0, ctx0 + n_local) of every utterance; between a frame's two
// launches the ranks exchange the beam floor (an all-reduce MIN of order
// keys) and after the second the word-end candidates (an all-gather).
//
//   P1 (entries): recombine the previous frame's gathered candidates (the
//       first minimum over ranks, NaN first; >= BIG/2 -> BIG), write that
//       frame's outputs and, for a live utterance, the carried book; read
//       the carry, renormalised and pruned as it is read by the floor of
//       the frame that wrote it (carry_floor; a floor >= BIG/2 counts as 0,
//       a score >= BIG/2 stays BIG, then > threshold -> BIG); then the
//       within-word step of every local slot in the reference's order (skip,
//       then fwd if strictly less, then loop if strictly less), the
//       emission, the word entry from the book (the entry wins ties), node 0
//       BIG, a clamp to BIG that keeps NaN. A live utterance's raw cells go
//       back over the carry; every utterance's end-node cells go to the end
//       scratch [B, n_local, W]; the local minimum as an order key.
//   P2 (ends): a thread a word: the end cells renormalised and pruned by
//       the frame's global floor, folded over the local contexts (first
//       minimum, NaN first) into the rank's send buffer (score, entry frame,
//       global context id); a live utterance's carry_floor becomes the
//       frame's floor.
//
// A dead utterance (t > feat_len) keeps its carry and carry_floor, and
// still computes every frame's outputs from them, as the reference's
// `alive` mask does. Order keys are signed (int for float, long long for
// double): a NaN takes the least key, so a NaN minimum propagates as the
// reference's min does, and an integer MIN is exact on every transport.
//
// What bounds it: bytes, the carry read and written once a frame (2 x B x
// n_local x N cells; 45.2 MB a frame in float32 at SieTill's 13 x 212 and
// B 1,024). Two instances of P1, chosen in the C entry from the shape alone
// (sr_wcts_shard_instance); P2 is one kernel:
//   * the owner instance (N <= 512 and the row within
//     search::SHARED_LIMIT: SieTill's 13 x 212, 22 KB in float32, 33 KB in
//     float64): a thread owns one node in every local context and reads its
//     tables and the frame's two emissions once; the utterance's row is
//     staged in shared memory as (score, backpointer), lanes on consecutive
//     nodes (coalesced, no division a slot), the parents read from shared
//     memory after one barrier, the new cells written in place over the
//     carry; the minimum folded by shuffles and once over the warps. Two
//     barriers a frame.
//   * the block instance (the first design; any other shape, or forced
//     with first_design = 1 for timing): one block of up to 512 threads an
//     utterance striding over the slots, the parents read from the carry in
//     device memory, the new cells into device scratch rows that the
//     wrapper allocates, then copied over the carry after the block's
//     barrier.
// The frame is `t`, or `*frame + t` where `frame` is given: a CUDA graph
// captures a chunk of frames once, with t the offset in the chunk, and
// serves every chunk by rewriting *frame.
//
// NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 37, B 1,024, T 960,
// 13 contexts x 212 nodes, world 1), a frame's two launches replayed from a
// CUDA graph, in turns: the owner instance 0.0253-0.0262 ms in float32 (by
// device time P1 0.0192, P2 0.0049 ms; 1.84-1.89x the 0.0138 ms bound; 32
// registers, 9 blocks an SM, one wave), 0.0329-0.0332 ms in float64 (P1
// 0.0236-0.0244, P2 0.0067-0.0068 ms; 1.59-1.60x its 0.0207 ms; 56
// registers, 5 an SM); the first design forced 0.0465-0.0471 and
// 0.0634-0.0638 ms (40 and 50 registers, 3 and 2 an SM). P2 takes 32
// registers.

#include <climits>
#include <cuda_runtime.h>

#include "search.cuh"

namespace {

using search::add;
using search::big;
using search::sub;

template <typename T> struct KeyOf;
template <> struct KeyOf<float> { using type = int; };
template <> struct KeyOf<double> { using type = long long; };

__device__ __forceinline__ int order_key(float v) {
  if (v != v) return INT_MIN;
  const int i = __float_as_int(v);
  return i < 0 ? (i ^ INT_MAX) : i;
}

__device__ __forceinline__ long long order_key(double v) {
  if (v != v) return LLONG_MIN;
  const long long i = __double_as_longlong(v);
  return i < 0 ? (i ^ LLONG_MAX) : i;
}

__device__ __forceinline__ float key_value(int k) {
  if (k == INT_MIN) return __int_as_float(0x7fc00000);
  return __int_as_float(k < 0 ? (k ^ INT_MAX) : k);
}

__device__ __forceinline__ double key_value(long long k) {
  if (k == LLONG_MIN) return __longlong_as_double(0x7ff8000000000000ll);
  return __longlong_as_double(k < 0 ? (k ^ LLONG_MAX) : k);
}

template <typename K>
__device__ __forceinline__ K key_min(K a, K b) { return b < a ? b : a; }

// the exact minimum key over the block (every thread calls it)
template <typename K>
__device__ K block_key_min(K k, K* s_red) {
  for (int o = 16; o > 0; o >>= 1) k = key_min(k, __shfl_xor_sync(search::FULL, k, o));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = k;
  __syncthreads();
  K m = s_red[0];
  const int nw = blockDim.x >> 5;
  for (int w = 1; w < nw; ++w) m = key_min(m, s_red[w]);
  return m;
}

// v takes the place of best: strictly less, or the first NaN (argmin's order)
template <typename T>
__device__ __forceinline__ bool takes(T v, T best) {
  return v < best || (v != v && best == best);
}

// the renormalisation base of a floor key: a floor >= BIG/2 counts as 0 (a
// NaN floor stays NaN)
template <typename T, typename K>
__device__ __forceinline__ T floor_of(K k) {
  const T f = key_value(k);
  return f >= big<T>() * T(0.5) ? T(0) : f;
}

// a raw cell renormalised by its frame's floor and pruned
template <typename T>
__device__ __forceinline__ T carried(T v, T floor, T thr, int prune) {
  v = v >= big<T>() * T(0.5) ? big<T>() : sub(v, floor);
  if (prune && v > thr) v = big<T>();
  return v;
}

// the gathered candidates of one rank: score [B, W], bkp [B, W], pred [B, W]
template <typename T>
struct Gathered {
  const unsigned char* base;
  size_t rank_bytes;
  int B, W;
  __device__ const T* score(int r) const {
    return reinterpret_cast<const T*>(base + r * rank_bytes);
  }
  __device__ const int* bkp(int r) const {
    return reinterpret_cast<const int*>(base + r * rank_bytes + (size_t)B * W * sizeof(T));
  }
  __device__ const int* pred(int r) const {
    return reinterpret_cast<const int*>(base + r * rank_bytes
                                        + (size_t)B * W * (sizeof(T) + sizeof(int)));
  }
};

// P1's operands (see sr_wcts_shard_entries)
template <typename T>
struct Step {
  using K = typename KeyOf<T>::type;
  const T* am;
  const int *feat_len, *state, *parent, *grand;
  const T* tdp;
  const int *loop_allowed, *entry_state;
  const T* entry_pen;
  const int *end_first, *end_next;
  T* hyp;
  int* bkp;
  const K* carry_floor;
  T* book;
  Gathered<T> g;
  int ranks;
  T* out_book;
  int *out_bkp, *out_pred;
  T* ends;
  int* ends_bkp;
  K* floor_key;
  T* nhyp;
  int* nbkp;
  const int* frame;
  int B, Tn, S, n_local, N, W, ctx0, prune;
  T thr;
};

template <typename T>
__device__ __forceinline__ int frame_of(const Step<T>& a, int t) {
  return a.frame ? *a.frame + t : t;
}

// frame t - 1's word ends, recombined over the ranks in rank order: that
// frame's outputs and a live utterance's carried book; s_book (where given)
// gets the book frame t's entries read
template <typename T>
__device__ void recombine_words(const Step<T>& a, int b, int t, int len, T* s_book) {
  const T BIGV = big<T>();
  const T HALF = BIGV * T(0.5);
  const int tp = t - 1;
  const bool alive = tp <= len;
  for (int w = threadIdx.x; w < a.W; w += blockDim.x) {
    const size_t o = (size_t)b * a.W + w;
    T best = a.g.score(0)[o];
    int win = 0;
    for (int r = 1; r < a.ranks; ++r) {
      const T v = a.g.score(r)[o];
      if (takes(v, best)) { best = v; win = r; }
    }
    if (best >= HALF) best = BIGV;
    const size_t q = ((size_t)(tp - 1) * a.B + b) * a.W + w;
    a.out_book[q] = best;
    a.out_bkp[q] = a.g.bkp(win)[o];
    a.out_pred[q] = a.g.pred(win)[o];
    const T kept = alive ? best : a.book[o];
    if (alive) a.book[o] = best;
    if (s_book) s_book[w] = kept;
  }
}

// one slot's new raw cell from its three predecessors' cells (skip from
// the grandparent, then fwd, then loop, each only where strictly less), the
// node's emission and its entry (ext + entry_pen + the entered state's
// emission), which wins ties; node 0 BIG; min(v, BIG) keeping NaN
template <typename T>
__device__ __forceinline__ void slot_step(T hg, int bg, T hp, int bp, T hn, int bn, bool loop_ok,
                                          T tdp0, T tdp1, T tdp2, T em, T ext, T epen, T eem,
                                          bool root, int t, T& v, int& vb) {
  const T BIGV = big<T>();
  T within = add(hg, tdp2);
  int wb = bg;
  const T fwd = add(hp, tdp1);
  if (fwd < within) { within = fwd; wb = bp; }
  const T loop = loop_ok ? add(hn, tdp0) : BIGV;
  if (loop < within) { within = loop; wb = bn; }
  within = add(within, em);
  const T entry = add(add(ext, epen), eem);
  if (entry <= within) { v = entry; vb = t - 1; } else { v = within; vb = wb; }
  if (root) v = BIGV;
  if (!(v < BIGV) && v == v) v = BIGV;
}

// a context's entry score: its word's book; the sentence start 0 at frame 1
// only; a padding context BIG
template <typename T>
__device__ __forceinline__ T entry_score(int ctx, int W, int t, T book_ctx) {
  return ctx < W ? book_ctx : (ctx == W && t == 1 ? T(0) : big<T>());
}

// the shared memory of the owner instance: the row's scores [n_local][N] T,
// its backpointers [n_local][N] int, the book [W] T
struct OwnerLayout {
  size_t h, b, book, total;
  template <typename T>
  static OwnerLayout of(int n_local, int N, int W) {
    const size_t row = (size_t)n_local * N;
    OwnerLayout L;
    L.h = 0;
    L.b = search::align16(row * sizeof(T));
    L.book = L.b + search::align16(row * sizeof(int));
    L.total = L.book + search::align16((size_t)W * sizeof(T));
    return L;
  }
};

template <typename T>
__global__ void __launch_bounds__(search::MAX_THREADS)
shard_owner_kernel(const Step<T> a, const OwnerLayout L, int t_in, int recombine, int step) {
  using K = typename KeyOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ K s_red[32];
  T* s_h = reinterpret_cast<T*>(smem + L.h);
  int* s_b = reinterpret_cast<int*>(smem + L.b);
  T* s_book = reinterpret_cast<T*>(smem + L.book);
  const int b = blockIdx.x;
  const int t = frame_of(a, t_in);
  const int len = a.feat_len[b];
  const int nl = a.n_local, N = a.N, W = a.W;
  const T BIGV = big<T>();

  if (recombine) {
    recombine_words(a, b, t, len, step ? s_book : nullptr);
  } else if (step) {
    for (int w = threadIdx.x; w < W; w += blockDim.x) s_book[w] = a.book[(size_t)b * W + w];
  }
  if (!step) return;

  // this thread's node in every local context: the carried row staged,
  // renormalised and pruned as read; the node's tables and the frame's two
  // emissions, the same in every context
  const int n = threadIdx.x;
  const bool node = n < N;
  const size_t row0 = (size_t)b * nl * N;
  const T fl = floor_of<T>(a.carry_floor[b]);
  int pa = 0, gr = 0, wl = -1;
  bool loop_ok = false;
  T tdp0 = BIGV, tdp1 = BIGV, tdp2 = BIGV, em = BIGV, eem = BIGV, epen = BIGV;
  if (node) {
    for (int c = 0; c < nl; ++c) {
      const size_t s = row0 + (size_t)c * N + n;
      s_h[c * N + n] = carried(a.hyp[s], fl, a.thr, a.prune);
      s_b[c * N + n] = a.bkp[s];
    }
    const T* am_t = a.am + ((size_t)b * a.Tn + (t - 1)) * a.S;
    pa = a.parent[n];
    gr = a.grand[n];
    tdp0 = a.tdp[3 * n];
    tdp1 = a.tdp[3 * n + 1];
    tdp2 = a.tdp[3 * n + 2];
    loop_ok = a.loop_allowed[n] != 0;
    em = am_t[a.state[n]];
    eem = am_t[a.entry_state[n]];
    epen = a.entry_pen[n];
    wl = a.end_first[n];
  }
  __syncthreads();

  const bool alive = t <= len;
  K kmin = order_key(BIGV);
  if (node) {
    for (int c = 0; c < nl; ++c) {
      const T* h = s_h + c * N;
      const int* hb = s_b + c * N;
      const int ctx = a.ctx0 + c;
      const T ext = entry_score<T>(ctx, W, t, ctx < W ? s_book[ctx] : BIGV);
      T v;
      int vb;
      slot_step(h[gr], hb[gr], h[pa], hb[pa], h[n], hb[n], loop_ok, tdp0, tdp1, tdp2, em, ext,
                epen, eem, n == 0, t, v, vb);
      if (alive) {
        a.hyp[row0 + (size_t)c * N + n] = v;
        a.bkp[row0 + (size_t)c * N + n] = vb;
      }
      for (int w = wl; w >= 0; w = a.end_next[w]) {
        const size_t e = ((size_t)b * nl + c) * W + w;
        a.ends[e] = v;
        a.ends_bkp[e] = vb;
      }
      kmin = key_min(kmin, order_key(v));
    }
  }
  kmin = block_key_min(kmin, s_red);
  if (threadIdx.x == 0) a.floor_key[b] = kmin;
}

template <typename T>
__global__ void __launch_bounds__(search::MAX_THREADS)
shard_block_kernel(const Step<T> a, int t_in, int recombine, int step) {
  using K = typename KeyOf<T>::type;
  __shared__ K s_red[32];
  const int b = blockIdx.x;
  const int t = frame_of(a, t_in);
  const int len = a.feat_len[b];
  const int nl = a.n_local, N = a.N, W = a.W;
  const T BIGV = big<T>();

  if (recombine) recombine_words(a, b, t, len, static_cast<T*>(nullptr));
  __syncthreads();
  if (!step) return;

  const T* am_t = a.am + ((size_t)b * a.Tn + (t - 1)) * a.S;
  const size_t row0 = (size_t)b * nl * N;
  const T fl = floor_of<T>(a.carry_floor[b]);
  K kmin = order_key(BIGV);
  for (int s = threadIdx.x; s < nl * N; s += blockDim.x) {
    const int c = s / N;
    const int n = s - c * N;
    const int ctx = a.ctx0 + c;
    const T ext = entry_score<T>(ctx, W, t, ctx < W ? a.book[(size_t)b * W + ctx] : BIGV);
    const T* h = a.hyp + row0 + (size_t)c * N;
    const int* hb = a.bkp + row0 + (size_t)c * N;
    const int pn = a.parent[n];
    const int gn = a.grand[n];
    T v;
    int vb;
    slot_step(carried(h[gn], fl, a.thr, a.prune), hb[gn], carried(h[pn], fl, a.thr, a.prune),
              hb[pn], carried(h[n], fl, a.thr, a.prune), hb[n], a.loop_allowed[n] != 0,
              a.tdp[3 * n], a.tdp[3 * n + 1], a.tdp[3 * n + 2], am_t[a.state[n]], ext,
              a.entry_pen[n], am_t[a.entry_state[n]], n == 0, t, v, vb);
    a.nhyp[row0 + s] = v;
    a.nbkp[row0 + s] = vb;
    for (int w = a.end_first[n]; w >= 0; w = a.end_next[w]) {
      const size_t e = ((size_t)b * nl + c) * W + w;
      a.ends[e] = v;
      a.ends_bkp[e] = vb;
    }
    kmin = key_min(kmin, order_key(v));
  }
  kmin = block_key_min(kmin, s_red);  // its barrier: every slot is computed
  if (threadIdx.x == 0) a.floor_key[b] = kmin;
  if (t <= len) {
    for (int s = threadIdx.x; s < nl * N; s += blockDim.x) {
      a.hyp[row0 + s] = a.nhyp[row0 + s];
      a.bkp[row0 + s] = a.nbkp[row0 + s];
    }
  }
}

constexpr int ENDS_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(ENDS_THREADS)
shard_ends_kernel(const int* __restrict__ feat_len, const T* __restrict__ lm_local,
                  const typename KeyOf<T>::type* __restrict__ floor_key,
                  typename KeyOf<T>::type* __restrict__ carry_floor, const T* __restrict__ ends,
                  const int* __restrict__ ends_bkp, T* __restrict__ send, int B, int n_local,
                  int W, int ctx0, const int* __restrict__ frame, int t_in, T thr, int prune) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * W) return;
  const int b = i / W;
  const int w = i - b * W;
  const int t = frame ? *frame + t_in : t_in;
  const T BIGV = big<T>();
  const T HALF = BIGV * T(0.5);
  const auto fk = floor_key[b];
  const T fl = floor_of<T>(fk);
  if (w == 0 && t <= feat_len[b]) carry_floor[b] = fk;
  T bestc = BIGV;
  int win = -1, wbkp = 0;
  for (int c = 0; c < n_local; ++c) {
    const size_t e = ((size_t)b * n_local + c) * W + w;
    const T h = carried(ends[e], fl, thr, prune);
    const T cand = h >= HALF ? BIGV : add(h, lm_local[(size_t)c * W + w]);
    if (win < 0 || takes(cand, bestc)) {
      bestc = cand;
      win = c;
      wbkp = ends_bkp[e];
    }
  }
  int* send_bkp = reinterpret_cast<int*>(send + (size_t)B * W);
  int* send_pred = send_bkp + (size_t)B * W;
  send[i] = bestc;
  send_bkp[i] = wbkp;
  send_pred[i] = ctx0 + win;
}

// the instance P1 takes for a shape: 1 the owner instance, 0 the block
// instance
template <typename T>
int instance_for(int n_local, int N, int W) {
  return N <= search::MAX_THREADS
                 && OwnerLayout::of<T>(n_local, N, W).total <= search::SHARED_LIMIT
             ? 1
             : 0;
}

// the dynamic shared memory limit of `kernel`, raised only where a launch
// needs more than the default 48 KB (static memory included)
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return smem + 1024 > 48 * 1024 ? search::allow_smem(kernel, smem) : cudaSuccess;
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

template <typename T>
int launch_entries(const Step<T>& a, int t, int recombine, int step, int first_design,
                   int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (a.B == 0) return (int)cudaSuccess;
  if (a.n_local <= 0 || a.N <= 0 || a.W <= 0 || a.ranks <= 0) return (int)cudaErrorInvalidValue;
  // an absolute frame is checked here; a frame-relative one (t the offset
  // added to *frame) by its caller, which writes *frame
  if (a.frame == nullptr ? (t < 1 || (step && t > a.Tn) || (recombine && (t < 2 || t > a.Tn + 1)))
                         : t < 0)
    return (int)cudaErrorInvalidValue;
  const int owner = !first_design && instance_for<T>(a.n_local, a.N, a.W);
  if (owner) {
    const OwnerLayout L = OwnerLayout::of<T>(a.n_local, a.N, a.W);
    err = allow_smem(shard_owner_kernel<T>, L.total);
    if (err != cudaSuccess) return (int)err;
    const int threads = search::threads_for(a.N);
    shard_owner_kernel<T><<<a.B, threads, L.total, (cudaStream_t)stream>>>(a, L, t, recombine,
                                                                          step);
  } else {
    if (step && (a.nhyp == nullptr || a.nbkp == nullptr)) return (int)cudaErrorInvalidValue;
    const long long slots = (long long)a.n_local * a.N;
    const int threads = search::threads_for(slots > a.W ? slots : a.W);
    shard_block_kernel<T><<<a.B, threads, 0, (cudaStream_t)stream>>>(a, t, recombine, step);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ends(const int* feat_len, const void* lm_local, const void* floor_key,
                void* carry_floor, const void* ends, const int* ends_bkp, void* send, int B,
                int n_local, int W, int ctx0, double thr, int prune, const int* frame, int t,
                int device, void* stream) {
  using K = typename KeyOf<T>::type;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaSuccess;
  if (n_local <= 0 || W <= 0 || (frame == nullptr ? t < 1 : t < 0))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * W;
  shard_ends_kernel<T><<<(unsigned)((n + ENDS_THREADS - 1) / ENDS_THREADS), ENDS_THREADS, 0,
                         (cudaStream_t)stream>>>(
      feat_len, static_cast<const T*>(lm_local), static_cast<const K*>(floor_key),
      static_cast<K*>(carry_floor), static_cast<const T*>(ends), ends_bkp, static_cast<T*>(send),
      B, n_local, W, ctx0, frame, t, (T)thr, prune);
  return (int)cudaGetLastError();
}

template <typename T>
int residency(int n_local, int N, int W, int first_design) {
  int blocks = 0;
  cudaError_t err;
  if (!first_design && instance_for<T>(n_local, N, W)) {
    const size_t smem = OwnerLayout::of<T>(n_local, N, W).total;
    err = allow_smem(shard_owner_kernel<T>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, shard_owner_kernel<T>,
                                                          search::threads_for(N), smem);
  } else {
    const long long slots = (long long)n_local * N;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, shard_block_kernel<T>, search::threads_for(slots > W ? slots : W), 0);
  }
  return err == cudaSuccess ? blocks : -1;
}

}  // namespace

// the instance sr_wcts_shard_entries launches for a shape (first_design =
// 0): 1 the owner instance, 0 the block instance (which needs the scratch
// rows nhyp, nbkp)
extern "C" int sr_wcts_shard_instance(int n_local, int N, int W, int f64) {
  return f64 ? instance_for<double>(n_local, N, W) : instance_for<float>(n_local, N, W);
}

// blocks an SM of P1's launch for a shape (first_design: the block
// instance), by the occupancy calculator; -1 on an error
extern "C" int sr_wcts_shard_residency(int n_local, int N, int W, int f64, int first_design) {
  return f64 ? residency<double>(n_local, N, W, first_design)
             : residency<float>(n_local, N, W, first_design);
}

// P1 in float (f64 == 0) or double. am [B, Tn, S]; the tree's tables [N]
// (tdp [N, 3]), end_first [N] (each node's first word ending there, -1:
// none) and end_next [W] (the next word ending at the same node, -1); the
// carry: hyp, bkp [B, n_local, N] raw cells (read, and written for a live
// utterance), carry_floor [B] the key they are renormalised by, book [B, W];
// gathered: `ranks` rank buffers of rank_bytes each (score [B, W], bkp and
// pred [B, W] int32); out_* [Tn, B, W]; ends, ends_bkp [B, n_local, W] the
// end-node cells; floor_key [B] (int or long long); nhyp, nbkp [B, n_local,
// N] the block instance's scratch rows (NULL for the owner instance).
// recombine: frame t - 1's candidates are in `gathered` (2 <= t <= Tn + 1);
// step: run frame t (t <= Tn). frame: NULL, or a device int the frame is
// *frame + t of. first_design: 0 the instance the shape chooses, 1 the
// block instance.
extern "C" int sr_wcts_shard_entries(
    int f64, const void* am, const int* feat_len, const int* state, const int* parent,
    const int* grand, const void* tdp, const int* loop_allowed, const int* entry_state,
    const void* entry_pen, const int* end_first, const int* end_next, void* hyp, int* bkp,
    const void* carry_floor, void* book, const void* gathered, long long rank_bytes, int ranks,
    void* out_book, int* out_bkp, int* out_pred, void* ends, int* ends_bkp, void* floor_key,
    void* nhyp, int* nbkp, int B, int Tn, int S, int n_local, int N, int W, int ctx0, double thr,
    int prune, const int* frame, int t, int recombine, int step, int first_design, int device,
    void* stream) {
  if (f64) {
    using T = double;
    const Step<T> a{static_cast<const T*>(am), feat_len, state, parent, grand,
                    static_cast<const T*>(tdp), loop_allowed, entry_state,
                    static_cast<const T*>(entry_pen), end_first, end_next, static_cast<T*>(hyp),
                    bkp, static_cast<const long long*>(carry_floor), static_cast<T*>(book),
                    Gathered<T>{static_cast<const unsigned char*>(gathered), (size_t)rank_bytes,
                                B, W},
                    ranks, static_cast<T*>(out_book), out_bkp, out_pred, static_cast<T*>(ends),
                    ends_bkp, static_cast<long long*>(floor_key), static_cast<T*>(nhyp), nbkp,
                    frame, B, Tn, S, n_local, N, W, ctx0, prune, (T)thr};
    return launch_entries(a, t, recombine, step, first_design, device, stream);
  }
  using T = float;
  const Step<T> a{static_cast<const T*>(am), feat_len, state, parent, grand,
                  static_cast<const T*>(tdp), loop_allowed, entry_state,
                  static_cast<const T*>(entry_pen), end_first, end_next, static_cast<T*>(hyp),
                  bkp, static_cast<const int*>(carry_floor), static_cast<T*>(book),
                  Gathered<T>{static_cast<const unsigned char*>(gathered), (size_t)rank_bytes, B,
                              W},
                  ranks, static_cast<T*>(out_book), out_bkp, out_pred, static_cast<T*>(ends),
                  ends_bkp, static_cast<int*>(floor_key), static_cast<T*>(nhyp), nbkp, frame, B,
                  Tn, S, n_local, N, W, ctx0, prune, (T)thr};
  return launch_entries(a, t, recombine, step, first_design, device, stream);
}

// P2 in float or double: floor_key [B] after the all-reduce MIN; ends,
// ends_bkp [B, n_local, W] from P1; lm_local [n_local, W]; carry_floor [B]
// updated for a live utterance; send: score [B, W], then bkp and pred [B,
// W] int32. frame: as P1's.
extern "C" int sr_wcts_shard_ends(int f64, const int* feat_len, const void* lm_local,
                                  const void* floor_key, void* carry_floor, const void* ends,
                                  const int* ends_bkp, void* send, int B, int n_local, int W,
                                  int ctx0, double thr, int prune, const int* frame, int t,
                                  int device, void* stream) {
  return f64 ? launch_ends<double>(feat_len, lm_local, floor_key, carry_floor, ends, ends_bkp,
                                   send, B, n_local, W, ctx0, thr, prune, frame, t, device, stream)
             : launch_ends<float>(feat_len, lm_local, floor_key, carry_floor, ends, ends_bkp,
                                  send, B, n_local, W, ctx0, thr, prune, frame, t, device, stream);
}
