// Kernel P: one rank's frame step of the context-sharded word-conditioned
// tree search (the per-device body of the reference's wcts_sharded, its
// step under lax.scan and shard_map). A rank owns n_local consecutive
// predecessor contexts [ctx0, ctx0 + n_local) of every utterance; between a
// frame's two launches the ranks exchange the beam floor (an all-reduce MIN
// of order keys) and after the second the word-end candidates (an
// all-gather), both issued by the host between launches.
//
//   P1 (entries): recombine the previous frame's gathered candidates (the
//       first minimum over ranks, NaN first; >= BIG/2 -> BIG), write that
//       frame's outputs and, for a live utterance, the carried book; then
//       the within-word step of every local slot in the reference's order
//       (skip, then fwd if strictly less, then loop if strictly less), the
//       emission, the word entry from the replicated book (the entry wins
//       ties), node 0 BIG, a clamp to BIG that keeps NaN, into the scratch
//       rows, and the utterance's local minimum as an order key.
//   P2 (ends): renormalise by the global floor (a floor >= BIG/2 is 0; a
//       score >= BIG/2 stays BIG), prune (> threshold -> BIG), update the
//       carry of a live utterance, and fold each word's end over the local
//       contexts (first minimum, NaN first) into the rank's send buffer:
//       score, entry frame and global context id.
//
// One block an utterance; its threads stride over the n_local x N slots,
// then over the W words. Order keys are signed (int for float, long long
// for double): a NaN takes the least key, so a NaN minimum propagates as
// the reference's min does, and an integer MIN is exact on every transport.

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

template <typename T>
__global__ void __launch_bounds__(search::MAX_THREADS)
shard_entries_kernel(const T* __restrict__ am, const int* __restrict__ feat_len,
                     const int* __restrict__ state, const int* __restrict__ parent,
                     const int* __restrict__ grand, const T* __restrict__ tdp,
                     const int* __restrict__ loop_allowed, const int* __restrict__ entry_state,
                     const T* __restrict__ entry_pen, const T* __restrict__ hyp,
                     const int* __restrict__ bkp, T* __restrict__ book, Gathered<T> g,
                     int ranks, T* __restrict__ out_book, int* __restrict__ out_bkp,
                     int* __restrict__ out_pred, T* __restrict__ nhyp, int* __restrict__ nbkp,
                     typename KeyOf<T>::type* __restrict__ floor_key, int B, int Tn, int S,
                     int n_local, int N, int W, int ctx0, int t, int recombine, int step) {
  using K = typename KeyOf<T>::type;
  __shared__ K s_red[32];
  const int b = blockIdx.x;
  const T BIGV = big<T>();
  const T HALF = BIGV * T(0.5);
  const int len = feat_len[b];

  if (recombine) {
    // frame t - 1's word ends, recombined over the ranks in rank order
    const int tp = t - 1;
    const bool alive = tp <= len;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const size_t o = (size_t)b * W + w;
      T best = g.score(0)[o];
      int win = 0;
      for (int r = 1; r < ranks; ++r) {
        const T v = g.score(r)[o];
        if (takes(v, best)) { best = v; win = r; }
      }
      if (best >= HALF) best = BIGV;
      const size_t q = ((size_t)(tp - 1) * B + b) * W + w;
      out_book[q] = best;
      out_bkp[q] = g.bkp(win)[o];
      out_pred[q] = g.pred(win)[o];
      if (alive) book[o] = best;
    }
    __syncthreads();
  }
  if (!step) return;

  const T* am_t = am + ((size_t)b * Tn + (t - 1)) * S;
  const size_t row0 = (size_t)b * n_local * N;
  K kmin = order_key(BIGV);
  for (int s = threadIdx.x; s < n_local * N; s += blockDim.x) {
    const int c = s / N;
    const int n = s - c * N;
    const int ctx = ctx0 + c;
    const T ext = ctx < W ? book[(size_t)b * W + ctx] : (ctx == W && t == 1 ? T(0) : BIGV);
    const T* h = hyp + row0 + (size_t)c * N;
    const int* hb = bkp + row0 + (size_t)c * N;
    const int pn = parent[n];
    const int gn = grand[n];
    T within = add(h[gn], tdp[3 * n + 2]);
    int wb = hb[gn];
    const T fwd = add(h[pn], tdp[3 * n + 1]);
    if (fwd < within) { within = fwd; wb = hb[pn]; }
    const T loop = loop_allowed[n] ? add(h[n], tdp[3 * n]) : BIGV;
    if (loop < within) { within = loop; wb = hb[n]; }
    within = add(within, am_t[state[n]]);
    const T entry = add(add(ext, entry_pen[n]), am_t[entry_state[n]]);
    T v;
    int vb;
    if (entry <= within) { v = entry; vb = t - 1; } else { v = within; vb = wb; }
    if (n == 0) v = BIGV;
    if (!(v < BIGV) && v == v) v = BIGV;      // minimum(v, BIG), NaN kept
    nhyp[row0 + s] = v;
    nbkp[row0 + s] = vb;
    kmin = key_min(kmin, order_key(v));
  }
  kmin = block_key_min(kmin, s_red);
  if (threadIdx.x == 0) floor_key[b] = kmin;
}

template <typename T>
__global__ void __launch_bounds__(search::MAX_THREADS)
shard_ends_kernel(const int* __restrict__ feat_len, const int* __restrict__ end_node,
                  const T* __restrict__ lm_local, const typename KeyOf<T>::type* __restrict__ floor_key,
                  T* __restrict__ nhyp, const int* __restrict__ nbkp, T* __restrict__ hyp,
                  int* __restrict__ bkp, T* __restrict__ send, int B, int n_local, int N, int W,
                  int ctx0, int t, T thr, int prune) {
  const int b = blockIdx.x;
  const T BIGV = big<T>();
  const T HALF = BIGV * T(0.5);
  const bool alive = t <= feat_len[b];
  T best = key_value(floor_key[b]);
  if (best >= HALF) best = T(0);
  const size_t row0 = (size_t)b * n_local * N;
  for (int s = threadIdx.x; s < n_local * N; s += blockDim.x) {
    T v = nhyp[row0 + s];
    v = v >= HALF ? BIGV : sub(v, best);
    if (prune && v > thr) v = BIGV;
    nhyp[row0 + s] = v;
    if (alive) {
      hyp[row0 + s] = v;
      bkp[row0 + s] = nbkp[row0 + s];
    }
  }
  __syncthreads();
  int* send_bkp = reinterpret_cast<int*>(send + (size_t)B * W);
  int* send_pred = send_bkp + (size_t)B * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int e = end_node[w];
    T bestc = BIGV;
    int win = -1;
    for (int c = 0; c < n_local; ++c) {
      const T h = nhyp[row0 + (size_t)c * N + e];
      const T cand = h >= HALF ? BIGV : add(h, lm_local[(size_t)c * W + w]);
      if (win < 0 || takes(cand, bestc)) { bestc = cand; win = c; }
    }
    const size_t o = (size_t)b * W + w;
    send[o] = bestc;
    send_bkp[o] = nbkp[row0 + (size_t)win * N + e];
    send_pred[o] = ctx0 + win;
  }
}

template <typename T>
int launch_entries(const void* am, const int* feat_len, const int* state, const int* parent,
                   const int* grand, const void* tdp, const int* loop_allowed,
                   const int* entry_state, const void* entry_pen, const void* hyp, const int* bkp,
                   void* book, const void* gathered, long long rank_bytes, int ranks,
                   void* out_book, int* out_bkp, int* out_pred, void* nhyp, int* nbkp,
                   void* floor_key, int B, int Tn, int S, int n_local, int N, int W, int ctx0,
                   int t, int recombine, int step, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaSuccess;
  if (n_local <= 0 || N <= 0 || W <= 0 || ranks <= 0 || t < 1 || (step && t > Tn)
      || (recombine && (t < 2 || t > Tn + 1)))
    return (int)cudaErrorInvalidValue;
  const int threads = search::threads_for((long long)n_local * N > W ? (long long)n_local * N : W);
  Gathered<T> g{static_cast<const unsigned char*>(gathered), (size_t)rank_bytes, B, W};
  shard_entries_kernel<T><<<B, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(am), feat_len, state, parent, grand, static_cast<const T*>(tdp),
      loop_allowed, entry_state, static_cast<const T*>(entry_pen), static_cast<const T*>(hyp),
      bkp, static_cast<T*>(book), g, ranks, static_cast<T*>(out_book), out_bkp, out_pred,
      static_cast<T*>(nhyp), nbkp, static_cast<typename KeyOf<T>::type*>(floor_key), B, Tn, S,
      n_local, N, W, ctx0, t, recombine, step);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ends(const int* feat_len, const int* end_node, const void* lm_local,
                const void* floor_key, void* nhyp, const int* nbkp, void* hyp, int* bkp,
                void* send, int B, int n_local, int N, int W, int ctx0, int t, double thr,
                int prune, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaSuccess;
  if (n_local <= 0 || N <= 0 || W <= 0 || t < 1) return (int)cudaErrorInvalidValue;
  const int threads = search::threads_for((long long)n_local * N > W ? (long long)n_local * N : W);
  shard_ends_kernel<T><<<B, threads, 0, (cudaStream_t)stream>>>(
      feat_len, end_node, static_cast<const T*>(lm_local),
      static_cast<const typename KeyOf<T>::type*>(floor_key), static_cast<T*>(nhyp), nbkp,
      static_cast<T*>(hyp), bkp, static_cast<T*>(send), B, n_local, N, W, ctx0, t, (T)thr,
      prune);
  return (int)cudaGetLastError();
}

}  // namespace

// P1 in float (f64 == 0) or double. am [B, Tn, S]; hyp, bkp [B, n_local, N]
// (the carry, read); book [B, W] (the carry, written for a live utterance);
// gathered: `ranks` rank buffers of rank_bytes each (score [B, W], bkp and
// pred [B, W] int32); out_* [Tn, B, W]; nhyp, nbkp [B, n_local, N] scratch;
// floor_key [B] (int or long long). recombine: frame t - 1's candidates are
// in `gathered` (2 <= t <= Tn + 1); step: run frame t (t <= Tn).
extern "C" int sr_wcts_shard_entries(int f64, const void* am, const int* feat_len,
                                     const int* state, const int* parent, const int* grand,
                                     const void* tdp, const int* loop_allowed,
                                     const int* entry_state, const void* entry_pen,
                                     const void* hyp, const int* bkp, void* book,
                                     const void* gathered, long long rank_bytes, int ranks,
                                     void* out_book, int* out_bkp, int* out_pred, void* nhyp,
                                     int* nbkp, void* floor_key, int B, int Tn, int S,
                                     int n_local, int N, int W, int ctx0, int t, int recombine,
                                     int step, int device, void* stream) {
  return f64 ? launch_entries<double>(am, feat_len, state, parent, grand, tdp, loop_allowed,
                                      entry_state, entry_pen, hyp, bkp, book, gathered,
                                      rank_bytes, ranks, out_book, out_bkp, out_pred, nhyp, nbkp,
                                      floor_key, B, Tn, S, n_local, N, W, ctx0, t, recombine,
                                      step, device, stream)
             : launch_entries<float>(am, feat_len, state, parent, grand, tdp, loop_allowed,
                                     entry_state, entry_pen, hyp, bkp, book, gathered,
                                     rank_bytes, ranks, out_book, out_bkp, out_pred, nhyp, nbkp,
                                     floor_key, B, Tn, S, n_local, N, W, ctx0, t, recombine,
                                     step, device, stream);
}

// P2 in float or double: floor_key [B] after the all-reduce MIN; nhyp
// renormalised in place; hyp, bkp (the carry) updated for a live utterance;
// send: score [B, W], then bkp and pred [B, W] int32.
extern "C" int sr_wcts_shard_ends(int f64, const int* feat_len, const int* end_node,
                                  const void* lm_local, const void* floor_key, void* nhyp,
                                  const int* nbkp, void* hyp, int* bkp, void* send, int B,
                                  int n_local, int N, int W, int ctx0, int t, double thr,
                                  int prune, int device, void* stream) {
  return f64 ? launch_ends<double>(feat_len, end_node, lm_local, floor_key, nhyp, nbkp, hyp, bkp,
                                   send, B, n_local, N, W, ctx0, t, thr, prune, device, stream)
             : launch_ends<float>(feat_len, end_node, lm_local, floor_key, nhyp, nbkp, hyp, bkp,
                                  send, B, n_local, N, W, ctx0, t, thr, prune, device, stream);
}
