// Kernel N: the backward word walk over kernel M's books.
//
// Replaces speechrecognition_tpu/search/linear_lvcsr.py::_traceback_device
// (a lax.scan of MAX_TRACE_WORDS steps of gathers, vectorised over the
// batch). Same inputs and output: book [T, B, W] and silend [T, B, V] in the
// score type, bkp, pred [T, B, W], origin, silorg [T, B, V] and feat_len [B]
// int; it writes words [max_words, B], the real-word indices in reverse
// order, -1 once the walk is done. A template on the score type.
//
// It follows the reference step exactly: the walk starts at the last live
// frame tb = max(feat_len, 1) (every index clamped into range, as the
// reference's gathers clamp), at the word end argmin picks, or at the silence
// copy argmin picks when the least silence end is strictly smaller (then at
// that copy's origin); it is done at once for the sentence start, a frame <= 0
// or an empty utterance. Each step emits the current word, reads its entry
// boundary and predecessor at frame t - 1, and moves to the predecessor at the
// origin of its silence copy at that boundary; it is done after the sentence
// start or a frame <= 0.
//
// argmin's order (argmin_before): a NaN comes before every number and the
// first NaN wins, as torch.argmin and jnp.argmin pick it; numbers by value,
// -0.0 equal to +0.0; ties to the first index. keys.cuh's order keys and
// search.cuh's pair_less rank a NaN last, so neither is used here. A NaN
// least value also makes the silence test false, as the reference's amin < .
//
// Two designs, chosen by the C entry's first_design:
//
// - the warp design (the wrappers' launch): a warp an utterance, 4 a block.
//   The 32 lanes read the last live frame's word ends and silence ends
//   coalesced, a lane every 32nd entry in order, and fold them by shuffles
//   under argmin_before. Lane 0 then walks: a step issues the bkp and pred
//   loads together (one index), then the origin load, so a step is two
//   dependent load latencies, and the walk stops when it is done (a few steps
//   an utterance on a decode, not MAX_TRACE_WORDS). The words are staged in
//   shared memory, and the warp writes the utterance's column, -1 after the
//   last word.
// - the first design (forced with first_design = 1 for timing): a
//   thread an utterance that folds both rows alone and runs all max_words
//   steps of three dependent loads, done or not.
//
// What bounds it: the bytes are a few KB and the operations a few thousand,
// so its bound is a fraction of a microsecond. A walk is a chain of dependent
// loads from the books kernel M left in device memory, so the longest walk's
// 2 x steps + 1 load latencies (the chain floor, chip_smoke.py phase 32) and
// the launch set its time.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;   // utterances a block of the warp design

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// true when (a, ia) comes before (b, ib) in argmin's order: a NaN before any
// number, then the smaller value (-0.0 == +0.0), then the smaller index. A
// total order on distinct indices, so a shuffle tree and a serial loop agree.
template <typename T>
__device__ __forceinline__ bool argmin_before(T a, int ia, T b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ia < ib;
}

// the first argmin of fb[0, n) for the first design: one thread, in order
template <typename T>
__device__ __forceinline__ int serial_argmin(const T* __restrict__ fb, int n, T& best) {
  int i_best = 0;
  best = fb[0];
  for (int i = 1; i < n; ++i) {
    const T x = fb[i];
    if (argmin_before(x, i, best, i_best)) {
      best = x;
      i_best = i;
    }
  }
  return i_best;
}

// the warp's argmin of its lanes' (value, index) pairs; every lane gets it
template <typename T>
__device__ __forceinline__ void warp_argmin(T& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (argmin_before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    linear_traceback_warp_kernel(const T* __restrict__ book, const int* __restrict__ bkp,
                                 const int* __restrict__ pred, const int* __restrict__ origin,
                                 const T* __restrict__ silend, const int* __restrict__ silorg,
                                 const int* __restrict__ feat_len, int* __restrict__ words, int B,
                                 int Tn, int W, int max_words) {
  extern __shared__ int s_words[];   // [WARPS][max_words]
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;   // a whole warp; the block has no barrier
  int* staged = s_words + (threadIdx.x >> 5) * max_words;
  const int V = W + 1;
  const int len = feat_len[b];
  const int tb = len > 1 ? len : 1;
  const int tl = tb - 1 < Tn - 1 ? tb - 1 : Tn - 1;
  const size_t row = (size_t)tl * B + b;
  const T* fb = book + row * W;
  const T* fs = silend + row * V;
  // lanes without an entry hold (+inf, INT_MAX), which every entry precedes
  T wv = (T)INFINITY, sv = (T)INFINITY;
  int wi = INT_MAX, si = INT_MAX;
#pragma unroll 4
  for (int k = lane; k < V; k += 32) {
    const T s = fs[k];
    if (k < W) {
      const T x = fb[k];
      if (argmin_before(x, k, wv, wi)) {
        wv = x;
        wi = k;
      }
    }
    if (argmin_before(s, k, sv, si)) {
      sv = s;
      si = k;
    }
  }
  warp_argmin(wv, wi);
  warp_argmin(sv, si);
  int n = 0;
  if (lane == 0) {
    const bool use_sil = sv < wv;
    int cur = use_sil ? si : wi;
    int t = use_sil ? silorg[row * V + si] : tb;
    bool done = cur >= W || t <= 0 || len == 0;
    while (!done) {
      staged[n++] = cur;
      if (n == max_words) break;
      const size_t o = ((size_t)clampi(t - 1, 0, Tn - 1) * B + b) * W + clampi(cur, 0, W - 1);
      const int boundary = bkp[o];
      const int v = pred[o];
      const int t_next =
          origin[((size_t)clampi(boundary, 0, Tn - 1) * B + b) * V + clampi(v, 0, W)];
      done = v >= W || t_next <= 0;
      cur = v;
      t = t_next;
    }
  }
  __syncwarp();
  n = __shfl_sync(FULL, n, 0);
  for (int k = lane; k < max_words; k += 32) words[(size_t)k * B + b] = k < n ? staged[k] : -1;
}

template <typename T>
__global__ void linear_traceback_kernel(const T* __restrict__ book, const int* __restrict__ bkp,
                                        const int* __restrict__ pred,
                                        const int* __restrict__ origin,
                                        const T* __restrict__ silend,
                                        const int* __restrict__ silorg,
                                        const int* __restrict__ feat_len, int* __restrict__ words,
                                        int B, int Tn, int W, int max_words) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int V = W + 1;
  const int len = feat_len[b];
  const int tb = len > 1 ? len : 1;
  const int tl = tb - 1 < Tn - 1 ? tb - 1 : Tn - 1;
  T wv, sv;
  const int w_best = serial_argmin(book + ((size_t)tl * B + b) * W, W, wv);
  const int sil_v = serial_argmin(silend + ((size_t)tl * B + b) * V, V, sv);
  const bool use_sil = sv < wv;
  int cur = use_sil ? sil_v : w_best;
  int t = use_sil ? silorg[((size_t)tl * B + b) * V + sil_v] : tb;
  bool done = cur >= W || t <= 0 || len == 0;
  for (int k = 0; k < max_words; ++k) {
    words[(size_t)k * B + b] = done ? -1 : cur;
    const int tc = clampi(t - 1, 0, Tn - 1);
    const int cc = clampi(cur, 0, W - 1);
    const size_t o = ((size_t)tc * B + b) * W + cc;
    const int boundary = bkp[o];
    const int v = pred[o];
    const int bc = clampi(boundary, 0, Tn - 1);
    const int vc = clampi(v, 0, W);
    const int t_next = origin[((size_t)bc * B + b) * V + vc];
    const bool new_done = done || v >= W || t_next <= 0;
    if (!done) {
      cur = v;
      t = t_next;
    }
    done = new_done;
  }
}

template <typename T>
int launch(const void* book, const int* bkp, const int* pred, const int* origin,
           const void* silend, const int* silorg, const int* feat_len, int* words, int B, int Tn,
           int W, int max_words, int first_design, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || max_words == 0) return (int)cudaSuccess;
  if (Tn == 0 || W == 0 || max_words < 0) return (int)cudaErrorInvalidValue;
  const T* bk = static_cast<const T*>(book);
  const T* se = static_cast<const T*>(silend);
  if (first_design) {
    constexpr int THREADS = 128;
    linear_traceback_kernel<T><<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        bk, bkp, pred, origin, se, silorg, feat_len, words, B, Tn, W, max_words);
  } else {
    const size_t smem = (size_t)WARPS * max_words * sizeof(int);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    linear_traceback_warp_kernel<T><<<(B + WARPS - 1) / WARPS, WARPS * 32, smem,
                                      (cudaStream_t)stream>>>(bk, bkp, pred, origin, se, silorg,
                                                              feat_len, words, B, Tn, W, max_words);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// book and silend in float (f64 == 0) or double; words [max_words, B];
// first_design 0: the warp design, 1: the first design (a thread an utterance)
extern "C" int sr_linear_traceback(int f64, const void* book, const int* bkp, const int* pred,
                                   const int* origin, const void* silend, const int* silorg,
                                   const int* feat_len, int* words, int B, int T, int W,
                                   int max_words, int first_design, int device, void* stream) {
  return f64 ? launch<double>(book, bkp, pred, origin, silend, silorg, feat_len, words, B, T, W,
                              max_words, first_design, device, stream)
             : launch<float>(book, bkp, pred, origin, silend, silorg, feat_len, words, B, T, W,
                             max_words, first_design, device, stream);
}
