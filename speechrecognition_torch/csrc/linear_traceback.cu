// Kernel N: the backward word walk over kernel M's books, one thread an
// utterance.
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
// reference's gathers clamp), at the first word end of least score, or at
// the first silence copy of least end score when that is strictly smaller
// (then at that copy's origin); it is done at once for the sentence start, a
// frame <= 0 or an empty utterance. Each step emits the current word (-1
// when done), reads its entry boundary and predecessor at frame t - 1, and
// moves to the predecessor at the origin of its silence copy at that
// boundary; it is done after the sentence start or a frame <= 0.
//
// What bounds it: a step is three dependent loads from device memory (the
// books stay where kernel M wrote them; only [max_words, B] ints leave the
// device), so a walk is max_words x 3 load latencies; the bytes are a few
// KB. Utterances walk in parallel, one a thread.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
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
  const T* fb = book + ((size_t)tl * B + b) * W;
  const T* fs = silend + ((size_t)tl * B + b) * V;
  int w_best = 0;
  T wv = fb[0];
  for (int w = 1; w < W; ++w)
    if (fb[w] < wv) {
      wv = fb[w];
      w_best = w;
    }
  int sil_v = 0;
  T sv = fs[0];
  for (int v = 1; v < V; ++v)
    if (fs[v] < sv) {
      sv = fs[v];
      sil_v = v;
    }
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
           int W, int max_words, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || max_words == 0) return (int)cudaSuccess;
  if (Tn == 0 || W == 0) return (int)cudaErrorInvalidValue;
  constexpr int THREADS = 128;
  linear_traceback_kernel<T><<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(book), bkp, pred, origin, static_cast<const T*>(silend), silorg,
      feat_len, words, B, Tn, W, max_words);
  return (int)cudaGetLastError();
}

}  // namespace

// book and silend in float (f64 == 0) or double; words [max_words, B]
extern "C" int sr_linear_traceback(int f64, const void* book, const int* bkp, const int* pred,
                                   const int* origin, const void* silend, const int* silorg,
                                   const int* feat_len, int* words, int B, int T, int W,
                                   int max_words, int device, void* stream) {
  return f64 ? launch<double>(book, bkp, pred, origin, silend, silorg, feat_len, words, B, T, W,
                              max_words, device, stream)
             : launch<float>(book, bkp, pred, origin, silend, silorg, feat_len, words, B, T, W,
                             max_words, device, stream);
}
