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
// Design: one persistent block per utterance and one thread per (word,
// position) slot (W*P = 288 threads for SieTill). The frame loop runs inside
// the kernel; each thread keeps its own slot's score and backpointer in
// registers and publishes them to shared memory (double-buffered) so its
// right-hand neighbours can read them for the 0-1-2 recursion. Per frame it
// follows the reference step exactly:
//   * within-word candidates from s, s-1 and s-2 with tdp_within; start at
//     the jump-2 candidate, take jump 1 if strictly less, then jump 0 if
//     strictly less (larger jumps win ties);
//   * entries into positions 0 and 1 cost (book_prev + entry_pen) plus the
//     acoustic score of the ENTERED position's state; entries win ties (<=);
//   * invalid slots and min(new, BIG); the block-wide minimum; renormalize
//     with the >= BIG/2 guards; prune new > am_threshold;
//   * word ends at last_pos (+ exit_pen when given), argmin over words with
//     the first index winning ties;
//   * the utterance freezes once t > feat_len (outputs are still written).
// Every operation is an add, compare or select in the score type and
// BIG = 1e30 is a finite sentinel, so the kernel matches its plain PyTorch
// version bit for bit in both types. The minimum is exact in any order, so the warp-shuffle reduction
// keeps that property; the word argmin is a serial first-index scan.
//
// What bounds it: latency. A frame is three __syncthreads plus one scattered
// read of am per thread; the arithmetic is a few dozen instructions.
// A block occupies one SM slot for the whole chunk, so the card is filled by
// many utterances at once: a batch of 1024 utterance blocks (7 per SM at 288
// threads) is what keeps all 132 SMs busy.

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T tmin(T a, T b);
template <>
__device__ __forceinline__ float tmin<float>(float a, float b) { return fminf(a, b); }
template <>
__device__ __forceinline__ double tmin<double>(double a, double b) { return fmin(a, b); }

template <typename T>
__global__ void decode_scan_kernel(
    const T* __restrict__ am, const int* __restrict__ feat_len,
    const int* __restrict__ state_table, const int* __restrict__ last_pos,
    const int* __restrict__ word_len, const T* __restrict__ tdp_within,
    const T* __restrict__ entry_pen, const T* __restrict__ exit_pen,
    const T* __restrict__ hyp_in, const int* __restrict__ bkp_in,
    const T* __restrict__ book_in, T* __restrict__ hyp_out,
    int* __restrict__ bkp_out, T* __restrict__ book_out,
    T* __restrict__ score, int* __restrict__ word, int* __restrict__ bkp,
    int B, int Tn, int S, int W, int P, int t0, T am_threshold, int prune) {
  const T BIG = T(1e30);
  const int WP = W * P;
  const int nwarps = blockDim.x / 32;
  // score-typed arrays first, then the int arrays, so each stays aligned
  extern __shared__ __align__(8) unsigned char smem_raw[];
  T* sh_h = reinterpret_cast<T*>(smem_raw);           // [2][WP]
  T* s_end = sh_h + 2 * WP;                           // [W]
  T* s_wmin = s_end + W;                              // [32]
  T* s_book = s_wmin + 32;                            // [1]
  int* sh_b = reinterpret_cast<int*>(s_book + 1);     // [2][WP]
  int* s_endb = sh_b + 2 * WP;                        // [W]

  const int b = blockIdx.x;
  const int idx = threadIdx.x;
  const bool slot = idx < WP;
  const int w = slot ? idx / P : 0;
  const int p = slot ? idx - w * P : 0;

  // per-slot constants
  int st = 0;
  T tw0 = BIG, tw1 = BIG, tw2 = BIG, ep = BIG, xp = T(0);
  bool valid = false, is_end = false;
  if (slot) {
    st = state_table[idx];
    tw0 = tdp_within[idx * 3 + 0];
    tw1 = tdp_within[idx * 3 + 1];
    tw2 = tdp_within[idx * 3 + 2];
    valid = p < word_len[w];
    is_end = p == last_pos[w];
    if (p < 2) ep = entry_pen[w * 2 + p];
    if (exit_pen != nullptr) xp = exit_pen[w];
  }

  T h = slot ? hyp_in[(size_t)b * WP + idx] : BIG;
  int bk = slot ? bkp_in[(size_t)b * WP + idx] : 0;
  if (idx == 0) *s_book = book_in[b];
  const int len = feat_len[b];
  const T half_big = BIG * T(0.5);
  const T* am_b = am + (size_t)b * Tn * S;

  int buf = 0;
  for (int i = 0; i < Tn; ++i) {
    const int t = t0 + i + 1;  // 1-based frame index
    if (slot) {
      sh_h[buf * WP + idx] = h;
      sh_b[buf * WP + idx] = bk;
    }
    __syncthreads();  // (1) hyp of frame t-1 and book_prev are visible
    const T book_prev = *s_book;

    T nv = BIG;
    int nb = 0;
    if (slot) {
      const T am_v = am_b[(size_t)i * S + st];
      const T c0 = h + tw0;
      const T c1 = p >= 1 ? sh_h[buf * WP + idx - 1] + tw1 : BIG;
      const T c2 = p >= 2 ? sh_h[buf * WP + idx - 2] + tw2 : BIG;
      const int b0 = p >= 1 ? sh_b[buf * WP + idx - 1] : 0;
      const int b00 = p >= 2 ? sh_b[buf * WP + idx - 2] : 0;
      T within = c2;
      int wb = b00;
      if (c1 < within) { within = c1; wb = b0; }
      if (c0 < within) { within = c0; wb = bk; }
      within = within + am_v;
      const T entry = p < 2 ? (book_prev + ep) + am_v : BIG;
      if (entry <= within) {
        nv = entry;
        nb = t - 1;
      } else {
        nv = within;
        nb = wb;
      }
      if (!valid) nv = BIG;
      nv = tmin(nv, BIG);
    }

    // block-wide minimum (exact in any order)
    T m = nv;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = tmin(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((idx & 31) == 0) s_wmin[idx >> 5] = m;
    __syncthreads();  // (2) per-warp minima are visible
    T best = s_wmin[0];
    for (int k = 1; k < nwarps; ++k) best = tmin(best, s_wmin[k]);
    if (best >= half_big) best = T(0);
    nv = nv >= half_big ? BIG : nv - best;
    if (prune && nv > am_threshold) nv = BIG;

    if (slot && is_end) {
      s_end[w] = exit_pen != nullptr ? nv + xp : nv;
      s_endb[w] = nb;
    }
    __syncthreads();  // (3) word-end scores are visible

    const bool alive = t <= len;
    if (idx == 0) {
      T bs = s_end[0];
      int bw = 0;
      for (int k = 1; k < W; ++k)
        if (s_end[k] < bs) { bs = s_end[k]; bw = k; }
      const int bb = s_endb[bw];
      if (bs >= half_big) bs = BIG;
      score[(size_t)i * B + b] = bs;
      word[(size_t)i * B + b] = bw;
      bkp[(size_t)i * B + b] = bb;
      if (alive) *s_book = bs;
    }
    if (alive) {
      h = nv;
      bk = nb;
    }
    buf ^= 1;
  }

  if (slot) {
    hyp_out[(size_t)b * WP + idx] = h;
    bkp_out[(size_t)b * WP + idx] = bk;
  }
  __syncthreads();
  if (idx == 0) book_out[b] = *s_book;
}

template <typename T>
int launch(const T* am, const int* feat_len, const int* state_table,
           const int* last_pos, const int* word_len, const T* tdp_within,
           const T* entry_pen, const T* exit_pen, const T* hyp_in,
           const int* bkp_in, const T* book_in, T* hyp_out, int* bkp_out,
           T* book_out, T* score, int* word, int* bkp, int B, int Tn, int S,
           int W, int P, int t0, T am_threshold, int prune, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaSuccess;
  const int WP = W * P;
  const int threads = (WP + 31) / 32 * 32;
  const size_t smem = (2 * (size_t)WP + W + 33) * sizeof(T) +
                      (2 * (size_t)WP + W) * sizeof(int);
  decode_scan_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      am, feat_len, state_table, last_pos, word_len, tdp_within, entry_pen,
      exit_pen, hyp_in, bkp_in, book_in, hyp_out, bkp_out, book_out, score,
      word, bkp, B, Tn, S, W, P, t0, am_threshold, prune);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sr_decode_scan(
    const float* am, const int* feat_len, const int* state_table,
    const int* last_pos, const int* word_len, const float* tdp_within,
    const float* entry_pen, const float* exit_pen, const float* hyp_in,
    const int* bkp_in, const float* book_in, float* hyp_out, int* bkp_out,
    float* book_out, float* score, int* word, int* bkp, int B, int T, int S,
    int W, int P, int t0, float am_threshold, int prune, int device,
    void* stream) {
  return launch<float>(am, feat_len, state_table, last_pos, word_len,
                       tdp_within, entry_pen, exit_pen, hyp_in, bkp_in,
                       book_in, hyp_out, bkp_out, book_out, score, word, bkp,
                       B, T, S, W, P, t0, am_threshold, prune, device, stream);
}

extern "C" int sr_decode_scan_f64(
    const double* am, const int* feat_len, const int* state_table,
    const int* last_pos, const int* word_len, const double* tdp_within,
    const double* entry_pen, const double* exit_pen, const double* hyp_in,
    const int* bkp_in, const double* book_in, double* hyp_out, int* bkp_out,
    double* book_out, double* score, int* word, int* bkp, int B, int T, int S,
    int W, int P, int t0, double am_threshold, int prune, int device,
    void* stream) {
  return launch<double>(am, feat_len, state_table, last_pos, word_len,
                        tdp_within, entry_pen, exit_pen, hyp_in, bkp_in,
                        book_in, hyp_out, bkp_out, book_out, score, word, bkp,
                        B, T, S, W, P, t0, am_threshold, prune, device, stream);
}
