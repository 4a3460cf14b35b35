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
//     acoustic score of the ENTERED position's state; entries win ties (<=);
//   * invalid slots and min(new, BIG); the utterance's minimum; renormalize
//     with the >= BIG/2 guards; prune new > am_threshold;
//   * word ends at last_pos (+ exit_pen when given), argmin over words with
//     the first index winning ties;
//   * the utterance freezes once t > feat_len (outputs are still written).
// Every operation is an add, compare or select in the score type and
// BIG = 1e30 is a finite sentinel, so the kernel matches its plain PyTorch
// version bit for bit in both types. The minimum is exact in any order, so
// a shuffle reduction keeps that property; the word argmin is the first
// index at the minimum.
//
// Two instances, chosen in the C entry from the lattice's shape alone
// (sr_decode_scan_instance):
//   * W*P <= 1024 (SieTill: 12 x 24 = 288 slots): one persistent block per
//     utterance, one thread per (word, position) slot. The frame loop runs
//     inside the kernel; each thread keeps its own slot's score and
//     backpointer in registers and publishes them to shared memory
//     (double-buffered) so its right-hand neighbours can read them; the
//     word argmin is a serial first-index scan by thread 0.
//     What bounds it: latency. A frame is three __syncthreads, one
//     scattered read of am per thread on the chain and thread 0's scan of
//     the W word ends; the arithmetic is a few dozen instructions. At 288
//     threads an SM holds 7 float32 blocks (2,048 threads) and 5 float64
//     ones (40 registers a thread), sr_decode_scan_residency's answer on
//     the card, so the full-width batch of 1,024 utterances takes two
//     waves (924, then 100 utterances in float32; 660, then 364 in
//     float64), not one.
//   * W*P > 1024: one block of 1024 threads per utterance, each looping over
//     ceil(W*P/1024) slots; the lattice double-buffered by frame parity in
//     device scratch that the wrapper allocates (a block's global writes
//     are visible to the block after __syncthreads); the word end by a
//     block reduction of (score, word) pairs. Simple, not tuned.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_SLOTS = 1024;      // the block instance's largest lattice
constexpr int SCRATCH_THREADS = 1024;  // threads per utterance of the scratch instance

template <typename T>
__device__ __forceinline__ T tmin(T a, T b);
template <>
__device__ __forceinline__ float tmin<float>(float a, float b) { return fminf(a, b); }
template <>
__device__ __forceinline__ double tmin<double>(double a, double b) { return fmin(a, b); }

// within-word candidates from s, s-1 and s-2, the selection, the emission
// and the entry of one slot, then the validity guard and the cap at BIG:
// the new score, and its backpointer in nb (h1, b1 count only where p >= 1,
// h2, b2 only where p >= 2)
template <typename T>
__device__ __forceinline__ T slot_step(T h, int bk, T h1, int b1, T h2, int b2, T tw0, T tw1,
                                       T tw2, T am_v, T entry, int p, bool valid, int t,
                                       int& nb) {
  const T BIG = T(1e30);
  const T c0 = h + tw0;
  const T c1 = p >= 1 ? h1 + tw1 : BIG;
  const T c2 = p >= 2 ? h2 + tw2 : BIG;
  T within = c2;
  int wb = p >= 2 ? b2 : 0;
  if (c1 < within) { within = c1; wb = p >= 1 ? b1 : 0; }
  if (c0 < within) { within = c0; wb = bk; }
  within = within + am_v;
  T nv;
  if (entry <= within) {
    nv = entry;
    nb = t - 1;
  } else {
    nv = within;
    nb = wb;
  }
  if (!valid) nv = BIG;
  return tmin(nv, BIG);
}

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
      const int q1 = buf * WP + idx - 1, q2 = q1 - 1;
      const T h1 = p >= 1 ? sh_h[q1] : BIG;
      const T h2 = p >= 2 ? sh_h[q2] : BIG;
      const int b1 = p >= 1 ? sh_b[q1] : 0;
      const int b2 = p >= 2 ? sh_b[q2] : 0;
      const T entry = p < 2 ? (book_prev + ep) + am_v : BIG;
      nv = slot_step(h, bk, h1, b1, h2, b2, tw0, tw1, tw2, am_v, entry, p, valid, t, nb);
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

// a word-end candidate: its score (exit penalty added), word and backpointer
template <typename T>
struct End {
  T v;
  int w, bk;
};

// (score, word) lexicographic: the smaller score, the smaller word on ties
template <typename T>
__device__ __forceinline__ bool end_less(const End<T>& a, const End<T>& b) {
  return a.v < b.v || (a.v == b.v && a.w < b.w);
}

// one block of SCRATCH_THREADS per utterance, thread x owning the slots
// x + k*blockDim.x; the lattice double-buffered in lat_h / lat_b [B][2][W*P]
// (not restrict: the threads read one another's writes after __syncthreads)
template <typename T>
__global__ void __launch_bounds__(SCRATCH_THREADS) decode_scan_scratch_kernel(
    const T* __restrict__ am, const int* __restrict__ feat_len,
    const int* __restrict__ state_table, const int* __restrict__ last_pos,
    const int* __restrict__ word_len, const T* __restrict__ tdp_within,
    const T* __restrict__ entry_pen, const T* __restrict__ exit_pen,
    const T* __restrict__ hyp_in, const int* __restrict__ bkp_in,
    const T* __restrict__ book_in, T* __restrict__ hyp_out,
    int* __restrict__ bkp_out, T* __restrict__ book_out,
    T* __restrict__ score, int* __restrict__ word, int* __restrict__ bkp,
    T* lat_h, int* lat_b, int B, int Tn, int S, int W, int P, int t0, T am_threshold,
    int prune) {
  __shared__ T s_wmin[SCRATCH_THREADS / 32];
  __shared__ End<T> s_wend[SCRATCH_THREADS / 32];
  const T BIG = T(1e30);
  const T half_big = BIG * T(0.5);
  const int b = blockIdx.x;
  const int nwarps = blockDim.x / 32;
  const int WP = W * P;
  const size_t off = (size_t)b * WP;
  const size_t lat0 = 2 * off;
  for (int s = threadIdx.x; s < WP; s += blockDim.x) {
    lat_h[lat0 + s] = hyp_in[off + s];
    lat_b[lat0 + s] = bkp_in[off + s];
  }
  T book = book_in[b];
  const int len = feat_len[b];
  __syncthreads();

  int buf = 0;
  for (int i = 0; i < Tn; ++i) {
    const int t = t0 + i + 1;  // 1-based frame index
    const T* ch = lat_h + lat0 + (size_t)buf * WP;
    const int* cb = lat_b + lat0 + (size_t)buf * WP;
    T* nh = lat_h + lat0 + (size_t)(buf ^ 1) * WP;
    int* nbk = lat_b + lat0 + (size_t)(buf ^ 1) * WP;
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
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = tmin(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) s_wmin[threadIdx.x >> 5] = m;
    __syncthreads();  // the per-warp minima are visible
    T best = s_wmin[0];
    for (int k = 1; k < nwarps; ++k) best = tmin(best, s_wmin[k]);
    if (best >= half_big) best = T(0);

    // (b) each thread's own slots: renormalise, prune, offer the word ends
    const bool alive = t <= len;
    End<T> e{T(__int_as_float(0x7f800000)), 0x7fffffff, 0};  // loses to every end
    for (int s = threadIdx.x; s < WP; s += blockDim.x) {
      const int w = s / P;
      T nv = nh[s] >= half_big ? BIG : nh[s] - best;
      if (prune && nv > am_threshold) nv = BIG;
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
      const End<T> other{__shfl_xor_sync(0xffffffffu, e.v, o),
                         __shfl_xor_sync(0xffffffffu, e.w, o),
                         __shfl_xor_sync(0xffffffffu, e.bk, o)};
      if (end_less(other, e)) e = other;
    }
    if ((threadIdx.x & 31) == 0) s_wend[threadIdx.x >> 5] = e;
    __syncthreads();  // the word ends and the new lattice are visible
    End<T> be = s_wend[0];
    for (int k = 1; k < nwarps; ++k)
      if (end_less(s_wend[k], be)) be = s_wend[k];
    const T bs = be.v >= half_big ? BIG : be.v;
    if (threadIdx.x == 0) {
      score[(size_t)i * B + b] = bs;
      word[(size_t)i * B + b] = be.w;
      bkp[(size_t)i * B + b] = be.bk;
    }
    if (alive) book = bs;
    buf ^= 1;
  }

  for (int s = threadIdx.x; s < WP; s += blockDim.x) {
    hyp_out[off + s] = lat_h[lat0 + (size_t)buf * WP + s];
    bkp_out[off + s] = lat_b[lat0 + (size_t)buf * WP + s];
  }
  if (threadIdx.x == 0) book_out[b] = book;
}

// 0 for the block instance (one thread a slot), -1 for the scratch instance
int instance_for(int W, int P) { return W * P <= BLOCK_SLOTS ? 0 : -1; }

template <typename T>
size_t block_smem(int W, int P) {
  const size_t WP = (size_t)W * P;
  return (2 * WP + W + 33) * sizeof(T) + (2 * WP + W) * sizeof(int);
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
  const int WP = W * P;
  const cudaStream_t st = (cudaStream_t)stream;
  if (instance_for(W, P) == 0) {
    decode_scan_kernel<T><<<B, (WP + 31) / 32 * 32, block_smem<T>(W, P), st>>>(
        am, feat_len, state_table, last_pos, word_len, tdp_within, entry_pen,
        exit_pen, hyp_in, bkp_in, book_in, hyp_out, bkp_out, book_out, score,
        word, bkp, B, Tn, S, W, P, t0, am_threshold, prune);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    T* lat_h = static_cast<T*>(scratch);
    decode_scan_scratch_kernel<T><<<B, SCRATCH_THREADS, 0, st>>>(
        am, feat_len, state_table, last_pos, word_len, tdp_within, entry_pen,
        exit_pen, hyp_in, bkp_in, book_in, hyp_out, bkp_out, book_out, score,
        word, bkp, lat_h, reinterpret_cast<int*>(lat_h + 2 * (size_t)B * WP), B, Tn, S, W, P,
        t0, am_threshold, prune);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int residency(int W, int P) {
  int n = 0;
  const cudaError_t err =
      instance_for(W, P) == 0
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_kernel<T>,
                                                          (W * P + 31) / 32 * 32,
                                                          block_smem<T>(W, P))
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_scan_scratch_kernel<T>,
                                                          SCRATCH_THREADS, 0);
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

// the instance both entries launch for a W x P lattice: 0 for the block
// instance, -1 for the scratch instance (which needs scratch of 2*B*W*P
// scores and 2*B*W*P ints)
extern "C" int sr_decode_scan_instance(int W, int P) { return instance_for(W, P); }

// blocks of that instance one SM holds at once (the occupancy calculator's
// answer for the launch the float32 entry, or with f64 != 0 the float64
// entry, makes), or -1
extern "C" int sr_decode_scan_residency(int W, int P, int f64) {
  return f64 ? residency<double>(W, P) : residency<float>(W, P);
}
