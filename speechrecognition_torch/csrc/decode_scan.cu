// Kernel B: time-synchronous word-loop Viterbi over one time chunk.
//
// Replaces speechrecognition_tpu/search/decoder.py::_decode_scan, the f32
// word-loop recursion that XLA fuses into one lax.scan (written op by op in
// PyTorch it costs about 30 launches per frame). Same inputs and outputs:
// am [B, T, S] f32, feat_len [B], the lexicon / TDP tables, the carried
// lattice (hyp [B, W, P] f32, bkp [B, W, P] i32, book [B] f32) and t0; it
// writes the carry after the chunk and, per frame, the best word end
// (score, word, backpointer), each [T, B].
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
// Every operation is an f32 add, compare or select and BIG = 1e30 is a
// finite sentinel, so the kernel matches its plain PyTorch version bit for
// bit. The minimum is exact in any order, so the warp-shuffle reduction
// keeps that property; the word argmin is a serial first-index scan.
//
// What bounds it: latency. A frame is three __syncthreads plus one scattered
// 4-byte read of am per thread; the arithmetic is a few dozen instructions.
// A block occupies one SM slot for the whole chunk, so the card is filled by
// many utterances at once: a batch of 1024 utterance blocks (7 per SM at 288
// threads) is what keeps all 132 SMs busy.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;

__global__ void decode_scan_kernel(
    const float* __restrict__ am, const int* __restrict__ feat_len,
    const int* __restrict__ state_table, const int* __restrict__ last_pos,
    const int* __restrict__ word_len, const float* __restrict__ tdp_within,
    const float* __restrict__ entry_pen, const float* __restrict__ exit_pen,
    const float* __restrict__ hyp_in, const int* __restrict__ bkp_in,
    const float* __restrict__ book_in, float* __restrict__ hyp_out,
    int* __restrict__ bkp_out, float* __restrict__ book_out,
    float* __restrict__ score, int* __restrict__ word, int* __restrict__ bkp,
    int B, int T, int S, int W, int P, int t0, float am_threshold,
    int prune) {
  const int WP = W * P;
  const int nwarps = blockDim.x / 32;
  extern __shared__ float smem[];
  float* sh_h = smem;                                 // [2][WP]
  int* sh_b = reinterpret_cast<int*>(sh_h + 2 * WP);  // [2][WP]
  float* s_end = reinterpret_cast<float*>(sh_b + 2 * WP);  // [W]
  int* s_endb = reinterpret_cast<int*>(s_end + W);    // [W]
  float* s_wmin = reinterpret_cast<float*>(s_endb + W);    // [32]
  float* s_book = s_wmin + 32;                        // [1]

  const int b = blockIdx.x;
  const int idx = threadIdx.x;
  const bool slot = idx < WP;
  const int w = slot ? idx / P : 0;
  const int p = slot ? idx - w * P : 0;

  // per-slot constants
  int st = 0;
  float tw0 = BIG, tw1 = BIG, tw2 = BIG, ep = BIG, xp = 0.f;
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

  float h = slot ? hyp_in[(size_t)b * WP + idx] : BIG;
  int bk = slot ? bkp_in[(size_t)b * WP + idx] : 0;
  if (idx == 0) *s_book = book_in[b];
  const int len = feat_len[b];
  const float half_big = BIG * 0.5f;
  const float* am_b = am + (size_t)b * T * S;

  int buf = 0;
  for (int i = 0; i < T; ++i) {
    const int t = t0 + i + 1;  // 1-based frame index
    if (slot) {
      sh_h[buf * WP + idx] = h;
      sh_b[buf * WP + idx] = bk;
    }
    __syncthreads();  // (1) hyp of frame t-1 and book_prev are visible
    const float book_prev = *s_book;

    float nv = BIG;
    int nb = 0;
    if (slot) {
      const float am_v = am_b[(size_t)i * S + st];
      const float c0 = h + tw0;
      const float c1 = p >= 1 ? sh_h[buf * WP + idx - 1] + tw1 : BIG;
      const float c2 = p >= 2 ? sh_h[buf * WP + idx - 2] + tw2 : BIG;
      const int b0 = p >= 1 ? sh_b[buf * WP + idx - 1] : 0;
      const int b00 = p >= 2 ? sh_b[buf * WP + idx - 2] : 0;
      float within = c2;
      int wb = b00;
      if (c1 < within) { within = c1; wb = b0; }
      if (c0 < within) { within = c0; wb = bk; }
      within = within + am_v;
      const float entry = p < 2 ? (book_prev + ep) + am_v : BIG;
      if (entry <= within) {
        nv = entry;
        nb = t - 1;
      } else {
        nv = within;
        nb = wb;
      }
      if (!valid) nv = BIG;
      nv = fminf(nv, BIG);
    }

    // block-wide minimum (exact in any order)
    float m = nv;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((idx & 31) == 0) s_wmin[idx >> 5] = m;
    __syncthreads();  // (2) per-warp minima are visible
    float best = s_wmin[0];
    for (int k = 1; k < nwarps; ++k) best = fminf(best, s_wmin[k]);
    if (best >= half_big) best = 0.f;
    nv = nv >= half_big ? BIG : nv - best;
    if (prune && nv > am_threshold) nv = BIG;

    if (slot && is_end) {
      s_end[w] = exit_pen != nullptr ? nv + xp : nv;
      s_endb[w] = nb;
    }
    __syncthreads();  // (3) word-end scores are visible

    const bool alive = t <= len;
    if (idx == 0) {
      float bs = s_end[0];
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

}  // namespace

extern "C" int sr_decode_scan(
    const float* am, const int* feat_len, const int* state_table,
    const int* last_pos, const int* word_len, const float* tdp_within,
    const float* entry_pen, const float* exit_pen, const float* hyp_in,
    const int* bkp_in, const float* book_in, float* hyp_out, int* bkp_out,
    float* book_out, float* score, int* word, int* bkp, int B, int T, int S,
    int W, int P, int t0, float am_threshold, int prune, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaSuccess;
  const int WP = W * P;
  const int threads = (WP + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)WP * (sizeof(float) + sizeof(int)) +
                      (size_t)W * (sizeof(float) + sizeof(int)) +
                      33 * sizeof(float);
  decode_scan_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      am, feat_len, state_table, last_pos, word_len, tdp_within, entry_pen,
      exit_pen, hyp_in, bkp_in, book_in, hyp_out, bkp_out, book_out, score,
      word, bkp, B, T, S, W, P, t0, am_threshold, prune);
  return (int)cudaGetLastError();
}
