// Kernel G: final position, backward walk and position -> state gather of the
// forced alignment.
//
// Replaces three functions of speechrecognition_tpu/align/viterbi.py, which
// XLA runs as three programs per batch (the walk as one lax.scan per chunk):
//   * _final_pos_dev: with pruning the highest position whose final cost is
//     finite (hi < BIG/2 as float32; position 0 when none is), else the
//     automaton's last position aut_len - 1;
//   * _align_bwd_chunk, over every chunk at once: walking global frames
//     t = Tp-1 .. 0, the frame emits the current position; then the position
//     stays at t == 0, steps back by jumps[t][cur] while t <= feat_len - 1,
//     and resets to the final position past the utterance's end;
//   * _states_from_positions: each emitted position's state (int32 here; the
//     reference narrowed it to int16 for a host transfer).
// A position below 0 counts from the row's end once, as the reference's
// take_along_axis does, and is clamped to the row beyond that (only a path
// through an unreachable forced final position gets there).
// Inputs: final_hi [B, A] float32, aut_len [B], jumps [Tp, B, A] int8,
// feat_len [B], states_tbl [B, A]; outputs states [B, T] (frames t < T),
// final_pos [B].
//
// Design: one thread per utterance walks its whole path; blocks of 128
// utterances. What bounds it: the dependent chain of Tp one-byte reads
// (each read's address needs the previous one), about one global-memory
// latency per frame; the trainer's batches of 256 give 256 chains in
// flight.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void align_backtrack_kernel(const float* __restrict__ final_hi,
                                       const int* __restrict__ aut_len,
                                       const signed char* __restrict__ jumps,
                                       const int* __restrict__ feat_len,
                                       const int* __restrict__ states_tbl,
                                       int* __restrict__ states, int* __restrict__ final_pos,
                                       int B, int A, int Tp, int T, int tie_pruned) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* fin = final_hi + (size_t)b * A;
  int fp;
  if (tie_pruned) {
    fp = -1;
    for (int a = 0; a < A; ++a)
      if (fin[a] < 5e29f) fp = a;  // float32(BIG * 0.5)
    fp = max(fp, 0);
  } else {
    fp = aut_len[b] - 1;
  }
  final_pos[b] = fp;
  const int len = feat_len[b];
  const int* tbl = states_tbl + (size_t)b * A;
  int cur = fp;
  for (int t = Tp - 1; t >= 0; --t) {
    int idx = cur < 0 ? cur + A : cur;
    idx = min(max(idx, 0), A - 1);
    if (t < T) states[(size_t)b * T + t] = tbl[idx];
    if (t == 0) break;
    cur = t <= len - 1 ? cur - jumps[((size_t)t * B + b) * A + idx] : fp;
  }
}

}  // namespace

extern "C" int sr_align_backtrack(const float* final_hi, const int* aut_len,
                                  const signed char* jumps, const int* feat_len,
                                  const int* states_tbl, int* states, int* final_pos, int B,
                                  int A, int Tp, int T, int tie_pruned, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || A == 0) return (int)cudaSuccess;
  align_backtrack_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      final_hi, aut_len, jumps, feat_len, states_tbl, states, final_pos, B, A, Tp, T,
      tie_pruned);
  return (int)cudaGetLastError();
}
