// Kernel E: one time chunk of the 0-1-2 forced-alignment Viterbi DP.
//
// Replaces speechrecognition_tpu/align/viterbi.py::_align_fwd_chunk, the
// banded DP that XLA fuses into one lax.scan (written op by op in PyTorch it
// costs about 25 launches per frame). Same inputs and outputs: the cost row
// entering the chunk prev [B, A], emission scores ams [B, C, A], the TDP
// table tdp [B, A, 3] (penalty into position a by jump j), pos_valid [B, A]
// (uint8), feat_len [B] and the chunk's first global frame t0; it writes the
// cost row after the chunk out [B, A] and the jump taken into every position
// at every frame, jumps [C, B, A] int8. A template on the score type: float
// for the f32 trainer, double for the f64 one (Hopper has native float64).
// BIG, its >= BIG/2 guards and the threshold are in the score type, as the
// reference casts them.
//
// Per frame t = t0 + i, exactly the reference's step:
//   * candidates c0 = prev[a] + tdp[a,0], c1 = prev[a-1] + tdp[a,1],
//     c2 = prev[a-2] + tdp[a,2] (BIG where a-j < 0); with pruning start from
//     c2 and take c1, then c0, only if strictly less (the largest jump wins
//     ties); without, start from c0 and take c1, then c2, if strictly less;
//   * cost = valid ? best + am : BIG, then min(cost, BIG);
//   * the row minimum (exact in any order); renormalise with the >= BIG/2
//     guards; prune cost > thr when pruning;
//   * at t == 0 only position 0 is initialised (am), with no renormalisation
//     or pruning; rows with t >= feat_len keep their carry. The jump is
//     written at every frame, as the reference does.
// Every operation is an add, compare or select in the score type, so the
// kernel matches its plain PyTorch version bit for bit.
//
// Design: one block per utterance, one thread per position (A <= 1024; the
// SieTill demo automata have 20-70), the frame loop inside the kernel. Each
// thread keeps its cost in a register and publishes it to shared memory
// (double-buffered) for its right-hand neighbours; the row minimum is a warp
// shuffle plus one shared slot per warp.
//
// What bounds it: latency. A frame is two __syncthreads and one read of am
// per thread; the arithmetic is a dozen instructions. A block holds one SM
// slot for the whole chunk, so the card is filled by many utterances at once
// (the trainer's batches of 256).

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T tmin(T a, T b);
template <>
__device__ __forceinline__ float tmin<float>(float a, float b) { return fminf(a, b); }
template <>
__device__ __forceinline__ double tmin<double>(double a, double b) { return fmin(a, b); }

template <typename T>
__global__ void align_fwd_kernel(const T* __restrict__ prev, const T* __restrict__ ams,
                                 const T* __restrict__ tdp,
                                 const unsigned char* __restrict__ pos_valid,
                                 const int* __restrict__ feat_len, T* __restrict__ out,
                                 signed char* __restrict__ jumps, int B, int C, int A,
                                 int t0, T thr, int tie_pruned, int use_pruning) {
  const T BIG = T(1e30);
  const T half_big = BIG * T(0.5);
  extern __shared__ __align__(8) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);  // [2][A]
  T* s_wmin = sh + 2 * A;                  // [32]

  const int b = blockIdx.x;
  const int a = threadIdx.x;
  const int nwarps = blockDim.x / 32;
  const bool pos = a < A;
  const size_t row = (size_t)b * A + a;

  bool valid = false;
  T tw0 = T(0), tw1 = T(0), tw2 = T(0);
  T h = BIG;
  if (pos) {
    valid = pos_valid[row] != 0;
    tw0 = tdp[row * 3 + 0];
    tw1 = tdp[row * 3 + 1];
    tw2 = tdp[row * 3 + 2];
    h = prev[row];
  }
  const int len = feat_len[b];
  const T* am_b = ams + (size_t)b * C * A;

  int buf = 0;
  for (int i = 0; i < C; ++i) {
    const int t = t0 + i;
    if (pos) sh[buf * A + a] = h;
    __syncthreads();  // (1) the previous frame's row is visible

    T cost = BIG;
    T am = T(0);
    if (pos) {
      am = am_b[(size_t)i * A + a];
      const T c0 = h + tw0;
      const T c1 = a >= 1 ? sh[buf * A + a - 1] + tw1 : BIG;
      const T c2 = a >= 2 ? sh[buf * A + a - 2] + tw2 : BIG;
      T best;
      signed char jump;
      if (tie_pruned) {
        best = c2;
        jump = 2;
        if (c1 < best) { best = c1; jump = 1; }
        if (c0 < best) { best = c0; jump = 0; }
      } else {
        best = c0;
        jump = 0;
        if (c1 < best) { best = c1; jump = 1; }
        if (c2 < best) { best = c2; jump = 2; }
      }
      cost = valid ? best + am : BIG;
      cost = tmin(cost, BIG);
      jumps[((size_t)i * B + b) * A + a] = jump;
    }

    // row minimum (exact in any order); idle threads hold BIG, which every
    // real row minimum already is or undercuts
    T m = cost;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = tmin(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((a & 31) == 0) s_wmin[a >> 5] = m;
    __syncthreads();  // (2) per-warp minima are visible
    T row_best = s_wmin[0];
    for (int k = 1; k < nwarps; ++k) row_best = tmin(row_best, s_wmin[k]);
    if (row_best >= half_big) row_best = T(0);
    cost = cost >= half_big ? BIG : cost - row_best;
    if (use_pruning && cost > thr) cost = BIG;
    if (t == 0) cost = (a == 0 && valid) ? am : BIG;
    if (t < len) h = cost;
    buf ^= 1;
  }
  if (pos) out[row] = h;
}

template <typename T>
int launch(const T* prev, const T* ams, const T* tdp, const unsigned char* pos_valid,
           const int* feat_len, T* out, signed char* jumps, int B, int C, int A, int t0,
           T thr, int tie_pruned, int use_pruning, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || A == 0) return (int)cudaSuccess;
  const int threads = (A + 31) / 32 * 32;
  const size_t smem = (2 * (size_t)A + 32) * sizeof(T);
  align_fwd_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(
      prev, ams, tdp, pos_valid, feat_len, out, jumps, B, C, A, t0, thr, tie_pruned,
      use_pruning);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sr_align_fwd(const float* prev, const float* ams, const float* tdp,
                            const unsigned char* pos_valid, const int* feat_len, float* out,
                            signed char* jumps, int B, int C, int A, int t0, float thr,
                            int tie_pruned, int use_pruning, int device, void* stream) {
  return launch<float>(prev, ams, tdp, pos_valid, feat_len, out, jumps, B, C, A, t0, thr,
                       tie_pruned, use_pruning, device, stream);
}

extern "C" int sr_align_fwd_f64(const double* prev, const double* ams, const double* tdp,
                                const unsigned char* pos_valid, const int* feat_len,
                                double* out, signed char* jumps, int B, int C, int A, int t0,
                                double thr, int tie_pruned, int use_pruning, int device,
                                void* stream) {
  return launch<double>(prev, ams, tdp, pos_valid, feat_len, out, jumps, B, C, A, t0, thr,
                        tie_pruned, use_pruning, device, stream);
}
