// Kernel C: double-float GMM state scores, max-approximation.
//
// Replaces speechrecognition_tpu/models/gmm.py::_density_scores_df and
// ::_am_chunk_df, the double-float scorer of the production (df32) decode
// that XLA fuses into one program per 4096-frame chunk. For every frame n
// and mixture s it computes, in the reference's operation order
// (Mixtures.cpp:590-628 accumulates in double; here (hi, lo) float32 pairs,
// df.cuh):
//
//   for each density j = s*D + d:
//     acc = 0;  for i = 0 .. dim-1:
//       diff = add_f(neg(mu[j,i]), x[n,i]);  acc = add(acc, mul(mul(diff, diff), iv[j,i]))
//     score_j = add(add(norm[j], acc * 0.5), neg(logw[j]))
//   out[n, s] = minimum(min_d score_j, MIN_SCORE_INIT)
//
// The min over the D densities is exact in any order (a selection, with a
// lexicographic compare on (hi, lo)), and the cap wins ties because
// minimum(m, cap) = less(m, cap) ? m : cap. Inactive density slots carry
// norm = INACTIVE_SCORE and mu = iv = logw = 0, and take part exactly as in
// the reference. Inputs: x [N, dim] f32; mu, iv [J, dim] and norm, logw [J]
// as separate hi and lo float32 arrays, J = S*D. Output: out_hi, out_lo
// [N, S]. The [N, S*D] density scores never reach device memory.
//
// What bounds it: FP32 instruction issue. One density and dimension costs 48
// FP32 instructions (add_f 10, two mul 9 each with the FMA product of df.cuh,
// add 20), 2 of them FMAs, so about 50 operations; N = 32768 frames x
// J = 1696 densities x dim = 25 is 1.39e9 such elements, 6.9e10 FP32
// operations. The card issues 128 FP32 instructions per SM and clock, and
// df32 arithmetic is almost all adds, so the issue rate, not the FMA peak, is
// the limit: about 2.0 ms at 48 instructions per element, against a roofline
// bound of about 1.04 ms (67 TFLOP/s, an FMA counted as two). The inputs and
// the 28 MB output are small next to that.
//
// Design: a block owns TILE_S = 2 mixtures (S = 106 on SieTill, so no
// mixture slot is idle) and TX * F frames; the TX threads of a mixture are
// whole warps, so every table read is a broadcast. The mixture's table rows
// are staged in shared memory as interleaved float2 pairs. For dim = 25, the
// SieTill dim, each thread keeps its F = 2 frames' features in registers
// (loaded once, the feature loop fully unrolled) and scores them against the
// same table element, so one 64-bit shared-memory load of the (hi, lo) pair
// of mu and one of iv serve two independent dependency chains. Any other dim
// takes the generic instance: one frame a thread, the block's frames staged
// in shared memory, as large a dim as the block's shared memory holds.
// Frames lie along grid.x, mixtures along grid.y.

#include <cuda_runtime.h>

#include "df.cuh"

namespace {

constexpr int TX = 128;      // threads along frames (4 warps per mixture)
constexpr int TILE_S = 2;    // mixtures per block (threadIdx.y)
constexpr int THREADS = TX * TILE_S;
constexpr float MIN_SCORE_INIT = 1e10f;  // Mixtures.cpp:699, exact in float32

// DIM: the feature dimension, or 0 for any (read from dim_arg); F: frames
// per thread
template <int DIM, int F>
__global__ void __launch_bounds__(THREADS, 2)
am_scores_df_kernel(const float* __restrict__ x,
                    const float* __restrict__ mu_hi, const float* __restrict__ mu_lo,
                    const float* __restrict__ iv_hi, const float* __restrict__ iv_lo,
                    const float* __restrict__ norm_hi, const float* __restrict__ norm_lo,
                    const float* __restrict__ logw_hi, const float* __restrict__ logw_lo,
                    float* __restrict__ out_hi, float* __restrict__ out_lo,
                    int N, int S, int D, int dim_arg) {
  const int dim = DIM > 0 ? DIM : dim_arg;
  extern __shared__ float2 smem2[];
  const int rows = TILE_S * D;            // table rows staged by this block
  float2* s_mu = smem2;                   // [rows][dim] (hi, lo)
  float2* s_iv = s_mu + rows * dim;       // [rows][dim]
  float2* s_norm = s_iv + rows * dim;     // [rows]
  float2* s_logw = s_norm + rows;         // [rows]
  float* s_x = reinterpret_cast<float*>(s_logw + rows);  // [TX * F][dim], DIM == 0 only

  const int s0 = blockIdx.y * TILE_S;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int j0 = s0 * D;
  const int jend = min(S * D, j0 + rows);  // rows past the last mixture stay unread
  for (int e = tid; e < rows * dim; e += THREADS) {
    if (j0 + e / dim < jend) {
      const size_t g = (size_t)j0 * dim + e;
      s_mu[e] = make_float2(mu_hi[g], mu_lo[g]);
      s_iv[e] = make_float2(iv_hi[g], iv_lo[g]);
    }
  }
  for (int r = tid; r < rows; r += THREADS) {
    if (j0 + r < jend) {
      s_norm[r] = make_float2(norm_hi[j0 + r], norm_lo[j0 + r]);
      s_logw[r] = make_float2(logw_hi[j0 + r], logw_lo[j0 + r]);
    }
  }

  // this thread's frames n0 + threadIdx.x + f*TX; frames past N score frame
  // N-1 and are not written
  const int nb = blockIdx.x * (TX * F);
  const int n0 = nb + threadIdx.x;
  float xr[F][DIM > 0 ? DIM : 1];
  if (DIM > 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float* xp = x + (size_t)min(n0 + f * TX, N - 1) * dim;
#pragma unroll
      for (int i = 0; i < (DIM > 0 ? DIM : 1); ++i) xr[f][i] = __ldg(xp + i);
    }
  } else {
    for (int e = tid; e < TX * F * dim; e += THREADS)
      s_x[e] = x[(size_t)min(nb + e / dim, N - 1) * dim + e % dim];
  }
  __syncthreads();

  const int s = s0 + threadIdx.y;
  if (s >= S) return;

  df::DF best[F];
  for (int d = 0; d < D; ++d) {
    const int r = threadIdx.y * D + d;
    const float2* mu = s_mu + r * dim;
    const float2* iv = s_iv + r * dim;
    df::DF acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = df::make(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < dim; ++i) {
      const float2 m = mu[i];
      const df::DF v = df::make(iv[i].x, iv[i].y);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float xv = DIM > 0 ? xr[f][DIM > 0 ? i : 0]
                                 : s_x[(threadIdx.x + f * TX) * dim + i];
        const df::DF diff = df::add_f(df::neg(df::make(m.x, m.y)), xv);
        acc[f] = df::add(acc[f], df::mul(df::mul(diff, diff), v));
      }
    }
    const float2 nr = s_norm[r];
    const float2 lw = s_logw[r];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const df::DF half = df::make(__fmul_rn(acc[f].hi, 0.5f), __fmul_rn(acc[f].lo, 0.5f));
      df::DF score = df::add(df::make(nr.x, nr.y), half);
      score = df::add(score, df::neg(df::make(lw.x, lw.y)));
      best[f] = d == 0 ? score : df::minimum(best[f], score);
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int n = n0 + f * TX;
    if (n < N) {
      const df::DF m = df::minimum(best[f], df::make(MIN_SCORE_INIT, 0.f));
      out_hi[(size_t)n * S + s] = m.hi;
      out_lo[(size_t)n * S + s] = m.lo;
    }
  }
}

template <int DIM, int F>
cudaError_t launch(const float* x, const float* mu_hi, const float* mu_lo, const float* iv_hi,
                   const float* iv_lo, const float* norm_hi, const float* norm_lo,
                   const float* logw_hi, const float* logw_lo, float* out_hi, float* out_lo,
                   int N, int S, int D, int dim, cudaStream_t stream) {
  const size_t rows = (size_t)TILE_S * D;
  const size_t smem = (2 * rows * dim + 2 * rows) * sizeof(float2) +
                      (DIM > 0 ? 0 : (size_t)TX * F * dim * sizeof(float));
  // above 48 KB only after opting in; beyond the 227 KB a block may use
  // (D = 16 densities of dim = 25 take 13 KB) the attribute call fails and
  // the wrapper raises
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(am_scores_df_kernel<DIM, F>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + TX * F - 1) / (TX * F), (S + TILE_S - 1) / TILE_S);
  const dim3 block(TX, TILE_S);
  am_scores_df_kernel<DIM, F><<<grid, block, smem, stream>>>(
      x, mu_hi, mu_lo, iv_hi, iv_lo, norm_hi, norm_lo, logw_hi, logw_lo, out_hi, out_lo, N, S,
      D, dim);
  return cudaGetLastError();
}

}  // namespace

// dim = 25, every SieTill model's, has its own instance with the features
// in registers; any other dim takes the generic one
extern "C" int sr_am_scores_df(const float* x, const float* mu_hi,
                               const float* mu_lo, const float* iv_hi,
                               const float* iv_lo, const float* norm_hi,
                               const float* norm_lo, const float* logw_hi,
                               const float* logw_lo, float* out_hi,
                               float* out_lo, int N, int S, int D, int dim,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || S == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
#define SR_LAUNCH(DIM, F)                                                                     \
  launch<DIM, F>(x, mu_hi, mu_lo, iv_hi, iv_lo, norm_hi, norm_lo, logw_hi, logw_lo, out_hi,  \
                 out_lo, N, S, D, dim, st)
  const cudaError_t launched = dim == 25 ? SR_LAUNCH(25, 2) : SR_LAUNCH(0, 1);
#undef SR_LAUNCH
  return (int)launched;
}
