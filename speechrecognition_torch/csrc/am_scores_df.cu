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
// What bounds it: FP32 instruction throughput. One density and dimension costs
// about 76 non-fused FP32 instructions (split, two_prod and the
// renormalisations of the error-free transforms), so N = 32768 frames x
// J = 1696 densities x dim = 25 is about 1.1e11 instructions; the inputs
// and the 28 MB output are small next to that.
//
// Design: a block owns 64 frames x 4 mixtures (256 threads); one thread owns
// one (frame, mixture) pair and loops over its mixture's densities. The
// block stages the 4*D table rows (mu and iv hi/lo, [dim] each) and the 64
// frames of x in shared memory. The 32 threads of a warp share one mixture,
// so every table read is a broadcast; x rows are read with stride dim, which
// for odd dim hits 32 distinct banks. Frames lie along grid.x (up to 2^31-1
// blocks), mixtures along grid.y.

#include <cuda_runtime.h>

#include "df.cuh"

namespace {

constexpr int TILE_N = 64;   // frames per block (threadIdx.x)
constexpr int TILE_S = 4;    // mixtures per block (threadIdx.y)
constexpr int THREADS = TILE_N * TILE_S;
constexpr float MIN_SCORE_INIT = 1e10f;  // Mixtures.cpp:699, exact in float32

__global__ void __launch_bounds__(THREADS)
am_scores_df_kernel(const float* __restrict__ x,
                    const float* __restrict__ mu_hi, const float* __restrict__ mu_lo,
                    const float* __restrict__ iv_hi, const float* __restrict__ iv_lo,
                    const float* __restrict__ norm_hi, const float* __restrict__ norm_lo,
                    const float* __restrict__ logw_hi, const float* __restrict__ logw_lo,
                    float* __restrict__ out_hi, float* __restrict__ out_lo,
                    int N, int S, int D, int dim) {
  extern __shared__ float smem[];
  const int rows = TILE_S * D;            // table rows staged by this block
  float* s_muh = smem;                    // [rows][dim]
  float* s_mul = s_muh + rows * dim;
  float* s_ivh = s_mul + rows * dim;
  float* s_ivl = s_ivh + rows * dim;
  float* s_nh = s_ivl + rows * dim;       // [rows]
  float* s_nl = s_nh + rows;
  float* s_wh = s_nl + rows;
  float* s_wl = s_wh + rows;
  float* s_x = s_wl + rows;               // [TILE_N][dim]

  const int n0 = blockIdx.x * TILE_N;
  const int s0 = blockIdx.y * TILE_S;
  const int tid = threadIdx.y * TILE_N + threadIdx.x;
  const int j0 = s0 * D;
  const int jend = min(S * D, j0 + rows);  // rows past the last mixture stay unread

  for (int e = tid; e < rows * dim; e += THREADS) {
    const int j = j0 + e / dim;
    if (j < jend) {
      const size_t g = (size_t)j0 * dim + e;
      s_muh[e] = mu_hi[g];
      s_mul[e] = mu_lo[g];
      s_ivh[e] = iv_hi[g];
      s_ivl[e] = iv_lo[g];
    }
  }
  for (int r = tid; r < rows; r += THREADS) {
    if (j0 + r < jend) {
      s_nh[r] = norm_hi[j0 + r];
      s_nl[r] = norm_lo[j0 + r];
      s_wh[r] = logw_hi[j0 + r];
      s_wl[r] = logw_lo[j0 + r];
    }
  }
  for (int e = tid; e < TILE_N * dim; e += THREADS) {
    const int n = n0 + e / dim;
    s_x[e] = n < N ? x[(size_t)n0 * dim + e] : 0.f;
  }
  __syncthreads();

  const int n = n0 + threadIdx.x;
  const int s = s0 + threadIdx.y;
  if (n >= N || s >= S) return;

  const float* xr = s_x + threadIdx.x * dim;
  df::DF best = df::make(0.f, 0.f);
  for (int d = 0; d < D; ++d) {
    const int r = threadIdx.y * D + d;
    const float* muh = s_muh + r * dim;
    const float* mul = s_mul + r * dim;
    const float* ivh = s_ivh + r * dim;
    const float* ivl = s_ivl + r * dim;
    df::DF acc = df::make(0.f, 0.f);
    for (int i = 0; i < dim; ++i) {
      const df::DF diff = df::add_f(df::neg(df::make(muh[i], mul[i])), xr[i]);
      acc = df::add(acc, df::mul(df::mul(diff, diff), df::make(ivh[i], ivl[i])));
    }
    const df::DF half = df::make(__fmul_rn(acc.hi, 0.5f), __fmul_rn(acc.lo, 0.5f));
    df::DF score = df::add(df::make(s_nh[r], s_nl[r]), half);
    score = df::add(score, df::neg(df::make(s_wh[r], s_wl[r])));
    best = d == 0 ? score : df::minimum(best, score);
  }
  best = df::minimum(best, df::make(MIN_SCORE_INIT, 0.f));
  out_hi[(size_t)n * S + s] = best.hi;
  out_lo[(size_t)n * S + s] = best.lo;
}

size_t smem_bytes(int D, int dim) {
  const size_t rows = (size_t)TILE_S * D;
  return (4 * rows * dim + 4 * rows + (size_t)TILE_N * dim) * sizeof(float);
}

}  // namespace

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
  // above 48 KB only after opting in; beyond the 227 KB a block may use
  // (D = 16 densities of dim = 25 take 33 KB) the attribute call fails and
  // the wrapper raises
  const size_t smem = smem_bytes(D, dim);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(am_scores_df_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + TILE_N - 1) / TILE_N, (S + TILE_S - 1) / TILE_S);
  const dim3 block(TILE_N, TILE_S);
  am_scores_df_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, mu_hi, mu_lo, iv_hi, iv_lo, norm_hi, norm_lo, logw_hi, logw_lo,
      out_hi, out_lo, N, S, D, dim);
  return (int)cudaGetLastError();
}
