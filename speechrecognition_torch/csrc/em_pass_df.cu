// Kernel H: the double-float E-step and AM-score pass over state-sorted
// frame blocks.
//
// Replaces the df32 branch of speechrecognition_tpu/models/gmm.py::
// em_pass_sorted (its loop body, which XLA fuses into one lax.scan over the
// blocks). Inputs: frames [NB, R, dim] float32 (rows of one aligned mixture
// per block), mask [NB, R] float32 (0 on padding rows), block_state [NB];
// the pack's tables mu, iv [S*D, dim] and norm, logw [S*D] as hi and lo
// float32 arrays. For each row with mask != 0, against its block's mixture s:
//
//   for d: acc = 0; for i: diff = add_f(neg(mu[s,d,i]), x[i]);
//                          acc = add(acc, mul(mul(diff, diff), iv[s,d,i]))
//          score_d = add(add(norm[s,d], acc * 0.5), neg(logw[s,d]))
//   best = the first d at the exact (hi, lo) minimum (slot 0 on the first
//          pass); frame score = min(mn.hi, 1e10) + (mn.hi < 1e10 ? mn.lo : 0)
//          in float64
//
// (kernel C's op order, df.cuh, so decisions equal the decode path's), and
// then in float64: total = sum of mask * frame score, and per (s, d) slot
// w = sum of mask, xs = sum of mask * x, x2s = sum of mask * x * x.
//
// Every sum has a fixed order, so two runs give the same bits: the first
// kernel (one block per sorted block) keeps each row's density and score in
// shared memory and gives each (d, i) sum, each w[d] and the block's total
// to one thread, which adds the block's rows in row order into per-block
// partials [NB, ...]; the second kernel gives each output element to one
// thread, which adds the partials of that element's state in block order.
// The per-row terms are exact (x*x of a float32 is exact in float64, and the
// mask is 0 or 1), so only the order of the adds differs from the plain
// version, whose sums are one-hot products: w is bit-equal to it, xs, x2s
// and the total agree to ~1e-15 relative.
//
// What bounds it: FP32 instruction throughput in the scoring (about 76
// instructions per density and dimension, as kernel C) over the live rows;
// the sums read each block's rows D*dim times from L1/L2.

#include <cuda_runtime.h>

#include "df.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float MIN_SCORE_INIT = 1e10f;  // Mixtures.cpp:699, exact in float32

__global__ void __launch_bounds__(THREADS)
em_block_kernel(const float* __restrict__ frames, const float* __restrict__ mask,
                const int* __restrict__ block_state,
                const float* __restrict__ mu_hi, const float* __restrict__ mu_lo,
                const float* __restrict__ iv_hi, const float* __restrict__ iv_lo,
                const float* __restrict__ norm_hi, const float* __restrict__ norm_lo,
                const float* __restrict__ logw_hi, const float* __restrict__ logw_lo,
                double* __restrict__ total_b, double* __restrict__ w_b,
                double* __restrict__ xs_b, double* __restrict__ x2s_b, int R, int D,
                int dim, int first_pass) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  double* s_fs = reinterpret_cast<double*>(smem_raw);       // [R] mask * frame score
  float* s_muh = reinterpret_cast<float*>(s_fs + R);        // [D][dim]
  float* s_mul = s_muh + D * dim;
  float* s_ivh = s_mul + D * dim;
  float* s_ivl = s_ivh + D * dim;
  float* s_nh = s_ivl + D * dim;                            // [D]
  float* s_nl = s_nh + D;
  float* s_wh = s_nl + D;
  float* s_wl = s_wh + D;
  int* s_best = reinterpret_cast<int*>(s_wl + D);           // [R]

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = block_state[blk];
  const size_t j0 = (size_t)s * D;
  for (int e = tid; e < D * dim; e += THREADS) {
    s_muh[e] = mu_hi[j0 * dim + e];
    s_mul[e] = mu_lo[j0 * dim + e];
    s_ivh[e] = iv_hi[j0 * dim + e];
    s_ivl[e] = iv_lo[j0 * dim + e];
  }
  for (int d = tid; d < D; d += THREADS) {
    s_nh[d] = norm_hi[j0 + d];
    s_nl[d] = norm_lo[j0 + d];
    s_wh[d] = logw_hi[j0 + d];
    s_wl[d] = logw_lo[j0 + d];
  }
  __syncthreads();

  const float* fb = frames + (size_t)blk * R * dim;
  const float* mb = mask + (size_t)blk * R;
  // scoring: one row per thread and step
  for (int r = tid; r < R; r += THREADS) {
    const float m = mb[r];
    if (m == 0.f) {
      s_best[r] = 0;
      s_fs[r] = 0.0;
      continue;
    }
    const float* x = fb + (size_t)r * dim;
    df::DF mn = df::make(0.f, 0.f);
    int best = 0;
    for (int d = 0; d < D; ++d) {
      df::DF acc = df::make(0.f, 0.f);
      for (int i = 0; i < dim; ++i) {
        const int e = d * dim + i;
        const df::DF diff = df::add_f(df::neg(df::make(s_muh[e], s_mul[e])), x[i]);
        acc = df::add(acc, df::mul(df::mul(diff, diff), df::make(s_ivh[e], s_ivl[e])));
      }
      const df::DF half = df::make(__fmul_rn(acc.hi, 0.5f), __fmul_rn(acc.lo, 0.5f));
      df::DF score = df::add(df::make(s_nh[d], s_nl[d]), half);
      score = df::add(score, df::neg(df::make(s_wh[d], s_wl[d])));
      if (d == 0 || df::less(score, mn)) {  // strict: the first minimum stays
        mn = score;
        best = d;
      }
    }
    const float capped_hi = fminf(mn.hi, MIN_SCORE_INIT);
    const float capped_lo = mn.hi < MIN_SCORE_INIT ? mn.lo : 0.f;
    s_best[r] = first_pass ? 0 : best;
    s_fs[r] = __dmul_rn(__dadd_rn((double)capped_hi, (double)capped_lo), (double)m);
  }
  __syncthreads();

  // sums in row order: item (d, i) → xs and x2s, then w[d], then the total
  const int n_xs = D * dim;
  for (int item = tid; item < n_xs + D + 1; item += THREADS) {
    if (item < n_xs) {
      const int d = item / dim;
      const int i = item - d * dim;
      double sx = 0.0, sx2 = 0.0;
      for (int r = 0; r < R; ++r) {
        if (s_best[r] != d) continue;
        const double m = (double)mb[r];
        if (m == 0.0) continue;
        const double v = (double)fb[(size_t)r * dim + i];
        sx = __dadd_rn(sx, __dmul_rn(v, m));
        sx2 = __dadd_rn(sx2, __dmul_rn(__dmul_rn(v, v), m));
      }
      xs_b[(size_t)blk * n_xs + item] = sx;
      x2s_b[(size_t)blk * n_xs + item] = sx2;
    } else if (item < n_xs + D) {
      const int d = item - n_xs;
      double cnt = 0.0;
      for (int r = 0; r < R; ++r)
        if (s_best[r] == d) cnt = __dadd_rn(cnt, (double)mb[r]);
      w_b[(size_t)blk * D + d] = cnt;
    } else {
      double tot = 0.0;
      for (int r = 0; r < R; ++r) tot = __dadd_rn(tot, s_fs[r]);
      total_b[blk] = tot;
    }
  }
}

// out element e of [S, D] (w) and [S, D, dim] (xs, x2s), and the total:
// the block partials of its state, in block order
__global__ void em_reduce_kernel(const int* __restrict__ block_state,
                                 const double* __restrict__ total_b,
                                 const double* __restrict__ w_b,
                                 const double* __restrict__ xs_b,
                                 const double* __restrict__ x2s_b, double* __restrict__ total,
                                 double* __restrict__ w, double* __restrict__ xs,
                                 double* __restrict__ x2s, int NB, int S, int D, int dim) {
  const int per_state = D * dim;
  const long n_xs = (long)S * per_state;
  const long n = 2 * n_xs + (long)S * D + 1;
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long)gridDim.x * blockDim.x) {
    double acc = 0.0;
    if (e < 2 * n_xs) {
      const bool sq = e >= n_xs;
      const long k = sq ? e - n_xs : e;
      const int s = (int)(k / per_state);
      const int off = (int)(k - (long)s * per_state);
      const double* src = sq ? x2s_b : xs_b;
      for (int b = 0; b < NB; ++b)
        if (block_state[b] == s) acc = __dadd_rn(acc, src[(size_t)b * per_state + off]);
      (sq ? x2s : xs)[k] = acc;
    } else if (e < 2 * n_xs + (long)S * D) {
      const long k = e - 2 * n_xs;
      const int s = (int)(k / D);
      const int d = (int)(k - (long)s * D);
      for (int b = 0; b < NB; ++b)
        if (block_state[b] == s) acc = __dadd_rn(acc, w_b[(size_t)b * D + d]);
      w[k] = acc;
    } else {
      for (int b = 0; b < NB; ++b) acc = __dadd_rn(acc, total_b[b]);
      *total = acc;
    }
  }
}

size_t smem_bytes(int R, int D, int dim) {
  return (size_t)R * sizeof(double) + (4 * (size_t)D * dim + 4 * (size_t)D) * sizeof(float) +
         (size_t)R * sizeof(int);
}

}  // namespace

extern "C" int sr_em_pass_df(const float* frames, const float* mask, const int* block_state,
                             const float* mu_hi, const float* mu_lo, const float* iv_hi,
                             const float* iv_lo, const float* norm_hi, const float* norm_lo,
                             const float* logw_hi, const float* logw_lo, double* total_b,
                             double* w_b, double* xs_b, double* x2s_b, double* total,
                             double* w, double* xs, double* x2s, int NB, int R, int S, int D,
                             int dim, int first_pass, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (NB > 0) {
    // above 48 KB only after opting in (R = 4096 rows with D = 16, dim = 25
    // take 55 KB); past the 227 KB a block may use the call fails and the
    // wrapper raises
    const size_t smem = smem_bytes(R, D, dim);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(em_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    em_block_kernel<<<NB, THREADS, smem, st>>>(frames, mask, block_state, mu_hi, mu_lo, iv_hi,
                                               iv_lo, norm_hi, norm_lo, logw_hi, logw_lo,
                                               total_b, w_b, xs_b, x2s_b, R, D, dim,
                                               first_pass);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long n = 2L * S * D * dim + (long)S * D + 1;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  em_reduce_kernel<<<blocks, THREADS, 0, st>>>(block_state, total_b, w_b, xs_b, x2s_b, total,
                                               w, xs, x2s, NB, S, D, dim);
  return (int)cudaGetLastError();
}
