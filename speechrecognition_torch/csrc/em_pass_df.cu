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
// Every sum has a fixed order, so two runs give the same bits, and there are
// no atomics. The tile kernel gives each tile of TILE_R rows of a sorted
// block to one CTA, which scores its rows, keeps each row's density and score
// in shared memory and gives each (d, i) sum, each w[d] and the tile's total
// to one thread, which adds the tile's rows in row order into per-tile
// partials [NB * NT, K]; the block-sums kernel adds each block's tile
// partials in tile order into [NB, K]; the state-sums kernel gives each
// output element to one thread, which adds the block partials of the
// element's state in block order (the total: of every block). The per-row
// terms are exact (x*x of a float32 is exact in float64, and the mask is 0
// or 1), so only the order of the adds differs from the plain version, whose
// sums are one-hot products: w is bit-equal to it, xs, x2s and the total
// agree to ~1e-15 relative.
//
// What bounds it: FP32 instruction issue in the scoring, 48 instructions per
// live row, density and dimension (kernel C's count): 317,161 live rows x 16
// densities x 25 dims at full width, about 6.3e9 FP32 operations, a roofline
// bound of about 0.1 ms. The sums add about a tenth to the issued
// instructions; the 78 MB of frames and mask are read once from device
// memory (about 0.02 ms).
//
// Design: the grid is every (sorted block, tile of TILE_R = 512 rows), 1,472
// CTAs of 256 threads at full width (184 blocks x 8 tiles), so all 132 SMs
// stay full (of the tile shapes tried on the card, 32 to 256 threads by 1 or
// 2 rows each, this one was the fastest). A CTA stages its block's mixture
// table as interleaved (hi, lo) float2 pairs in shared memory; each thread
// scores F = 2 rows (two independent dependency chains per table load). For
// dim = 25, the SieTill dim, the CTA also stages its rows with coalesced
// loads in shared memory and each thread holds its rows' features in
// registers; any other dim takes the generic instance, which reads the rows
// from device memory, so dim is bounded only by the table's shared memory.
// The same CTA then forms the tile's sums, so the rows' densities and scores
// never reach device memory. The wrapper sizes the partials' scratch with
// sr_em_pass_df_scratch, so TILE_R is set here only.

#include <cuda_runtime.h>

#include "df.cuh"

namespace {

constexpr int HT = 256;             // threads per tile CTA
constexpr int F = 2;                // rows per thread in the scoring
constexpr int TILE_R = HT * F;      // rows per tile
constexpr int CH = TILE_R / 32;     // 32-row chunks of a tile, one warp each
constexpr int RT = 256;             // threads per reduce CTA
constexpr float MIN_SCORE_INIT = 1e10f;  // Mixtures.cpp:699, exact in float32

// partials per tile or block: xs [D*dim], x2s [D*dim], w [D], the total
__host__ __device__ long partial_len(int D, int dim) { return 2L * D * dim + D + 1; }

size_t tile_smem_bytes(int D, int dim, bool staged) {
  return (size_t)TILE_R * sizeof(double)                      // s_fs
         + (2 * (size_t)D * dim + 2 * (size_t)D) * sizeof(float2)  // tables
         + (staged ? (size_t)TILE_R * dim * sizeof(float) : 0)  // s_x
         + (size_t)TILE_R * sizeof(float)                     // s_m
         + (size_t)TILE_R * sizeof(int)                       // s_best
         + ((size_t)CH * D + D + 1 + TILE_R) * sizeof(int);   // s_cnt, s_start, s_order
}

// DIM: the feature dimension, or 0 for any (read from dim_arg); at most 128
// registers a thread for the SieTill dim of 25 (2 CTAs an SM)
template <int DIM>
__global__ void __launch_bounds__(HT, (DIM > 0 ? 2 : 1))
em_tile_kernel(const float* __restrict__ frames, const float* __restrict__ mask,
               const int* __restrict__ block_state,
               const float* __restrict__ mu_hi, const float* __restrict__ mu_lo,
               const float* __restrict__ iv_hi, const float* __restrict__ iv_lo,
               const float* __restrict__ norm_hi, const float* __restrict__ norm_lo,
               const float* __restrict__ logw_hi, const float* __restrict__ logw_lo,
               double* __restrict__ tile_p, int R, int NT, int D, int dim_arg,
               int first_pass) {
  const int dim = DIM > 0 ? DIM : dim_arg;
  extern __shared__ __align__(8) unsigned char smem_raw[];
  double* s_fs = reinterpret_cast<double*>(smem_raw);        // [TILE_R] mask * score
  float2* s_mu = reinterpret_cast<float2*>(s_fs + TILE_R);   // [D][dim] (hi, lo)
  float2* s_iv = s_mu + D * dim;                             // [D][dim]
  float2* s_norm = s_iv + D * dim;                           // [D]
  float2* s_logw = s_norm + D;                               // [D]
  float* s_x = reinterpret_cast<float*>(s_logw + D);         // [TILE_R][dim], DIM > 0 only
  float* s_m = s_x + (DIM > 0 ? TILE_R * dim : 0);           // [TILE_R]
  int* s_best = reinterpret_cast<int*>(s_m + TILE_R);        // [TILE_R], -1 on dead rows
  int* s_cnt = s_best + TILE_R;      // [CH][D] rows of density d in chunk c, then the offset
  int* s_start = s_cnt + CH * D;     // [D + 1] density d's rows in s_order
  int* s_order = s_start + D + 1;    // [TILE_R] live rows by density, each in row order

  const int tile = blockIdx.x;          // blockIdx.x = blk * NT + tile
  const int blk = tile / NT;
  const int r0 = (tile - blk * NT) * TILE_R;
  const int nrows = min(TILE_R, R - r0);
  const int tid = threadIdx.x;
  const size_t j0 = (size_t)block_state[blk] * D;
  for (int e = tid; e < D * dim; e += HT) {
    s_mu[e] = make_float2(mu_hi[j0 * dim + e], mu_lo[j0 * dim + e]);
    s_iv[e] = make_float2(iv_hi[j0 * dim + e], iv_lo[j0 * dim + e]);
  }
  for (int d = tid; d < D; d += HT) {
    s_norm[d] = make_float2(norm_hi[j0 + d], norm_lo[j0 + d]);
    s_logw[d] = make_float2(logw_hi[j0 + d], logw_lo[j0 + d]);
  }
  const float* fb = frames + ((size_t)blk * R + r0) * dim;
  if (DIM > 0)
    for (int e = tid; e < nrows * dim; e += HT) s_x[e] = fb[e];
  const float* xrows = DIM > 0 ? s_x : fb;                   // the tile's rows [nrows][dim]
  const float* mb = mask + (size_t)blk * R + r0;
  for (int r = tid; r < TILE_R; r += HT) s_m[r] = r < nrows ? mb[r] : 0.f;
  for (int e = tid; e < CH * D; e += HT) s_cnt[e] = 0;
  __syncthreads();

  // scoring: rows tid and tid + HT (features in registers when DIM > 0)
  bool live[F];
  bool any = false;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    live[f] = s_m[tid + f * HT] != 0.f;
    any |= live[f];
  }
  if (any) {
    const float* xp[F];
    float xr[F][DIM > 0 ? DIM : 1];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      xp[f] = xrows + (size_t)min(tid + f * HT, nrows - 1) * dim;
#pragma unroll
      for (int i = 0; i < (DIM > 0 ? DIM : 1); ++i)
        if (DIM > 0) xr[f][i] = xp[f][i];
    }
    df::DF mn[F];
    int best[F];
    for (int d = 0; d < D; ++d) {
      const float2* mu = s_mu + d * dim;
      const float2* iv = s_iv + d * dim;
      df::DF acc[F];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = df::make(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < dim; ++i) {
        const float2 m = mu[i];
        const df::DF v = df::make(iv[i].x, iv[i].y);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float xv = DIM > 0 ? xr[f][DIM > 0 ? i : 0] : __ldg(xp[f] + i);
          const df::DF diff = df::add_f(df::neg(df::make(m.x, m.y)), xv);
          acc[f] = df::add(acc[f], df::mul(df::mul(diff, diff), v));
        }
      }
      const float2 nr = s_norm[d];
      const float2 lw = s_logw[d];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const df::DF half = df::make(__fmul_rn(acc[f].hi, 0.5f), __fmul_rn(acc[f].lo, 0.5f));
        df::DF score = df::add(df::make(nr.x, nr.y), half);
        score = df::add(score, df::neg(df::make(lw.x, lw.y)));
        if (d == 0 || df::less(score, mn[f])) {  // strict: the first minimum stays
          mn[f] = score;
          best[f] = d;
        }
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int r = tid + f * HT;
      if (live[f]) {
        const float capped_hi = fminf(mn[f].hi, MIN_SCORE_INIT);
        const float capped_lo = mn[f].hi < MIN_SCORE_INIT ? mn[f].lo : 0.f;
        s_best[r] = first_pass ? 0 : best[f];
        s_fs[r] = __dmul_rn(__dadd_rn((double)capped_hi, (double)capped_lo), (double)s_m[r]);
      } else {
        s_best[r] = -1;
        s_fs[r] = 0.0;
      }
    }
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      s_best[tid + f * HT] = -1;
      s_fs[tid + f * HT] = 0.0;
    }
  }
  __syncthreads();

  // bucket the live rows by density, keeping row order: a warp owns the
  // 32-row chunks r >> 5 of its two rows; rows of one density in a chunk are
  // ranked by lane (__match_any_sync), the chunks' counts are prefix-summed
  // per density, and the densities' totals give each one's start
  int rank[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int r = tid + f * HT;
    const int b = s_best[r];
    const unsigned m = __match_any_sync(0xffffffffu, b);
    rank[f] = __popc(m & ((1u << (tid & 31)) - 1u));
    if (b >= 0 && rank[f] == 0) s_cnt[(r >> 5) * D + b] = __popc(m);
  }
  __syncthreads();
  for (int d = tid; d < D; d += HT) {
    int run = 0;
    for (int c = 0; c < CH; ++c) {
      const int n = s_cnt[c * D + d];
      s_cnt[c * D + d] = run;
      run += n;
    }
    s_start[d + 1] = run;
  }
  __syncthreads();
  if (tid == 0) {
    s_start[0] = 0;
    for (int d = 0; d < D; ++d) s_start[d + 1] += s_start[d];
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int r = tid + f * HT;
    const int b = s_best[r];
    if (b >= 0) s_order[s_start[b] + s_cnt[(r >> 5) * D + b] + rank[f]] = r;
  }
  __syncthreads();

  // the tile's sums in row order: item (d, i) → xs and x2s, then w[d], then
  // the total; each over its density's rows only, dead rows in none
  const int n_xs = D * dim;
  double* out = tile_p + (size_t)tile * partial_len(D, dim);
  for (int item = tid; item < n_xs + D + 1; item += HT) {
    if (item < n_xs) {
      const int d = item / dim;
      const int i = item - d * dim;
      double sx = 0.0, sx2 = 0.0;
      for (int k = s_start[d]; k < s_start[d + 1]; ++k) {
        const int r = s_order[k];
        const double m = (double)s_m[r];
        const double v = (double)xrows[(size_t)r * dim + i];
        sx = __dadd_rn(sx, __dmul_rn(v, m));
        sx2 = __dadd_rn(sx2, __dmul_rn(__dmul_rn(v, v), m));
      }
      out[item] = sx;
      out[n_xs + item] = sx2;
    } else if (item < n_xs + D) {
      const int d = item - n_xs;
      double cnt = 0.0;
      for (int k = s_start[d]; k < s_start[d + 1]; ++k)
        cnt = __dadd_rn(cnt, (double)s_m[s_order[k]]);
      out[2 * n_xs + d] = cnt;
    } else {
      double tot = 0.0;
      for (int r = 0; r < nrows; ++r)
        if (s_best[r] >= 0) tot = __dadd_rn(tot, s_fs[r]);
      out[2 * n_xs + D] = tot;
    }
  }
}

// block partials: element (b, k) of [NB, K] is the sum of block b's NT tile
// partials at k, in tile order
__global__ void __launch_bounds__(RT)
em_block_sums_kernel(const double* __restrict__ tile_p, double* __restrict__ block_p, int NB,
                     int NT, int K) {
  const long e = (long)blockIdx.x * RT + threadIdx.x;
  if (e >= (long)NB * K) return;
  const long b = e / K;
  const long k = e - b * K;
  const double* src = tile_p + b * NT * K + k;
  double acc = 0.0;
#pragma unroll 4
  for (int t = 0; t < NT; ++t) acc = __dadd_rn(acc, src[(long)t * K]);
  block_p[e] = acc;
}

// out element (s, k) of the state sums (k < D*dim: xs, then x2s, then w):
// the block partials of state s in block order; the last element is the
// total, over every block. A branch-free loop (a predicated load and a
// select), so the loads of many blocks are in flight at once.
__global__ void __launch_bounds__(RT)
em_state_sums_kernel(const int* __restrict__ block_state, const double* __restrict__ block_p,
                     double* __restrict__ total, double* __restrict__ w,
                     double* __restrict__ xs, double* __restrict__ x2s, int NB, int S, int D,
                     int dim) {
  const int n_xs = D * dim;
  const int K1 = 2 * n_xs + D;          // per-state elements; the total is at K1
  const long e = (long)blockIdx.x * RT + threadIdx.x;
  if (e > (long)S * K1) return;
  const bool is_total = e == (long)S * K1;
  const int s = is_total ? 0 : (int)(e / K1);
  const int k = is_total ? K1 : (int)(e - (long)s * K1);
  const int K = K1 + 1;
  double acc = 0.0;
#pragma unroll 8
  for (int b = 0; b < NB; ++b) {
    const bool take = is_total || block_state[b] == s;
    const double v = take ? block_p[(long)b * K + k] : 0.0;
    acc = take ? __dadd_rn(acc, v) : acc;
  }
  if (is_total)
    *total = acc;
  else if (k < n_xs)
    xs[(long)s * n_xs + k] = acc;
  else if (k < 2 * n_xs)
    x2s[(long)s * n_xs + k - n_xs] = acc;
  else
    w[(long)s * D + k - 2 * n_xs] = acc;
}

template <int DIM>
cudaError_t launch_tiles(const float* frames, const float* mask, const int* block_state,
                         const float* mu_hi, const float* mu_lo, const float* iv_hi,
                         const float* iv_lo, const float* norm_hi, const float* norm_lo,
                         const float* logw_hi, const float* logw_lo, double* tile_p, int NB,
                         int R, int NT, int D,
                         int dim, int first_pass, cudaStream_t st) {
  // above 48 KB only after opting in (D = 16, dim = 25 take 69,188 B, so two
  // CTAs share an SM's 228 KB); past the 227 KB a block may use the call
  // fails and the wrapper raises
  const size_t smem = tile_smem_bytes(D, dim, DIM > 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        em_tile_kernel<DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  em_tile_kernel<DIM><<<NB * NT, HT, smem, st>>>(
      frames, mask, block_state, mu_hi, mu_lo, iv_hi, iv_lo, norm_hi, norm_lo, logw_hi,
      logw_lo, tile_p, R, NT, D, dim, first_pass);
  return cudaGetLastError();
}

}  // namespace

// Doubles of scratch that sr_em_pass_df needs for NB blocks of R rows: the
// per-tile partials [NB * NT][K], then the per-block partials [NB][K],
// K = 2 * D * dim + D + 1, NT = ceil(R / TILE_R).
extern "C" int sr_em_pass_df_scratch(int NB, int R, int D, int dim) {
  const long n = (long)NB * ((R + TILE_R - 1) / TILE_R + 1) * partial_len(D, dim);
  return n <= 0x7fffffffL ? (int)n : -1;
}

extern "C" int sr_em_pass_df(const float* frames, const float* mask, const int* block_state,
                             const float* mu_hi, const float* mu_lo, const float* iv_hi,
                             const float* iv_lo, const float* norm_hi, const float* norm_lo,
                             const float* logw_hi, const float* logw_lo, double* scratch,
                             double* total, double* w, double* xs, double* x2s, int NB, int R,
                             int S, int D, int dim, int first_pass, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  const int NT = (R + TILE_R - 1) / TILE_R;
  const long K = partial_len(D, dim);
  double* tile_p = scratch;
  double* block_p = scratch + (long)NB * NT * K;
  if (NB > 0 && NT > 0) {
    err = dim == 25 ? launch_tiles<25>(frames, mask, block_state, mu_hi, mu_lo, iv_hi, iv_lo,
                                       norm_hi, norm_lo, logw_hi, logw_lo, tile_p, NB, R, NT, D,
                                       dim, first_pass, st)
                    : launch_tiles<0>(frames, mask, block_state, mu_hi, mu_lo, iv_hi, iv_lo,
                                      norm_hi, norm_lo, logw_hi, logw_lo, tile_p, NB, R, NT, D,
                                      dim, first_pass, st);
    if (err != cudaSuccess) return (int)err;
    const long n = (long)NB * K;
    em_block_sums_kernel<<<(int)((n + RT - 1) / RT), RT, 0, st>>>(tile_p, block_p, NB, NT,
                                                                  (int)K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long n = (long)S * (K - 1) + 1;
  em_state_sums_kernel<<<(int)((n + RT - 1) / RT), RT, 0, st>>>(
      block_state, block_p, total, w, xs, x2s, NT > 0 ? NB : 0, S, D, dim);
  return (int)cudaGetLastError();
}
