// Kernel O: the int8 quantized max-approximation scorer, with or without
// density preselection.
//
// Replaces speechrecognition_tpu/models/quantized.py::am_scores_q with the
// functions it fuses (quantize_features, quantized_distances, _select_mask;
// XLA fuses them around one s8 x s8 -> s32 product on the TPU's MXU). Same
// inputs and output: features x f32 [N, dim], isv f32 [dim] (scale ·
// invsqrt(var)), the quantized means [J, DIM4] (int8 zero-padded to DIM4
// words, read as int32), qmeans_sq and consts int32 [J]; with preselection
// the quantized centers [C, DIM4], qcenters_sq int32 [C], cluster_of int32
// [J] and n_selected; it writes the scores f32 [N, S] (J = S * D).
//
// Per frame it follows the reference exactly, in integers:
//   * qx = clip(rint(x * isv), -128, 127): one rounded float multiply,
//     round half to even (jnp.round), clip; a NaN product quantizes to 0,
//     as XLA's saturating float-to-int conversion gives (fmaxf alone would
//     give -128);
//   * d[j] = xx - 2 * cross[j] + qmeans_sq[j], cross by __dp4a over the
//     padded words (the zero bytes add nothing); total = d + consts;
//   * with preselection: cd[c] the same distance to each center; kth the
//     n_selected-th smallest cd counting duplicates (jax.lax.top_k); a
//     density whose cluster has cd > kth takes INACTIVE_INT;
//   * best = the integer minimum over a mixture's D densities; the score
//     __int2float_rn(best) / scale2x as one rounded float division; with
//     preselection best >= INACTIVE_INT reads the backoff score.
// Integer sums cannot overflow (dim·255² ≈ 2.9e6 at dim 45; INACTIVE_INT
// 2^30), so any order of the sums gives the reference's integers.
//
// Design: a block of 128 threads a tile of FT frames, an instance a frame
// width of DIM4 = 4, 12 or 32 words (dim <= 16, 48 or 128; AN4's 45 in
// 12). The tile is quantized into shared memory (4 int8 a word); with preselection each warp takes
// frames in turn, a lane 8 clusters (C <= 256): the distances in registers,
// kth by a binary search on the value (a warp's count of cd <= mid by
// __reduce_add_sync; the least value with count >= n_selected is the
// n_selected-th smallest), the selection as 8 ballots into a 256-bit mask a
// frame. Then a thread a mixture (looping over S): for each density its
// DIM4 words in registers, for each frame of the tile DIM4 __dp4a against
// the frame's words (a broadcast from shared memory), the minimum in FT
// registers; one coalesced row of scores a frame at the end.
//
// What bounds it: issue of the __dp4a products (2·N·J·dim s8 operations,
// which the tensor cores' 1,979 TOP/s would bound far lower; mma.sync s8 is
// later work) and the means' reads through L1, not device memory (the
// bytes: the features in, the scores out).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int FT = 32;             // frames a tile
constexpr int MAX_C = 256;         // clusters: 8 a lane
constexpr int C_PER_LANE = MAX_C / 32;
constexpr int INACTIVE = 1 << 30;  // INACTIVE_INT
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int quantize(float x, float isv) {
  float q = rintf(__fmul_rn(x, isv));
  if (isnan(q)) return 0;
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return (int)q;
}

template <int DIM4, bool PRESELECT>
__global__ void __launch_bounds__(THREADS) quantized_scores_kernel(
    const float* __restrict__ x, const float* __restrict__ isv, const int* __restrict__ qmeans,
    const int* __restrict__ qmeans_sq, const int* __restrict__ consts,
    const int* __restrict__ qcenters, const int* __restrict__ qcenters_sq,
    const int* __restrict__ cluster_of, float* __restrict__ out, int N, int S, int D, int dim,
    int C, int n_selected, float scale2x, float backoff) {
  __shared__ int s_x[FT][DIM4];
  __shared__ int s_xx[FT];
  __shared__ unsigned s_sel[FT][C_PER_LANE];
  const int f0 = blockIdx.x * FT;
  const int nf = min(FT, N - f0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. the tile's quantized frames, 4 bytes a word (zeros past dim and nf)
  for (int e = threadIdx.x; e < FT * DIM4; e += THREADS) {
    const int f = e / DIM4, k = e - f * DIM4;
    unsigned packed = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * k + q;
      const int v = f < nf && i < dim ? quantize(x[(size_t)(f0 + f) * dim + i], isv[i]) : 0;
      packed |= (unsigned)(v & 0xff) << (8 * q);
    }
    s_x[f][k] = (int)packed;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < FT; f += THREADS) {
    int xx = 0;
#pragma unroll
    for (int k = 0; k < DIM4; ++k) xx = __dp4a(s_x[f][k], s_x[f][k], xx);
    s_xx[f] = xx;
  }
  __syncthreads();

  // 2. the selected clusters of each frame: a warp a frame, a lane 8 clusters
  if (PRESELECT) {
    for (int f = warp; f < FT; f += THREADS / 32) {
      int cd[C_PER_LANE];
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int j = 0; j < C_PER_LANE; ++j) {
        const int c = lane + 32 * j;
        cd[j] = INT_MAX;
        if (c < C) {
          int cross = 0;
#pragma unroll
          for (int k = 0; k < DIM4; ++k) cross = __dp4a(s_x[f][k], __ldg(qcenters + c * DIM4 + k), cross);
          cd[j] = s_xx[f] - 2 * cross + qcenters_sq[c];
          lo = min(lo, cd[j]);
          hi = max(hi, cd[j]);
        }
      }
      lo = __reduce_min_sync(FULL, lo);
      hi = __reduce_max_sync(FULL, hi);
      // the least value with at least n_selected distances at or below it
      while (lo < hi) {
        const int mid = (int)(((long long)lo + (long long)hi) >> 1);
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < C_PER_LANE; ++j) cnt += lane + 32 * j < C && cd[j] <= mid;
        cnt = __reduce_add_sync(FULL, cnt);
        if (cnt >= n_selected)
          hi = mid;
        else
          lo = mid + 1;
      }
#pragma unroll
      for (int j = 0; j < C_PER_LANE; ++j) {
        const unsigned bits = __ballot_sync(FULL, lane + 32 * j < C && cd[j] <= lo);
        if (lane == 0) s_sel[f][j] = bits;
      }
    }
    __syncthreads();
  }

  // 3. a thread a mixture: the integer minimum over its densities for every
  // frame of the tile, then one division a score
  for (int s = threadIdx.x; s < S; s += THREADS) {
    int best[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) best[f] = INT_MAX;
    for (int d = 0; d < D; ++d) {
      const int j = s * D + d;
      int qm[DIM4];
#pragma unroll
      for (int k = 0; k < DIM4; ++k) qm[k] = __ldg(qmeans + (size_t)j * DIM4 + k);
      const int base = qmeans_sq[j];
      const int cst = consts[j];
      const int cl = PRESELECT ? cluster_of[j] : 0;
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        int cross = 0;
#pragma unroll
        for (int k = 0; k < DIM4; ++k) cross = __dp4a(s_x[f][k], qm[k], cross);
        int total = s_xx[f] - 2 * cross + base + cst;
        if (PRESELECT && !((s_sel[f][cl >> 5] >> (cl & 31)) & 1u)) total = INACTIVE;
        best[f] = min(best[f], total);
      }
    }
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      if (f < nf) {
        float v = __fdiv_rn(__int2float_rn(best[f]), scale2x);
        if (PRESELECT && best[f] >= INACTIVE) v = backoff;
        out[(size_t)(f0 + f) * S + s] = v;
      }
    }
  }
}

template <int DIM4>
cudaError_t launch_dim(bool preselect, const float* x, const float* isv, const int* qmeans,
                       const int* qmeans_sq, const int* consts, const int* qcenters,
                       const int* qcenters_sq, const int* cluster_of, float* out, int N, int S,
                       int D, int dim, int C, int n_selected, float scale2x, float backoff,
                       cudaStream_t stream) {
  const int blocks = (N + FT - 1) / FT;
  if (preselect)
    quantized_scores_kernel<DIM4, true><<<blocks, THREADS, 0, stream>>>(
        x, isv, qmeans, qmeans_sq, consts, qcenters, qcenters_sq, cluster_of, out, N, S, D,
        dim, C, n_selected, scale2x, backoff);
  else
    quantized_scores_kernel<DIM4, false><<<blocks, THREADS, 0, stream>>>(
        x, isv, qmeans, qmeans_sq, consts, qcenters, qcenters_sq, cluster_of, out, N, S, D,
        dim, C, n_selected, scale2x, backoff);
  return cudaGetLastError();
}

}  // namespace

// x f32 [N, dim]; qmeans [J, dim4] and qcenters [C, dim4] int8 zero-padded
// to dim4 words (4, 12 or 32: dim <= 16, 48 or 128); qcenters,
// qcenters_sq and cluster_of NULL (C == 0) without preselection; out f32
// [N, S]. The scores of a mixture with no selected density are backoff.
extern "C" int sr_quantized_scores(const float* x, const float* isv, const int* qmeans,
                                   const int* qmeans_sq, const int* consts,
                                   const int* qcenters, const int* qcenters_sq,
                                   const int* cluster_of, float* out, int N, int S, int D,
                                   int dim, int dim4, int C, int n_selected, float scale2x,
                                   float backoff, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || S == 0) return (int)cudaSuccess;
  const bool preselect = C > 0;
  if (D < 1 || dim < 1 || dim4 * 4 < dim || C > MAX_C ||
      (dim4 != 4 && dim4 != 12 && dim4 != 32) ||
      (preselect && (n_selected < 1 || n_selected > C || qcenters == nullptr ||
                     qcenters_sq == nullptr || cluster_of == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define SR_O_ARGS                                                                            \
  preselect, x, isv, qmeans, qmeans_sq, consts, qcenters, qcenters_sq, cluster_of, out, N, S, \
      D, dim, C, n_selected, scale2x, backoff, st
  switch (dim4) {
    case 4: err = launch_dim<4>(SR_O_ARGS); break;
    case 12: err = launch_dim<12>(SR_O_ARGS); break;
    default: err = launch_dim<32>(SR_O_ARGS); break;
  }
#undef SR_O_ARGS
  return (int)err;
}
