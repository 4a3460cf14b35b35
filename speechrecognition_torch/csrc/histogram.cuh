// Histogram pruning inside kernel K: the arithmetic of
// speechrecognition_tpu/search/histogram.py (histogram_quantile :31-52,
// histogram_prune :55-69), per utterance, in the scan's float type:
//   scale = (bins - 1) / max(upper - lower, 1e-30)
//   bin(s) = clamp(trunc((s - lower) * scale), 0, bins - 1)
//   quantile(n) = b / scale + lower, b the first bin whose cumulative count
//                 reaches n (bins if none does)
// Each float step is one rounded operation (no contraction), so the
// threshold is the reference's bit for bit; the counts are integers in
// shared memory (or device scratch), added with atomics in any order.

#pragma once

#include "search.cuh"

namespace hist {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double tmax(double a, double b) { return fmax(a, b); }

template <typename T>
__device__ __forceinline__ T scale(T lower, T upper, int bins) {
  return div(T(bins - 1), tmax(search::sub(upper, lower), T(1e-30)));
}

// the bin of a valid score (scores of the scan are in [0, upper] here)
template <typename T>
__device__ __forceinline__ int bin(T s, T lower, T sc, int bins) {
  const int k = (int)mul(search::sub(s, lower), sc);  // truncation toward zero
  return min(max(k, 0), bins - 1);
}

// warp-collective (all 32 lanes): the quantile of the n-th best from the
// counts[bins], by an inclusive prefix over 32 bins at a time
template <typename T>
__device__ T quantile(const int* counts, int bins, int n, T lower, T sc) {
  const int lane = threadIdx.x & 31;
  int run = 0, found = bins;
  for (int k0 = 0; k0 < bins; k0 += 32) {
    const int k = k0 + lane;
    int v = k < bins ? counts[k] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(search::FULL, v, o);
      if (lane >= o) v += u;
    }
    v += run;
    const unsigned hit = __ballot_sync(search::FULL, k < bins && v >= n);
    if (hit) {
      found = k0 + __ffs(hit) - 1;
      break;
    }
    run = __shfl_sync(search::FULL, v, 31);
  }
  return search::add(div(T(found), sc), lower);
}

}  // namespace hist
