// Shared pieces of the search-tier scans (kernels I, J, K, M and P): the
// score type's BIG sentinel, adds and subtracts rounded to nearest with no
// contraction (the reference computes each as one rounded operation), the
// exact block minimum, the block argmin that takes the first index, and the
// placement of an utterance's lattice: in shared memory up to SHARED_LIMIT
// bytes, past it in device scratch that the wrapper allocates. A NaN score
// is kept as the reference keeps it: tmin and block_min give NaN where an
// operand is NaN (jnp.minimum, .min), and takes, pair_less and block_argmin
// take the first NaN (jnp.argmin).

#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "keys.cuh"

namespace search {

constexpr unsigned FULL = 0xffffffffu;
// threads of a block, at most (one block per utterance)
constexpr int MAX_THREADS = 512;
// the bytes of an utterance's state a block keeps in shared memory, at most
constexpr size_t SHARED_LIMIT = 96 * 1024;

template <typename T>
__host__ __device__ __forceinline__ T big() { return T(1e30); }

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float tmin(float a, float b) { return keys::nan_min(a, b); }
__device__ __forceinline__ double tmin(double a, double b) { return keys::nan_min(a, b); }

// v takes the place of best in a scan for the first minimum: strictly
// less, or the first NaN
template <typename T>
__device__ __forceinline__ bool takes(T v, T best) {
  return v < best || (v != v && best == best);
}

// v == w, a NaN equal to a NaN
template <typename T>
__device__ __forceinline__ bool same_value(T v, T w) {
  return v == w || (v != v && w != w);
}

// renormalisation by the frame's minimum (0 for a dead frame): BIG stays BIG
template <typename T>
__device__ __forceinline__ T renorm(T v, T best) {
  return v >= big<T>() * T(0.5) ? big<T>() : sub(v, best);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// threads of a block for `slots` slots: whole warps, at most MAX_THREADS
inline int threads_for(long long slots) {
  const long long w = (slots + 31) / 32 * 32;
  return (int)(w < 32 ? 32 : w > MAX_THREADS ? MAX_THREADS : w);
}

// the exact minimum over the block, NaN where any thread holds a NaN (every
// thread calls it; blockDim a multiple of 32); s_red holds 32 values. The
// trailing barrier lets the next call reuse s_red.
template <typename T>
__device__ __forceinline__ T block_min(T m, T* s_red) {
  m = keys::warp_minimum_nan(m);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = m;
  __syncthreads();
  T best = s_red[0];
  const int nw = blockDim.x >> 5;
  for (int k = 1; k < nw; ++k) best = tmin(best, s_red[k]);
  __syncthreads();
  return best;
}

// the block's sum of an int (every thread calls it); the result is in *s_sum
// after the caller's next barrier. *s_sum must be 0 before.
__device__ __forceinline__ void block_add(int v, int* s_sum) {
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(s_sum, v);
}

// (value, index) lexicographic: the smaller value, the smaller index on
// ties; a NaN before every other value, the smaller index among NaNs
template <typename T>
__device__ __forceinline__ bool pair_less(T v, int i, T w, int j) {
  if (v != v) return w == w || i < j;
  return v < w || (v == w && i < j);
}

// the block's (value, index) minimum: the first index at the minimum value
// (every thread calls it). Threads without a candidate pass (+inf, INT_MAX).
template <typename T>
__device__ __forceinline__ void block_argmin(T& v, int& idx, T* s_v, int* s_i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, idx, o);
    if (pair_less(ov, oi, v, idx)) {
      v = ov;
      idx = oi;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    s_v[threadIdx.x >> 5] = v;
    s_i[threadIdx.x >> 5] = idx;
  }
  __syncthreads();
  v = s_v[0];
  idx = s_i[0];
  const int nw = blockDim.x >> 5;
  for (int k = 1; k < nw; ++k)
    if (pair_less(s_v[k], s_i[k], v, idx)) {
      v = s_v[k];
      idx = s_i[k];
    }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T infinity() { return T(__int_as_float(0x7f800000)); }

// sets `kernel`'s dynamic shared memory limit to `smem` bytes (before its
// launch): the default 48 KB holds static and dynamic shared memory
// together, so a launch with less than 48 KB of dynamic shared memory can
// still need it
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem == 0) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace search
