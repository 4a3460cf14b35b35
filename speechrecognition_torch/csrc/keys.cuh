// Order-preserving unsigned keys of float and double, and the exact warp
// minimum (kernels D and F) and maximum (kernel L) by redux.sync on them.
// order_key ranks a NaN above +inf (its sign bit is clear on the card), so
// warp_minimum drops a NaN and warp_maximum keeps it. warp_minimum_nan and
// nan_min keep a NaN as jnp.minimum and .min do (kernels B, E, I, J, K and
// M); nan_first_key gives a NaN the least key, for an argmin that takes the
// first NaN as jnp.argmin does.
//
// A key's unsigned order is the value's order, with -0 taken as +0 as the
// float compare takes it: the key is formed from f + 0, which turns -0 into
// +0 and changes nothing else. key_value maps a key back, so a minimum of -0
// comes back as +0, which no score of the scans produces (their inputs carry
// no -0), and a maximum of -0 as +0, which kernel L never takes (its maxima
// are of lse3 results, alone or plus an emission, never -0, and of alpha +
// beta, where beta (lse3 results shifted by v - shift) is never -0).
// redux.sync takes 32-bit operands only, so the double minimum and maximum
// take two: the high halves of the keys, then the low halves of the lanes
// that hold the smallest (largest) high half.

#pragma once

#include <cuda_runtime.h>

namespace keys {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(__fadd_rn(f, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned long long order_key(double d) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(__dadd_rn(d, 0.0));
  return (u >> 63) ? ~u : (u | (1ull << 63));
}

__device__ __forceinline__ double key_value(unsigned long long k) {
  return __longlong_as_double((long long)((k >> 63) ? (k & ~(1ull << 63)) : ~k));
}

// the exact minimum over the full warp
__device__ __forceinline__ float warp_minimum(float m) {
  return key_value(__reduce_min_sync(FULL, order_key(m)));
}

__device__ __forceinline__ double warp_minimum(double m) {
  const unsigned long long k = order_key(m);
  const unsigned hi = (unsigned)(k >> 32);
  const unsigned key_hi = __reduce_min_sync(FULL, hi);
  const unsigned key_lo = __reduce_min_sync(FULL, hi == key_hi ? (unsigned)k : FULL);
  return key_value(((unsigned long long)key_hi << 32) | key_lo);
}

// a NaN's key is 0, below every other value's
__device__ __forceinline__ unsigned nan_first_key(float f) { return f != f ? 0u : order_key(f); }

__device__ __forceinline__ unsigned long long nan_first_key(double d) {
  return d != d ? 0ull : order_key(d);
}

// the exact minimum over the full warp, NaN where any lane holds a NaN (the
// vote beside the keys' minimum, off its chain)
__device__ __forceinline__ float warp_minimum_nan(float m) {
  const float r = warp_minimum(m);
  return __any_sync(FULL, m != m) ? __int_as_float(0x7fffffff) : r;
}

__device__ __forceinline__ double warp_minimum_nan(double m) {
  const double r = warp_minimum(m);
  return __any_sync(FULL, m != m) ? __longlong_as_double(0x7ff8000000000000ll) : r;
}

// the minimum of two values, NaN where either is (min.NaN in float32; the
// same bits as fminf and fmin otherwise, -0 aside, which no score is)
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ double nan_min(double a, double b) {
  return b < a || b != b ? b : a;
}

// the exact maximum over the full warp
__device__ __forceinline__ float warp_maximum(float m) {
  return key_value(__reduce_max_sync(FULL, order_key(m)));
}

__device__ __forceinline__ double warp_maximum(double m) {
  const unsigned long long k = order_key(m);
  const unsigned hi = (unsigned)(k >> 32);
  const unsigned key_hi = __reduce_max_sync(FULL, hi);
  const unsigned key_lo = __reduce_max_sync(FULL, hi == key_hi ? (unsigned)k : 0u);
  return key_value(((unsigned long long)key_hi << 32) | key_lo);
}

}  // namespace keys
