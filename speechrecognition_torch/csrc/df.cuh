// Double-float (two-float32) arithmetic for the device.
//
// The same error-free transforms as speechrecognition_tpu/ops/doublefloat.py
// and its plain PyTorch counterpart speechrecognition_torch/ops/doublefloat.py,
// step for step and in the same operation order, with one exception: the
// exact product. Every add, subtract and multiply is an explicit
// round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn): nvcc never
// contracts those into a fused multiply-add, which would round once where the
// transform relies on two roundings and so change the lo words. The build
// keeps nvcc's default --fmad=true for the other kernels; only these
// intrinsics are protected from contraction.
//
// The exception: mul forms the error of hi*hi with one explicit FMA
// (two_prod_fma: p = fl(a*b), e = fma(a, b, -p)), in 2 instructions where
// Dekker's split product (two_prod, kept below as the reference's own
// formulation) takes 16. Both give the exact error a*b - fl(a*b), which is a
// float32 whenever it does not underflow: the FMA rounds that exact value
// once, so it returns it unchanged, and each partial product and sum of
// Dekker's version is exact in that range. So the two agree bit for bit
// wherever |a*b| stays above about 2^-100 (ulp(a)*ulp(b) >= 2^-149); they part
// only where the error falls below the float32 normal range, which no score
// reaches (tests/test_torch_doublefloat.py pins both facts). The plain
// versions keep Dekker's formula, and the kernels are held bit-equal to them.
// That one FMA is the only fused operation here: the cross terms of mul and
// every add of two_sum and fast_two_sum must stay as two roundings.
//
// Denormals are kept (no -ftz), as on the CPU, so the lo words agree with
// the plain versions even where they underflow.

#pragma once

namespace df {

struct DF {
  float hi, lo;
};

// Dekker splitting constant for float32 (2^12 + 1)
constexpr float SPLIT = 4097.0f;

__device__ __forceinline__ DF make(float hi, float lo) { return DF{hi, lo}; }

// s = fl(a+b); e = exact error (Knuth's branch-free version)
__device__ __forceinline__ DF two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  const float e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return DF{s, e};
}

// two_sum requiring |a| >= |b|
__device__ __forceinline__ DF fast_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float e = __fsub_rn(b, __fsub_rn(s, a));
  return DF{s, e};
}

// Dekker split into two non-overlapping 12-bit halves
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float t = __fmul_rn(a, SPLIT);
  hi = __fsub_rn(t, __fsub_rn(t, a));
  lo = __fsub_rn(a, hi);
}

// p = fl(a*b); e = exact error, via Dekker splitting (no FMA)
__device__ __forceinline__ DF two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  // ((ah*bh - p) + ah*bl + al*bh) + al*bl, left to right
  float e = __fsub_rn(__fmul_rn(ah, bh), p);
  e = __fadd_rn(e, __fmul_rn(ah, bl));
  e = __fadd_rn(e, __fmul_rn(al, bh));
  e = __fadd_rn(e, __fmul_rn(al, bl));
  return DF{p, e};
}

// p = fl(a*b); e = a*b - p, rounded once by the FMA: exact, and equal to
// two_prod's e, wherever that error does not underflow (see the top comment)
__device__ __forceinline__ DF two_prod_fma(float a, float b) {
  const float p = __fmul_rn(a, b);
  return DF{p, __fmaf_rn(a, b, -p)};
}

__device__ __forceinline__ DF add(DF a, DF b) {
  DF s = two_sum(a.hi, b.hi);
  const DF t = two_sum(a.lo, b.lo);
  s.lo = __fadd_rn(s.lo, t.hi);
  s = fast_two_sum(s.hi, s.lo);
  s.lo = __fadd_rn(s.lo, t.lo);
  return fast_two_sum(s.hi, s.lo);
}

// DF + plain float32
__device__ __forceinline__ DF add_f(DF a, float b) {
  DF s = two_sum(a.hi, b);
  s.lo = __fadd_rn(s.lo, a.lo);
  return fast_two_sum(s.hi, s.lo);
}

__device__ __forceinline__ DF neg(DF a) { return DF{-a.hi, -a.lo}; }

__device__ __forceinline__ DF sub(DF a, DF b) { return add(a, neg(b)); }

// the product's exact part through the FMA; the cross terms a.hi*b.lo and
// a.lo*b.hi are two rounded products and a rounded add, as in the reference
__device__ __forceinline__ DF mul(DF a, DF b) {
  DF p = two_prod_fma(a.hi, b.hi);
  p.lo = __fadd_rn(p.lo, __fadd_rn(__fmul_rn(a.hi, b.lo), __fmul_rn(a.lo, b.hi)));
  return fast_two_sum(p.hi, p.lo);
}

// a < b, exact (lexicographic on normalized pairs)
__device__ __forceinline__ bool less(DF a, DF b) {
  return (a.hi < b.hi) || ((a.hi == b.hi) && (a.lo < b.lo));
}

__device__ __forceinline__ bool less_equal(DF a, DF b) {
  return (a.hi < b.hi) || ((a.hi == b.hi) && (a.lo <= b.lo));
}

__device__ __forceinline__ DF minimum(DF a, DF b) { return less(a, b) ? a : b; }

}  // namespace df
