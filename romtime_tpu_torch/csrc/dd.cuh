// Double-f32 (dd) error-free transformations shared by the serving
// kernels (ops/compensated.py on the host side).
//
// They rely on IEEE rounding of each individual operation, so they use the
// __fadd_rn/__fsub_rn/__fmul_rn intrinsics, which nvcc never contracts
// into FMAs; TwoProduct's error term is fmaf(a, b, -p), exact by
// construction.

#pragma once

#include <cuda_runtime.h>

// a + b = s + e exactly (branch-free Knuth TwoSum).
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float ap = __fsub_rn(s, b);
  const float bp = __fsub_rn(s, ap);
  e = __fadd_rn(__fsub_rn(a, ap), __fsub_rn(b, bp));
}

// a·b = p + e exactly.
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = fmaf(a, b, -p);
}

// (ah, al) += (bh, bl), renormalized.
__device__ __forceinline__ void dd_add(float& ah, float& al, float bh, float bl) {
  float sh, se;
  two_sum(ah, bh, sh, se);
  two_sum(sh, __fadd_rn(__fadd_rn(se, al), bl), ah, al);
}

// (hi, lo) + delta for |delta| ≲ |hi| (ops/compensated.py dd_add_small).
__device__ __forceinline__ void dd_add_small(float hi, float lo, float delta,
                                             float& out_h, float& out_l) {
  float s, e;
  two_sum(hi, delta, s, e);
  two_sum(s, __fadd_rn(e, lo), out_h, out_l);
}

// Double-word BDF-2 extrapolation pred = 2·u − u1 and history difference
// d = u1 − u (ops/windowed_fused.py _dd_predictor, non-first step).
__device__ __forceinline__ void dd_predict(float uh, float ul, float u1h,
                                           float u1l, float& ph, float& pl,
                                           float& d) {
  float a, e;
  two_sum(__fmul_rn(2.f, uh), -u1h, a, e);
  const float plo = __fadd_rn(e, __fsub_rn(__fmul_rn(2.f, ul), u1l));
  two_sum(a, plo, ph, pl);
  float dh, de;
  two_sum(u1h, -uh, dh, de);
  d = __fadd_rn(dh, __fadd_rn(de, __fsub_rn(u1l, ul)));
}
