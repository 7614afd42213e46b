// SvfFilter's block as element steps, the one copy of its arithmetic in the
// CUDA sources: the block kernel (csrc/svf_filter.cu) and the chain
// kernel's SVF body (csrc/chain_kernel.cu body_svf) include it; compiled by
// the host C++ compiler, tests/test_torch_svf_filter.py holds it bit-equal
// to the plain version (knaster_tpu_torch/ugens/filters.py svf_block).
//
// The coefficients of every sample from its filter type, cutoff, q and
// gain (svf_coefficients, svf.rs:150-268): the tangent of pi cutoff / sr
// by the degree-9 sine polynomial's quotient at f32 (core/dsp.py
// tan_first_quadrant), tan at f64; 10^(gain / 40) by pow; the chained
// selects of the m's in the plain version's order.
//
// The SVF in state-space form, s[t+1] = M[t] s[t] + c[t] with M = [[2 a1 - 1,
// -2 a2], [2 a2, 1 - 2 a3]] and c = [2 a2, 2 a3] x, scanned as core/dsp.py
// affine_scan_2x2_rows scans it: six rows (A00 A01 A10 A11 C0 C1), then
// Hillis-Steele steps s = 1, 2, 4, ... < B, at each of which sample t
// composes its map with sample t - s's (the identity where t < s). Then the
// state before each sample, the outputs (svf.rs:270-300) and the final
// state. Every step is written as the plain version's expression, in its
// association; built with --fmad=false (-ffp-contract=off on the host),
// every add and multiply rounds on its own.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define KTT_SVF_FN __host__ __device__ __forceinline__
#else
#define KTT_SVF_FN inline
#endif

namespace svf {

// Python's constants as torch rounds them into a tensor's dtype
constexpr double kPi = 3.141592653589793;
constexpr double kHalfPi = 1.5707963267948966;
// core/dsp.py SIN9_C
constexpr double kS1 = -0.16666652, kS2 = 0.008332964, kS3 = -0.00019804752,
                 kS4 = 2.5981028e-06;
// SvfFilterType
constexpr int kLow = 0, kHigh = 1, kBand = 2, kNotch = 3, kPeak = 4, kAll = 5, kBell = 6,
              kLowShelf = 7, kHighShelf = 8;

KTT_SVF_FN float sin_poly(float u) {
  const float u2 = u * u;
  float p = float(kS4) * u2 + float(kS3);
  p = p * u2 + float(kS2);
  p = p * u2 + float(kS1);
  return (p * u2 + 1.0f) * u;
}

KTT_SVF_FN float tan_first_quadrant(float x) {
  return sin_poly(x) / sin_poly(float(kHalfPi) - x);
}
KTT_SVF_FN double tan_first_quadrant(double x) { return tan(x); }
KTT_SVF_FN float pow_of(float a, float b) { return powf(a, b); }
KTT_SVF_FN double pow_of(double a, double b) { return pow(a, b); }
KTT_SVF_FN float sqrt_of(float a) { return sqrtf(a); }
KTT_SVF_FN double sqrt_of(double a) { return sqrt(a); }

template <typename T>
struct Coefs {
  T a1, a2, a3, m0, m1, m2;
};

// one sample's coefficients (ugens/filters.py svf_coefficients); the type
// ty an int (the block kernel) or a float (the chain kernel's param row: a
// value that is none of the nine takes the defaults, as the chained wheres
// do)
template <typename T, typename Ty>
KTT_SVF_FN Coefs<T> coefs(Ty ty, T cutoff, T q, T gain, T sr) {
  const T amp = pow_of(T(10), gain / T(40));
  const T sqrt_amp = sqrt_of(amp);
  const bool bell = ty == Ty(kBell), ls = ty == Ty(kLowShelf), hs = ty == Ty(kHighShelf);
  const T g_base = tan_first_quadrant((T(kPi) * cutoff) / sr);
  const T g = (bell || ls) ? g_base / sqrt_amp : (hs ? g_base * sqrt_amp : g_base);
  const T k = bell ? T(1) / (q * amp) : T(1) / q;
  Coefs<T> c;
  c.a1 = T(1) / (T(1) + g * (g + k));
  c.a2 = g * c.a1;
  c.a3 = g * c.a2;
  // the first matching case, as the chained wheres pick it
  c.m0 = (ty == Ty(kLow) || ty == Ty(kBand)) ? T(0) : (hs ? amp * amp : T(1));
  c.m1 = ty == Ty(kLow) ? T(0)
       : ty == Ty(kBand) ? T(1)
       : (ty == Ty(kNotch) || ty == Ty(kHigh) || ty == Ty(kPeak)) ? -k
       : ty == Ty(kAll) ? T(-2) * k
       : bell ? k * (amp * amp - T(1))
       : ls ? k * (amp - T(1))
       : hs ? k * (T(1) - amp) * amp
       : T(0);
  c.m2 = ty == Ty(kLow) ? T(1)
       : ty == Ty(kHigh) ? T(-1)
       : ty == Ty(kPeak) ? T(-2)
       : ls ? amp * amp - T(1)
       : hs ? T(1) - amp * amp
       : T(0);
  return c;
}

// rows [6][B] of sample t from its coefficients and input
template <typename T>
KTT_SVF_FN void rows(T* r, int B, int t, T a1, T a2, T a3, T x) {
  r[t] = T(2) * a1 - T(1);
  r[B + t] = T(-2) * a2;
  r[2 * B + t] = T(2) * a2;
  r[3 * B + t] = T(1) - T(2) * a3;
  r[4 * B + t] = T(2) * a2 * x;
  r[5 * B + t] = T(2) * a3 * x;
}

// one Hillis-Steele step of sample t at stride s: rows r -> rows n
template <typename T>
KTT_SVF_FN void step(const T* r, T* n, int B, int t, int s) {
  const bool has = t >= s;
  const int u = t - s;
  const T l00 = has ? r[u] : T(1);
  const T l01 = has ? r[B + u] : T(0);
  const T l10 = has ? r[2 * B + u] : T(0);
  const T l11 = has ? r[3 * B + u] : T(1);
  const T lc0 = has ? r[4 * B + u] : T(0);
  const T lc1 = has ? r[5 * B + u] : T(0);
  const T a00 = r[t], a01 = r[B + t], a10 = r[2 * B + t], a11 = r[3 * B + t];
  const T c0 = r[4 * B + t], c1 = r[5 * B + t];
  n[t] = a00 * l00 + a01 * l10;
  n[B + t] = a00 * l01 + a01 * l11;
  n[2 * B + t] = a10 * l00 + a11 * l10;
  n[3 * B + t] = a10 * l01 + a11 * l11;
  n[4 * B + t] = a00 * lc0 + a01 * lc1 + c0;
  n[5 * B + t] = a10 * lc0 + a11 * lc1 + c1;
}

// the state after sample t from the scanned rows m and the state x0, x1
// before the block
template <typename T>
KTT_SVF_FN void after(const T* m, int B, int t, T x0, T x1, T* s0, T* s1) {
  *s0 = m[t] * x0 + m[B + t] * x1 + m[4 * B + t];
  *s1 = m[2 * B + t] * x0 + m[3 * B + t] * x1 + m[5 * B + t];
}

// the output of sample t (its state before it: s0, s1)
template <typename T>
KTT_SVF_FN T out(T s0, T s1, T a1, T a2, T a3, T m0, T m1, T m2, T x) {
  const T v3 = x - s1;
  const T v1 = a1 * s0 + a2 * v3;
  const T v2 = s1 + a2 * s0 + a3 * v3;
  return m0 * x + m1 * v1 + m2 * v2;
}

}  // namespace svf
