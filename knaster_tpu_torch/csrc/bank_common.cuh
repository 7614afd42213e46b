// Device pieces every fused voice-bank kernel shares: the counterparts of
// the in-kernel helpers of knaster_tpu/parallel/pallas_bank.py and of the
// plain torch helpers in knaster_tpu_torch/kernels/bank_common.py.
//
// Layout every bank kernel reads. One thread per voice. Float params arrive
// as anchored ramp groups ramps[n_float][5][V] (v0, step, el, dur, tgt);
// eventful blocks add D breakpoint rounds rounds[n_float][5][D][V] (v0,
// step, dur, tgt, frame) and packed trigger words words[n_trig][W][V], W =
// ceil(B/32). The mix leaves as warp partials partial[ceil(V/32)][C][B],
// summed by the wrapper.
//
// Numerics. Every library is built with --fmad=false and no fast math: each
// multiply and add rounds on its own and divides are IEEE divides, as in the
// plain torch versions and XLA at optimization level 0, so carried state is
// bit-equal to the plain versions'. Expressions keep Python's left-to-right
// association.
//
// Each kernel library is one translation unit that includes this header
// once, so the extern "C" ktt_error_string below is defined once per library.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace ktt {

constexpr int kGroup = 5;  // floats per ramp group / breakpoint group

constexpr uint32_t kTableSize = 16384u;
constexpr uint32_t kTableHighMask = kTableSize - 1u;
constexpr uint32_t kCycle = 1u << 30;  // TABLE_SIZE * FRACTIONAL_PART phase units

// np.float32 values of the JAX package's constants, written exactly
constexpr float kIdxScale = 0x1.921fb6p-12f;  // 2*pi / 16384
constexpr float kU2Rad = 0x1.921fb6p-28f;     // 2*pi / 2^30
constexpr float kHalfPi = 0x1.921fb6p+0f;     // pi / 2
constexpr float kToIncMax = 0x1.fffffep+30f;  // 2^31 - 128
constexpr float kMinDt = 0x1.12e0bep-30f;     // np.float32(1e-9)
constexpr float kC0 = 1.0f;
constexpr float kC1 = -0x1.555542p-3f;   // -0.16666652
constexpr float kC2 = 0x1.110df8p-7f;    // 0.008332964
constexpr float kC3 = -0x1.9f55f4p-13f;  // -0.00019804752
constexpr float kC4 = 0x1.5cb622p-19f;   // 2.5981028e-06

__device__ __forceinline__ float sin_poly(float u) {
  const float u2 = u * u;
  float p = kC4 * u2 + kC3;
  p = p * u2 + kC2;
  p = p * u2 + kC1;
  return (p * u2 + kC0) * u;
}

// SinWt's table-quantized sine: the 16384-grid index folded to the first
// quadrant by integer identities, then the degree-9 odd polynomial
__device__ __forceinline__ float sin_quant(uint32_t phase) {
  const uint32_t idx = (phase >> 16) & kTableHighMask;
  const uint32_t half = idx & (kTableSize / 2u - 1u);
  const bool neg = idx >= kTableSize / 2u;
  const uint32_t m = half > kTableSize / 4u ? kTableSize / 2u - half : half;
  const float p = sin_poly(static_cast<float>(static_cast<int32_t>(m)) * kIdxScale);
  return neg ? -p : p;
}

// AdditiveVoice's full-resolution phase angle (mod one cycle)
__device__ __forceinline__ float theta_full(uint32_t phase) {
  return static_cast<float>(static_cast<int32_t>(phase & (kCycle - 1u))) * kU2Rad;
}

__device__ __forceinline__ uint32_t to_inc(float x) {
  // jnp.clip(x, 0, 2^31 - 128) then int32 truncation, reinterpreted as u32
  x = fminf(fmaxf(x, 0.0f), kToIncMax);
  return static_cast<uint32_t>(static_cast<int32_t>(x));
}

struct Ramp {
  float v0, step, el, dur, tgt;
};

__device__ __forceinline__ Ramp load_ramp(const float* __restrict__ ramps,
                                          int p, int V, int v) {
  const float* g = ramps + static_cast<size_t>(p) * kGroup * V + v;
  return Ramp{g[0], g[static_cast<size_t>(V)], g[2 * static_cast<size_t>(V)],
              g[3 * static_cast<size_t>(V)], g[4 * static_cast<size_t>(V)]};
}

__device__ __forceinline__ float mat_base(float i_f, const Ramp& g) {
  const float prog = i_f + g.el;
  return prog >= g.dur ? g.tgt : g.v0 + g.step * prog;
}

// breakpoint rounds [n_float][5][D][V]: piece r wins from its frame on
__device__ __forceinline__ float mat_rounds(float i_f, float acc,
                                            const float* __restrict__ rounds,
                                            int p, int D, int V, int v) {
  const size_t plane = static_cast<size_t>(D) * V;
  const float* g = rounds + static_cast<size_t>(p) * kGroup * plane + v;
  for (int r = 0; r < D; ++r) {
    const float* gr = g + static_cast<size_t>(r) * V;
    const float rv0 = __ldg(gr);
    const float rstep = __ldg(gr + plane);
    const float rdur = __ldg(gr + 2 * plane);
    const float rtgt = __ldg(gr + 3 * plane);
    const float rframe = __ldg(gr + 4 * plane);
    const float ln = i_f - rframe;
    const float val = ln >= rdur ? rtgt : rv0 + rstep * ln;
    acc = i_f >= rframe ? val : acc;
  }
  return acc;
}

// the materialized float param p at sample i_f: base ramp, then (eventful)
// the breakpoint rounds
template <bool EVENTFUL>
__device__ __forceinline__ float mat(float i_f, const Ramp& g,
                                     const float* __restrict__ rounds, int p,
                                     int D, int V, int v) {
  const float base = mat_base(i_f, g);
  return EVENTFUL ? mat_rounds(i_f, base, rounds, p, D, V, v) : base;
}

// packed trigger words: word w of trigger k holds frames [32w, 32w+32);
// a thread keeps the current word of each trigger in a register
__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ words,
                                              int k, int W, int w, int V, int v) {
  return words[(static_cast<size_t>(k) * W + w) * V + v];
}

__device__ __forceinline__ bool trig_bit(uint32_t word, int i) {
  return (word >> (i & 31)) & 1u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// EnvAsr state machine (stages: 0 stop, 1 atk, 2 sus, 3 rel). With restart
// and release false it is the event-free variant (_env_asr_free). Updates
// stage, t and rscale; returns the envelope value.
__device__ __forceinline__ float env_asr(float& stage, float& t, float& rscale,
                                         bool restart, bool release, float atk,
                                         float rel) {
  if (restart) stage = 1.0f;
  const bool rel_from_atk = release && stage == 1.0f;
  const bool rel_from_sus = release && stage == 2.0f;
  rscale = rel_from_atk ? t : (rel_from_sus ? 1.0f : rscale);
  if (rel_from_atk || rel_from_sus) {
    t = 1.0f;
    stage = 3.0f;
  }
  const float env = stage == 1.0f ? t
                  : stage == 2.0f ? 1.0f
                  : stage == 3.0f ? t * t * t * rscale
                  : 0.0f;
  float t_next = stage == 1.0f ? t + atk : (stage == 3.0f ? t - rel : t);
  const bool to_sus = stage == 1.0f && t_next >= 1.0f;
  if (to_sus) t_next = 1.0f;  // pin sustain t
  const bool done = stage == 3.0f && t_next <= 0.0f;
  if (to_sus) stage = 2.0f;
  if (done) {
    stage = 0.0f;
    t_next = 0.0f;
  }
  t = t_next;
  return env;
}

// EnvAr state machine (stages: 0 stopped, 1 attack, 2 release), no sustain.
// restart false is the event-free variant (_env_ar_free). Note that `done`
// excludes the sample that just entered release (~to_rel), which EnvAsr's
// has no counterpart of.
__device__ __forceinline__ float env_ar(float& stage, float& t, bool restart,
                                        float atk, float rel) {
  if (restart) stage = 1.0f;
  const float env = stage == 1.0f ? t : (stage == 2.0f ? t * t * t : 0.0f);
  float t_next = stage == 1.0f ? t + atk : (stage == 2.0f ? t - rel : t);
  const bool to_rel = stage == 1.0f && t_next >= 1.0f;
  if (to_rel) {
    stage = 2.0f;
    t_next = 1.0f;
  }
  const bool done = stage == 2.0f && !to_rel && t_next <= 0.0f;
  if (done) {
    stage = 0.0f;
    t_next = 0.0f;
  }
  t = t_next;
  return env;
}

// SVF lowpass coefficients in the one-divide form (pallas_bank
// _svf_low_coeffs): s = sin(x), c = cos(x) by the odd polynomial,
// a1 = d*c^2, a2 = d*s*c, a3 = d*s^2 with d = q / (q + s*c)
__device__ __forceinline__ void svf_low_coeffs(float x, float q, float& a1,
                                               float& a2, float& a3) {
  const float s = sin_poly(x);
  const float c = sin_poly(kHalfPi - x);
  const float sc = s * c;
  const float d = q / (q + sc);
  a1 = d * (c * c);
  a2 = d * sc;
  a3 = d * (s * s);
}

// polyBLEP residual of the saw (polyblep.rs)
__device__ __forceinline__ float blep(float t, float dt) {
  const float safe_dt = fmaxf(dt, kMinDt);
  const float a = t / safe_dt - 1.0f;
  const float b = (t - 1.0f) / safe_dt + 1.0f;
  return t < dt ? -(a * a) : (t > 1.0f - dt ? b * b : 0.0f);
}

constexpr float kPi = 0x1.921fb6p+1f;  // np.float32(np.pi)

// degree-5 fit of 2^f on [-0.5, 0.5] (pallas_bank _EXP2_C)
constexpr float kExp2C0 = 0x1.5f48c8p-10f;  // 0.0013400433
constexpr float kExp2C1 = 0x1.3d107cp-7f;   // 0.009676037
constexpr float kExp2C2 = 0x1.c6aeccp-5f;   // 0.05550327
constexpr float kExp2C3 = 0x1.ebf906p-3f;   // 0.24022107
constexpr float kExp2C4 = 0x1.62e430p-1f;   // 0.6931472
constexpr float kExp2C5 = 0x1.000002p+0f;   // 1.0000001
constexpr float kLog2E = 0x1.715476p+0f;    // np.float32(log2(e))
constexpr float kTiny = 0x1.197998p-40f;    // np.float32(1e-12)

// exp(x) for x <= 0 (pallas_bank _exp_poly): x*log2(e) = n + f, n rounded
// half to even, 2^n in the exponent field with n clamped to [-126, 0], 2^f
// by the polynomial. The max keeps jnp.maximum's NaN.
__device__ __forceinline__ float exp_poly(float x) {
  float z = x * kLog2E;
  z = z < -126.0f ? -126.0f : z;
  const float n = rintf(z);
  const float f = z - n;
  float p = kExp2C0;
  p = p * f + kExp2C1;
  p = p * f + kExp2C2;
  p = p * f + kExp2C3;
  p = p * f + kExp2C4;
  p = p * f + kExp2C5;
  const int n_i = static_cast<int>(fminf(fmaxf(n, -126.0f), 0.0f));
  return __int_as_float((n_i + 127) << 23) * p;
}

// (sin, cos) of theta in [0, pi] (pallas_bank _sincos_halfturn)
__device__ __forceinline__ void sincos_halfturn(float theta, float& s, float& c) {
  const float folded = kPi - theta;
  s = sin_poly(theta < folded ? theta : folded);
  c = sin_poly(kHalfPi - theta);
}

// the multi-segment Envelope (pallas_bank _make_env_multiseg), its running
// flag folded into seg as these sentinels
constexpr float kEnvSegFinished = -1.0f;  // a non-looping program ran out
constexpr float kEnvSegStopped = -2.0f;   // t_stop froze the value

enum EnvShape { kLinear = 0, kExponential = 1, kSinusoidal = 2, kStep = 3 };

// _segment_value's formula for one shape over the selected constants
__device__ __forceinline__ float env_shape_eval(int shape, float from_v, float val,
                                                float frac) {
  switch (shape) {
    case kLinear:
      return from_v + frac * (val - from_v);
    case kSinusoidal:
      return from_v + (val - from_v) * (1.0f - cosf(kPi * frac)) * 0.5f;
    case kStep:
      return val;
    default: {  // kExponential: geometric for same signs, else linear
      const float lin = from_v + frac * (val - from_v);
      const float fa = fmaxf(fabsf(from_v), kTiny);
      const float ta = fmaxf(fabsf(val), kTiny);
      const float sgn = from_v > 0.0f ? 1.0f : (from_v < 0.0f ? -1.0f : 0.0f);
      const float geo = sgn * fa * expf(frac * logf(ta / fa));
      return from_v * val > 0.0f ? geo : lin;
    }
  }
}

// An envelope program in the body constants: S segments as recip[S],
// dur[S], val[S], shape[S] (codes as floats), the distinct shapes present
// in first-segment order, the start value and the looping flag.
struct EnvProgram {
  const float* __restrict__ recip;
  const float* __restrict__ dur;
  const float* __restrict__ val;
  const float* __restrict__ shape;
  const float* __restrict__ present;
  int S, n_present;
  float start_v;
  bool looping;

  // One sample: the triggers, the segment-constant selects (a loop over
  // S), each present shape once, t_stop's freeze, then the transitions.
  // Updates seg, t and from_v; returns the envelope value.
  __device__ __forceinline__ float step(float& seg, float& t, float& from_v, float dt,
                                        bool restart, bool stop) const {
    if (restart) {
      seg = 0.0f;
      t = 0.0f;
      from_v = start_v;
    }
    float r = __ldg(recip), d = __ldg(dur), v = __ldg(val);
    int sh = static_cast<int>(__ldg(shape));
    for (int s = 1; s < S; ++s) {
      if (seg == static_cast<float>(s)) {
        r = __ldg(recip + s);
        d = __ldg(dur + s);
        v = __ldg(val + s);
        sh = static_cast<int>(__ldg(shape + s));
      }
    }
    const float frac = fminf(fmaxf(t * r, 0.0f), 1.0f);
    float cur = env_shape_eval(static_cast<int>(__ldg(present)), from_v, v, frac);
    for (int j = 1; j < n_present; ++j) {
      const int pj = static_cast<int>(__ldg(present + j));
      const float e = env_shape_eval(pj, from_v, v, frac);
      if (sh == pj) cur = e;
    }
    if (stop && seg >= 0.0f) {
      from_v = cur;
      seg = kEnvSegStopped;
    }
    const bool is_run = seg >= 0.0f;
    const bool in_seg = t < d;
    const bool has_next = seg + 1.0f < static_cast<float>(S);
    const float out = is_run ? (in_seg ? cur : v) : from_v;
    const bool adv = is_run && !in_seg && has_next;
    const bool fin = is_run && !in_seg && !has_next;
    if (adv || fin) from_v = v;
    t = (is_run && in_seg) ? t + dt : (adv ? t - d + dt : t);
    if (adv) seg = seg + 1.0f;
    if (fin) {
      if (looping) {
        seg = 0.0f;
        t = 0.0f;
      } else {
        seg = kEnvSegFinished;
      }
    }
    return out;
  }
};

}  // namespace ktt

extern "C" const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
