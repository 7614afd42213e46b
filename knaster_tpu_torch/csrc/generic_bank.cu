// Generic fused voice bank for Hopper (sm_90a): one harness templated over a
// voice body, called through ctypes from knaster_tpu_torch/kernels/generic_bank.py.
//
// Replaces knaster_tpu/parallel/generic_bank.py::_generic_kernel, with the
// library voices' mosaic_voice bodies (knaster_tpu/models/voices.py
// SineVoice :87, EnvelopeVoice :221, FMVoice :353, SubtractiveVoice :477,
// AdditiveVoice :833, ModalVoice :1625) as device bodies. The harness does what the Pallas harness does: per
// voice it materializes every float param per sample from its anchored ramp
// group (plus D breakpoint rounds in eventful blocks), reads each trigger's
// bit from its packed words (eventful blocks; event-free blocks have none),
// runs the body on the per-voice carry, multiplies each output by the 0/1
// active gain per sample (not folded into a param), and mixes C channels.
//
// A body is a struct with compile-time counts NF (float params, in the
// voice's param order), NT (triggers), NC (32-bit carry words, in the
// voice's carry order; u32 carries as their bits, f32 carries by
// __float_as_uint) and C (outputs), a constructor over the body constants
// (consts[n_consts] on the device: envelope rates, phase units per Hz, and
// for the additive body A[H], B[H] and thr[H]), and
//   step(i_f, carry[NC], P, T[NT], out[C])
// where P(k) is float param k at this sample. Each body's math is the TPU
// body's, op for op.
//
// Design. One thread per voice (256-thread blocks, ragged tail masked), the
// carry and the ramp groups in registers, a warp shuffle reduction per
// sample and channel into partial[warp][C][B]. What bounds it: the body's
// FP32/SFU issue, as in the hand-written banks.
//
// Numerics. --fmad=false and no fast math, so the carried state is
// bit-equal to the plain harness running the voice's torch body; bodies
// that take cosf/sinf (Sine and Additive pan, the Additive fundamental) may
// differ from torch's by an ulp in the mix only. The Envelope body's
// SINUSOIDAL and EXPONENTIAL shapes take cosf, expf and logf, whose value
// reaches the carried efrom where t_stop freezes a curved segment: there
// the state may differ from torch's by an ulp. The Modal body takes no
// libm call (polynomial exp, sin and cos).
//
// The Modal body's carry is 3 + 2M registers; ModalBody<M> is instantiated
// for M = 1 ... 16 (ptxas -v reports each one's registers and spills).

#include "bank_common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = 256;

__device__ __forceinline__ float as_f(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ uint32_t as_u(float x) { return __float_as_uint(x); }

// P(k): float param k at sample i_f
template <int NF, bool EVENTFUL>
struct Params {
  const Ramp* g;
  const float* __restrict__ rounds;
  float i_f;
  int D, V, v;
  __device__ __forceinline__ float operator()(int k) const {
    return mat<EVENTFUL>(i_f, g[k], rounds, k, D, V, v);
  }
};

// SineVoice.mosaic_voice: SinWt phase + table-quantized sine, EnvAsr, exact
// equal-power pan (cos/sin of the materialized pan every sample)
struct SineBody {
  static constexpr int NF = 3, NT = 2, NC = 4, C = 2;  // freq, amp, pan
  float f2pi, atk, rel;
  __device__ SineBody(const float* __restrict__ k, int)
      : f2pi(k[0]), atk(k[1]), rel(k[2]) {}
  template <class P>
  __device__ __forceinline__ void step(float, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float stage = as_f(c[1]), t = as_f(c[2]), rscale = as_f(c[3]);
    const float env = env_asr(stage, t, rscale, trig[0], trig[1], atk, rel);
    const float sig = sin_quant(c[0]) * (env * p(1));
    c[0] += to_inc(p(0) * f2pi);
    const float angle = (p(2) * 0.5f + 0.5f) * kHalfPi;
    out[0] = sig * cosf(angle);
    out[1] = sig * sinf(angle);
    c[1] = as_u(stage);
    c[2] = as_u(t);
    c[3] = as_u(rscale);
  }
};

// FMVoice.mosaic_voice: the hand FM kernel's math
struct FMBody {
  static constexpr int NF = 4, NT = 1, NC = 4, C = 1;  // freq, ratio, index, amp
  float f2pi, atk, rel;
  __device__ FMBody(const float* __restrict__ k, int)
      : f2pi(k[0]), atk(k[1]), rel(k[2]) {}
  template <class P>
  __device__ __forceinline__ void step(float, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float stage = as_f(c[2]), t = as_f(c[3]);
    const float env = env_ar(stage, t, trig[0], atk, rel);
    const float gain = env * p(3);
    const float freq = p(0);
    const float mod = sin_quant(c[0]);
    c[0] += to_inc(freq * p(1) * f2pi);
    const float car_freq = freq * (1.0f + p(2) * mod);
    const float car = sin_quant(c[1]);
    c[1] += to_inc(car_freq * f2pi);
    out[0] = car * gain;
    c[2] = as_u(stage);
    c[3] = as_u(t);
  }
};

// SubtractiveVoice.mosaic_voice: the hand subtractive kernel's math
struct SubBody {
  static constexpr int NF = 4, NT = 2, NC = 6, C = 1;  // freq, cutoff, q, amp
  float inv_sr, pi_inv_sr, atk, rel;
  __device__ SubBody(const float* __restrict__ k, int)
      : inv_sr(k[0]), pi_inv_sr(k[1]), atk(k[2]), rel(k[3]) {}
  template <class P>
  __device__ __forceinline__ void step(float, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float t = as_f(c[0]), ic1 = as_f(c[1]), ic2 = as_f(c[2]);
    float stage = as_f(c[3]), et = as_f(c[4]), rscale = as_f(c[5]);
    const float env = env_asr(stage, et, rscale, trig[0], trig[1], atk, rel);
    const float dt = fminf(fmaxf(p(0) * inv_sr, 0.0f), 0.5f);
    float tt = t + 0.5f;
    tt = tt - floorf(tt);
    const float saw = 2.0f * tt - 1.0f - blep(tt, dt);
    t = t + dt;
    t = t - floorf(t);
    float a1, a2, a3;
    svf_low_coeffs(pi_inv_sr * p(1), p(2), a1, a2, a3);
    const float v3 = saw - ic2;
    const float v1 = a1 * ic1 + a2 * v3;
    const float v2 = ic2 + a2 * ic1 + a3 * v3;
    ic1 = 2.0f * v1 - ic1;
    ic2 = 2.0f * v2 - ic2;
    out[0] = v2 * (env * p(3));
    c[0] = as_u(t);
    c[1] = as_u(ic1);
    c[2] = as_u(ic2);
    c[3] = as_u(stage);
    c[4] = as_u(et);
    c[5] = as_u(rscale);
  }
};

// AdditiveVoice.mosaic_voice: the hand wavetable kernel's partials, exact
// equal-power pan of the materialized pan every sample
struct AdditiveBody {
  static constexpr int NF = 3, NT = 2, NC = 4, C = 2;  // freq, amp, pan
  float f2pi, atk, rel;
  const float* __restrict__ acoef;
  const float* __restrict__ bcoef;
  const float* __restrict__ thr;
  int H;
  __device__ AdditiveBody(const float* __restrict__ k, int n)
      : f2pi(k[0]), atk(k[1]), rel(k[2]), acoef(k + 3), bcoef(k + 3 + (n - 3) / 3),
        thr(k + 3 + 2 * ((n - 3) / 3)), H((n - 3) / 3) {}
  template <class P>
  __device__ __forceinline__ void step(float, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float stage = as_f(c[1]), t = as_f(c[2]), rscale = as_f(c[3]);
    const float env = env_asr(stage, t, rscale, trig[0], trig[1], atk, rel);
    const float freq = p(0);
    const float theta = theta_full(c[0]);
    const float s1 = sinf(theta);
    const float c1 = cosf(theta);
    c[0] += to_inc(freq * f2pi);
    float s = s1, co = c1;
    float acc = freq <= __ldg(thr) ? __ldg(acoef) * s + __ldg(bcoef) * co : 0.0f;
    for (int h = 1; h < H; ++h) {
      const float sn = s * c1 + co * s1;
      const float cn = co * c1 - s * s1;
      s = sn;
      co = cn;
      const float part = __ldg(acoef + h) * s + __ldg(bcoef + h) * co;
      acc = acc + (freq <= __ldg(thr + h) ? part : 0.0f);
    }
    const float sig = acc * (env * p(1));
    const float angle = (p(2) * 0.5f + 0.5f) * kHalfPi;
    out[0] = sig * cosf(angle);
    out[1] = sig * sinf(angle);
    c[1] = as_u(stage);
    c[2] = as_u(t);
    c[3] = as_u(rscale);
  }
};

// EnvelopeVoice.mosaic_voice: SinWt phase, the multi-segment envelope
// (EnvProgram, the segment table in the constants), polynomial Pan2 gains.
// The carry keeps the running flag folded into eseg (kEnvSegFinished /
// kEnvSegStopped).
struct EnvelopeBody {
  // freq, amp, pan, time_scale; t_restart, t_stop; phase, eseg, et, efrom
  static constexpr int NF = 4, NT = 2, NC = 4, C = 2;
  static constexpr int kHead = 10;  // constants before the segment table
  float f2pi, base_scale;
  EnvProgram prog;
  // k: f2pi, 1/sr, start value, looping, S, n_present, present[4], then
  // recip[S], dur[S], val[S], shape[S]
  __device__ EnvelopeBody(const float* __restrict__ k, int)
      : f2pi(k[0]), base_scale(k[1]) {
    const int S = static_cast<int>(k[4]);
    prog.start_v = k[2];
    prog.looping = k[3] != 0.0f;
    prog.S = S;
    prog.n_present = static_cast<int>(k[5]);
    prog.present = k + 6;
    prog.recip = k + kHead;
    prog.dur = k + kHead + S;
    prog.val = k + kHead + 2 * S;
    prog.shape = k + kHead + 3 * S;
  }
  template <class P>
  __device__ __forceinline__ void step(float, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    const float dt = p(3) * base_scale;
    float eseg = as_f(c[1]), et = as_f(c[2]), efrom = as_f(c[3]);
    const float env = prog.step(eseg, et, efrom, dt, trig[0], trig[1]);
    const float sig = sin_quant(c[0]) * (env * p(1));
    c[0] += to_inc(p(0) * f2pi);
    const float angle = (p(2) * 0.5f + 0.5f) * kHalfPi;
    out[0] = sig * sin_poly(kHalfPi - angle);
    out[1] = sig * sin_poly(angle);
    c[1] = as_u(eseg);
    c[2] = as_u(et);
    c[3] = as_u(efrom);
  }
};

// ModalVoice.mosaic_voice with M modes: an EnvAr mallet into M
// rotation-decay modes s' = R(theta) s + (x, 0), per-mode decay from
// exp_poly with 1/decay taken once per sample, the rotation from
// sincos_halfturn, dead modes (theta >= pi) at r = 0, polynomial Pan2.
// The carry: stage, t, struck, then s{m}a, s{m}b per mode.
template <int M>
struct ModalBody {
  // freq, amp, pan, decay; t_strike
  static constexpr int NF = 4, NT = 1, NC = 3 + 2 * M, C = 2;
  static constexpr int kHead = 6;  // atk, rel, 1/area, 2pi/sr, thr^2, M
  float atk, rel, inv_area, c2pi;
  const float* __restrict__ ratio;
  const float* __restrict__ k_exp;
  const float* __restrict__ gain;
  __device__ ModalBody(const float* __restrict__ k, int)
      : atk(k[0]), rel(k[1]), inv_area(k[2]), c2pi(k[3]), ratio(k + kHead),
        k_exp(k + kHead + M), gain(k + kHead + 2 * M) {}
  template <class P>
  __device__ __forceinline__ void step(float, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float stage = as_f(c[0]), t = as_f(c[1]), struck = as_f(c[2]);
    const float pulse = env_ar(stage, t, trig[0], atk, rel);
    if (trig[0]) struck = fmaxf(struck, 1.0f);
    const float x = pulse * (p(1) * inv_area);
    const float inv_decay = 1.0f / p(3);
    const float freq = p(0);
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float theta = c2pi * (freq * __ldg(ratio + m));
      float r = exp_poly(__ldg(k_exp + m) * inv_decay);
      r = theta < kPi ? r : 0.0f;
      float sth_u, cth_u;
      sincos_halfturn(theta, sth_u, cth_u);
      const float cth = r * cth_u;
      const float sth = r * sth_u;
      const float s0 = as_f(c[3 + 2 * m]), s1 = as_f(c[4 + 2 * m]);
      const float s0n = cth * s0 - sth * s1 + x;
      const float s1n = sth * s0 + cth * s1;
      c[3 + 2 * m] = as_u(s0n);
      c[4 + 2 * m] = as_u(s1n);
      acc = acc + __ldg(gain + m) * s1n;
    }
    const float angle = (p(2) * 0.5f + 0.5f) * kHalfPi;
    out[0] = acc * sin_poly(kHalfPi - angle);
    out[1] = acc * sin_poly(angle);
    c[0] = as_u(stage);
    c[1] = as_u(t);
    c[2] = as_u(struck);
  }
};

constexpr int kEnvelopeId = 4;
constexpr int kModalId0 = 4;  // ModalBody<M> is body kModalId0 + M
constexpr int kMaxModes = 16;

template <class Body, bool EVENTFUL>
__global__ void __launch_bounds__(kThreads)
generic_bank_kernel(const float* __restrict__ ramps, const float* __restrict__ rounds,
                    const float* __restrict__ act, const uint32_t* __restrict__ words,
                    const uint32_t* __restrict__ carry_in,
                    const float* __restrict__ consts, float* __restrict__ partial,
                    uint32_t* __restrict__ carry_out, int V, int B, int D,
                    int n_consts) {
  constexpr int NF = Body::NF, NT = Body::NT, NC = Body::NC, C = Body::C;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int warp = v >> 5;
  const int lane = threadIdx.x & 31;
  // whole warps past the bank exit together (the shuffles need full warps)
  if ((warp << 5) >= V) return;
  const bool valid = v < V;
  const int vv = valid ? v : 0;  // ragged lanes read voice 0, contribute 0

  Ramp g[NF];
#pragma unroll
  for (int k = 0; k < NF; ++k) g[k] = load_ramp(ramps, k, V, vv);
  uint32_t c[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) c[k] = carry_in[static_cast<size_t>(k) * V + vv];
  const float a = act[vv];
  const Body body(consts, n_consts);
  const int W = (B + 31) >> 5;
  uint32_t w[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) w[k] = 0u;
  float* out = partial + static_cast<size_t>(warp) * C * B;

  for (int i = 0; i < B; ++i) {
    const float i_f = static_cast<float>(i);
    bool trig[NT];
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (EVENTFUL && (i & 31) == 0) w[k] = load_word(words, k, W, i >> 5, V, vv);
      trig[k] = EVENTFUL && trig_bit(w[k], i);
    }
    const Params<NF, EVENTFUL> p{g, rounds, i_f, D, V, vv};
    float o[C];
    body.step(i_f, c, p, trig, o);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float s = warp_sum(valid ? o[ch] * a : 0.0f);
      if (lane == 0) out[static_cast<size_t>(ch) * B + i] = s;
    }
  }
  if (valid) {
#pragma unroll
    for (int k = 0; k < NC; ++k) carry_out[static_cast<size_t>(k) * V + v] = c[k];
  }
}

template <class Body>
cudaError_t launch_body(const float* ramps, const float* rounds, const float* act,
                        const uint32_t* words, const uint32_t* carry_in,
                        const float* consts, float* partial, uint32_t* carry_out, int V,
                        int B, int D, int eventful, int n_consts, cudaStream_t s) {
  const dim3 grid((V + kThreads - 1) / kThreads);
  if (eventful) {
    generic_bank_kernel<Body, true><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, carry_in, consts, partial, carry_out, V, B, D,
        n_consts);
  } else {
    generic_bank_kernel<Body, false><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, carry_in, consts, partial, carry_out, V, B, D,
        n_consts);
  }
  return cudaGetLastError();
}

// ModalBody<m> for the run-time mode count m in [M, kMaxModes]
template <int M>
cudaError_t launch_modal(int m, const float* ramps, const float* rounds, const float* act,
                         const uint32_t* words, const uint32_t* carry_in,
                         const float* consts, float* partial, uint32_t* carry_out, int V,
                         int B, int D, int eventful, int n_consts, cudaStream_t s) {
  if constexpr (M > kMaxModes) {
    return cudaErrorInvalidValue;
  } else {
    if (m != M) {
      return launch_modal<M + 1>(m, ramps, rounds, act, words, carry_in, consts, partial,
                                 carry_out, V, B, D, eventful, n_consts, s);
    }
    return launch_body<ModalBody<M>>(ramps, rounds, act, words, carry_in, consts, partial,
                                     carry_out, V, B, D, eventful, n_consts, s);
  }
}

}  // namespace

extern "C" {

// Launches one block of the bank with device body `body` (0 Sine, 1 FM,
// 2 Subtractive, 3 Additive, 4 Envelope, 4 + M Modal with M = 1 ... 16
// modes) on `stream`; returns cudaGetLastError().
// rounds/words are read only when `eventful` is non-zero; carry_in/out are
// [NC][V] 32-bit words, partial is [ceil(V/32)][C][B].
int ktt_generic_bank(int body, const float* ramps, const float* rounds,
                     const float* act, const uint32_t* words, const uint32_t* carry_in,
                     const float* consts, float* partial, uint32_t* carry_out, int V,
                     int B, int D, int eventful, int n_consts, void* stream) {
  if (V < 1 || B < 1 || (eventful && D < 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (body) {
    case 0:
      if (n_consts != 3) return static_cast<int>(cudaErrorInvalidValue);
      err = launch_body<SineBody>(ramps, rounds, act, words, carry_in, consts, partial,
                                  carry_out, V, B, D, eventful, n_consts, s);
      break;
    case 1:
      if (n_consts != 3) return static_cast<int>(cudaErrorInvalidValue);
      err = launch_body<FMBody>(ramps, rounds, act, words, carry_in, consts, partial,
                                carry_out, V, B, D, eventful, n_consts, s);
      break;
    case 2:
      if (n_consts != 4) return static_cast<int>(cudaErrorInvalidValue);
      err = launch_body<SubBody>(ramps, rounds, act, words, carry_in, consts, partial,
                                 carry_out, V, B, D, eventful, n_consts, s);
      break;
    case 3:
      if (n_consts < 6 || (n_consts - 3) % 3 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = launch_body<AdditiveBody>(ramps, rounds, act, words, carry_in, consts,
                                      partial, carry_out, V, B, D, eventful, n_consts, s);
      break;
    case kEnvelopeId: {
      const int S = n_consts > EnvelopeBody::kHead ? (n_consts - EnvelopeBody::kHead) / 4 : 0;
      if (S < 1 || n_consts != EnvelopeBody::kHead + 4 * S) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = launch_body<EnvelopeBody>(ramps, rounds, act, words, carry_in, consts,
                                      partial, carry_out, V, B, D, eventful, n_consts, s);
      break;
    }
    default: {
      const int M = body - kModalId0;
      if (M < 1 || M > kMaxModes || n_consts != 6 + 4 * M) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = launch_modal<1>(M, ramps, rounds, act, words, carry_in, consts, partial,
                            carry_out, V, B, D, eventful, n_consts, s);
    }
  }
  return static_cast<int>(err);
}

}  // extern "C"
