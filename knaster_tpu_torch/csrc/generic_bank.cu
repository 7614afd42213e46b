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
// __float_as_uint), C (outputs) and kPan (the pan param of a stereo body
// whose outputs are one signal times its pan gains, or -1); a Consts struct,
// its constants, which reach the kernel by value as a __grid_constant__
// parameter packed on the host (kernels/generic_bank.py const_image);
//   hoist(k, ramps, B), what it takes once an event-free block; and
//   step(k, carry[NC], P, T[NT], out[C])
// where P(k) is float param k at this sample. A stereo body writes its
// signal to out[0] and the harness applies pan_gains(pan). Each body's math
// is the TPU body's, op for op.
//
// Design. One thread per voice in 256-thread CTAs, the carry and the ramp
// groups in registers, at most 64 registers (80 or 128 for the Modal body,
// 96 for the Subtractive body's eventful blocks, where that measured
// faster) so that a 131,072-voice bank's 512 CTAs run in one wave. What
// bounds it: the body's FP32/SFU issue, as in the hand-written banks. What
// the design does about it:
// - the mix (bank_common.cuh): an event-free block stores each sample's C
//   values into a shared-memory tile of 16 (channel, sample) columns and
//   the CTA sums each column after one barrier a tile (CtaMix: a store a
//   value and a quarter of a 16-byte load, where a warp shuffle sum takes
//   five shuffles and five adds a value); an eventful block keeps the warp
//   shuffle into a row per warp (its breakpoint re-reads need the L1 cache
//   the tile would take) and sums the warp rows once at the end; then the
//   kernel sums the CTA rows itself in a fixed order (mix_finish), so no
//   reduction launch follows;
// - the constants: the Additive body's A, B and thresholds (padded to its
//   instantiation HMAX in 8, 16, 32, 64) and the Modal body's per-mode
//   constants are kernel parameters read as constant-bank operands by fully
//   unrolled loops; the Envelope body's segment table is staged once per
//   CTA into shared memory and selected by index (one 16-byte read a
//   sample), each present shape evaluated only where a lane of the warp
//   selects it;
// - hoists: in an event-free block, what reads only params that are flat
//   over the block (bank_common.cuh ramp_flat) is taken once, from their
//   values at sample 0: a stereo body's pan gains and the Subtractive
//   body's SVF coefficients; the Additive body takes sincosf once a sample.
// Whole warps past the bank skip the body and only join the CTA's barriers;
// ragged lanes read voice 0 and contribute 0.
//
// Numerics. --fmad=false and no fast math, so the carried state is
// bit-equal to the plain harness running the voice's torch body; bodies
// that take cosf/sinf/sincosf (Sine and Additive pan, the Additive
// fundamental) may differ from torch's by an ulp in the mix only. The
// Envelope body's SINUSOIDAL and EXPONENTIAL shapes take cosf, expf and
// logf, whose value reaches the carried efrom where t_stop freezes a curved
// segment: there the state may differ from torch's by an ulp. The Modal
// body takes no libm call (polynomial exp, sin and cos). The mix is the
// same terms as the plain version's torch.sum in another, fixed, order.
//
// The Modal body's carry is 3 + 2M registers; ModalBody<M> is instantiated
// for M = 1 ... 16, AdditiveBody<HMAX> for HMAX = 8, 16, 32, 64 (ptxas -v
// reports each one's registers and spills; an AdditiveVoice of more than
// 64 harmonics has no CUDA body).

#include <cstring>

#include "bank_common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = kMixThreads;

__device__ __forceinline__ float as_f(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ uint32_t as_u(float x) { return __float_as_uint(x); }

// P(k): float param k at sample i_f
template <int NF, bool EVENTFUL>
struct Params {
  static constexpr bool kEventful = EVENTFUL;
  const Ramp* g;
  const float* __restrict__ rounds;
  float i_f;
  int D, V, v;
  __device__ __forceinline__ float operator()(int k) const {
    return mat<EVENTFUL>(i_f, g[k], rounds, k, D, V, v);
  }
};

__device__ __forceinline__ float pan_angle(float pan) { return (pan * 0.5f + 0.5f) * kHalfPi; }

// Pan2's exact equal-power gains (Sine, Additive)
struct ExactPan {
  static __device__ __forceinline__ void pan_gains(float pan, float& l, float& r) {
    const float angle = pan_angle(pan);
    l = cosf(angle);
    r = sinf(angle);
  }
};

// Pan2's polynomial gains (Envelope, Modal)
struct PolyPan {
  static __device__ __forceinline__ void pan_gains(float pan, float& l, float& r) {
    const float angle = pan_angle(pan);
    l = sin_poly(kHalfPi - angle);
    r = sin_poly(angle);
  }
};

// at most 64 registers, so that four CTAs share an SM and a 131,072-voice
// bank's 512 CTAs run in one wave (the Modal body overrides it, the
// Subtractive body for its eventful blocks)
struct FourCtas {
  static constexpr int kMinBlocks = 4, kMinBlocksEventful = 4;
};

// nothing taken once a block
struct NoHoist {
  template <class K>
  __device__ __forceinline__ void hoist(const K&, const Ramp*, int) {}
};

// no shared-memory table
struct NoTable {
  static constexpr bool kTable = false;
  template <class K>
  static size_t table_bytes(const K&, int) { return 0; }
};

// SineVoice.mosaic_voice: SinWt phase + table-quantized sine, EnvAsr, exact
// equal-power pan
struct SineBody : ExactPan, NoTable, NoHoist, FourCtas {
  static constexpr int NF = 3, NT = 2, NC = 4, C = 2, kPan = 2;  // freq, amp, pan
  struct Consts {
    float f2pi, atk, rel;
  };
  __device__ SineBody(const Consts&, const float4*) {}
  template <class P>
  __device__ __forceinline__ void step(const Consts& k, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float stage = as_f(c[1]), t = as_f(c[2]), rscale = as_f(c[3]);
    const float env = env_asr(stage, t, rscale, trig[0], trig[1], k.atk, k.rel);
    out[0] = sin_quant(c[0]) * (env * p(1));
    c[0] += to_inc(p(0) * k.f2pi);
    c[1] = as_u(stage);
    c[2] = as_u(t);
    c[3] = as_u(rscale);
  }
};

// FMVoice.mosaic_voice: the hand FM kernel's math
struct FMBody : NoTable, NoHoist, FourCtas {
  static constexpr int NF = 4, NT = 1, NC = 4, C = 1, kPan = -1;  // freq, ratio, index, amp
  struct Consts {
    float f2pi, atk, rel;
  };
  __device__ FMBody(const Consts&, const float4*) {}
  template <class P>
  __device__ __forceinline__ void step(const Consts& k, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float stage = as_f(c[2]), t = as_f(c[3]);
    const float env = env_ar(stage, t, trig[0], k.atk, k.rel);
    const float gain = env * p(3);
    const float freq = p(0);
    const float mod = sin_quant(c[0]);
    c[0] += to_inc(freq * p(1) * k.f2pi);
    const float car_freq = freq * (1.0f + p(2) * mod);
    const float car = sin_quant(c[1]);
    c[1] += to_inc(car_freq * k.f2pi);
    out[0] = car * gain;
    c[2] = as_u(stage);
    c[3] = as_u(t);
  }
};

// SubtractiveVoice.mosaic_voice: the hand subtractive kernel's math
struct SubBody : NoTable, FourCtas {
  static constexpr int NF = 4, NT = 2, NC = 6, C = 1, kPan = -1;  // freq, cutoff, q, amp
  // its eventful blocks (three IEEE divides and 60 breakpoint words a
  // sample) ran 3-7% faster unbounded, at 96 registers and two CTAs an SM,
  // than at 64 and four
  static constexpr int kMinBlocksEventful = 1;
  struct Consts {
    float inv_sr, pi_inv_sr, atk, rel;
  };
  // event-free: the SVF coefficients once a block where cutoff and q are
  // flat (ramp_flat), from their values at sample 0
  bool coef_flat = false;
  float a1h = 0.0f, a2h = 0.0f, a3h = 0.0f;
  __device__ SubBody(const Consts&, const float4*) {}
  __device__ __forceinline__ void hoist(const Consts& k, const Ramp* g, int B) {
    coef_flat = ramp_flat(g[1], B) && ramp_flat(g[2], B);
    if (coef_flat) {
      svf_low_coeffs(k.pi_inv_sr * mat_base(0.0f, g[1]), mat_base(0.0f, g[2]), a1h, a2h, a3h);
    }
  }
  template <class P>
  __device__ __forceinline__ void step(const Consts& k, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float t = as_f(c[0]), ic1 = as_f(c[1]), ic2 = as_f(c[2]);
    float stage = as_f(c[3]), et = as_f(c[4]), rscale = as_f(c[5]);
    const float env = env_asr(stage, et, rscale, trig[0], trig[1], k.atk, k.rel);
    const float dt = fminf(fmaxf(p(0) * k.inv_sr, 0.0f), 0.5f);
    float tt = t + 0.5f;
    tt = tt - floorf(tt);
    const float saw = 2.0f * tt - 1.0f - blep(tt, dt);
    t = t + dt;
    t = t - floorf(t);
    float a1 = a1h, a2 = a2h, a3 = a3h;
    if (P::kEventful || !coef_flat) svf_low_coeffs(k.pi_inv_sr * p(1), p(2), a1, a2, a3);
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

// AdditiveVoice.mosaic_voice: the hand wavetable kernel's partials
// (bank_common.cuh additive_partials) over HMAX instantiated harmonics, H
// of them live; exact equal-power pan
template <int HMAX>
struct AdditiveBody : ExactPan, NoTable, NoHoist, FourCtas {
  static constexpr int NF = 3, NT = 2, NC = 4, C = 2, kPan = 2;  // freq, amp, pan
  struct Consts {
    float f2pi, atk, rel, H;
    Harmonics<HMAX> h;
  };
  int H;
  __device__ AdditiveBody(const Consts& k, const float4*) : H(static_cast<int>(k.H)) {}
  template <class P>
  __device__ __forceinline__ void step(const Consts& k, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float stage = as_f(c[1]), t = as_f(c[2]), rscale = as_f(c[3]);
    const float env = env_asr(stage, t, rscale, trig[0], trig[1], k.atk, k.rel);
    const float freq = p(0);
    const float acc = additive_partials<HMAX>(freq, theta_full(c[0]), k.h, H);
    c[0] += to_inc(freq * k.f2pi);
    out[0] = acc * (env * p(1));
    c[1] = as_u(stage);
    c[2] = as_u(t);
    c[3] = as_u(rscale);
  }
};

// EnvelopeVoice.mosaic_voice: SinWt phase, the multi-segment envelope
// (EnvProgram, its segment table staged into shared memory from the device
// constants), polynomial Pan2 gains. The carry keeps the running flag
// folded into eseg (kEnvSegFinished / kEnvSegStopped).
struct EnvelopeBody : PolyPan, NoHoist, FourCtas {
  // freq, amp, pan, time_scale; t_restart, t_stop; phase, eseg, et, efrom
  static constexpr int NF = 4, NT = 2, NC = 4, C = 2, kPan = 2;
  static constexpr int kHead = 10;  // device constants before the segment table
  static constexpr bool kTable = true;
  // the device constants' head: f2pi, 1/sr, start value, looping, S,
  // n_present, present[4]; then recip[S], dur[S], val[S], shape[S]
  struct Consts {
    float f2pi, base_scale, start_v, looping, S, n_present, present[4];
  };
  static size_t table_bytes(const Consts&, int n_consts) {
    return static_cast<size_t>((n_consts - kHead) / 4) * sizeof(float4);
  }
  static __device__ __forceinline__ void stage_table(const Consts& k, const float* consts,
                                                     float4* table) {
    const int S = static_cast<int>(k.S);
    const float* seg = consts + kHead;
    for (int s = threadIdx.x; s < S; s += kThreads) {
      table[s] = make_float4(seg[s], seg[S + s], seg[2 * S + s], seg[3 * S + s]);
    }
  }
  EnvProgram prog;
  __device__ EnvelopeBody(const Consts& k, const float4* table) {
    prog.table = table;
    prog.S = static_cast<int>(k.S);
    prog.present = 0u;
    for (int j = 0; j < static_cast<int>(k.n_present); ++j) {
      prog.present |= 1u << static_cast<int>(k.present[j]);
    }
    prog.start_v = k.start_v;
    prog.looping = k.looping != 0.0f;
  }
  template <class P>
  __device__ __forceinline__ void step(const Consts& k, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    const float dt = p(3) * k.base_scale;
    float eseg = as_f(c[1]), et = as_f(c[2]), efrom = as_f(c[3]);
    const float env = prog.step(eseg, et, efrom, dt, trig[0], trig[1]);
    out[0] = sin_quant(c[0]) * (env * p(1));
    c[0] += to_inc(p(0) * k.f2pi);
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
struct ModalBody : PolyPan, NoTable, NoHoist {
  // freq, amp, pan, decay; t_strike
  static constexpr int NF = 4, NT = 1, NC = 3 + 2 * M, C = 2, kPan = 2;
  // a carry of 3 + 2M registers: three CTAs an SM up to 12 modes, two past
  static constexpr int kMinBlocks = M <= 12 ? 3 : 2, kMinBlocksEventful = kMinBlocks;
  struct Consts {
    float atk, rel, inv_area, c2pi, ratio[M], k_exp[M], gain[M];
  };
  __device__ ModalBody(const Consts&, const float4*) {}
  template <class P>
  __device__ __forceinline__ void step(const Consts& k, uint32_t* c, const P& p,
                                       const bool* trig, float* out) const {
    float stage = as_f(c[0]), t = as_f(c[1]), struck = as_f(c[2]);
    const float pulse = env_ar(stage, t, trig[0], k.atk, k.rel);
    if (trig[0]) struck = fmaxf(struck, 1.0f);
    const float x = pulse * (p(1) * k.inv_area);
    const float inv_decay = 1.0f / p(3);
    const float freq = p(0);
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float theta = k.c2pi * (freq * k.ratio[m]);
      float r = exp_poly(k.k_exp[m] * inv_decay);
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
      acc = acc + k.gain[m] * s1n;
    }
    out[0] = acc;
    c[0] = as_u(stage);
    c[1] = as_u(t);
    c[2] = as_u(struck);
  }
};

constexpr int kEnvelopeId = 4;
constexpr int kModalId0 = 4;  // ModalBody<M> is body kModalId0 + M
constexpr int kMaxModes = 16;

template <class Body, bool EVENTFUL>
__global__ void __launch_bounds__(kThreads,
                                  EVENTFUL ? Body::kMinBlocksEventful : Body::kMinBlocks)
generic_bank_kernel(const float* __restrict__ ramps, const float* __restrict__ rounds,
                    const float* __restrict__ act, const uint32_t* __restrict__ words,
                    const uint32_t* __restrict__ carry_in, const float* __restrict__ consts,
                    const __grid_constant__ typename Body::Consts kc, float* work,
                    float* __restrict__ mix, unsigned* tickets,
                    uint32_t* __restrict__ carry_out, int V, int B, int D) {
  constexpr int NF = Body::NF, NT = Body::NT, NC = Body::NC, C = Body::C;
  extern __shared__ float4 table[];
  const int v = blockIdx.x * kThreads + threadIdx.x;
  // whole warps past the bank skip the body; they only join the barriers
  const bool live = ((v >> 5) << 5) < V;
  const bool valid = v < V;
  const int vv = valid ? v : 0;  // ragged lanes read voice 0, contribute 0
  if constexpr (Body::kTable) {
    Body::stage_table(kc, consts, table);
    __syncthreads();
  }

  Ramp g[NF];
  uint32_t c[NC];
  float a = 0.0f;
  if (live) {
#pragma unroll
    for (int k = 0; k < NF; ++k) g[k] = load_ramp(ramps, k, V, vv);
#pragma unroll
    for (int k = 0; k < NC; ++k) c[k] = carry_in[static_cast<size_t>(k) * V + vv];
    a = act[vv];
  }
  Body body(kc, table);
  // event-free: what is the same at every sample of the block once, where
  // the params it reads are flat over it (ramp_flat): the pan gains, and
  // whatever the body hoists
  bool flat = false;
  float hl = 0.0f, hr = 0.0f;
  if constexpr (!EVENTFUL) {
    if (live) {
      body.hoist(kc, g, B);
      if constexpr (Body::kPan >= 0) {
        flat = ramp_flat(g[Body::kPan], B);
        if (flat) Body::pan_gains(mat_base(0.0f, g[Body::kPan]), hl, hr);
      }
    }
  }
  const int W = (B + 31) >> 5;
  uint32_t w[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) w[k] = 0u;

  // one sample of this voice: its C outputs times the active gain (0 on a
  // ragged lane)
  auto sample = [&](int i, float (&o)[C]) {
    const float i_f = static_cast<float>(i);
    bool trig[NT];
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (EVENTFUL && (i & 31) == 0) w[k] = load_word(words, k, W, i >> 5, V, vv);
      trig[k] = EVENTFUL && trig_bit(w[k], i);
    }
    const Params<NF, EVENTFUL> p{g, rounds, i_f, D, V, vv};
    body.step(kc, c, p, trig, o);
    if constexpr (Body::kPan >= 0) {
      float l = hl, r = hr;
      if (!flat) Body::pan_gains(p(Body::kPan), l, r);
      o[1] = o[0] * r;
      o[0] = o[0] * l;
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) o[ch] = valid ? o[ch] * a : 0.0f;
  };

  if constexpr (EVENTFUL) {
    if (live) {
      float* wrow = mix_warp_row(work, C * B);
      for (int i = 0; i < B; ++i) {
        float o[C];
        sample(i, o);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const float s = warp_sum(o[ch]);
          if ((threadIdx.x & 31) == 0) wrow[static_cast<size_t>(ch) * B + i] = s;
        }
      }
    }
    mix_combine_warps(work, V, C * B);
  } else {
    constexpr int T = CtaMix<C>::T;  // samples a mix tile
    __shared__ __align__(16) CtaMix<C> tile;
    if (!live) tile.clear();
    float* row = work + static_cast<size_t>(blockIdx.x) * C * B;
    for (int i0 = 0; i0 < B; i0 += T) {
      const int end = min(i0 + T, B);
      const int buf = (i0 / T) & 1;
      if (live) {
        for (int i = i0; i < end; ++i) {
          float o[C];
          sample(i, o);
#pragma unroll
          for (int ch = 0; ch < C; ++ch) tile.put(buf, ch * T + i - i0, o[ch]);
        }
      }
      tile.flush(buf, row, B, i0, end - i0);
    }
  }
  if (valid) {
#pragma unroll
    for (int k = 0; k < NC; ++k) carry_out[static_cast<size_t>(k) * V + v] = c[k];
  }
  mix_finish(work, mix, tickets, C * B);
}

struct Launch {
  const float *ramps, *rounds, *act;
  const uint32_t *words, *carry_in;
  const float *consts, *image;
  float *work, *mix;
  unsigned* tickets;
  uint32_t* carry_out;
  int V, B, D, eventful, n_consts, n_image;
  cudaStream_t s;
};

template <class Body, bool EVENTFUL>
cudaError_t launch_variant(const Launch& L, const typename Body::Consts& kc) {
  auto kernel = generic_bank_kernel<Body, EVENTFUL>;
  const size_t dyn = Body::table_bytes(kc, L.n_consts);
  // the 32 KB mix tile is static; a table past 16 KB needs the opt-in
  if (dyn > 16 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((L.V + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, dyn, L.s>>>(L.ramps, L.rounds, L.act, L.words, L.carry_in,
                                       L.consts, kc, L.work, L.mix, L.tickets,
                                       L.carry_out, L.V, L.B, L.D);
  return cudaGetLastError();
}

// unpack the host image into the body's Consts and launch the variant
template <class Body>
cudaError_t launch_body(const Launch& L) {
  typename Body::Consts kc;
  if (static_cast<size_t>(L.n_image) * sizeof(float) != sizeof(kc)) return cudaErrorInvalidValue;
  std::memcpy(&kc, L.image, sizeof(kc));
  return L.eventful ? launch_variant<Body, true>(L, kc) : launch_variant<Body, false>(L, kc);
}

// ModalBody<m> for the run-time mode count m in [M, kMaxModes]
template <int M>
cudaError_t launch_modal(int m, const Launch& L) {
  if constexpr (M > kMaxModes) {
    return cudaErrorInvalidValue;
  } else {
    if (m != M) return launch_modal<M + 1>(m, L);
    return launch_body<ModalBody<M>>(L);
  }
}

// AdditiveBody<HMAX> for the image's HMAX (n_image = 4 + 3*HMAX), H in [1, HMAX]
cudaError_t launch_additive(const Launch& L) {
  const int hmax = (L.n_image - 4) / 3;
  if (L.n_image < 4 || !(L.image[3] >= 1.0f) || L.image[3] > static_cast<float>(hmax)) {
    return cudaErrorInvalidValue;
  }
  switch (hmax) {
    case 8:
      return launch_body<AdditiveBody<8>>(L);
    case 16:
      return launch_body<AdditiveBody<16>>(L);
    case 32:
      return launch_body<AdditiveBody<32>>(L);
    case 64:
      return launch_body<AdditiveBody<64>>(L);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches one block of the bank with device body `body` (0 Sine, 1 FM,
// 2 Subtractive, 3 Additive, 4 Envelope, 4 + M Modal with M = 1 ... 16
// modes) on `stream`; returns cudaGetLastError().
// rounds/words are read only when `eventful` is non-zero; carry_in/out are
// [NC][V] 32-bit words; consts[n_consts] are the body's device constants
// (the Envelope body's segment table is read from there), image[n_image]
// the host copy of its kernel-parameter constants. work is [9*ceil(V/256)
// + ceil(V/8192)][C][B] scratch, mix [C][B] the bank's mix, tickets
// 1 + ceil(V/8192) words that are zero before the launch and after it.
int ktt_generic_bank(int body, const float* ramps, const float* rounds, const float* act,
                     const uint32_t* words, const uint32_t* carry_in, const float* consts,
                     const float* image, float* work, float* mix, unsigned* tickets,
                     uint32_t* carry_out, int V, int B, int D, int eventful, int n_consts,
                     int n_image, void* stream) {
  if (V < 1 || B < 1 || (eventful && D < 1) || image == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{ramps, rounds, act, words, carry_in, consts, image, work, mix, tickets,
                 carry_out, V, B, D, eventful, n_consts, n_image,
                 static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (body) {
    case 0:
      err = launch_body<SineBody>(L);
      break;
    case 1:
      err = launch_body<FMBody>(L);
      break;
    case 2:
      err = launch_body<SubBody>(L);
      break;
    case 3:
      err = launch_additive(L);
      break;
    case kEnvelopeId: {
      const int S = n_consts > EnvelopeBody::kHead ? (n_consts - EnvelopeBody::kHead) / 4 : 0;
      if (S < 1 || n_consts != EnvelopeBody::kHead + 4 * S || image[4] != static_cast<float>(S)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = launch_body<EnvelopeBody>(L);
      break;
    }
    default: {
      const int M = body - kModalId0;
      if (M < 1 || M > kMaxModes) return static_cast<int>(cudaErrorInvalidValue);
      err = launch_modal<1>(M, L);
    }
  }
  return static_cast<int>(err);
}

}  // extern "C"
