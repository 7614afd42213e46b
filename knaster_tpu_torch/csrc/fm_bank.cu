// Fused 2-operator FM voice bank for Hopper (sm_90a), called through ctypes
// from knaster_tpu_torch/kernels/fm_bank.py.
//
// Replaces knaster_tpu/parallel/pallas_bank.py::_fm_kernel. Per voice and
// sample: the anchored freq/ratio/index/amp ramps (plus D breakpoint rounds
// in eventful blocks), the packed restart bit, the EnvAr state machine, the
// modulator phase advanced by freq*ratio, the carrier's audio-rate frequency
// freq*(1 + index*mod), both table-quantized sines on u32 phases, and the
// mono mix.
//
// Design. One thread per voice in 256-thread CTAs, both phases and the
// envelope in registers across the B-sample loop. What bounds it: FP32
// issue, two table-quantized sines and the four ramps a voice-sample where
// the voice sounds; memory is ~100 bytes per voice per block. What the
// design does about it:
// - the sines: both variants read sin_quant from its 4097 first-quadrant
//   values in shared memory (fill_sin_table, sin_quant_table), bit-equal
//   to the polynomial and faster than it in eventful blocks too (PERF.md
//   §6);
// - per-block hoists in event-free blocks, each where the values it reads
//   are the same at every sample, from sample 0, bit-equal by rule
//   (ramp_flat): the values of freq, ratio, index and amp, and the
//   modulator's u32 increment where freq and ratio are both flat. The
//   carrier's increment stays per sample: it reads the modulator's sine. A
//   warp takes a hoist only where all its lanes can (__all_sync);
// - EnvAr has no sustain, so the envelope is steady only where the voice
//   is stopped (env_ar_steady: stage 0, env 0). A warp whose every gain is
//   zero (its envelopes steady and its amps flat) still advances both
//   phases sample by sample, since the carrier's increment reads the
//   modulator's sine at every sample, and skips only the carrier's sine
//   and the mix (it adds nothing to the tile);
// - the act fold in the prologue: an event-free block takes the 0/1 active
//   gain and folds it into amp's (v0, step, tgt) as bank_common.py
//   fold_act does, so the host launches nothing for it;
// - the mix (bank_common.cuh): a shared-memory tile (CtaMix) in event-free
//   blocks, a warp shuffle into a row per warp in eventful ones (their
//   breakpoint re-reads keep L1), the CTA rows summed in the kernel in a
//   fixed order (mix_finish): no reduction launch follows.
// Event-free blocks run at most 64 registers (four CTAs an SM, one wave at
// 131,072 voices), eventful blocks unbounded: each the faster per variant
// (PERF.md §6). Whole warps past the bank skip the body and only join the
// CTA's barriers; ragged lanes read voice 0 and contribute 0.
//
// Numerics. Built with --fmad=false and no fast math: every multiply and add
// rounds on its own, as in the plain torch version, so phm, phc, stage and
// t are bit-equal to the plain version's; the mix differs by its order of
// summation only.

#include <type_traits>

#include "bank_common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = kMixThreads;
constexpr int kFreq = 0, kRatio = 1, kIndex = 2, kAmp = 3;

template <bool EVENTFUL>
__global__ void __launch_bounds__(kThreads, EVENTFUL ? 1 : 4)
fm_bank_kernel(const float* __restrict__ ramps, const float* __restrict__ rounds,
               const float* __restrict__ act, const uint32_t* __restrict__ words,
               const uint32_t* __restrict__ phm_in, const uint32_t* __restrict__ phc_in,
               const float* __restrict__ stage_in, const float* __restrict__ t_in,
               float* work, float* __restrict__ mix, unsigned* tickets,
               uint32_t* __restrict__ phm_out, uint32_t* __restrict__ phc_out,
               float* __restrict__ stage_out, float* __restrict__ t_out, int V, int B, int D,
               float atk, float rel, float f2pi) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  // whole warps past the bank skip the body; they only join the barriers
  const bool live = ((v >> 5) << 5) < V;
  const bool valid = v < V;
  const int vv = valid ? v : 0;  // ragged lanes read voice 0, contribute 0

  Ramp freq_g{}, ratio_g{}, index_g{}, amp_g{};
  uint32_t phm = 0u, phc = 0u;
  float stage = 0.0f, t = 0.0f, a = 0.0f;
  if (live) {
    freq_g = load_ramp(ramps, kFreq, V, vv);
    ratio_g = load_ramp(ramps, kRatio, V, vv);
    index_g = load_ramp(ramps, kIndex, V, vv);
    amp_g = load_ramp(ramps, kAmp, V, vv);
    phm = phm_in[vv];
    phc = phc_in[vv];
    stage = stage_in[vv];
    t = t_in[vv];
    a = act[vv];
  }

  extern __shared__ float sin_tab[];
  fill_sin_table(sin_tab);
  if constexpr (EVENTFUL) {
    const int W = (B + 31) >> 5;
    uint32_t rw = 0u;
    if (live) {
      float* wrow = mix_warp_row(work, B);
      for (int i = 0; i < B; ++i) {
        const float i_f = static_cast<float>(i);
        if ((i & 31) == 0) rw = load_word(words, 0, W, i >> 5, V, vv);
        const float env = env_ar(stage, t, trig_bit(rw, i), atk, rel);
        const float gain = env * mat<true>(i_f, amp_g, rounds, kAmp, D, V, vv) * a;
        const float freq = mat<true>(i_f, freq_g, rounds, kFreq, D, V, vv);
        const float mod = sin_quant_table(phm, sin_tab);
        phm += to_inc(freq * mat<true>(i_f, ratio_g, rounds, kRatio, D, V, vv) * f2pi);
        const float car_freq =
            freq * (1.0f + mat<true>(i_f, index_g, rounds, kIndex, D, V, vv) * mod);
        const float car = sin_quant_table(phc, sin_tab);
        phc += to_inc(car_freq * f2pi);
        const float s = warp_sum(valid ? car * gain : 0.0f);
        if ((threadIdx.x & 31) == 0) wrow[i] = s;
      }
    }
    mix_combine_warps(work, V, B);
  } else {
    // the act fold, per voice (bank_common.py fold_act)
    amp_g.v0 = amp_g.v0 * a;
    amp_g.step = amp_g.step * a;
    amp_g.tgt = amp_g.tgt * a;
    // the hoists' values at sample 0, and where a warp may take them
    const float freq0 = mat_base(0.0f, freq_g);
    const float ratio0 = mat_base(0.0f, ratio_g);
    const float index0 = mat_base(0.0f, index_g);
    const float amp0 = mat_base(0.0f, amp_g);
    const uint32_t incm0 = to_inc(freq0 * ratio0 * f2pi);
    constexpr unsigned kAll = 0xffffffffu;
    const bool f_freq = __all_sync(kAll, !valid || ramp_flat(freq_g, B));
    const bool f_ratio = __all_sync(kAll, !valid || ramp_flat(ratio_g, B));
    const bool f_index = __all_sync(kAll, !valid || ramp_flat(index_g, B));
    const bool f_amp = __all_sync(kAll, !valid || ramp_flat(amp_g, B));
    const bool f_env = __all_sync(kAll, !valid || env_ar_steady(stage));
    // every gain of the warp is +-0 (env 0 times a flat amp): every term of
    // the mix is +-0, which leaves a sum as it is (the CTA's column sums
    // see +0 instead)
    const bool quiet = f_env && f_amp && __all_sync(kAll, !valid || 0.0f * amp0 == 0.0f);
    const bool flat = f_freq && f_ratio && f_index && f_amp;

    // one sample: both phases advance; with MIX the carrier's sine times the
    // gain is returned. F (a whole warp's ramps flat) takes every hoist
    // without a test.
    auto sample = [&](int i, auto mix_c, auto flat_c) -> float {
      constexpr bool MIX = decltype(mix_c)::value;
      constexpr bool F = decltype(flat_c)::value;
      const float i_f = static_cast<float>(i);
      float gain = 0.0f;
      if constexpr (MIX) {
        const float env = f_env ? 0.0f : env_ar(stage, t, false, atk, rel);
        gain = env * (F || f_amp ? amp0 : mat_base(i_f, amp_g));
      }
      const float freq = F || f_freq ? freq0 : mat_base(i_f, freq_g);
      const float mod = sin_quant_table(phm, sin_tab);
      phm += F || (f_freq && f_ratio)
                 ? incm0
                 : to_inc(freq * (f_ratio ? ratio0 : mat_base(i_f, ratio_g)) * f2pi);
      const float car_freq =
          freq * (1.0f + (F || f_index ? index0 : mat_base(i_f, index_g)) * mod);
      float out = 0.0f;
      if constexpr (MIX) out = sin_quant_table(phc, sin_tab) * gain;
      phc += to_inc(car_freq * f2pi);
      return out;
    };
    using Yes = std::true_type;
    using No = std::false_type;

    constexpr int T = CtaMix<1>::T;  // samples a mix tile
    __shared__ __align__(16) CtaMix<1> tile;
    if (!live || quiet) tile.clear();
    float* row = work + static_cast<size_t>(blockIdx.x) * B;
    for (int i0 = 0; i0 < B; i0 += T) {
      const int end = min(i0 + T, B);
      const int buf = (i0 / T) & 1;
      if (live) {
        if (quiet) {
          for (int i = i0; i < end; ++i) sample(i, No{}, No{});
        } else if (flat && end - i0 == T) {
          // a whole tile unrolled: its samples depend on each other only
          // through the phases and the envelope
#pragma unroll
          for (int j = 0; j < T; ++j) {
            const float x = sample(i0 + j, Yes{}, Yes{});
            tile.put(buf, j, valid ? x : 0.0f);
          }
        } else {
          for (int i = i0; i < end; ++i) {
            const float x = sample(i, Yes{}, No{});
            tile.put(buf, i - i0, valid ? x : 0.0f);
          }
        }
      }
      tile.flush(buf, row, B, i0, end - i0);
    }
  }
  if (valid) {
    phm_out[v] = phm;
    phc_out[v] = phc;
    stage_out[v] = stage;
    t_out[v] = t;
  }
  mix_finish(work, mix, tickets, B);
}

struct Launch {
  const float *ramps, *rounds, *act;
  const uint32_t *words, *phm_in, *phc_in;
  const float *stage_in, *t_in;
  float *work, *mix;
  unsigned* tickets;
  uint32_t *phm_out, *phc_out;
  float *stage_out, *t_out;
  int V, B, D;
  float atk, rel, f2pi;
  cudaStream_t s;
};

template <bool EVENTFUL>
cudaError_t launch_variant(const Launch& L) {
  auto kernel = fm_bank_kernel<EVENTFUL>;
  const size_t dyn = kSinTable * sizeof(float);
  // the 32 KB mix tile of event-free blocks is static: the table passes 48
  // KB only by the opt-in, set once (not again while a CUDA graph captures
  // the launch)
  static bool opted_in = false;
  if (!EVENTFUL && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((L.V + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, dyn, L.s>>>(L.ramps, L.rounds, L.act, L.words, L.phm_in, L.phc_in,
                                       L.stage_in, L.t_in, L.work, L.mix, L.tickets,
                                       L.phm_out, L.phc_out, L.stage_out, L.t_out, L.V, L.B,
                                       L.D, L.atk, L.rel, L.f2pi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one block of the bank on `stream`; returns cudaGetLastError().
// act is read in every block; rounds/words only when `eventful` is non-zero.
// ramps hold the raw ramp groups of freq, ratio, index and amp (nothing
// folded in). work is [9*ceil(V/256) + ceil(V/8192)][1][B] scratch, mix
// [1][B] the bank's mix, tickets 1 + ceil(V/8192) words that are zero
// before the launch and after it.
int ktt_fm_bank(const float* ramps, const float* rounds, const float* act,
                const uint32_t* words, const uint32_t* phm_in, const uint32_t* phc_in,
                const float* stage_in, const float* t_in, float* work, float* mix,
                unsigned* tickets, uint32_t* phm_out, uint32_t* phc_out, float* stage_out,
                float* t_out, int V, int B, int D, int eventful, float atk, float rel,
                float f2pi, void* stream) {
  if (V < 1 || B < 1 || (eventful && D < 1) || act == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{ramps,   rounds,  act,       words,   phm_in, phc_in, stage_in, t_in,
                 work,    mix,     tickets,   phm_out, phc_out, stage_out, t_out, V,
                 B,       D,       atk,       rel,     f2pi,    static_cast<cudaStream_t>(stream)};
  return static_cast<int>(eventful ? launch_variant<true>(L) : launch_variant<false>(L));
}

}  // extern "C"
