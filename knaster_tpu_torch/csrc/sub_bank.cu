// Fused subtractive voice bank for Hopper (sm_90a), called through ctypes
// from knaster_tpu_torch/kernels/sub_bank.py.
//
// Replaces knaster_tpu/parallel/pallas_bank.py::_sub_kernel. Per voice and
// sample: the anchored freq/cutoff/q/amp ramps (plus D breakpoint rounds in
// eventful blocks), the packed restart/release bits, the EnvAsr state
// machine, a polyBLEP sawtooth, the SVF lowpass coefficients from the
// per-sample cutoff and q in the one-divide sin/cos form (_svf_low_coeffs),
// one SVF step, and the mono mix.
//
// Design. One thread per voice in 256-thread CTAs, the saw phase, both SVF
// integrator states and the envelope in registers across the B-sample
// loop. What bounds it: FP32 issue, the IEEE divides the most expensive
// part (three a voice-sample in the reference's form: two in the BLEP, one
// in the coefficients); memory is ~120 bytes per voice per block. What the
// design does about it:
// - one divide in the BLEP (bank_common.cuh blep_warp): the one quotient
//   the BLEP reads, taken only where some lane of the warp is within dt of
//   a saw edge;
// - per-block hoists in event-free blocks, each where the values it reads
//   are the same at every sample (ramp_flat, env_asr_steady), from sample
//   0, bit-equal by rule: the SVF coefficients (flat cutoff and q), dt
//   (flat freq), amp, and the envelope where the stage is 0 or 2 at block
//   entry. A warp takes a hoist only where all its lanes can (__all_sync).
//   The saw and the SVF always run: their state moves even where the
//   envelope is 0;
// - the act fold in the prologue: an event-free block takes the 0/1 active
//   gain and folds it into amp's (v0, step, tgt) as bank_common.py
//   fold_act does, so the host launches nothing for it;
// - the mix (bank_common.cuh): a shared-memory tile (CtaMix) in event-free
//   blocks, a warp shuffle into a row per warp in eventful ones (their
//   breakpoint re-reads keep L1), the CTA rows summed in the kernel in a
//   fixed order (mix_finish): no reduction launch follows.
// Event-free blocks run at most 64 registers (four CTAs an SM, one wave at
// 131,072 voices); eventful blocks keep the parent's unbounded registers.
// Whole warps past the bank skip the body and only join the CTA's barriers;
// ragged lanes read voice 0 and contribute 0.
//
// Numerics. The SVF step keeps the reference's association,
// v1 = a1*ic1 + a2*v3 and v2 = (ic2 + a2*ic1) + a3*v3, with no FMA
// contraction (--fmad=false), so t, ic1, ic2 and the envelope are
// bit-equal to the plain version's.

#include "bank_common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = kMixThreads;
constexpr int kFreq = 0, kCut = 1, kQ = 2, kAmp = 3;

// the saw's dt from the freq at a sample
__device__ __forceinline__ float saw_dt(float freq, float inv_sr) {
  return fminf(fmaxf(freq * inv_sr, 0.0f), 0.5f);
}

// One sample's saw and SVF step (polyblep.rs saw, svf.rs process_sample
// with m = (0, 0, 1)); returns v2, the lowpass output.
__device__ __forceinline__ float saw_svf(float& t, float& ic1, float& ic2, float dt, float a1,
                                         float a2, float a3) {
  float tt = t + 0.5f;
  tt = tt - floorf(tt);
  const float saw = 2.0f * tt - 1.0f - blep_warp(tt, dt);
  t = t + dt;
  t = t - floorf(t);
  const float v3 = saw - ic2;
  const float v1 = a1 * ic1 + a2 * v3;
  const float v2 = ic2 + a2 * ic1 + a3 * v3;
  ic1 = 2.0f * v1 - ic1;
  ic2 = 2.0f * v2 - ic2;
  return v2;
}

template <bool EVENTFUL>
__global__ void __launch_bounds__(kThreads, EVENTFUL ? 1 : 4)
sub_bank_kernel(const float* __restrict__ ramps, const float* __restrict__ rounds,
                const float* __restrict__ act, const uint32_t* __restrict__ words,
                const float* __restrict__ t_in, const float* __restrict__ ic1_in,
                const float* __restrict__ ic2_in, const float* __restrict__ stage_in,
                const float* __restrict__ et_in, const float* __restrict__ rscale_in,
                float* work, float* __restrict__ mix, unsigned* tickets,
                float* __restrict__ t_out, float* __restrict__ ic1_out,
                float* __restrict__ ic2_out, float* __restrict__ stage_out,
                float* __restrict__ et_out, float* __restrict__ rscale_out, int V, int B,
                int D, float atk, float rel, float inv_sr, float pi_inv_sr) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  // whole warps past the bank skip the body; they only join the barriers
  const bool live = ((v >> 5) << 5) < V;
  const bool valid = v < V;
  const int vv = valid ? v : 0;  // ragged lanes read voice 0, contribute 0

  Ramp freq_g{}, cut_g{}, q_g{}, amp_g{};
  float t = 0.0f, ic1 = 0.0f, ic2 = 0.0f, stage = 0.0f, et = 0.0f, rscale = 0.0f, a = 0.0f;
  if (live) {
    freq_g = load_ramp(ramps, kFreq, V, vv);
    cut_g = load_ramp(ramps, kCut, V, vv);
    q_g = load_ramp(ramps, kQ, V, vv);
    amp_g = load_ramp(ramps, kAmp, V, vv);
    t = t_in[vv];
    ic1 = ic1_in[vv];
    ic2 = ic2_in[vv];
    stage = stage_in[vv];
    et = et_in[vv];
    rscale = rscale_in[vv];
    a = act[vv];
  }

  if constexpr (EVENTFUL) {
    const int W = (B + 31) >> 5;
    uint32_t rw = 0u, qw = 0u;
    if (live) {
      float* wrow = mix_warp_row(work, B);
      for (int i = 0; i < B; ++i) {
        const float i_f = static_cast<float>(i);
        if ((i & 31) == 0) {
          rw = load_word(words, 0, W, i >> 5, V, vv);
          qw = load_word(words, 1, W, i >> 5, V, vv);
        }
        const float env = env_asr(stage, et, rscale, trig_bit(rw, i), trig_bit(qw, i), atk, rel);
        const float dt = saw_dt(mat<true>(i_f, freq_g, rounds, kFreq, D, V, vv), inv_sr);
        float a1, a2, a3;
        svf_low_coeffs(pi_inv_sr * mat<true>(i_f, cut_g, rounds, kCut, D, V, vv),
                       mat<true>(i_f, q_g, rounds, kQ, D, V, vv), a1, a2, a3);
        const float v2 = saw_svf(t, ic1, ic2, dt, a1, a2, a3);
        const float gain = env * mat<true>(i_f, amp_g, rounds, kAmp, D, V, vv) * a;
        const float s = warp_sum(valid ? v2 * gain : 0.0f);
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
    const float dt0 = saw_dt(mat_base(0.0f, freq_g), inv_sr);
    float a1h, a2h, a3h;
    svf_low_coeffs(pi_inv_sr * mat_base(0.0f, cut_g), mat_base(0.0f, q_g), a1h, a2h, a3h);
    const float amp0 = mat_base(0.0f, amp_g);
    const float env0 = stage == 2.0f ? 1.0f : 0.0f;
    const float gain0 = valid ? env0 * amp0 : 0.0f;  // a ragged lane sums +-0
    constexpr unsigned kAll = 0xffffffffu;
    const bool f_dt = __all_sync(kAll, !valid || ramp_flat(freq_g, B));
    const bool f_coef = __all_sync(kAll, !valid || (ramp_flat(cut_g, B) && ramp_flat(q_g, B)));
    const bool f_amp = __all_sync(kAll, !valid || ramp_flat(amp_g, B));
    const bool f_env = __all_sync(kAll, !valid || env_asr_steady(stage));
    const bool fast = f_dt && f_coef && f_amp && f_env;

    constexpr int T = CtaMix<1>::T;  // samples a mix tile
    __shared__ __align__(16) CtaMix<1> tile;
    if (!live) tile.clear();
    float* row = work + static_cast<size_t>(blockIdx.x) * B;
    for (int i0 = 0; i0 < B; i0 += T) {
      const int end = min(i0 + T, B);
      const int buf = (i0 / T) & 1;
      if (live) {
        if (fast) {
          // a whole tile unrolled
          auto put = [&](int j) {
            tile.put(buf, j, saw_svf(t, ic1, ic2, dt0, a1h, a2h, a3h) * gain0);
          };
          if (end - i0 == T) {
#pragma unroll
            for (int j = 0; j < T; ++j) put(j);
          } else {
            for (int j = 0; j < end - i0; ++j) put(j);
          }
        } else {
          for (int i = i0; i < end; ++i) {
            const float i_f = static_cast<float>(i);
            const float env = f_env ? env0 : env_asr(stage, et, rscale, false, false, atk, rel);
            const float dt = f_dt ? dt0 : saw_dt(mat_base(i_f, freq_g), inv_sr);
            float a1 = a1h, a2 = a2h, a3 = a3h;
            if (!f_coef) {
              svf_low_coeffs(pi_inv_sr * mat_base(i_f, cut_g), mat_base(i_f, q_g), a1, a2, a3);
            }
            const float v2 = saw_svf(t, ic1, ic2, dt, a1, a2, a3);
            const float amp = f_amp ? amp0 : mat_base(i_f, amp_g);
            tile.put(buf, i - i0, valid ? v2 * (env * amp) : 0.0f);
          }
        }
      }
      tile.flush(buf, row, B, i0, end - i0);
    }
  }
  if (valid) {
    t_out[v] = t;
    ic1_out[v] = ic1;
    ic2_out[v] = ic2;
    stage_out[v] = stage;
    et_out[v] = et;
    rscale_out[v] = rscale;
  }
  mix_finish(work, mix, tickets, B);
}

}  // namespace

extern "C" {

// Launches one block of the bank on `stream`; returns cudaGetLastError().
// act is read in every block; rounds/words only when `eventful` is non-zero.
// ramps hold the raw ramp groups of freq, cutoff, q and amp (nothing folded
// in). work is [9*ceil(V/256) + ceil(V/8192)][1][B] scratch, mix [1][B] the
// bank's mix, tickets 1 + ceil(V/8192) words that are zero before the launch
// and after it.
int ktt_sub_bank(const float* ramps, const float* rounds, const float* act,
                 const uint32_t* words, const float* t_in, const float* ic1_in,
                 const float* ic2_in, const float* stage_in, const float* et_in,
                 const float* rscale_in, float* work, float* mix, unsigned* tickets,
                 float* t_out, float* ic1_out, float* ic2_out, float* stage_out,
                 float* et_out, float* rscale_out, int V, int B, int D, int eventful,
                 float atk, float rel, float inv_sr, float pi_inv_sr, void* stream) {
  if (V < 1 || B < 1 || (eventful && D < 1) || act == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((V + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eventful) {
    sub_bank_kernel<true><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, t_in, ic1_in, ic2_in, stage_in, et_in, rscale_in, work,
        mix, tickets, t_out, ic1_out, ic2_out, stage_out, et_out, rscale_out, V, B, D, atk,
        rel, inv_sr, pi_inv_sr);
  } else {
    sub_bank_kernel<false><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, t_in, ic1_in, ic2_in, stage_in, et_in, rscale_in, work,
        mix, tickets, t_out, ic1_out, ic2_out, stage_out, et_out, rscale_out, V, B, D, atk,
        rel, inv_sr, pi_inv_sr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
