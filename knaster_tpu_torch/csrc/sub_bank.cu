// Fused subtractive voice bank for Hopper (sm_90a), called through ctypes
// from knaster_tpu_torch/kernels/sub_bank.py.
//
// Replaces knaster_tpu/parallel/pallas_bank.py::_sub_kernel. Per voice and
// sample: the anchored freq/cutoff/q/amp ramps (plus D breakpoint rounds in
// eventful blocks), the packed restart/release bits, the EnvAsr state
// machine, a polyBLEP sawtooth, the SVF lowpass coefficients recomputed from
// the per-sample cutoff and q in the one-divide sin/cos form
// (_svf_low_coeffs), one SVF step, and the mono mix.
//
// Design. One thread per voice (256-thread blocks, ragged tail masked), the
// saw phase, both SVF integrator states and the envelope in registers
// across the B-sample loop, a warp shuffle reduction per sample. What
// bounds it: FP32 issue, with three IEEE divides per voice-sample (two in
// the BLEP, one in the coefficients) the most expensive part; memory is
// ~120 bytes per voice per block.
//
// Numerics. The SVF step keeps the reference's association,
// v1 = a1*ic1 + a2*v3 and v2 = (ic2 + a2*ic1) + a3*v3, with no FMA
// contraction (--fmad=false), so t, ic1, ic2 and the envelope are
// bit-equal to the plain version's.

#include "bank_common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = 256;
constexpr int kFreq = 0, kCut = 1, kQ = 2, kAmp = 3;

template <bool EVENTFUL>
__global__ void __launch_bounds__(kThreads)
sub_bank_kernel(const float* __restrict__ ramps, const float* __restrict__ rounds,
                const float* __restrict__ act, const uint32_t* __restrict__ words,
                const float* __restrict__ t_in, const float* __restrict__ ic1_in,
                const float* __restrict__ ic2_in, const float* __restrict__ stage_in,
                const float* __restrict__ et_in, const float* __restrict__ rscale_in,
                float* __restrict__ partial, float* __restrict__ t_out,
                float* __restrict__ ic1_out, float* __restrict__ ic2_out,
                float* __restrict__ stage_out, float* __restrict__ et_out,
                float* __restrict__ rscale_out, int V, int B, int D, float atk,
                float rel, float inv_sr, float pi_inv_sr) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int warp = v >> 5;
  const int lane = threadIdx.x & 31;
  // whole warps past the bank exit together (the shuffles need full warps)
  if ((warp << 5) >= V) return;
  const bool valid = v < V;
  const int vv = valid ? v : 0;  // ragged lanes read voice 0, contribute 0

  const Ramp freq_g = load_ramp(ramps, kFreq, V, vv);
  const Ramp cut_g = load_ramp(ramps, kCut, V, vv);
  const Ramp q_g = load_ramp(ramps, kQ, V, vv);
  const Ramp amp_g = load_ramp(ramps, kAmp, V, vv);
  float t = t_in[vv];
  float ic1 = ic1_in[vv];
  float ic2 = ic2_in[vv];
  float stage = stage_in[vv];
  float et = et_in[vv];
  float rscale = rscale_in[vv];
  const float a = EVENTFUL ? act[vv] : 1.0f;
  const int W = (B + 31) >> 5;
  uint32_t rw = 0u, qw = 0u;
  float* out = partial + static_cast<size_t>(warp) * B;

  for (int i = 0; i < B; ++i) {
    const float i_f = static_cast<float>(i);
    bool restart = false, release = false;
    if (EVENTFUL) {
      if ((i & 31) == 0) {
        rw = load_word(words, 0, W, i >> 5, V, vv);
        qw = load_word(words, 1, W, i >> 5, V, vv);
      }
      restart = trig_bit(rw, i);
      release = trig_bit(qw, i);
    }
    const float env = env_asr(stage, et, rscale, restart, release, atk, rel);

    // polyBLEP sawtooth (polyblep.rs saw): y = 2*frac(t+0.5)-1 - blep
    const float dt =
        fminf(fmaxf(mat<EVENTFUL>(i_f, freq_g, rounds, kFreq, D, V, vv) * inv_sr, 0.0f), 0.5f);
    float tt = t + 0.5f;
    tt = tt - floorf(tt);
    const float saw = 2.0f * tt - 1.0f - blep(tt, dt);
    t = t + dt;
    t = t - floorf(t);

    float a1, a2, a3;
    svf_low_coeffs(pi_inv_sr * mat<EVENTFUL>(i_f, cut_g, rounds, kCut, D, V, vv),
                   mat<EVENTFUL>(i_f, q_g, rounds, kQ, D, V, vv), a1, a2, a3);
    // SVF step (svf.rs process_sample, m = (0, 0, 1))
    const float v3 = saw - ic2;
    const float v1 = a1 * ic1 + a2 * v3;
    const float v2 = ic2 + a2 * ic1 + a3 * v3;
    ic1 = 2.0f * v1 - ic1;
    ic2 = 2.0f * v2 - ic2;

    float gain = env * mat<EVENTFUL>(i_f, amp_g, rounds, kAmp, D, V, vv);
    if (EVENTFUL) gain = gain * a;
    const float s = warp_sum(valid ? v2 * gain : 0.0f);
    if (lane == 0) out[i] = s;
  }
  if (valid) {
    t_out[v] = t;
    ic1_out[v] = ic1;
    ic2_out[v] = ic2;
    stage_out[v] = stage;
    et_out[v] = et;
    rscale_out[v] = rscale;
  }
}

}  // namespace

extern "C" {

// Launches one block of the bank on `stream`; returns cudaGetLastError().
// rounds/act/words are read only when `eventful` is non-zero.
int ktt_sub_bank(const float* ramps, const float* rounds, const float* act,
                 const uint32_t* words, const float* t_in, const float* ic1_in,
                 const float* ic2_in, const float* stage_in, const float* et_in,
                 const float* rscale_in, float* partial, float* t_out, float* ic1_out,
                 float* ic2_out, float* stage_out, float* et_out, float* rscale_out,
                 int V, int B, int D, int eventful, float atk, float rel, float inv_sr,
                 float pi_inv_sr, void* stream) {
  if (V < 1 || B < 1 || (eventful && D < 1)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((V + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eventful) {
    sub_bank_kernel<true><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, t_in, ic1_in, ic2_in, stage_in, et_in, rscale_in,
        partial, t_out, ic1_out, ic2_out, stage_out, et_out, rscale_out, V, B, D, atk,
        rel, inv_sr, pi_inv_sr);
  } else {
    sub_bank_kernel<false><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, t_in, ic1_in, ic2_in, stage_in, et_in, rscale_in,
        partial, t_out, ic1_out, ic2_out, stage_out, et_out, rscale_out, V, B, D, atk,
        rel, inv_sr, pi_inv_sr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
