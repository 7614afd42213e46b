// Fused additive wavetable voice bank for Hopper (sm_90a), called through
// ctypes from knaster_tpu_torch/kernels/wt_bank.py.
//
// Replaces knaster_tpu/parallel/pallas_bank.py::_wt_kernel. Per voice and
// sample: the anchored freq/amp/pan ramps (plus D breakpoint rounds in
// eventful blocks), the packed restart/release bits, the EnvAsr state
// machine, sinf/cosf of the full-resolution fundamental angle, H partials by
// phasor recurrence (s, c) <- (s*c1 + c*s1, c*c1 - s*s1) weighted by the
// table's A_h/B_h and masked per sample against the hoisted Nyquist
// thresholds (freq <= nyq/(h+1)), equal-power pan (polynomial on the linear
// angle pack event-free, cosf/sinf of the materialized pan eventful) and the
// stereo mix.
//
// Design. One thread per voice (256-thread blocks, ragged tail masked), the
// phase and envelope in registers across the B-sample loop. H is a runtime
// value: the A, B and threshold constants (coefs[3][H], computed on the host
// in f64 and rounded to f32 as the JAX package does) are read per harmonic
// through the read-only cache; every lane reads the same address, so each
// read is one broadcast. What bounds it: FP32 issue, ~7 ops per harmonic
// per voice-sample (112 at H = 16) plus one sinf/cosf pair.
//
// Numerics. --fmad=false keeps the recurrence's multiplies and adds rounded
// one by one, so phase, stage, t and rscale are bit-equal to the plain
// version's. The mix goes through sinf/cosf, which may differ from torch's
// and XLA's sin/cos by an ulp, carried through the recurrence: the mix is
// compared within a stated tolerance.

#include "bank_common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = 256;
constexpr int kFreq = 0, kAmp = 1, kPan = 2;

template <bool EVENTFUL>
__global__ void __launch_bounds__(kThreads)
wt_bank_kernel(const float* __restrict__ ramps, const float* __restrict__ rounds,
               const float* __restrict__ act, const uint32_t* __restrict__ words,
               const uint32_t* __restrict__ phase_in, const float* __restrict__ stage_in,
               const float* __restrict__ t_in, const float* __restrict__ rscale_in,
               const float* __restrict__ coefs, float* __restrict__ partial,
               uint32_t* __restrict__ phase_out, float* __restrict__ stage_out,
               float* __restrict__ t_out, float* __restrict__ rscale_out, int V, int B,
               int D, int H, float atk, float rel, float f2pi) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int warp = v >> 5;
  const int lane = threadIdx.x & 31;
  // whole warps past the bank exit together (the shuffles need full warps)
  if ((warp << 5) >= V) return;
  const bool valid = v < V;
  const int vv = valid ? v : 0;  // ragged lanes read voice 0, contribute 0

  const Ramp freq_g = load_ramp(ramps, kFreq, V, vv);
  const Ramp amp_g = load_ramp(ramps, kAmp, V, vv);
  const Ramp pan_g = load_ramp(ramps, kPan, V, vv);
  uint32_t phase = phase_in[vv];
  float stage = stage_in[vv];
  float t = t_in[vv];
  float rscale = rscale_in[vv];
  const float a = EVENTFUL ? act[vv] : 1.0f;
  const int W = (B + 31) >> 5;
  uint32_t rw = 0u, qw = 0u;
  const float* acoef = coefs;
  const float* bcoef = coefs + H;
  const float* thr = coefs + 2 * H;

  float* out_l = partial + static_cast<size_t>(warp) * 2 * B;
  float* out_r = out_l + B;

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
    const float env = env_asr(stage, t, rscale, restart, release, atk, rel);

    const float freq = mat<EVENTFUL>(i_f, freq_g, rounds, kFreq, D, V, vv);
    const float theta = theta_full(phase);
    const float s1 = sinf(theta);
    const float c1 = cosf(theta);
    phase += to_inc(freq * f2pi);

    float s = s1, c = c1;
    float acc = freq <= __ldg(thr) ? __ldg(acoef) * s + __ldg(bcoef) * c : 0.0f;
    for (int h = 1; h < H; ++h) {
      const float sn = s * c1 + c * s1;
      const float cn = c * c1 - s * s1;
      s = sn;
      c = cn;
      const float part = __ldg(acoef + h) * s + __ldg(bcoef + h) * c;
      acc = acc + (freq <= __ldg(thr + h) ? part : 0.0f);
    }

    float gain = env * mat<EVENTFUL>(i_f, amp_g, rounds, kAmp, D, V, vv);
    if (EVENTFUL) gain = gain * a;
    const float sig = acc * gain;
    float panl, panr;
    if (EVENTFUL) {
      const float pan = mat<true>(i_f, pan_g, rounds, kPan, D, V, vv);
      const float angle = (pan * 0.5f + 0.5f) * kHalfPi;
      panl = cosf(angle);
      panr = sinf(angle);
    } else {
      // pan_g holds the linear-angle pack (a0, da, lt, rt, rem)
      const float angle = pan_g.v0 + pan_g.step * i_f;
      const bool ended = i_f >= pan_g.tgt;
      panl = ended ? pan_g.el : sin_poly(kHalfPi - angle);
      panr = ended ? pan_g.dur : sin_poly(angle);
    }
    const float l = warp_sum(valid ? sig * panl : 0.0f);
    const float r = warp_sum(valid ? sig * panr : 0.0f);
    if (lane == 0) {
      out_l[i] = l;
      out_r[i] = r;
    }
  }
  if (valid) {
    phase_out[v] = phase;
    stage_out[v] = stage;
    t_out[v] = t;
    rscale_out[v] = rscale;
  }
}

}  // namespace

extern "C" {

// Launches one block of the bank on `stream`; returns cudaGetLastError().
// rounds/act/words are read only when `eventful` is non-zero; coefs holds
// A[H], B[H] and the Nyquist thresholds thr[H].
int ktt_wt_bank(const float* ramps, const float* rounds, const float* act,
                const uint32_t* words, const uint32_t* phase_in, const float* stage_in,
                const float* t_in, const float* rscale_in, const float* coefs,
                float* partial, uint32_t* phase_out, float* stage_out, float* t_out,
                float* rscale_out, int V, int B, int D, int H, int eventful, float atk,
                float rel, float f2pi, void* stream) {
  if (V < 1 || B < 1 || H < 1 || (eventful && D < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((V + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eventful) {
    wt_bank_kernel<true><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, phase_in, stage_in, t_in, rscale_in, coefs, partial,
        phase_out, stage_out, t_out, rscale_out, V, B, D, H, atk, rel, f2pi);
  } else {
    wt_bank_kernel<false><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, phase_in, stage_in, t_in, rscale_in, coefs, partial,
        phase_out, stage_out, t_out, rscale_out, V, B, D, H, atk, rel, f2pi);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
