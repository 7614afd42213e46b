// Fused sine voice bank for Hopper (sm_90a), called through ctypes from
// knaster_tpu_torch/kernels/sine_bank.py.
//
// Replaces knaster_tpu/parallel/pallas_bank.py::_sine_kernel. Per voice and
// sample: the anchored freq/amp/pan ramps (_mat, plus D breakpoint rounds in
// eventful blocks), packed restart/release trigger bits (_trig_bit), the
// saturating u32 phase increment (_to_inc), the table-quantized sine from a
// folded-quadrant degree-9 polynomial (_sin_quant), the EnvAsr state machine
// (_env_asr / _env_asr_free), equal-power pan (_pan_gains) and the stereo mix.
//
// Design. One thread per voice (256-thread blocks, ragged tail masked); the
// phase and envelope state stay in registers across the B-sample loop, the
// base ramp groups are read once, and each sample's sig*panl / sig*panr is
// reduced across the warp with __shfl_down_sync; lane 0 writes
// partial[warp][ch][i] and the wrapper sums the warp partials. Eventful
// blocks read their D breakpoint rounds per sample from the L1-cached
// operand (D is a runtime value; those blocks are rare next to event-free
// ones). What bounds it: FP32/SFU issue per voice-sample (tens of ops) and
// the per-sample shuffles; memory is a few tens of bytes per voice per block.
//
// Numerics. Built with --fmad=false and no fast math: every multiply and add
// rounds on its own, as in the plain torch version and XLA, so the carried
// state (phase, stage, t, rscale) is bit-equal to the plain version's, and
// cosf/sinf are the accurate library versions.

#include "bank_common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = 256;
constexpr int kFreq = 0, kAmp = 1, kPan = 2;

template <bool EVENTFUL>
__global__ void __launch_bounds__(kThreads)
sine_bank_kernel(const float* __restrict__ ramps, const float* __restrict__ rounds,
                 const float* __restrict__ act, const uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ phase_in, const float* __restrict__ stage_in,
                 const float* __restrict__ t_in, const float* __restrict__ rscale_in,
                 float* __restrict__ partial, uint32_t* __restrict__ phase_out,
                 float* __restrict__ stage_out, float* __restrict__ t_out,
                 float* __restrict__ rscale_out, int V, int B, int D, float atk,
                 float rel, float f2pi) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int warp = v >> 5;
  const int lane = threadIdx.x & 31;
  // whole warps past the bank exit together (the shuffles need full warps)
  if ((warp << 5) >= V) return;
  const bool valid = v < V;
  const int vv = valid ? v : 0;  // ragged lanes read voice 0, contribute 0

  Ramp freq_g = load_ramp(ramps, kFreq, V, vv);
  Ramp amp_g = load_ramp(ramps, kAmp, V, vv);
  Ramp pan_g = load_ramp(ramps, kPan, V, vv);
  uint32_t phase = phase_in[vv];
  float stage = stage_in[vv];
  float t = t_in[vv];
  float rscale = rscale_in[vv];
  const float a = EVENTFUL ? act[vv] : 1.0f;
  const int W = (B + 31) >> 5;
  uint32_t rw = 0u, qw = 0u;

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

    float amp = mat_base(i_f, amp_g);
    float freq = mat_base(i_f, freq_g);
    float panl, panr;
    if (EVENTFUL) {
      amp = mat_rounds(i_f, amp, rounds, kAmp, D, V, vv);
      freq = mat_rounds(i_f, freq, rounds, kFreq, D, V, vv);
      const float pan = mat_rounds(i_f, mat_base(i_f, pan_g), rounds, kPan, D, V, vv);
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
    float gain = env * amp;
    if (EVENTFUL) gain = gain * a;

    const float osc = sin_quant(phase);
    phase += to_inc(freq * f2pi);

    const float sig = osc * gain;
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
// rounds/act/words are read only when `eventful` is non-zero.
int ktt_sine_bank(const float* ramps, const float* rounds, const float* act,
                  const uint32_t* words, const uint32_t* phase_in,
                  const float* stage_in, const float* t_in, const float* rscale_in,
                  float* partial, uint32_t* phase_out, float* stage_out,
                  float* t_out, float* rscale_out, int V, int B, int D,
                  int eventful, float atk, float rel, float f2pi, void* stream) {
  if (V < 1 || B < 1 || (eventful && D < 1)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((V + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eventful) {
    sine_bank_kernel<true><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, phase_in, stage_in, t_in, rscale_in, partial,
        phase_out, stage_out, t_out, rscale_out, V, B, D, atk, rel, f2pi);
  } else {
    sine_bank_kernel<false><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, phase_in, stage_in, t_in, rscale_in, partial,
        phase_out, stage_out, t_out, rscale_out, V, B, D, atk, rel, f2pi);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
