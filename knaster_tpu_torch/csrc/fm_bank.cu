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
// Design. One thread per voice (256-thread blocks, ragged tail masked), both
// phases and the envelope in registers across the B-sample loop, a warp
// shuffle reduction per sample, lane 0 writing partial[warp][0][i]. What
// bounds it: FP32 issue (two sine polynomials and four ramp selects per
// voice-sample); memory is ~100 bytes per voice per block.

#include "bank_common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = 256;
constexpr int kFreq = 0, kRatio = 1, kIndex = 2, kAmp = 3;

template <bool EVENTFUL>
__global__ void __launch_bounds__(kThreads)
fm_bank_kernel(const float* __restrict__ ramps, const float* __restrict__ rounds,
               const float* __restrict__ act, const uint32_t* __restrict__ words,
               const uint32_t* __restrict__ phm_in, const uint32_t* __restrict__ phc_in,
               const float* __restrict__ stage_in, const float* __restrict__ t_in,
               float* __restrict__ partial, uint32_t* __restrict__ phm_out,
               uint32_t* __restrict__ phc_out, float* __restrict__ stage_out,
               float* __restrict__ t_out, int V, int B, int D, float atk, float rel,
               float f2pi) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int warp = v >> 5;
  const int lane = threadIdx.x & 31;
  // whole warps past the bank exit together (the shuffles need full warps)
  if ((warp << 5) >= V) return;
  const bool valid = v < V;
  const int vv = valid ? v : 0;  // ragged lanes read voice 0, contribute 0

  const Ramp freq_g = load_ramp(ramps, kFreq, V, vv);
  const Ramp ratio_g = load_ramp(ramps, kRatio, V, vv);
  const Ramp index_g = load_ramp(ramps, kIndex, V, vv);
  const Ramp amp_g = load_ramp(ramps, kAmp, V, vv);
  uint32_t phm = phm_in[vv];
  uint32_t phc = phc_in[vv];
  float stage = stage_in[vv];
  float t = t_in[vv];
  const float a = EVENTFUL ? act[vv] : 1.0f;
  const int W = (B + 31) >> 5;
  uint32_t rw = 0u;
  float* out = partial + static_cast<size_t>(warp) * B;

  for (int i = 0; i < B; ++i) {
    const float i_f = static_cast<float>(i);
    bool restart = false;
    if (EVENTFUL) {
      if ((i & 31) == 0) rw = load_word(words, 0, W, i >> 5, V, vv);
      restart = trig_bit(rw, i);
    }
    const float env = env_ar(stage, t, restart, atk, rel);
    float gain = env * mat<EVENTFUL>(i_f, amp_g, rounds, kAmp, D, V, vv);
    if (EVENTFUL) gain = gain * a;

    const float freq = mat<EVENTFUL>(i_f, freq_g, rounds, kFreq, D, V, vv);
    const float mod = sin_quant(phm);
    phm += to_inc(freq * mat<EVENTFUL>(i_f, ratio_g, rounds, kRatio, D, V, vv) * f2pi);
    const float car_freq =
        freq * (1.0f + mat<EVENTFUL>(i_f, index_g, rounds, kIndex, D, V, vv) * mod);
    const float car = sin_quant(phc);
    phc += to_inc(car_freq * f2pi);

    const float s = warp_sum(valid ? car * gain : 0.0f);
    if (lane == 0) out[i] = s;
  }
  if (valid) {
    phm_out[v] = phm;
    phc_out[v] = phc;
    stage_out[v] = stage;
    t_out[v] = t;
  }
}

}  // namespace

extern "C" {

// Launches one block of the bank on `stream`; returns cudaGetLastError().
// rounds/act/words are read only when `eventful` is non-zero.
int ktt_fm_bank(const float* ramps, const float* rounds, const float* act,
                const uint32_t* words, const uint32_t* phm_in, const uint32_t* phc_in,
                const float* stage_in, const float* t_in, float* partial,
                uint32_t* phm_out, uint32_t* phc_out, float* stage_out, float* t_out,
                int V, int B, int D, int eventful, float atk, float rel, float f2pi,
                void* stream) {
  if (V < 1 || B < 1 || (eventful && D < 1)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((V + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (eventful) {
    fm_bank_kernel<true><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, phm_in, phc_in, stage_in, t_in, partial, phm_out,
        phc_out, stage_out, t_out, V, B, D, atk, rel, f2pi);
  } else {
    fm_bank_kernel<false><<<grid, kThreads, 0, s>>>(
        ramps, rounds, act, words, phm_in, phc_in, stage_in, t_in, partial, phm_out,
        phc_out, stage_out, t_out, V, B, D, atk, rel, f2pi);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
