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

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 5;  // floats per ramp group / breakpoint group
constexpr int kFreq = 0, kAmp = 1, kPan = 2;

constexpr uint32_t kTableSize = 16384u;
constexpr uint32_t kTableHighMask = kTableSize - 1u;

// np.float32 values of the JAX package's constants, written exactly
constexpr float kIdxScale = 0x1.921fb6p-12f;  // 2*pi / 16384
constexpr float kHalfPi = 0x1.921fb6p+0f;     // pi / 2
constexpr float kToIncMax = 0x1.fffffep+30f;  // 2^31 - 128
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

__device__ __forceinline__ float sin_quant(uint32_t phase) {
  const uint32_t idx = (phase >> 16) & kTableHighMask;
  const uint32_t half = idx & (kTableSize / 2u - 1u);
  const bool neg = idx >= kTableSize / 2u;
  const uint32_t m = half > kTableSize / 4u ? kTableSize / 2u - half : half;
  const float p = sin_poly(static_cast<float>(static_cast<int32_t>(m)) * kIdxScale);
  return neg ? -p : p;
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

// breakpoint rounds [3][5][D][V]: piece r wins from its frame on
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

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
    float env;
    float t_next;
    if (EVENTFUL) {
      if ((i & 31) == 0) {
        rw = words[static_cast<size_t>(i >> 5) * V + vv];
        qw = words[static_cast<size_t>(W + (i >> 5)) * V + vv];
      }
      const bool restart = (rw >> (i & 31)) & 1u;
      const bool release = (qw >> (i & 31)) & 1u;
      if (restart) stage = 1.0f;
      const bool rel_from_atk = release && stage == 1.0f;
      const bool rel_from_sus = release && stage == 2.0f;
      rscale = rel_from_atk ? t : (rel_from_sus ? 1.0f : rscale);
      if (rel_from_atk || rel_from_sus) {
        t = 1.0f;
        stage = 3.0f;
      }
    }
    env = stage == 1.0f ? t
        : stage == 2.0f ? 1.0f
        : stage == 3.0f ? t * t * t * rscale
        : 0.0f;
    t_next = stage == 1.0f ? t + atk : (stage == 3.0f ? t - rel : t);
    const bool to_sus = stage == 1.0f && t_next >= 1.0f;
    if (to_sus) t_next = 1.0f;  // pin sustain t
    const bool done = stage == 3.0f && t_next <= 0.0f;
    if (to_sus) stage = 2.0f;
    if (done) {
      stage = 0.0f;
      t_next = 0.0f;
    }
    t = t_next;

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

const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
