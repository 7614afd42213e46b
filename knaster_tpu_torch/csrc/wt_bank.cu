// Fused additive wavetable voice bank for Hopper (sm_90a), called through
// ctypes from knaster_tpu_torch/kernels/wt_bank.py.
//
// Replaces knaster_tpu/parallel/pallas_bank.py::_wt_kernel. Per voice and
// sample: the anchored freq/amp/pan ramps (plus D breakpoint rounds in
// eventful blocks), the packed restart/release bits, the EnvAsr state
// machine, sincosf of the full-resolution fundamental angle, H partials by
// phasor recurrence (s, c) <- (s*c1 + c*s1, c*c1 - s*s1) weighted by the
// table's A_h/B_h and masked per sample against the hoisted Nyquist
// thresholds (freq <= nyq/(h+1)), equal-power pan (polynomial on the linear
// angle pack event-free, cosf/sinf of the materialized pan eventful) and the
// stereo mix.
//
// Design. One thread per voice in 256-thread CTAs, the phase and envelope
// in registers across the B-sample loop. What bounds it: FP32 issue, ~7
// ops per harmonic per voice-sample (112 at H = 16) plus one sincosf. What
// the design does about it:
// - the constants: A, B and the thresholds (computed on the host in f64 and
//   rounded to f32 as the JAX package does) reach the kernel by value, a
//   __grid_constant__ parameter padded to the instantiation HMAX in 8, 16,
//   32, 64 (A = B = 0, thr = -inf), so that the fully unrolled harmonic loop
//   (bank_common.cuh additive_partials, shared with the generic Additive
//   body) reads them as constant-bank operands and stops at H; no load a
//   harmonic. A table of more than 64 harmonics takes the run-time variant
//   (HMAX = kRuntimeH): the [3][H] table stays in global memory and the
//   same recurrence reads it with a warp-uniform index
//   (additive_partials_rt), one broadcast load a constant;
// - the mix (bank_common.cuh): an event-free block sums each sample's
//   stereo pair in a shared-memory tile (CtaMix), an eventful block by a
//   warp shuffle into a row per warp, summed once at the end; the kernel
//   sums the CTA rows itself in a fixed order (mix_finish): no shuffle a
//   sample and channel where the block is event-free, no reduction launch;
// - at most 64 registers, so that a 131,072-voice bank runs in one wave.
// Whole warps past the bank skip the body and only join the CTA's barriers;
// ragged lanes read voice 0 and contribute 0.
//
// Numerics. --fmad=false keeps the recurrence's multiplies and adds rounded
// one by one, so phase, stage, t and rscale are bit-equal to the plain
// version's. The mix goes through sincosf, which may differ from torch's
// and XLA's sin/cos by an ulp, carried through the recurrence, and sums
// the same terms as the plain version in another, fixed, order: the mix is
// compared within a stated tolerance.

#include <cstring>

#include "bank_common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = kMixThreads;
constexpr int kFreq = 0, kAmp = 1, kPan = 2;

template <int HMAX>
struct WtConsts {
  float H;
  Harmonics<HMAX> h;
};

// the run-time variant: H alone; the table is the coefs operand
template <>
struct WtConsts<kRuntimeH> {
  float H;
};

// at most 64 registers: four CTAs an SM, a 131,072-voice bank in one wave
template <int HMAX, bool EVENTFUL>
__global__ void __launch_bounds__(kThreads, 4)
wt_bank_kernel(const float* __restrict__ ramps, const float* __restrict__ rounds,
               const float* __restrict__ act, const uint32_t* __restrict__ words,
               const uint32_t* __restrict__ phase_in, const float* __restrict__ stage_in,
               const float* __restrict__ t_in, const float* __restrict__ rscale_in,
               const __grid_constant__ WtConsts<HMAX> kc,
               const float* __restrict__ coefs, float* work,
               float* __restrict__ mix, unsigned* tickets, uint32_t* __restrict__ phase_out,
               float* __restrict__ stage_out, float* __restrict__ t_out,
               float* __restrict__ rscale_out, int V, int B, int D, float atk, float rel,
               float f2pi) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  // whole warps past the bank skip the body; they only join the barriers
  const bool live = ((v >> 5) << 5) < V;
  const bool valid = v < V;
  const int vv = valid ? v : 0;  // ragged lanes read voice 0, contribute 0

  Ramp freq_g{}, amp_g{}, pan_g{};
  uint32_t phase = 0u;
  float stage = 0.0f, t = 0.0f, rscale = 0.0f, a = 1.0f;
  if (live) {
    freq_g = load_ramp(ramps, kFreq, V, vv);
    amp_g = load_ramp(ramps, kAmp, V, vv);
    pan_g = load_ramp(ramps, kPan, V, vv);
    phase = phase_in[vv];
    stage = stage_in[vv];
    t = t_in[vv];
    rscale = rscale_in[vv];
    if (EVENTFUL) a = act[vv];
  }
  const int H = static_cast<int>(kc.H);
  const int W = (B + 31) >> 5;
  uint32_t rw = 0u, qw = 0u;

  // one sample of this voice: (left, right), 0 on a ragged lane
  auto sample = [&](int i, float& l, float& r) {
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
    float acc;
    if constexpr (HMAX == kRuntimeH) {
      acc = additive_partials_rt(freq, theta_full(phase), coefs, coefs + H, coefs + 2 * H, H);
    } else {
      acc = additive_partials<HMAX>(freq, theta_full(phase), kc.h, H);
    }
    phase += to_inc(freq * f2pi);

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
      pack_gains(i_f, PanPack{pan_g.v0, pan_g.step, pan_g.el, pan_g.dur, pan_g.tgt}, panl,
                 panr);
    }
    l = valid ? sig * panl : 0.0f;
    r = valid ? sig * panr : 0.0f;
  };

  if constexpr (EVENTFUL) {
    if (live) {
      float* wrow = mix_warp_row(work, 2 * B);
      for (int i = 0; i < B; ++i) {
        float l, r;
        sample(i, l, r);
        l = warp_sum(l);
        r = warp_sum(r);
        if ((threadIdx.x & 31) == 0) {
          wrow[i] = l;
          wrow[B + i] = r;
        }
      }
    }
    mix_combine_warps(work, V, 2 * B);
  } else {
    constexpr int T = CtaMix<2>::T;  // samples a mix tile
    __shared__ __align__(16) CtaMix<2> tile;
    if (!live) tile.clear();
    float* row = work + static_cast<size_t>(blockIdx.x) * 2 * B;
    for (int i0 = 0; i0 < B; i0 += T) {
      const int end = min(i0 + T, B);
      const int buf = (i0 / T) & 1;
      if (live) {
        for (int i = i0; i < end; ++i) {
          float l, r;
          sample(i, l, r);
          tile.put(buf, i - i0, l);
          tile.put(buf, T + i - i0, r);
        }
      }
      tile.flush(buf, row, B, i0, end - i0);
    }
  }
  if (valid) {
    phase_out[v] = phase;
    stage_out[v] = stage;
    t_out[v] = t;
    rscale_out[v] = rscale;
  }
  mix_finish(work, mix, tickets, 2 * B);
}

struct Launch {
  const float *ramps, *rounds, *act;
  const uint32_t *words, *phase_in;
  const float *stage_in, *t_in, *rscale_in, *image, *coefs;
  float *work, *mix;
  unsigned* tickets;
  uint32_t* phase_out;
  float *stage_out, *t_out, *rscale_out;
  int V, B, D, eventful;
  float atk, rel, f2pi;
  cudaStream_t s;
};

template <int HMAX>
cudaError_t launch_hmax(const Launch& L) {
  WtConsts<HMAX> kc;
  std::memcpy(&kc, L.image, sizeof(kc));
  if (HMAX == kRuntimeH && L.coefs == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((L.V + kThreads - 1) / kThreads);
  if (L.eventful) {
    wt_bank_kernel<HMAX, true><<<grid, kThreads, 0, L.s>>>(
        L.ramps, L.rounds, L.act, L.words, L.phase_in, L.stage_in, L.t_in, L.rscale_in, kc,
        L.coefs, L.work, L.mix, L.tickets, L.phase_out, L.stage_out, L.t_out, L.rscale_out, L.V, L.B,
        L.D, L.atk, L.rel, L.f2pi);
  } else {
    wt_bank_kernel<HMAX, false><<<grid, kThreads, 0, L.s>>>(
        L.ramps, L.rounds, L.act, L.words, L.phase_in, L.stage_in, L.t_in, L.rscale_in, kc,
        L.coefs, L.work, L.mix, L.tickets, L.phase_out, L.stage_out, L.t_out, L.rscale_out, L.V, L.B,
        L.D, L.atk, L.rel, L.f2pi);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one block of the bank on `stream`; returns cudaGetLastError().
// rounds/act/words are read only when `eventful` is non-zero. image is the
// host copy of the kernel parameter: H, then A, B and the Nyquist
// thresholds each padded to HMAX (n_image = 1 + 3*HMAX, HMAX in 8, 16, 32,
// 64, H <= HMAX), or H alone (n_image = 1, any H >= 1: the run-time
// variant, which reads the table from coefs, the [3][H] device table). work
// is [9*ceil(V/256) + ceil(V/8192)][2][B] scratch, mix [2][B] the bank's
// mix, tickets 1 + ceil(V/8192) words that are zero before the launch and
// after it.
int ktt_wt_bank(const float* ramps, const float* rounds, const float* act,
                const uint32_t* words, const uint32_t* phase_in, const float* stage_in,
                const float* t_in, const float* rscale_in, const float* image, int n_image,
                const float* coefs, float* work, float* mix, unsigned* tickets,
                uint32_t* phase_out, float* stage_out, float* t_out, float* rscale_out,
                int V, int B, int D, int eventful, float atk, float rel, float f2pi,
                void* stream) {
  if (V < 1 || B < 1 || (eventful && D < 1) || image == nullptr || !(image[0] >= 1.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{ramps, rounds, act, words, phase_in, stage_in, t_in, rscale_in, image,
                 coefs, work, mix, tickets, phase_out, stage_out, t_out, rscale_out, V, B, D,
                 eventful, atk, rel, f2pi, static_cast<cudaStream_t>(stream)};
  const int hmax = (n_image - 1) / 3;
  if (n_image != 1 + 3 * hmax || (hmax != kRuntimeH && image[0] > static_cast<float>(hmax))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (hmax) {
    case kRuntimeH:
      return static_cast<int>(launch_hmax<kRuntimeH>(L));
    case 8:
      return static_cast<int>(launch_hmax<8>(L));
    case 16:
      return static_cast<int>(launch_hmax<16>(L));
    case 32:
      return static_cast<int>(launch_hmax<32>(L));
    case 64:
      return static_cast<int>(launch_hmax<64>(L));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
