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
// Design. One thread per voice in 256-thread CTAs, the phase and envelope
// state in registers across the B-sample loop, at most 64 registers (four
// CTAs an SM, a 131,072-voice bank in one wave). What bounds it: FP32 issue
// per voice-sample (the sine polynomial most of it) where the voices are
// sustained and their ramps flat; memory is a few tens of bytes per voice
// per block. What the design does about it:
// - the staging: an event-free block takes the raw pan ramp group and the
//   0/1 active gain, and the prologue builds what the host built before it,
//   by the same operations in the same order: act folded into amp's (v0,
//   step, tgt) (bank_common.py fold_act) and the linear-angle pan pack
//   (bank_common.py and bank_common.cuh pan_pack), so the host launches
//   neither;
// - per-block hoists in event-free blocks, each where the values it reads
//   are the same at every sample, from sample 0, bit-equal by rule: the pan
//   gains (pack_flat), the u32 increment (ramp_flat of freq), amp
//   (ramp_flat) and the envelope where the stage is 0 or 2 at block entry
//   (env_asr_steady: the state stays as it is and env is 0 or 1). A warp
//   takes a hoist only where all its lanes can (__all_sync), so a sustained
//   warp's loop is the sine, the phase add, three multiplies and the tile
//   stores; a warp whose every gain is zero advances its phase by B
//   increments at once (exact in u32 arithmetic) and sums nothing;
// - the mix (bank_common.cuh): event-free blocks sum each sample's stereo
//   pair in a shared-memory tile (CtaMix), eventful blocks by a warp
//   shuffle into a row per warp (their breakpoint re-reads keep L1); the
//   kernel sums the CTA rows itself in a fixed order (mix_finish), so no
//   reduction launch follows.
// Whole warps past the bank skip the body and only join the CTA's barriers;
// ragged lanes read voice 0 and contribute 0.
//
// Numerics. Built with --fmad=false and no fast math: every multiply and add
// rounds on its own, as in the plain torch version and XLA, so the carried
// state (phase, stage, t, rscale) is bit-equal to the plain version's, and
// cosf/sinf are the accurate library versions. The pack's target gains
// (cosf/sinf) and the mix's order reach the mix only.

#include "bank_common.cuh"

namespace {

using namespace ktt;

constexpr int kThreads = kMixThreads;
constexpr int kFreq = 0, kAmp = 1, kPan = 2;

// at most 64 registers: four CTAs an SM, a 131,072-voice bank in one wave.
// Event-free blocks read sin_quant from its 4097 first-quadrant values in
// shared memory (faster than the polynomial at B = 64 and 1024, PERF.md §6)
template <bool EVENTFUL>
__global__ void __launch_bounds__(kThreads, 4)
sine_bank_kernel(const float* __restrict__ ramps, const float* __restrict__ rounds,
                 const float* __restrict__ act, const uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ phase_in, const float* __restrict__ stage_in,
                 const float* __restrict__ t_in, const float* __restrict__ rscale_in,
                 float* work, float* __restrict__ mix, unsigned* tickets,
                 uint32_t* __restrict__ phase_out, float* __restrict__ stage_out,
                 float* __restrict__ t_out, float* __restrict__ rscale_out, int V, int B,
                 int D, float atk, float rel, float f2pi) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  // whole warps past the bank skip the body; they only join the barriers
  const bool live = ((v >> 5) << 5) < V;
  const bool valid = v < V;
  const int vv = valid ? v : 0;  // ragged lanes read voice 0, contribute 0

  Ramp freq_g{}, amp_g{}, pan_g{};
  uint32_t phase = 0u;
  float stage = 0.0f, t = 0.0f, rscale = 0.0f, a = 0.0f;
  if (live) {
    freq_g = load_ramp(ramps, kFreq, V, vv);
    amp_g = load_ramp(ramps, kAmp, V, vv);
    pan_g = load_ramp(ramps, kPan, V, vv);
    phase = phase_in[vv];
    stage = stage_in[vv];
    t = t_in[vv];
    rscale = rscale_in[vv];
    a = act[vv];
  }

  if constexpr (EVENTFUL) {
    const int W = (B + 31) >> 5;
    uint32_t rw = 0u, qw = 0u;
    if (live) {
      float* wrow = mix_warp_row(work, 2 * B);
      for (int i = 0; i < B; ++i) {
        const float i_f = static_cast<float>(i);
        if ((i & 31) == 0) {
          rw = load_word(words, 0, W, i >> 5, V, vv);
          qw = load_word(words, 1, W, i >> 5, V, vv);
        }
        // the parent design's order: both base ramps, then their rounds, and
        // the pan gains before the mix's select (with cosf/sinf inside the
        // select the loop ran slower than the parent's, PERF.md §6)
        const float env = env_asr(stage, t, rscale, trig_bit(rw, i), trig_bit(qw, i), atk, rel);
        float amp = mat_base(i_f, amp_g);
        float freq = mat_base(i_f, freq_g);
        amp = mat_rounds(i_f, amp, rounds, kAmp, D, V, vv);
        freq = mat_rounds(i_f, freq, rounds, kFreq, D, V, vv);
        const float pan = mat_rounds(i_f, mat_base(i_f, pan_g), rounds, kPan, D, V, vv);
        const float angle = (pan * 0.5f + 0.5f) * kHalfPi;
        const float panl = cosf(angle);
        const float panr = sinf(angle);
        const float gain = env * amp * a;
        const float osc = sin_quant(phase);
        phase += to_inc(freq * f2pi);
        const float sig = osc * gain;
        const float l = warp_sum(valid ? sig * panl : 0.0f);
        const float r = warp_sum(valid ? sig * panr : 0.0f);
        if ((threadIdx.x & 31) == 0) {
          wrow[i] = l;
          wrow[B + i] = r;
        }
      }
    }
    mix_combine_warps(work, V, 2 * B);
  } else {
    extern __shared__ float sin_tab[];
    fill_sin_table(sin_tab);
    // the staging, per voice (bank_common.py fold_act, pan_pack)
    amp_g.v0 = amp_g.v0 * a;
    amp_g.step = amp_g.step * a;
    amp_g.tgt = amp_g.tgt * a;
    const PanPack pk = pan_pack(pan_g);
    // the hoists' values at sample 0, and where a warp may take them
    float hl, hr;
    pack_gains(0.0f, pk, hl, hr);
    const uint32_t inc0 = to_inc(mat_base(0.0f, freq_g) * f2pi);
    const float amp0 = mat_base(0.0f, amp_g);
    const float env0 = stage == 2.0f ? 1.0f : 0.0f;
    const float gain0 = valid ? env0 * amp0 : 0.0f;  // a ragged lane sums +-0
    constexpr unsigned kAll = 0xffffffffu;
    const bool f_pan = __all_sync(kAll, !valid || pack_flat(pk, B));
    const bool f_freq = __all_sync(kAll, !valid || ramp_flat(freq_g, B));
    const bool f_amp = __all_sync(kAll, !valid || ramp_flat(amp_g, B));
    const bool f_env = __all_sync(kAll, !valid || env_asr_steady(stage));
    const bool fast = f_pan && f_freq && f_amp && f_env;
    // every sample of the warp is +-0: nothing to sum (a +-0 term leaves a
    // sum as it is, and the CTA's column sums see +0 instead)
    const bool quiet =
        fast && __all_sync(kAll, gain0 == 0.0f && isfinite(hl) && isfinite(hr));

    constexpr int T = CtaMix<2>::T;  // samples a mix tile
    __shared__ __align__(16) CtaMix<2> tile;
    if (!live || quiet) tile.clear();
    if (live && quiet) phase += static_cast<uint32_t>(B) * inc0;
    float* row = work + static_cast<size_t>(blockIdx.x) * 2 * B;
    for (int i0 = 0; i0 < B; i0 += T) {
      const int end = min(i0 + T, B);
      const int buf = (i0 / T) & 1;
      if (live && !quiet) {
        if (fast) {
          // a whole tile unrolled: its samples depend on each other only
          // through the phase add
          auto put = [&](int j) {
            const float sig = sin_quant_table(phase, sin_tab) * gain0;
            phase += inc0;
            tile.put(buf, j, sig * hl);
            tile.put(buf, T + j, sig * hr);
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
            const float env = f_env ? env0 : env_asr(stage, t, rscale, false, false, atk, rel);
            const float amp = f_amp ? amp0 : mat_base(i_f, amp_g);
            const uint32_t inc = f_freq ? inc0 : to_inc(mat_base(i_f, freq_g) * f2pi);
            float l = hl, r = hr;
            if (!f_pan) pack_gains(i_f, pk, l, r);
            const float sig = sin_quant_table(phase, sin_tab) * (env * amp);
            phase += inc;
            tile.put(buf, i - i0, valid ? sig * l : 0.0f);
            tile.put(buf, T + i - i0, valid ? sig * r : 0.0f);
          }
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
  const float *stage_in, *t_in, *rscale_in;
  float *work, *mix;
  unsigned* tickets;
  uint32_t* phase_out;
  float *stage_out, *t_out, *rscale_out;
  int V, B, D;
  float atk, rel, f2pi;
  cudaStream_t s;
};

template <bool EVENTFUL>
cudaError_t launch_variant(const Launch& L) {
  auto kernel = sine_bank_kernel<EVENTFUL>;
  const size_t dyn = EVENTFUL ? 0 : kSinTable * sizeof(float);
  // the 32 KB mix tile is static: the table passes 48 KB only by the opt-in,
  // set once (not again while a CUDA graph captures the launch)
  static bool opted_in = false;
  if (dyn > 0 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((L.V + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, dyn, L.s>>>(L.ramps, L.rounds, L.act, L.words, L.phase_in,
                                       L.stage_in, L.t_in, L.rscale_in, L.work, L.mix,
                                       L.tickets, L.phase_out, L.stage_out, L.t_out,
                                       L.rscale_out, L.V, L.B, L.D, L.atk, L.rel, L.f2pi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one block of the bank on `stream`; returns cudaGetLastError().
// act is read in every block; rounds/words only when `eventful` is non-zero.
// ramps hold the raw ramp groups of freq, amp and pan (nothing folded in).
// work is [9*ceil(V/256) + ceil(V/8192)][2][B] scratch, mix [2][B] the
// bank's mix, tickets 1 + ceil(V/8192) words that are zero before the
// launch and after it.
int ktt_sine_bank(const float* ramps, const float* rounds, const float* act,
                  const uint32_t* words, const uint32_t* phase_in, const float* stage_in,
                  const float* t_in, const float* rscale_in, float* work, float* mix,
                  unsigned* tickets, uint32_t* phase_out, float* stage_out, float* t_out,
                  float* rscale_out, int V, int B, int D, int eventful, float atk,
                  float rel, float f2pi, void* stream) {
  if (V < 1 || B < 1 || (eventful && D < 1) || act == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch L{ramps,     rounds,    act,   words, phase_in, stage_in,
                 t_in,      rscale_in, work,  mix,   tickets,  phase_out,
                 stage_out, t_out,     rscale_out, V, B, D, atk, rel, f2pi,
                 static_cast<cudaStream_t>(stream)};
  return static_cast<int>(eventful ? launch_variant<true>(L) : launch_variant<false>(L));
}

}  // extern "C"
