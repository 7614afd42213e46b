// The generic fused voice-bank harness for Hopper (sm_90a): the kernel
// templated over a voice body, and launch_body<Body>, which unpacks a body's
// constants and launches it. csrc/generic_bank.cu instantiates it with the
// library voices' bodies; a user voice's CUDA source (KernelVoiceSpec
// cuda_source) is compiled against it into a library of its own
// (kernels/build.py user_translation_unit).
//
// Replaces knaster_tpu/parallel/generic_bank.py::_generic_kernel. Per voice
// the harness materializes every float param per sample from its anchored
// ramp group (plus D breakpoint rounds in eventful blocks), reads each
// trigger's bit from its packed words (eventful blocks; event-free blocks
// have none), runs the body on the per-voice carry, multiplies each output
// by the 0/1 active gain per sample, and mixes C channels in the kernel
// (bank_common.cuh CtaMix, mix_combine_warps, mix_finish).
//
// The body contract. A body is a struct with compile-time counts NF (float
// params, in the voice's param order), NT (triggers), NC (32-bit carry
// words, in the voice's carry order; u32 carries as their bits, f32
// carries by __float_as_uint), C (outputs) and kPan (the pan param of a
// stereo body whose outputs are one signal times its pan gains, or -1); a
// Consts struct of floats, its constants, which reach the kernel by value
// as a __grid_constant__ parameter packed on the host (the n_image floats
// must fill it exactly); a constructor Body(const Consts&, const float4*
// table, const float* consts);
//   hoist(k, ramps, B), what it takes once an event-free block; and
//   step(k, carry[NC], P, T[NT], out[C])
// where P(k) is float param k at this sample. A stereo body writes its
// signal to out[0] and the harness applies pan_gains(pan). The policies
// come from deriving: NoHoist (nothing taken once a block), NoTable (no
// shared-memory table; a body with one sets kTable, table_bytes and
// stage_table), FourCtas (at most 64 registers: kMinBlocks and
// kMinBlocksEventful CTAs an SM), ExactPan (cosf/sinf gains) or PolyPan
// (polynomial gains). A body may call bank_common.cuh's helpers (sin_quant,
// to_inc, env_ar, env_asr, sin_poly, ...). Built with --fmad=false and no
// fast math, a body that keeps its torch body's association carries its
// state bit-equal to it.

#pragma once

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
  Body body(kc, table, consts);
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

}  // namespace
