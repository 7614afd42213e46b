// PinkNoise's block for Hopper (sm_90a), called through ctypes from
// knaster_tpu_torch/kernels/pink_noise.py.
//
// No TPU kernel precedes it: the JAX package renders PinkNoise in XLA
// (knaster_tpu/ugens/noise.py PinkNoise.process). Its plain torch version
// (pink_noise_plain) launches ~700 small operations a block, most of them
// the u32 arithmetic of three Threefry-2x32 evaluations, which on the card
// leave the host launching, not the card computing: the realtime soak's
// `ir` chunk spent most of its host time there (PERF.md §6). This kernel
// is one launch a block.
//
// Per instance (one CTA each) and sample t of the block, as the plain
// version:
// - the noise stream: the key fold_in(PRNGKey(seed), frame + t), then two
//   draws of jax.random.uniform from it (the counters (0, 0) and (0, 1)),
//   x0 and x1 in (-1, 1); one thread a sample, into the workspace;
// - Voss-McCartney: the counter c_t = ((c - 1 + t) & 255) + 1 fires octave
//   ctz(c_t), whose previous value leaves the sum and x0_t takes its place;
//   the always-on white source x1 enters and its previous value leaves:
//   d_t = ((x0_t - removed_t) + x1_t) - x1_{t-1};
// - pink_t = pink + cumsum(d)_t in the association of core/dsp.py
//   cumsum_base16 (rows of 16 from 0, the row totals scanned the same way,
//   each row plus the scanned totals before it), and out_t = pink_t * 0.1.
// The recurrence and the scan run on thread 0 in sample order: they are a
// few operations a sample, the Threefry work is not.
//
// Numerics. Built with --fmad=false: every add and multiply rounds on its
// own, in the plain version's order, so the output and the state are
// bit-equal to it. The plain version's `removed` sums nine lanes of which
// one is the octave's value and eight are +0, which is the value plus +0.
// f32 and f64 (the uniform takes 23 or 52 bits of the draw).

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

using namespace ktt;

constexpr int kOctaves = 9;  // PINK_NOISE_OCTAVES
constexpr int kSpanMask = (1 << (kOctaves - 1)) - 1;
constexpr int kThreads = 256;
constexpr int kScanBase = 16;

__device__ __forceinline__ float uniform_of_bits(uint32_t b0, uint32_t b1, float) {
  return __uint_as_float(((b0 ^ b1) >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ double uniform_of_bits(uint32_t b0, uint32_t b1, double) {
  const unsigned long long m = (static_cast<unsigned long long>(b0) << 20) | (b1 >> 12) |
                               0x3FF0000000000000ull;
  return __longlong_as_double(static_cast<long long>(m)) - 1.0;
}

// In place: x[0, n) -> its inclusive prefix sum in cumsum_base16's
// association. `work` holds the upper levels' totals: ceil(n/16) +
// ceil(n/256) + ... values, fewer than n for n > 16.
template <typename T>
__device__ void scan_base16(T* x, int n, T* work) {
  if (n <= kScanBase) {
    T acc = x[0] + T(0);
    x[0] = acc;
    for (int c = 1; c < n; ++c) {
      acc = acc + x[c];
      x[c] = acc;
    }
    return;
  }
  const int rows = (n + kScanBase - 1) / kScanBase;
  for (int r = 0; r < rows; ++r) {  // each row from 0, the tail padded with +0
    const int c0 = r * kScanBase;
    T acc = x[c0] + T(0);
    x[c0] = acc;
    for (int c = c0 + 1; c < c0 + kScanBase; ++c) {
      acc = acc + (c < n ? x[c] : T(0));
      if (c < n) x[c] = acc;
    }
    work[r] = acc;
  }
  scan_base16(work, rows, work + rows);
  for (int r = 0; r < rows; ++r) {  // each row plus the totals before it
    const T before = r > 0 ? work[r - 1] : T(0);
    const int end = min(n, (r + 1) * kScanBase);
    for (int c = r * kScanBase; c < end; ++c) x[c] = x[c] + before;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pink_noise_kernel(const int32_t* __restrict__ seed, const int32_t* __restrict__ frame,
                  const T* __restrict__ whites, const T* __restrict__ always_on,
                  const int32_t* __restrict__ counter, const T* __restrict__ pink,
                  T* __restrict__ out, T* __restrict__ ws, T* __restrict__ whites_out,
                  T* __restrict__ always_on_out, int32_t* __restrict__ counter_out,
                  int32_t* __restrict__ frame_out, T* __restrict__ pink_out, int B) {
  const int inst = blockIdx.x;
  const uint32_t s = static_cast<uint32_t>(seed[inst]);
  const uint32_t f0 = static_cast<uint32_t>(frame[inst]);
  T* x0 = ws + static_cast<size_t>(inst) * 2 * B;
  T* x1 = x0 + B;
  for (int t = threadIdx.x; t < B; t += blockDim.x) {
    uint32_t ka = 0u, kb = f0 + static_cast<uint32_t>(t);  // fold_in(PRNGKey(seed), frame + t)
    threefry2x32(0u, s, ka, kb);
    uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;  // the draws' counters (0, 0), (0, 1)
    threefry2x32(ka, kb, a0, a1);
    threefry2x32(ka, kb, b0, b1);
    x0[t] = uniform_of_bits(a0, a1, T(0)) * T(2) - T(1);
    x1[t] = uniform_of_bits(b0, b1, T(0)) * T(2) - T(1);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  T w[kOctaves];
  for (int o = 0; o < kOctaves; ++o) w[o] = whites[inst * kOctaves + o];
  T x1_prev = always_on[inst];
  const int c0 = counter[inst];
  for (int t = 0; t < B; ++t) {  // d_t into x0's lane
    const int c = ((c0 - 1 + t) & kSpanMask) + 1;
    const int octave = __ffs(c) - 1;
    const T a = x0[t], b = x1[t];
    const T removed = w[octave] + T(0);
    w[octave] = a;
    x0[t] = ((a - removed) + b) - x1_prev;
    x1_prev = b;
  }
  for (int o = 0; o < kOctaves; ++o) whites_out[inst * kOctaves + o] = w[o];
  always_on_out[inst] = x1_prev;
  counter_out[inst] = ((c0 - 1 + B) & kSpanMask) + 1;
  frame_out[inst] = static_cast<int32_t>(f0 + static_cast<uint32_t>(B));
  scan_base16(x0, B, x1);
  const T p0 = pink[inst];
  const T scale = T(1) / T(kOctaves + 1);
  T* o = out + static_cast<size_t>(inst) * B;
  T p = p0;
  for (int t = 0; t < B; ++t) {
    p = p0 + x0[t];
    o[t] = p * scale;
  }
  pink_out[inst] = p;
}

template <typename T>
int launch(const int32_t* seed, const int32_t* frame, const void* whites,
           const void* always_on, const int32_t* counter, const void* pink, void* out,
           void* ws, void* whites_out, void* always_on_out, int32_t* counter_out,
           int32_t* frame_out, void* pink_out, int n, int B, cudaStream_t stream) {
  pink_noise_kernel<T><<<n, kThreads, 0, stream>>>(
      seed, frame, static_cast<const T*>(whites), static_cast<const T*>(always_on), counter,
      static_cast<const T*>(pink), static_cast<T*>(out), static_cast<T*>(ws),
      static_cast<T*>(whites_out), static_cast<T*>(always_on_out), counter_out, frame_out,
      static_cast<T*>(pink_out), B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One block of n PinkNoise instances on `stream`; returns cudaGetLastError().
// seed, frame, counter and their outputs are [n] int32; whites [n][9];
// always_on, pink [n]; out [n][B]; ws [n][2][B] scratch; the float tensors
// f32, or f64 where is_double is non-zero.
int ktt_pink_noise(const int32_t* seed, const int32_t* frame, const void* whites,
                   const void* always_on, const int32_t* counter, const void* pink, void* out,
                   void* ws, void* whites_out, void* always_on_out, int32_t* counter_out,
                   int32_t* frame_out, void* pink_out, int n, int B, int is_double,
                   void* stream) {
  if (n < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return is_double
             ? launch<double>(seed, frame, whites, always_on, counter, pink, out, ws,
                              whites_out, always_on_out, counter_out, frame_out, pink_out, n,
                              B, s)
             : launch<float>(seed, frame, whites, always_on, counter, pink, out, ws,
                             whites_out, always_on_out, counter_out, frame_out, pink_out, n,
                             B, s);
}

const char* ktt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
